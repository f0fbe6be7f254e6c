"""State carried across from the JAX package.

The detector has no weights: its state is the marker dictionary and the
static configuration.  ``from_jax_state`` takes them as a dict of numpy
arrays and scalars (``name``, ``num_bits``, ``tau``, ``code_list`` as
uint64, and the fields of the JAX ``DetectorConfig`` and ``QuadParams``)
and returns the port's objects, ``warp_impl`` (the tail route's warp)
included.  The one field the port does not have, ``use_pallas`` (the
JAX package's choice between its Pallas kernels and XLA), is ignored: on
the card the port always launches its kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .detector import DetectorConfig
from .dictionaries import ARDictionary
from .segment import QuadParams


def _fields(cls, state: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in state.items() if k in names}


def from_jax_state(state: dict):
    """-> (ARDictionary, DetectorConfig, QuadParams).

    ``state`` holds ``name``, ``num_bits``, ``tau`` and ``code_list`` of
    the dictionary, ``config`` (the DetectorConfig fields) and ``params``
    (the QuadParams fields)."""
    dictionary = ARDictionary(
        name=str(state["name"]),
        num_bits=int(state["num_bits"]),
        tau=int(state["tau"]),
        code_list=np.asarray(state["code_list"], dtype=np.uint64).copy(),
    )
    config = DetectorConfig(**_fields(DetectorConfig, state["config"]))
    params = QuadParams(**_fields(QuadParams, state["params"]))
    return dictionary, config, params
