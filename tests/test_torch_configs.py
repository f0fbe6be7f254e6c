"""Twins of the configurations the other end-to-end twins leave out: the
port's Detector against the JAX Detector (XLA path) at 320x240 with no
inner lanes, without the bit-error filter, with a contour epsilon of 0.1,
and with the ``4k-dense-grid`` preset's config on a board of
``APRILTAG_36H11`` tags.  Each case runs its scenes as one batch, on both
sides, and compares every frame's markers, candidates and stats."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aruco3_tpu import Detector as JDetector
from aruco3_tpu import DetectorConfig as JDetectorConfig
from aruco3_tpu import dictionaries as jdictionaries
from aruco3_tpu_torch import Detector, DetectorConfig, dictionaries, render
from aruco3_tpu_torch.detector import to_host
from aruco3_tpu_torch.models import presets
from torch_twin import make_scene

W, H = 320, 240
BOARD_QUADS = [np.array([[0, 0], [s, 0], [s, s], [0, s]], float) * 1.0 + o
               for s, o in ((70, (20, 20)), (64, (130, 30)), (72, (225, 24)), (80, (40, 140)),
                            (66, (190, 150)))]


def corrupted():
    """Marker 5 of ``make_scene("single")`` with a patch of its code cells
    painted white: a decode more than the dictionary's tau from any code."""
    img, _ = make_scene("single")
    img = img.copy()
    img[105:150, 140:185] = 235
    return img


def board(d):
    """Five tags of ``d`` on a white 320x240 frame, ids 0-4, with noise."""
    img = np.full((H, W), 255, np.uint8)
    for mid, q in enumerate(BOARD_QUADS):
        img = np.minimum(img, render.render_marker(d, mid, (W, H), q))
    rng = np.random.default_rng(11)
    return np.clip(img + rng.normal(0, 2.0, img.shape), 0, 255).astype(np.uint8)


# name -> (config fields, dictionary, scenes)
CASES = {
    "max_inner_candidates_0": ({"max_inner_candidates": 0}, "ARUCO_DEFAULT",
                               ("single", "multi", "nested")),
    "no_bit_error_filter": ({"filter_high_bit_errors": False}, "ARUCO_DEFAULT",
                            ("single", "corrupted")),
    "contour_epsilon_0.1": ({"contour_simplification_epsilon": 0.1}, "ARUCO_DEFAULT",
                            ("multi", "nested", "dark")),
    "preset_4k_dense_grid": (dataclasses.asdict(presets.get_preset("4k-dense-grid").config),
                             presets.get_preset("4k-dense-grid").dictionary, ("board",)),
}


def scene(kind, d):
    if kind == "corrupted":
        return corrupted()
    if kind == "board":
        return board(d)
    return make_scene(kind)[0]


def summary(det):
    return sorted((m.id, m.code, m.hamming_distance, tuple(m.corners)) for m in det.markers)


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_matches_jax(case):
    fields, dict_name, kinds = CASES[case]
    d = dictionaries.ARDictionary.new_from_named_dict(dict_name)
    jdet = JDetector(JDetectorConfig(use_pallas="never", **fields),
                     jdictionaries.ARDictionary.new_from_named_dict(dict_name))
    det = Detector(DetectorConfig(**fields), d, device="cpu")
    imgs = np.stack([scene(k, d) for k in kinds])
    jout = jax.device_get(jdet.detect_batch(jnp.asarray(imgs)))
    out = det.detect_batch(imgs)
    found = []
    for i, kind in enumerate(kinds):
        ref = jdet._to_host(jax.tree_util.tree_map(lambda x, i=i: x[i], jout))
        got = to_host(out, i)
        assert summary(got) == summary(ref), kind
        assert got.candidates == ref.candidates, kind
        assert got.stats == ref.stats, kind
        found += got.markers
    assert found
    if case == "no_bit_error_filter":  # a decode past tau is reported
        assert any(m.hamming_distance >= d.tau for m in found)
    if case == "preset_4k_dense_grid":
        assert {m.id for m in found} == set(range(len(BOARD_QUADS)))
