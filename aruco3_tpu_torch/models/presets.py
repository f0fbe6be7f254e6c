"""Detector presets: tuned (dictionary, config) bundles per workload.

Counterpart of ``aruco3_tpu/models/presets.py``, with the same five
presets.  ``build`` places the detector on the card unless the caller asks
for another device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..detector import Detector, DetectorConfig
from ..dictionaries import ARDictionary


@dataclass(frozen=True)
class Preset:
    name: str
    dictionary: str
    config: DetectorConfig
    description: str

    def build(self, device: str | torch.device = "cuda") -> Detector:
        return Detector(
            self.config, ARDictionary.new_from_named_dict(self.dictionary), device=device
        )


PRESETS = {
    # Reference-default behaviour: large single markers, ARUCO dict.
    "reference-default": Preset(
        name="reference-default",
        dictionary="ARUCO_DEFAULT",
        config=DetectorConfig(),
        description="Reference defaults (aruco.rs:32-43): large markers, "
        "ARUCO 5x5 dictionary, 32 candidate lanes.",
    ),
    # 1080p streams with 36h12 markers.
    "1080p-mip36h12": Preset(
        name="1080p-mip36h12",
        dictionary="ARUCO_MIP_36H12",
        config=DetectorConfig(max_candidates=32),
        description="1080p video, ARUCO_MIP_36H12, up to ~24 markers/frame.",
    ),
    # Dense ChArUco-style grids on 4K frames.
    "4k-dense-grid": Preset(
        name="4k-dense-grid",
        dictionary="APRILTAG_36H11",
        config=DetectorConfig(
            max_candidates=96,
            min_side_length_factor=0.02,
            min_corner_separation_factor=0.002,
        ),
        description="4K calibration-grid scenes: 96 candidate lanes, "
        "relaxed size/separation gates for 64+ small markers.",
    ),
    # Low-latency single-marker tracking (e.g. one fiducial on a robot).
    "low-latency-tracker": Preset(
        name="low-latency-tracker",
        dictionary="APRILTAG_36H11",
        config=DetectorConfig(max_candidates=8, refine_corners=True),
        description="Minimal candidate capacity for single-target tracking "
        "latency.",
    ),
    # Permissive decode (the reference's filter_high_bit_errors=False mode).
    "permissive-decode": Preset(
        name="permissive-decode",
        dictionary="ARUCO_DEFAULT",
        config=DetectorConfig(filter_high_bit_errors=False),
        description="Report nearest-code decodes regardless of tau "
        "(reference aruco.rs:96 with the filter disabled).",
    ),
}


def get_preset(name: str) -> Preset:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; known: {sorted(PRESETS)}"
        ) from None


def build_detector(name: str, device: str | torch.device = "cuda") -> Detector:
    return get_preset(name).build(device)
