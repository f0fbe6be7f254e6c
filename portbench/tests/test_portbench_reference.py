"""The reference against the program's own plain path (the port on the
CPU runs every kernel's plain version) on the same frames, on each route:
the fused refine route, the label route (more than 128 lanes: kernels 5
and 6), the tail route (no refinement: kernel 8) and the gather warp.
They have to agree exactly, so that a difference on the card is the
kernels' or the glue's and not the reference's."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import check, runner, scenes  # noqa: E402
from portbench.reference import detect as ref  # noqa: E402
from portbench.reference.dictionaries import ARDictionary  # noqa: E402

SCENE = dict(runner.load_config("aruco_default_vga")["scene"], height=240, width=320,
             tile=[240, 320], origin=[0, 0], pitch=[240, 320], columns=1, markers=[1, 1])


@pytest.mark.parametrize("fields,route", [
    ({}, "fused"),
    ({"max_candidates": 130}, "labels"),
    ({"refine_corners": False}, "tail"),
    ({"refine_corners": False, "warp_impl": "gather"}, "tail"),
])
def test_reference_equals_the_programs_plain_path(fields, route):
    from aruco3_tpu_torch import ARDictionary as PortDictionary
    from aruco3_tpu_torch import Detector, DetectorConfig

    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    frames, _ = scenes.render_frames(SCENE, d, 2, 31337, "cpu")
    cfg = ref.DetectorConfig(**fields)
    assert ref.route(cfg, 240, 320) == route
    want = ref.detect_batch(frames, d, cfg)
    got = Detector(DetectorConfig(**fields), PortDictionary.new_from_named_dict("ARUCO_DEFAULT"),
                   device="cpu").detect_batch(frames)
    assert want["marker_valid"].any()
    for k in check.FIELDS[:5]:
        assert torch.equal(got[k], want[k]), k
