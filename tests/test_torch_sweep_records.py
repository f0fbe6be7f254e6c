"""The ``sweep`` and ``stream`` records of ``tests/torch_golden/`` (the JAX
package's results at the settings users change, and on BASELINE config
5's two-dictionary stream) on the CPU: they hold every case of
``torch_golden.sweep_cases`` and both dictionaries of
``torch_golden.stream_frames``, made from the frames the port's renderer
draws now; every case whose point is not lane overflow decodes a marker on
each frame; and the port's CPU path passes the comparator on eleven of the
cheaper cases (an odd shape on each route, four channels, 129 lanes, one
lane on the tail route, S = 25 and S = 81, a 7x7 threshold box, one CCL
round, ds 8, the gather warp, the wide separation gate).  No JAX compile:
the records were made by ``tools/torch_make_golden.py sweep stream``."""

import numpy as np
import pytest
import torch
import torch_twin  # noqa: F401  (one torch thread a worker; tools/ on the path)
import torch_golden as golden

from aruco3_tpu_torch import ARDictionary, Detector, pose

HELD = (
    "threshold_window=3,min_side_length_factor=0.05",
    "ccl_rounds=1:clutter",
    "coarse_factor=8",
    "max_candidates=129:clutter",
    "max_candidates=1:noref:clutter",
    "homography_sample_size=25",
    "homography_sample_size=81",
    "min_corner_separation_factor=0.3",
    "warp_impl=gather:noref",
    "shape/241x323",
    "shape/97x131",
    "channels/4",
)


@pytest.fixture(scope="module")
def records():
    return golden.load("sweep")


def test_record_holds_every_case(records):
    cases = golden.sweep_cases()
    assert len(cases) == 50
    for name, case in cases.items():
        rec = golden.subset(records, name)
        assert "pallas/marker_valid" in rec and "pose_translations" in rec, name
        golden.check_hashes(name, rec["hashes"], golden.sweep_frames(name))
        found = golden.held(rec)["marker_valid"].sum(axis=1)
        assert case.overflow or (found > 0).all(), (name, found)


def test_stream_record_holds_both_dictionaries():
    records = golden.load("stream")
    frames = golden.stream_frames()
    assert list(frames) == list(golden.STREAM_DICTS)
    for name, f in frames.items():
        assert f.shape == (golden.STREAM_PER_DICT * golden.STREAM_DEPTH,) + golden.LANDSCAPE_HW
        rec = golden.subset(records, name)
        golden.check_hashes(name, rec["hashes"], f)
        assert (golden.held(rec)["marker_valid"].sum(axis=1) > 0).all(), name


@pytest.mark.parametrize("name", HELD)
def test_port_cpu_path_matches_record(name, records):
    case = golden.sweep_cases()[name]
    frames = golden.sweep_frames(name)
    det = Detector(case.config, ARDictionary.new_from_named_dict(case.dictionary), device="cpu")
    out = det.detect_batch(torch.from_numpy(frames))
    h, w = frames.shape[1:3]
    poses = pose.solve_normalized_batch(
        out["marker_corners"] / torch.tensor([float(w), float(h)]), golden.MARKER_MM)
    rep = golden.compare_batch(name, golden.subset(records, name), frames, out, poses,
                               lambda: golden.port_fits(det, frames))
    assert rep.differences == [] and rep.compared == len(frames)
    assert case.overflow or rep.lanes > 0


def test_shapes_take_their_coarse_factors():
    want = {(241, 323): 2, (479, 641): 4, (555, 777): 5, (250, 1000): 6, (1000, 250): 6,
            (190, 190): 1, (97, 131): 1}
    assert set(want) == set(golden.SWEEP_SHAPES)
    for (h, w), ds in want.items():
        case = golden.sweep_cases()[f"shape/{h}x{w}"]
        det = Detector(case.config, ARDictionary.new_from_named_dict(case.dictionary),
                       device="cpu")
        assert det.geometry(h, w)[3] == ds
        assert golden.sweep_frames(f"shape/{h}x{w}").shape == (golden.SHAPE_FRAMES, h, w)
    assert np.array_equal(golden.sweep_frames("channels/1")[..., 0],
                          golden.sweep_frames("coarse_factor=2"))
