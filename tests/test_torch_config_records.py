"""The ``configs`` record of ``tests/torch_golden/`` (the JAX package's
results on the configurations users run: BASELINE configs 1, 2 and 4,
config 2's noise frames, the presets, the 15 dictionaries on both routes,
colour input) on the CPU: it holds every case of
``torch_golden.config_cases``; two of its cases come out again from the
JAX package (``dict/APRILTAG_16H5`` and ``dict/CHILITAGS``: marks 6 and
10 on the refine route, two JAX compiles and their gather-warp decodes in
interpret mode); the port's CPU path passes the comparator on config 1,
the first 4 frames of config 2 and of its noise frames, the presets, a
``dict/`` case at each mark size on the refine route and two on the tail
route, the colour frames and the cluttered frames on both routes; and
the comparator refuses frames whose hash differs from the record's."""

import pytest
import torch
import torch_twin  # noqa: F401  (one torch thread a worker; tools/ on the path)
import torch_golden as golden
import torch_make_golden

from aruco3_tpu_torch import ARDictionary, Detector, pose

REGENERATED = ("dict/APRILTAG_16H5", "dict/CHILITAGS")
# case -> frames held (None: all the record's)
HELD = {
    "config1": None,
    "config2": 4,
    "config2_noise": 4,
    "preset/reference-default": None,
    "preset/low-latency-tracker": None,
    "preset/permissive-decode": None,
    "dict/APRILTAG_16H5": None,  # mark 6
    "dict/ARUCO_MIP_25H7": None,  # mark 7
    "dict/APRILTAG_36H10": None,  # mark 8
    "dict/CHILITAGS": None,  # mark 10, 64-bit codes
    "dict/ARUCO_MIP_16H3" + golden.NOREF: None,
    "dict/CHILITAGS" + golden.NOREF: None,
    "rgb": None,
    "clutter": None,
    "clutter" + golden.NOREF: None,
}


@pytest.fixture(scope="module")
def records():
    return golden.load("configs")


@pytest.fixture(scope="module")
def programs():
    """The record maker's programs and decoders, shared by the module."""
    return {}


def frames_of(name: str, n: int | None):
    """The first ``n`` recorded frames of case ``name`` (all if None)."""
    if name in ("config2", "config2_noise") and n is not None:
        return golden.config2_frames(name == "config2_noise", n)
    frames = golden.config_frames(name)
    return frames if n is None else frames[:n]


def test_record_holds_every_case(records):
    cases = golden.config_cases()
    assert {c.dictionary for c in cases.values()} >= set(golden.CONFIG_DICTS)
    assert len(golden.CONFIG_DICTS) == 15
    for name in cases:
        rec = golden.subset(records, name)
        assert "pallas/marker_valid" in rec and "pose_translations" in rec, name
        assert len(rec["hashes"]) in (1, cases[name].batch), name


@pytest.mark.parametrize("name", REGENERATED)
def test_case_regenerates_from_jax(name, records, programs):
    rec = torch_make_golden.config_record(name, programs)
    assert torch_make_golden.same(rec, golden.subset(records, name)) == []


@pytest.mark.parametrize("name", sorted(HELD))
def test_port_cpu_path_matches_record(name, records):
    case = golden.config_cases()[name]
    frames = frames_of(name, HELD[name])
    rec = {k: v[: len(frames)] for k, v in golden.subset(records, name).items()}
    det = Detector(case.config, ARDictionary.new_from_named_dict(case.dictionary), device="cpu")
    out = det.detect_batch(torch.from_numpy(frames))
    h, w = frames.shape[1:3]
    poses = pose.solve_normalized_batch(
        out["marker_corners"] / torch.tensor([float(w), float(h)]), golden.MARKER_MM)
    rep = golden.compare_batch(name, rec, frames, out, poses,
                               lambda: golden.port_fits(det, frames))
    assert rep.differences == [] and rep.compared == len(frames)
    if name == "preset/permissive-decode":  # a decode past tau is reported
        valid = out["marker_valid"].numpy()
        assert (out["marker_dist"].numpy()[valid] >= det.dictionary.tau).any()


def test_comparator_refuses_a_stale_config_frame(records):
    rec = golden.subset(records, "config1")
    frames = golden.config_frames("config1").copy()
    frames[0, 0, 0] ^= 1
    with pytest.raises(golden.StaleRecord):
        golden.compare_batch("config1", rec, frames, {}, None)
    with pytest.raises(golden.StaleRecord):
        golden.check_hashes("config4", golden.stacked(rec, 2)["hashes"],
                            golden.config_frames("config1"))
