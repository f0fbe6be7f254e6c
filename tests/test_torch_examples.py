"""The port's examples (``examples/torch_*.py``) on the CPU, held against
the JAX package: the first three views of the pose-accuracy simulator
against ``Detector.detect`` + ``pose.solve_with_intrinsics`` of the JAX
package on the same rendered images (ids equal, poses within
``tests/test_pose.py``'s golden tolerances), ``torch_detect_image`` on a
synthesized 320x240 scene against the JAX detector's ids and corners, and
a short run of ``torch_stream_demo``.  Two JAX detector compiles (640x480
and 320x240)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_twin  # noqa: F401  (one torch thread a worker)

import aruco3_tpu as jax_pkg
from aruco3_tpu import pose as jpose
from aruco3_tpu_torch.utils.imageio import read_pgm

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
import torch_detect_image  # noqa: E402
import torch_pose_accuracy_sim as sim  # noqa: E402
import torch_stream_demo  # noqa: E402

VIEWS = 3
# tests/test_pose.py's golden tolerances (max abs): rotation, translation (mm).
ROT_TOL, TRANS_TOL = 1e-5, 1e-3


def test_pose_sim_matches_jax():
    got = sim.simulate(VIEWS, device="cpu")
    dictionary = jax_pkg.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    detector = jax_pkg.Detector(jax_pkg.DetectorConfig(), dictionary)
    intr = sim.camera()
    jintr = jax_pkg.CameraIntrinsics.new(intr.image_width, intr.image_height, intr.focal_x,
                                         intr.focal_y)
    views = sim.orbit_views(VIEWS, sim.ARDictionary.new_from_named_dict("ARUCO_DEFAULT"), intr)
    assert got["detected"] == VIEWS
    for view, (img, rot, trans) in zip(got["views"], views):
        det = detector.detect(img)
        assert view["ids"] == [m.id for m in det.markers]
        match = [m for m in det.markers if m.id == sim.MARKER_ID]
        best, _ = jpose.solve_with_intrinsics(match[0].corners, sim.MARKER_MM, jintr)
        assert np.abs(view["translation"] - np.asarray(best.translation)).max() < TRANS_TOL
        assert np.abs(view["normal"] - np.asarray(best.rotation)[:, 2]).max() < ROT_TOL
        # The rendered pose is recovered (the JAX example's error measures).
        assert view["t_err_mm"] < 15.0 and view["r_err_deg"] < 5.0
    lines = sim.report(got)
    assert lines[0] == f"views: {VIEWS}  detected: {VIEWS}"
    assert lines[1].startswith("translation error mm: mean=")
    assert lines[2].startswith("normal-axis error deg: mean=")


def test_detect_image_matches_jax(tmp_path):
    out = tmp_path / "detected.ppm"
    got = torch_detect_image.detect_image(device="cpu", size=(320, 240),
                                          rng=np.random.default_rng(11), out=str(out))
    mid, _ = got["truth"]
    img = got["detection"].grey
    dictionary = jax_pkg.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    ref = jax_pkg.Detector(jax_pkg.DetectorConfig(), dictionary).detect(img)
    summary = sorted((m.id, m.code, tuple(m.corners)) for m in got["detection"].markers)
    assert summary == sorted((m.id, m.code, tuple(m.corners)) for m in ref.markers)
    assert mid in {m.id for m in ref.markers}
    assert out.read_bytes().startswith(b"P6\n320 240\n255\n")
    lines = torch_detect_image.report(got)
    assert lines[0] == f"synthesized scene with marker id={mid}"
    assert not any(line.startswith("NOTE") for line in lines)


def test_detect_image_reads_a_pgm(tmp_path):
    """A PGM on the command line's path: the scene written and read back
    gives the same markers as the synthesized frame."""
    from aruco3_tpu_torch.utils.imageio import write_pgm

    first = torch_detect_image.detect_image(device="cpu", size=(320, 240),
                                            rng=np.random.default_rng(4),
                                            out=str(tmp_path / "a.ppm"))
    write_pgm(str(tmp_path / "scene.pgm"), first["detection"].grey)
    np.testing.assert_array_equal(read_pgm(str(tmp_path / "scene.pgm")), first["detection"].grey)
    again = torch_detect_image.detect_image(str(tmp_path / "scene.pgm"), device="cpu",
                                            out=str(tmp_path / "b.ppm"))
    assert again["truth"] is None
    assert [(m.id, m.corners) for m in again["detection"].markers] == \
        [(m.id, m.corners) for m in first["detection"].markers]


def test_stream_demo_runs_on_cpu():
    lines = []
    got = torch_stream_demo.run_demo(2.0, (160, 120), camera_index=1, device="cpu",
                                     log=lines.append)
    assert len(got["ticks"]) == len(lines) >= 1
    assert lines[0].startswith("streams alive=")
    mid, pts, translation = got["last"][0]
    assert mid == 23 and len(pts) == 4 and np.isfinite(translation).all()
    with pytest.raises(ValueError, match="no camera with index 7"):
        torch_stream_demo.select_sources(7)
    assert torch_stream_demo.list_cameras()[1] == "[1] synthetic-cam-1 (orbit marker 23)"


def test_examples_refuse_a_missing_card(monkeypatch):
    """Without ``--cpu`` an example needs the card: it never falls back to
    the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module, argv in ((torch_detect_image, []), (sim, ["2"]), (torch_stream_demo, ["1"])):
        monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
        with pytest.raises(SystemExit, match="run with --cpu"):
            module.main()
