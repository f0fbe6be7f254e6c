"""The JAX records of ``tests/torch_golden/`` and their comparator
(``tools/torch_golden.py``) on the CPU: the stored records of the small
path and of the first three ``ARUCO_DEFAULT`` suite scenes come out again
from the JAX package (two JAX compiles: 4x120x160 with pose, 1x240x320,
and their Pallas-warp decodes in interpret mode: ``warp_eval`` for the
small path's tail route, the gather warp for the scenes' refine route),
the port's CPU path on those frames passes the comparator, the stored
hashes are those of the port's renders, the plain versions of kernels 1,
4 and 8 equal the JAX TPU kernels' record (``kernels.npz``) bit for bit,
the comparator accepts a fit-corner tie (counted), holds a lane to the
Pallas warp's decode where JAX's XLA warp decodes otherwise (counted),
and refuses a swapped id, a pose beyond tolerance, a missing lane, a fit
difference that is no tie, a wrong hash and a record without the Pallas
decode, and the smoke script and the comparator import no JAX."""

import numpy as np
import pytest
import torch
import torch_twin  # noqa: F401  (one torch thread a worker; tools/ on the path)
import torch_golden as golden
import torch_make_golden

from aruco3_tpu_torch import ARDictionary, Detector, pose

SCENES = 3
SUITE = "suite/ARUCO_DEFAULT"


@pytest.fixture(scope="module")
def small():
    frames = golden.path_frames(("small",))["small"][0]
    return frames, golden.subset(golden.load("paths"), "small")


@pytest.fixture(scope="module")
def scenes():
    images = [img for _, img, _ in golden.scene_images(SUITE, SCENES)]
    return images, golden.head(golden.subset(golden.load("scenes"), SUITE), SCENES)


def port_small(frames):
    name, cfg = golden.path_specs()["small"]
    det = Detector(cfg, ARDictionary.new_from_named_dict(name), device="cpu")
    out = det.detect_batch(torch.from_numpy(frames))
    h, w = frames.shape[1:]
    poses = pose.solve_normalized_batch(
        out["marker_corners"] / torch.tensor([float(w), float(h)]), golden.MARKER_MM)
    return det, out, poses


def test_small_record_regenerates_from_jax(small):
    frames, rec = small
    assert torch_make_golden.same(torch_make_golden.path_record("small", frames), rec) == []


def test_scene_records_regenerate_from_jax(scenes):
    _, rec = scenes
    assert torch_make_golden.same(torch_make_golden.scene_record(SUITE, SCENES), rec) == []


def test_port_small_path_matches_records(small):
    frames, rec = small
    det, out, poses = port_small(frames)
    rep = golden.compare_batch("small", rec, frames, out, poses,
                               lambda: golden.port_fits(det, frames))
    assert rep.differences == [] and rep.ties == []
    assert rep.compared == rep.equal == len(frames) and rep.lanes == len(frames)


def test_port_scenes_match_records(scenes):
    images, rec = scenes
    det = Detector(golden.path_specs()["small"][1], ARDictionary.new_from_named_dict("ARUCO_DEFAULT"),
                   device="cpu")
    outs = [det.detect_batch(torch.from_numpy(img)[None]) for img in images]
    rep = golden.compare_scenes(SUITE, rec, images, outs,
                                lambda k: golden.port_fits(det, images[k][None]))
    assert rep.differences == [] and rep.compared == rep.equal == SCENES and rep.lanes > 0


@pytest.mark.parametrize("which", ["small", "scenes"])
def test_stored_hashes_are_the_port_renders(which, small, scenes):
    frames, rec = small if which == "small" else scenes
    assert list(rec["hashes"]) == [golden.frame_hash(f) for f in frames]
    golden.check_hashes(which, rec["hashes"], frames)


def test_plain_versions_match_kernel_records():
    """What phase 3 of ``chip_smoke.py`` holds the kernels to, on the CPU:
    kernel 1's refine-mode level 1 and the chain's level 2, kernel 4's
    samples and cell grids at pyramid levels 0-3 (through the recorded
    homographies; grids at marks 6, 7, 8 and 10, samples and grids at S =
    49 and 64) and kernel 8's samples equal the JAX TPU kernels' outputs on
    the probes bit for bit."""
    rec = golden.load("kernels")
    got = golden.port_kernel_outputs("cpu")
    assert sorted(set(got["levels"].ravel().tolist())) == [0, 1, 2, 3]
    keys = sorted(k for k in rec if k not in ("hashes", "H", "H_s64"))
    assert {golden.probe_grid_key(m) for m in golden.PROBE_MARKS} <= set(keys)
    assert {"warp_samples_s64", "warp_grids_s64"} <= set(keys)
    for key in keys:
        np.testing.assert_array_equal(got[key], rec[key], err_msg=key)


# ---- the comparator on a made-up frame: 2 lanes, lane 0 a marker.
SQUARE = np.array([[10.0, 10.0], [30.0, 10.0], [30.0, 30.0], [10.0, 30.0]], np.float32)
FRAME = np.zeros((1, 8, 8), np.uint8)


def made_up():
    """(record, port outputs, poses) of one frame in which both agree."""
    quads = np.stack([SQUARE, SQUARE + 40])[None]
    out = {"quads": quads, "quad_valid": np.array([[True, True]]),
           "marker_valid": np.array([[True, False]]), "marker_id": np.array([[7, 0]]),
           "marker_dist": np.array([[0, 0]]), "marker_code": np.array([[[5, 1], [0, 0]]]),
           "marker_rot": np.array([[1, 0]]), "marker_corners": quads.copy(),
           "stats": {"markers": np.array([1])}}
    poses = (np.tile(np.eye(3, dtype=np.float32), (1, 2, 2, 1, 1)),
             np.tile(np.array([1.0, 2.0, 300.0], np.float32), (1, 2, 2, 1)),
             np.zeros((1, 2, 2), np.float32))
    rec = golden.batch_record(out, poses)
    # The Pallas warp's decode, here equal to the XLA warp's.
    rec.update({f"pallas/{k}": v.copy() for k, v in rec.items() if k not in ("quads", "quad_valid")})
    rec["hashes"] = np.array([golden.frame_hash(FRAME[0])])
    rec["fit_quads"] = quads.copy()
    rec["fit_centroids"] = np.array([[[20.0, 20.0], [60.0, 60.0]]], np.float32)
    rec["fit_sizes"] = np.array([[9, 9]])
    return rec, out, poses


def port_fit(quads):
    return lambda: quads


def test_comparator_accepts_equal_outputs():
    rec, out, poses = made_up()
    rep = golden.compare_batch("made-up", rec, FRAME, out, poses, port_fit(rec["fit_quads"]))
    assert rep.counts()["equal"] == 1 and rep.differences == [] and rep.ties == []


def test_comparator_accepts_and_counts_a_tie():
    rec, out, poses = made_up()
    # Corner A at another extreme point as far from the centroid: the
    # other corners follow it, and the refined corners differ.
    tie = np.roll(SQUARE, 1, axis=0)
    fits = rec["fit_quads"].copy()
    fits[0, 0] = tie
    out["marker_corners"] = out["marker_corners"].copy()
    out["marker_corners"][0, 0] = tie
    rep = golden.compare_batch("made-up", rec, FRAME, out, poses, port_fit(fits))
    assert rep.differences == []
    assert rep.ties == [(0, 0, ["marker_corners"])] and rep.counts()["ties_accepted"] == 1


def refused(case):
    rec, out, poses = made_up()
    fits = rec["fit_quads"]
    if case == "swapped id":
        out["marker_id"] = np.array([[8, 0]])
    elif case == "pose":
        poses = (poses[0], poses[1] + np.float32(2 * golden.POSE_TRANS_TOL), poses[2])
    elif case == "missing lane":
        out["marker_valid"] = np.array([[False, False]])
    elif case == "no tie":
        fits = fits.copy()
        fits[0, 0, 0] += 3.0  # corner A nearer the centroid: not a tie
        out["marker_corners"] = out["marker_corners"] + 1
    return golden.compare_batch("made-up", rec, FRAME, out, poses, port_fit(fits))


@pytest.mark.parametrize("case,field", [("swapped id", "marker_id"),
                                        ("pose", "pose_translations"),
                                        ("missing lane", "marker_valid"),
                                        ("no tie", "fit_quads")])
def test_comparator_refuses(case, field):
    rep = refused(case)
    assert rep.ties == [] and rep.equal == 0
    assert field in {d.field for d in rep.differences}
    assert all(d.where == "made-up" and d.item == 0 for d in rep.differences)


@pytest.mark.parametrize("port_id,held", [(8, True), (7, False)])
def test_comparator_holds_the_pallas_decode(port_id, held):
    """Where JAX's XLA warp (id 7) and the Pallas warp of the route (id 8)
    decode a lane differently, the port is held to the Pallas warp's, and
    the lane is counted either way."""
    rec, out, poses = made_up()
    rec["pallas/marker_id"] = np.array([[8, 0]])
    out["marker_id"] = np.array([[port_id, 0]])
    rep = golden.compare_batch("made-up", rec, FRAME, out, poses, port_fit(rec["fit_quads"]))
    assert rep.warp_split == [(0, 0)] and rep.counts()["xla_warp_lanes_apart"] == 1
    assert (rep.differences == []) == held
    assert held or {d.field for d in rep.differences} == {"marker_id"}


def test_comparator_refuses_a_record_without_pallas_decode():
    rec, out, poses = made_up()
    rec = {k: v for k, v in rec.items() if not k.startswith("pallas/")}
    with pytest.raises(golden.StaleRecord):
        golden.compare_batch("made-up", rec, FRAME, out, poses)


def test_comparator_refuses_a_wrong_hash():
    rec, out, poses = made_up()
    with pytest.raises(golden.StaleRecord):
        golden.compare_batch("made-up", rec, FRAME + 1, out, poses)
    with pytest.raises(golden.StaleRecord):
        golden.subset(rec, "no such path")


def test_smoke_and_comparator_import_no_jax():
    """``chip_smoke.py``, the comparator and the parity report import
    nothing of JAX or of the JAX package, and read none of its files, while
    the comparator holds the port's CPU path to the small path's record."""
    import os
    import subprocess
    import sys

    code = (
        "import os, sys\n"
        "opened = []\n"
        "sys.addaudithook(lambda ev, args: opened.append(str(args[0])) "
        "if ev == 'open' and isinstance(args[0], (str, bytes, os.PathLike)) else None)\n"
        "sys.path.insert(0, 'tools')\n"
        "import chip_smoke, torch_golden as golden, torch_parity_report\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from aruco3_tpu_torch import ARDictionary, Detector\n"
        "frames = golden.path_frames(('small',))['small'][0]\n"
        "name, cfg = golden.path_specs()['small']\n"
        "det = Detector(cfg, ARDictionary.new_from_named_dict(name), device='cpu')\n"
        "rep = golden.compare_batch('small', golden.subset(golden.load('paths'), 'small'), frames,\n"
        "                           det.detect_batch(torch.from_numpy(frames)))\n"
        "assert rep.equal == 4 and not rep.differences\n"
        "jax_dir = os.path.join(os.getcwd(), 'aruco3_tpu') + os.sep\n"
        "assert not [p for p in opened if os.path.abspath(p).startswith(jax_dir)]\n"
        "assert 'jax' not in sys.modules and 'aruco3_tpu' not in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=golden.ROOT, env=env,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
