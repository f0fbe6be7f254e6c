"""Multi-rank entry points of the port on the CPU: frame-batch sharding
(``parallel.sharding``) and row-sharded single frames
(``parallel.spatial``) at world size 2 over gloo, each rank a process
started with ``torch.multiprocessing``, held against the single-process
detector; the band threshold against the JAX package's; and the masks
route (``detector.detect_from_masks``, ``detector.detect_arrays``) against
``detect_batch_arrays``."""

import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig, pose, render
from aruco3_tpu_torch.detector import detect_arrays, detect_batch_arrays, detect_from_masks
from aruco3_tpu_torch.ops import frontend as kfrontend
from aruco3_tpu_torch.parallel import sharding, spatial
from torch_twin import make_scene, n, t

WORLD = 2
GROUP_TIMEOUT_S = 60  # a collective that hangs fails the ranks after this
JOIN_TIMEOUT_S = 240


def _rank_main(rank, world, store_path, out_prefix, job, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )
    try:
        torch.save(job(*args), f"{out_prefix}{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path, job, *args):
    """Run ``job(*args)`` on WORLD gloo ranks; returns each rank's result."""
    prefix = str(tmp_path / "rank")
    ctx = mp.spawn(
        _rank_main, args=(WORLD, str(tmp_path / "store"), prefix, job, args),
        nprocs=WORLD, join=False,
    )
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"ranks still running after {JOIN_TIMEOUT_S} s")
    return [torch.load(f"{prefix}{r}.pt") for r in range(WORLD)]


def _sharded_job(frames):
    det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict("ARUCO_DEFAULT"),
                   device="cpu")
    return sharding.detect_sharded(det, frames, with_pose=True)


def _spatial_job(frame):
    det = Detector(DetectorConfig(max_candidates=16),
                   ARDictionary.new_from_named_dict("ARUCO_DEFAULT"), device="cpu")
    return spatial.detect_spatial(det, frame)


def small_frames():
    return np.stack([make_scene(k, 160, 120, scale=0.5)[0]
                     for k in ("single", "multi", "dark", "nested")])


def test_sharded_matches_detect_batch(tmp_path):
    frames = small_frames()
    results = run_ranks(tmp_path, _sharded_job, torch.from_numpy(frames))
    det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict("ARUCO_DEFAULT"),
                   device="cpu")
    ref = det.detect_batch(frames)
    scale = torch.tensor([160.0, 120.0])
    rot, tr, err = pose.solve_normalized_batch(ref["marker_corners"] / scale, 40.0)
    ref.update(pose_rotations=rot, pose_translations=tr, pose_errors=err)
    valid = ref["marker_valid"]
    assert valid.sum() >= 4
    for got in results:  # every rank holds the whole batch
        assert set(got) == set(sharding.OUTPUT_KEYS + sharding.POSE_KEYS)
        for k in ("marker_valid", "marker_id", "marker_dist", "marker_code"):
            assert torch.equal(got[k], ref[k]), k
        for k in ("marker_corners",) + sharding.POSE_KEYS:
            assert torch.equal(got[k][valid], ref[k][valid]), k


def _shard_rows():
    rows = sharding.shard_frames(torch.arange(12).reshape(6, 2))
    try:
        sharding.shard_frames(torch.arange(10).reshape(5, 2))
    except ValueError:
        return rows, True
    return rows, False


def test_shard_frames_takes_this_ranks_rows(tmp_path):
    (rows0, raised0), (rows1, raised1) = run_ranks(tmp_path, _shard_rows)
    assert rows0.tolist() == [[0, 1], [2, 3], [4, 5]]
    assert rows1.tolist() == [[6, 7], [8, 9], [10, 11]]
    assert raised0 and raised1  # a batch of 5 does not divide by 2


def _marker_set(out):
    valid = n(out["marker_valid"])
    return sorted(int(i) for i, v in zip(n(out["marker_id"]), valid) if v)


@pytest.mark.parametrize("size, seed", [((320, 240), 21), ((320, 250), 5)])
def test_spatial_matches_single_device(tmp_path, size, seed):
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    rng = np.random.default_rng(seed)
    mid = int(rng.integers(0, len(d)))
    img, _, _ = render.random_marker_scene(d, mid, size, rng=rng)
    single = Detector(DetectorConfig(max_candidates=16), d, device="cpu").detect(img)
    single_ids = sorted(m.id for m in single.markers)
    assert mid in single_ids
    results = run_ranks(tmp_path, _spatial_job, torch.from_numpy(img))
    for out in results:
        assert _marker_set(out) == single_ids
        k = int(np.argmax(n(out["marker_valid"])))
        corners_single = np.array(single.markers[0].corners, float)
        corners_spatial = n(out["marker_corners"][k])
        assert np.abs(np.sort(corners_spatial.ravel())
                      - np.sort(corners_single.ravel())).max() <= 1.0
    assert torch.equal(results[0]["marker_corners"], results[1]["marker_corners"])


@pytest.mark.parametrize("world", [2, 4])
def test_threshold_open_tile_matches_jax(world):
    """Each band of a 64x80 frame, with the halos the exchange delivers,
    against the JAX ``_threshold_open_tile`` and the plain frontend's
    opened black mask."""
    import jax
    import jax.numpy as jnp

    from aruco3_tpu.parallel import spatial as jspatial

    rng = np.random.default_rng(3)
    h, w, window = 64, 80, 7
    grey = np.clip(rng.normal(128, 60, (h, w)), 0, 255).astype(np.uint8)
    grey[10:40, 20:50] //= 4
    halo = window + 4
    hs = h // world
    padded = np.concatenate([np.zeros((halo, w), np.uint8), grey, np.zeros((halo, w), np.uint8)])
    opened = n(kfrontend.plain(t(grey)[None], window, 2, 2, opened=True)[3][0])
    jtile = jax.jit(jspatial._threshold_open_tile, static_argnums=(2, 3, 4, 5, 6))
    for r in range(world):
        ext = padded[r * hs : r * hs + hs + 2 * halo]
        got = n(spatial._threshold_open_tile(t(ext), r * hs, h, w, window, 2, halo))
        ref = np.asarray(jtile(jnp.asarray(ext), r * hs, h, w, window, 2, halo))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, opened[r * hs : (r + 1) * hs])


def _masks_route_cases():
    return [(k, 320, 240, 1.0) for k in ("single", "multi", "dark", "nested")] + [
        ("multi", 160, 120, 0.5)]


def _markers(out, b):
    valid = n(out["marker_valid"][b])
    ids = n(out["marker_id"][b])
    corners = np.round(n(out["marker_corners"][b]))
    return sorted((int(ids[k]), tuple(corners[k].ravel())) for k in np.nonzero(valid)[0])


def test_detect_from_masks_matches_detect_batch():
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    det = Detector(DetectorConfig(), d, device="cpu")
    for w, h in ((320, 240), (160, 120)):
        scale = w / 320
        frames = torch.from_numpy(np.stack([make_scene(k, w, h, scale)[0]
                                            for k in ("single", "multi", "dark", "nested")]))
        params, min_edge, min_sep, ds = det.geometry(h, w)
        ref = detect_batch_arrays(frames, d, det.config, params, min_edge, min_sep, ds)
        coarse, _, _, black = kfrontend.plain(frames, det.config.threshold_window,
                                              params.open_radius, ds, opened=True)
        got = detect_from_masks(frames, black, coarse, d, det.config, params, min_edge,
                                min_sep, ds)
        for b, kind in enumerate(("single", "multi", "dark", "nested")):
            assert _markers(got, b) == _markers(ref, b), (w, kind)
            assert {m for m, _ in _markers(got, b)} == make_scene(kind)[1]


@pytest.mark.parametrize("kind, w, h, scale", _masks_route_cases())
def test_detect_arrays_matches_detect_batch(kind, w, h, scale):
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    det = Detector(DetectorConfig(), d, device="cpu")
    img, ids = make_scene(kind, w, h, scale)
    params, min_edge, min_sep, ds = det.geometry(h, w)
    ref = det.detect_batch(img[None])
    got = detect_arrays(torch.from_numpy(img), d, det.config, params, min_edge, min_sep, ds)
    assert got["marker_valid"].shape == ref["marker_valid"].shape[1:]
    assert _markers({k: v[None] for k, v in got.items() if torch.is_tensor(v)}, 0) == \
        _markers(ref, 0)
    assert {m for m, _ in _markers(ref, 0)} == ids
    assert int(got["stats"]["markers"]) == int(ref["stats"]["markers"][0])
