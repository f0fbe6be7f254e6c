"""The IPPE pose kernel (``ops/ippe.py``, ``csrc/pose.cu``) against its
plain PyTorch version.

The ``gpu`` tests need the card and skip elsewhere; they compare the
kernel with the plain version on the same CUDA tensors, every lane and
output bit for bit, NaN where NaN.  This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_ippe.py
"""

import numpy as np
import pytest
import torch

from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig, pose, render
from aruco3_tpu_torch.ops import ippe
from aruco3_tpu_torch.runtime import graph
from torch_twin import cuda_device, make_scene


def _plain(pts, size):
    """``ippe.plain`` on any leading shape, its outputs reshaped back."""
    lead = pts.shape[:-2]
    if torch.is_tensor(size):
        size = torch.broadcast_to(size, lead).reshape(-1)
    rot, tr, err = ippe.plain(pts.reshape(-1, 4, 2), size)
    return rot.reshape(lead + (2, 3, 3)), tr.reshape(lead + (2, 3)), err.reshape(lead + (2,))


def _assert_same(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)


def _quads(rng, n, spread=0.4):
    """(n, 4, 2) float32 normalized squares, turned and skewed."""
    c = rng.uniform(-spread, spread, (n, 1, 2))
    r = rng.uniform(0.02, 0.2, (n, 1, 1))
    ang = rng.uniform(0, 2 * np.pi, (n, 1))[..., None]
    base = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], float)[None]
    rot = np.concatenate([np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang)], -1)
    quad = np.einsum("nij,nkj->nki", rot.reshape(n, 2, 2), base.repeat(n, 0)) * r + c
    quad += rng.normal(0, 0.01, quad.shape)
    return torch.from_numpy(quad.astype(np.float32))


def test_pose_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version (counted), and
    ``solve_normalized_batch`` returns what the unflattened solve gives:
    homography, canonical solve, lower error first."""
    rng = np.random.default_rng(11)
    pts = _quads(rng, 24).reshape(2, 12, 4, 2)
    ippe.count.reset()
    got = pose.solve_normalized_batch(pts, 40.0)
    assert (ippe.count.launches, ippe.count.plain_calls) == (0, 1)
    obj = torch.broadcast_to(pose.make_marker_square(40.0), (2, 12, 4, 3))
    h = pose.compute_homography_from_marker_square(40.0, pts)
    rot, tr, err = pose.solve_canonical_form(obj, pts, h)
    swap = err[..., 1] < err[..., 0]
    ref = (torch.where(swap[..., None, None, None], rot.flip(-3), rot),
           torch.where(swap[..., None, None], tr.flip(-2), tr),
           torch.where(swap[..., None], err.flip(-1), err))
    assert swap.any() and not swap.all()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _detector_corners(dev, dict_name, frames):
    """``detect_batch``'s marker corners over the frame size on the card,
    every lane (invalid ones as the detector leaves them)."""
    det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict(dict_name), device=dev)
    h, w = frames.shape[1:3]
    out = det.detect_batch(torch.from_numpy(frames).to(dev))
    assert bool(out["marker_valid"].any()) and not bool(out["marker_valid"].all())
    return out["marker_corners"] / torch.tensor([float(w), float(h)], device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["1080p", "vga"])
def test_pose_kernel_on_detector_corners(frame):
    dev = cuda_device()
    if frame == "1080p":
        d = ARDictionary.new_from_named_dict("ARUCO_MIP_36H12")
        frames = np.stack([render.bench_scene(d, seed=s)[0] for s in (0, 1)])
        norm = _detector_corners(dev, "ARUCO_MIP_36H12", frames)
    else:
        d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
        rng = np.random.default_rng(5)
        frames = np.stack([render.random_marker_scene(d, k, (640, 480), rng=rng)[0]
                           for k in (3, 9, 40)])
        norm = _detector_corners(dev, "ARUCO_DEFAULT", frames)
    ippe.count.reset()
    got = pose.solve_normalized_batch(norm, 40.0)
    assert (ippe.count.launches, ippe.count.plain_calls) == (1, 0)
    _assert_same(got, _plain(norm, 40.0))


@pytest.mark.gpu
@pytest.mark.parametrize("spread, size", [(0.4, 40.0), (3.0, 17.5), (0.05, 1e-3)])
def test_pose_kernel_on_random_quads(spread, size):
    dev = cuda_device()
    rng = np.random.default_rng(int(size * 1000) + 3)
    quads = _quads(rng, 4096, spread)
    wild = torch.from_numpy(rng.uniform(-2, 2, (1024, 4, 2)).astype(np.float32))
    pts = torch.cat([quads, wild]).to(dev)
    _assert_same(ippe.solve(pts, size), ippe.plain(pts, size))


@pytest.mark.gpu
def test_pose_kernel_on_degenerate_quads():
    """Near-collinear and collapsed quads (the homography's denominator
    under 1e-20), zeros, infinities and NaN."""
    dev = cuda_device()
    rng = np.random.default_rng(8)
    n = 512
    p0 = rng.uniform(-0.5, 0.5, (n, 1, 2))
    step = rng.uniform(-1e-3, 1e-3, (n, 1, 2))
    line = p0 + np.arange(4)[None, :, None] * step  # collinear up to rounding
    tiny = p0 + rng.uniform(-1, 1, (n, 4, 2)) * 1e-11
    same = np.broadcast_to(p0, (n, 4, 2))
    odd = np.zeros((6, 4, 2))
    odd[1, 2] = np.inf
    odd[2, 0, 1] = np.nan
    odd[3] = [[0.1, 0.1], [0.3, 0.1], [0.3, 0.3], [0.1, 0.3]]
    odd[4] = -odd[3]
    odd[5, :, 0] = 1e30
    pts = torch.from_numpy(np.concatenate([line, tiny, same, odd]).astype(np.float32)).to(dev)
    u, v = pts[..., 0], pts[..., 1]
    den = (u[:, 1] - u[:, 2]) * (v[:, 3] - v[:, 2]) - (u[:, 3] - u[:, 2]) * (v[:, 1] - v[:, 2])
    assert int((den.abs() < 1e-20).sum()) > n
    got = ippe.solve(pts, 40.0)
    _assert_same(got, ippe.plain(pts, 40.0))
    assert bool(torch.isnan(got[0]).any())


@pytest.mark.gpu
def test_pose_kernel_with_per_lane_sizes():
    dev = cuda_device()
    rng = np.random.default_rng(21)
    pts = _quads(rng, 3000).to(dev)
    sizes = torch.from_numpy(rng.uniform(1.0, 200.0, 3000).astype(np.float32)).to(dev)
    _assert_same(ippe.solve(pts, sizes), ippe.plain(pts, sizes))
    per_frame = torch.tensor([20.0, 40.0, 60.0], device=dev)[:, None]
    pts3 = pts[:3 * 1000].reshape(3, 1000, 4, 2)
    _assert_same(pose.solve_normalized_batch(pts3, per_frame), _plain(pts3, per_frame))


@pytest.mark.gpu
@pytest.mark.parametrize("lead", [(), (7,), (3, 44), (0,), (2, 0)])
def test_pose_kernel_leading_shapes(lead):
    dev = cuda_device()
    rng = np.random.default_rng(len(lead) + 2)
    n = int(np.prod(lead)) if lead else 1
    pts = _quads(rng, n).reshape(lead + (4, 2)).to(dev)
    got = pose.solve_normalized_batch(pts, 40.0)
    assert [g.shape for g in got] == [lead + (2, 3, 3), lead + (2, 3), lead + (2,)]
    _assert_same(got, _plain(pts, 40.0))


@pytest.mark.gpu
def test_pose_kernel_on_non_contiguous_points():
    dev = cuda_device()
    rng = np.random.default_rng(4)
    base = _quads(rng, 600).reshape(6, 100, 4, 2).to(dev)
    permuted = base.permute(2, 3, 1, 0).contiguous().permute(3, 2, 0, 1)
    for pts in (base[:, ::3], base.transpose(0, 1), permuted):
        assert not pts.is_contiguous()
        _assert_same(pose.solve_normalized_batch(pts, 40.0), _plain(pts.contiguous(), 40.0))
    best, alt = pose.solve_with_normalized_points(base[0, 0], 19.0)
    ref = _plain(base[0, 0], 19.0)
    _assert_same((best.rotation, alt.rotation, best.error), (ref[0][0], ref[0][1], ref[2][0]))


@pytest.mark.gpu
def test_pose_call_launches_one_kernel():
    """A call with a numeric size: the counter goes up by one and the card
    runs one kernel, the pose kernel, and nothing else; captured in a CUDA
    graph it is one kernel node."""
    from torch.profiler import ProfilerActivity, profile

    dev = cuda_device()
    pts = _quads(np.random.default_rng(1), 44).to(dev)
    pose.solve_normalized_batch(pts, 40.0)
    torch.cuda.synchronize()
    ippe.count.reset()
    for calls in (1, 2, 3):
        pose.solve_normalized_batch(pts, 40.0)
        assert ippe.count.launches == calls
    for _ in range(5):  # the profiler now and then drops device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                pose.solve_normalized_batch(pts, 40.0)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
                 for _ in range(e.count)]
        if len(names) >= 10:
            break
    assert len(names) == 10 and all("ippe_kernel" in name for name in names), names
    g = graph.Graph(lambda x: pose.solve_normalized_batch(x, 40.0), (44, 4, 2), torch.float32, dev)
    assert g.kernel_nodes == 1
    _assert_same(g(pts), pose.solve_normalized_batch(pts, 40.0))


@pytest.mark.gpu
def test_pose_kernel_refuses_bad_inputs():
    dev = cuda_device()
    pts = torch.zeros((5, 4, 2), device=dev)
    with pytest.raises(ValueError):
        ippe.solve(pts.double(), 40.0)
    with pytest.raises(ValueError):
        ippe.solve(pts.reshape(5, 8), 40.0)
    with pytest.raises(ValueError):
        ippe.solve(pts, torch.ones(4, device=dev))
    with pytest.raises(ValueError):
        ippe.solve(pts, torch.ones(5))
    with pytest.raises(ValueError):
        ippe.solve(pts[:, :3], 40.0)


@pytest.mark.gpu
def test_pose_kernel_on_scene_corners_at_320x240():
    """``make_scene``'s four kinds at 320x240 through the detector on the
    card, every lane posed by the kernel and by the plain version."""
    dev = cuda_device()
    frames = np.stack([make_scene(k)[0] for k in ("single", "multi", "dark", "nested")])
    norm = _detector_corners(dev, "ARUCO_DEFAULT", frames)
    _assert_same(pose.solve_normalized_batch(norm, 40.0), _plain(norm, 40.0))
