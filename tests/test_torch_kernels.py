"""The port's four CUDA kernels against their plain PyTorch versions.

The ``gpu`` tests need the card and skip elsewhere.  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

On the CPU each wrapper takes its plain version, which the twin tests
(tests/test_torch_*.py) hold against the JAX package.
"""

import numpy as np
import pytest
import torch

from aruco3_tpu_torch import Detector, DetectorConfig, dictionaries, rectify, segment
from aruco3_tpu_torch.ops import coarse_fit as k2
from aruco3_tpu_torch.ops import frontend as k1
from aruco3_tpu_torch.ops import refine as k3
from aruco3_tpu_torch.ops import warp_decode as k4
from torch_twin import cuda_device, make_scene, n, noisy_blocks, random_quads

P = segment.QuadParams()
S = 49


def test_wrappers_take_plain_version_on_cpu():
    """A CPU tensor runs the plain version and launches nothing."""
    for mod in (k1, k2, k3, k4):
        mod.launches = mod.plain_calls = 0
    img, _ = make_scene("dark")
    det = Detector(DetectorConfig(), dictionaries.ARDictionary.new_from_named_dict("ARUCO_DEFAULT"))
    det.detect(img)
    for mod in (k1, k2, k3, k4):
        assert (mod.launches, mod.plain_calls) == (0, 1), mod.__name__


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ds", [((240, 320), 2), ((250, 333), 10), ((1080, 1920), 10)])
def test_frontend_kernel_matches_plain(shape, ds):
    dev = cuda_device()
    rng = np.random.default_rng(1)
    grey = torch.from_numpy(noisy_blocks(rng, 2, *shape)).to(dev)
    got = k1.threshold_open_pool(grey, 7, 2, ds)
    ref = k1.plain(grey, 7, 2, ds)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,density,ds",
    [((40, 54), 0.35, 6), ((40, 54), 0.6, 6), ((108, 192), 0.3, 10), ((150, 200), 0.3, 4)],
)
def test_coarse_fit_kernel_matches_plain(shape, density, ds):
    """The last shape's planes exceed shared memory (global scratch path)."""
    dev = cuda_device()
    rng = np.random.default_rng(14)
    c = torch.from_numpy(rng.random((3,) + shape) < density).to(dev)
    g1, g2, gic = k2.coarse_fit(c, P, ds)
    r1, r2, ric = k2.plain(c, P, ds)
    assert torch.equal(gic, ric)
    for got, ref in ((g1, r1), (g2, r2)):
        for key in ("valid", "sizes", "qualifying", "roots"):
            assert torch.equal(got[key], ref[key].to(got[key].dtype)), key
        assert (got["centroids"] - ref["centroids"]).abs().max() <= 1e-3
        assert k2.quad_mismatches(got, ref) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind,ds", [("single", 2), ("dark", 2), ("nested", 2), ("single", 6)])
def test_refine_kernel_matches_plain(kind, ds):
    dev = cuda_device()
    img = torch.from_numpy(make_scene(kind)[0][None]).to(dev)
    coarse, near, _ = k1.threshold_open_pool(img, 7, 2, ds)
    f1, f2, ic = k2.coarse_fit(coarse, P, ds)
    cand = segment.merge_fits(f1, f2, P, ds)
    args = (img, near, cand["quads"].contiguous(), cand["centroids"], ic,
            cand["is_inner"].contiguous(), cand["valid"].contiguous(), ds,
            segment.refine_window_size(P, ds))
    assert torch.equal(k3.refine_corners(*args), k3.plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(240, 320), (1080, 1920)])
def test_warp_decode_kernel_matches_plain(shape):
    dev = cuda_device()
    rng = np.random.default_rng(21)
    h, w = shape
    grey = torch.from_numpy(noisy_blocks(rng, 2, h, w)).to(dev)
    quads = torch.from_numpy(
        np.stack([random_quads(rng, 24, 10, min(h, w) * 0.8, h, w) for _ in range(2)])
    ).to(dev)
    quads[0, 5] = quads[0, 5, [0, 0, 2, 3]]  # degenerate
    H, hv = rectify.homography_square_to_quad(quads, S)
    shapes = rectify.pyramid_level_shapes(h, w, rectify.num_levels(h, w))
    uppers = rectify.upper_levels(rectify.level1_plane(grey), shapes)
    lvl, tlx, tly = rectify.warp_windows(quads, shapes)
    valid = hv.clone()
    valid[1, :3] = False
    args = (grey, uppers, H.contiguous(), lvl, tlx, tly, valid, S, 8)
    gs, gl, gg = k4.warp_decode(*args)
    rs, rl, rg = k4.plain(*args)
    assert (gs - rs).abs().max() <= 1e-3
    assert torch.equal(gl, rl) and torch.equal(gg, rg)


@pytest.mark.gpu
def test_kernels_reject_bad_inputs():
    dev = cuda_device()
    grey = torch.zeros((1, 64, 64), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        k1.threshold_open_pool(grey, 7, 2, 2)
    with pytest.raises(ValueError):
        k2.coarse_fit(torch.zeros((1, 8, 8), dtype=torch.bool, device=dev),
                      segment.QuadParams(max_candidates=200), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["single", "multi", "dark", "nested", "rgb"])
def test_detect_on_card_matches_cpu(kind):
    dev = cuda_device()
    d = dictionaries.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    img, ids = make_scene(kind)
    got = Detector(DetectorConfig(), d, device=dev).detect(img)
    ref = Detector(DetectorConfig(), d).detect(img)
    assert ids <= {m.id for m in got.markers}
    assert sorted((m.id, m.code, tuple(m.corners)) for m in got.markers) == sorted(
        (m.id, m.code, tuple(m.corners)) for m in ref.markers
    )
    assert got.candidates == ref.candidates
    assert got.stats == ref.stats
    np.testing.assert_array_equal(np.stack(got.homographies), np.stack(ref.homographies))
    assert n(torch.as_tensor(got.grey)).shape == img.shape[:2]
