"""The port's CUDA kernels against their plain PyTorch versions.

The ``gpu`` tests need the card and skip elsewhere.  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

On the CPU each wrapper takes its plain version, which the twin tests
(tests/test_torch_*.py) hold against the JAX package.
"""

import math

import numpy as np
import pytest
import torch

from aruco3_tpu_torch import Detector, DetectorConfig, dictionaries, frontend, rectify, segment
from aruco3_tpu_torch.ops import _build
from aruco3_tpu_torch.ops import coarse_fit as k2
from aruco3_tpu_torch.ops import fit as kfit
from aruco3_tpu_torch.ops import frontend as k1
from aruco3_tpu_torch.ops import refine as k3
from aruco3_tpu_torch.ops import warp_decode as k4
from aruco3_tpu_torch.ops import warp_eval as k8
from torch_twin import (
    coarse_layout_model, coarse_masks, cuda_device, make_scene, n, noisy_blocks, random_quads,
)

P = segment.QuadParams()
S = 49
COUNTS = {
    "frontend": k1.count,
    "coarse_fit": k2.count,
    "coarse_labels": k2.labels_count,
    "rank_roots": kfit.rank_count,
    "fit_lanes": kfit.lanes_count,
    "fused_fit": kfit.fused_count,
    "refine": k3.count,
    "warp_decode": k4.count,
    "warp_eval": k8.count,
}


def _detect_counts(img, cfg=DetectorConfig()):
    """Detect ``img`` on the CPU; (launches, plain calls) of every wrapper."""
    for c in COUNTS.values():
        c.reset()
    d = dictionaries.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    Detector(cfg, d, device="cpu").detect(img)
    return {name: (c.launches, c.plain_calls) for name, c in COUNTS.items()}


def test_wrappers_take_plain_version_on_cpu():
    """A CPU tensor runs the plain version and launches nothing."""
    got = _detect_counts(make_scene("dark")[0])
    ran = {"frontend", "coarse_fit", "refine", "warp_decode"}
    assert got == {name: (0, int(name in ran)) for name in COUNTS}


def test_label_route_takes_plain_versions_on_cpu():
    """A portrait grid outside the fused envelope takes the label route:
    labels mode, then kernel 7's plain version; above 128 lanes kernels 5
    and 6 once per plane."""
    img = np.ascontiguousarray(np.rot90(make_scene("dark")[0]))
    got = _detect_counts(img, DetectorConfig(coarse_factor=2))
    ran = {"frontend", "coarse_labels", "fused_fit", "refine", "warp_decode"}
    assert got == {name: (0, int(name in ran)) for name in COUNTS}
    got = _detect_counts(make_scene("dark")[0], DetectorConfig(max_candidates=160))
    ran = {"frontend": 1, "coarse_labels": 1, "rank_roots": 2, "fit_lanes": 2,
           "refine": 1, "warp_decode": 1}
    assert got == {name: (0, ran.get(name, 0)) for name in COUNTS}


def _grey_batch(rng, b, h, w, dev):
    """b grey frames: up to four of ``noisy_blocks``, the rest those turned
    by a few rows and columns each."""
    base = torch.from_numpy(noisy_blocks(rng, min(b, 4), h, w)).to(dev)
    extra = [torch.roll(base[i % len(base)], (7 * i, 13 * i), (0, 1)) for i in range(len(base), b)]
    return torch.cat([base, torch.stack(extra)]) if extra else base


def _walks(b, h, w, window, open_radius, ds):
    run, chunk, _ = k1.plan(b, h, w, window, open_radius, ds)
    return run > chunk


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ds,window,open_radius,b", [
    ((240, 320), 2, 7, 2, 2), ((250, 333), 10, 7, 2, 2), ((1080, 1920), 10, 7, 2, 2),
    ((120, 160), 1, 7, 2, 2), ((1920, 1080), 10, 7, 2, 2), ((2160, 3840), 20, 7, 2, 2),
    ((97, 203), 3, 7, 2, 2), ((40, 50), 2, 7, 2, 2),
    ((250, 333), 10, 3, 2, 2), ((250, 333), 10, 15, 2, 2), ((250, 333), 10, 88, 2, 2),
    ((250, 333), 10, 130, 2, 2),
    ((250, 333), 10, 7, 0, 2), ((250, 333), 10, 7, 1, 2), ((250, 333), 10, 7, 7, 2),
    ((250, 333), 10, 7, 14, 2), ((250, 333), 10, 140, 2, 2),
    # batches whose blocks walk their strips
    ((480, 640), 4, 7, 2, 64), ((2160, 3840), 10, 7, 2, 16), ((250, 333), 10, 130, 2, 4),
    ((250, 333), 10, 7, 14, 128), ((250, 333), 10, 140, 2, 4),
])
def test_frontend_kernel_matches_plain(shape, ds, window, open_radius, b):
    """Frames from 40x50 (level 1 padded past the image) to 4K, widths that
    are no multiple of 16 or of ds, windows whose column sums need 32 bits
    (130) and whose strips are wider than the block (140: two grey columns
    a thread), open radii 0 to 14; the optional opened mask against
    ``segment.open_mask``; batches whose blocks walk (the VGA and dense 4K
    cells' shapes, windows 130 and 140, open radius 14)."""
    dev = cuda_device()
    rng = np.random.default_rng(1)
    grey = _grey_batch(rng, b, *shape, dev)
    assert _walks(b, *shape, window, open_radius, ds) == (b > 2)
    got = k1.threshold_open_pool(grey, window, open_radius, ds, opened=True)
    ref = k1.plain(grey, window, open_radius, ds)
    ref += (segment.open_mask(~frontend.adaptive_threshold(grey, window), open_radius),)
    for a, b in zip(got, ref, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(k1.threshold_open_pool(grey, window, open_radius, ds), got))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ds,b", [((240, 320), 2, 2), ((1080, 1920), 10, 2), ((120, 160), 1, 2),
                                        ((97, 203), 3, 2), ((40, 50), 2, 2), ((2160, 3840), 20, 2),
                                        ((1080, 1920), 10, 128)])
def test_frontend_kernel_chain_level1_matches_plain(shape, ds, b):
    """The refine route's mode: level 1 in bfloat16 by the chain
    (``rectify.level1_plane(chain=True)``) bit for bit, level 1 padded past
    the image at 40x50, the other outputs those of the exact mode; at the
    1080p batch cell's 128 frames, whose blocks walk."""
    dev = cuda_device()
    rng = np.random.default_rng(2)
    grey = _grey_batch(rng, b, *shape, dev)
    assert _walks(b, *shape, 7, 2, ds) == (b > 2)
    got = k1.threshold_open_pool(grey, 7, 2, ds, chain=True)
    ref = k1.plain(grey, 7, 2, ds, chain=True)
    assert got[2].dtype == torch.bfloat16
    for a, b in zip(got, ref, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    exact = k1.threshold_open_pool(grey, 7, 2, ds)
    assert torch.equal(got[0], exact[0]) and torch.equal(got[1], exact[1])


# The grid of a frame alone before the strips walked (tiles of 110 x 240
# at 1080x1920, 120 x 220 portrait, ...): at one frame a launch takes no
# fewer blocks.
FRAME_ALONE_BLOCKS = {((1080, 1920), 7, 2): 80, ((1920, 1080), 7, 2): 80,
                      ((2160, 3840), 7, 2): 352, ((120, 160), 7, 2): 1, ((97, 203), 7, 2): 1,
                      ((40, 50), 7, 2): 1, ((250, 333), 130, 2): 850, ((250, 333), 7, 7): 6,
                      ((333, 250), 7, 14): 24, ((250, 333), 140, 2): 136}


@pytest.mark.parametrize("b", [1, 16, 64, 128])
@pytest.mark.parametrize("shape,window,open_radius,ds", [
    ((1080, 1920), 7, 2, 10), ((1920, 1080), 7, 2, 10), ((2160, 3840), 7, 2, 20),
    ((120, 160), 7, 2, 1), ((97, 203), 7, 2, 3), ((40, 50), 7, 2, 2),
    ((250, 333), 130, 2, 10), ((250, 333), 7, 7, 10), ((333, 250), 7, 14, 7),
    ((250, 333), 140, 2, 10),
])
def test_frontend_plan_covers_each_output_once(shape, window, open_radius, ds, b):
    """Over every block's walk the chunks of ``plan`` write every pixel,
    coarse cell and level-1 cell exactly once, each coarse and level-1 cell
    inside one chunk of one block, and fit in shared memory, two blocks an
    SM where a walk runs at r = 7, open radius 2; a walk gives at least a
    wave of resident blocks, and a frame alone one chunk a block on a grid
    no smaller than before the walk."""
    h, w = shape
    run, chunk, tw = k1.plan(b, h, w, window, open_radius, ds)
    assert run % chunk == chunk % ds == tw % ds == chunk % 2 == tw % 2 == 0
    smem = k1.smem_bytes(chunk, tw, window, open_radius, run > chunk)
    assert smem <= k1.SMEM_MAX
    blocks = math.prod(k1.grid(b, h, w, ds, run, tw))
    if run > chunk and (window, open_radius) == (7, 2):
        assert smem <= k1.smem_per_block(2) and blocks >= 2 * k1.SMS
    if b == 1:
        assert run == chunk and blocks >= FRAME_ALONE_BLOCKS[shape, window, open_radius]
    (hc, wc), (h1, w1) = k1._shapes(h, w, ds)
    hits = [np.zeros(s, np.int32) for s in ((h, w), (hc, wc), (h1, w1))]
    walked = {}
    for (by, bx), k, ranges in k1.tiles(h, w, ds, run, chunk, tw):
        assert walked.setdefault((by, bx), -1) == k - 1  # chunks in order down the run
        walked[by, bx] = k
        (ya, yb), (xa, xb) = ranges[0]
        y0, x0 = by * run + k * chunk, bx * tw
        assert ya == y0 and xa == x0 and y0 + chunk <= (by + 1) * run
        for plane, ((a0, a1), (c0, c1)) in zip(hits, ranges):
            plane[a0:a1, c0:c1] += 1
        for ((a0, a1), (c0, c1)), f in zip(ranges[1:], (ds, 2)):
            # each cell's rows and columns lie inside the chunk's
            assert a0 * f >= y0 and a1 * f <= y0 + chunk and c0 * f >= x0 and c1 * f <= x0 + tw
    assert len(walked) * b == blocks
    for plane in hits:
        assert (plane == 1).all()


@pytest.mark.parametrize("b,h,w,window,open_radius,ds", [
    (1, 1080, 1920, 400, 2, 10), (1, 1080, 1920, 7, 2, 0),
    (1, 1080, 1920, 7, k1.MAX_OPEN_RADIUS + 1, 10), (0, 1080, 1920, 7, 2, 10),
])
def test_frontend_plan_refuses_what_does_not_fit(b, h, w, window, open_radius, ds):
    with pytest.raises(ValueError):
        k1.plan(b, h, w, window, open_radius, ds)


@pytest.mark.parametrize("b", [1, 128])
@pytest.mark.parametrize("shape,open_radius,ds", [
    ((1080, 1920), 2, 10), ((480, 640), 2, 4), ((97, 203), 2, 3), ((250, 333), 0, 2),
    ((333, 250), 14, 7),
])
def test_frontend_plan_gives_what_the_launch_takes(shape, open_radius, ds, b):
    """For every window up to 260 ``plan`` either refuses or gives a
    layout that ``a3_frontend`` launches: at most two grey columns a
    thread, mask rows in 9 words, one morphology window a warp, the shared
    memory within a block's; windows up to 137 plan at open radius 2, up
    to 197 at 1080p, with strips past the block's width among them."""
    eb = 2 * open_radius + 2
    window_rows = (32 if eb <= 10 else 64) - 2 * eb
    planned = []
    for window in range(261):
        try:
            run, chunk, tw = k1.plan(b, *shape, window, open_radius, ds)
        except ValueError:
            continue
        planned.append(window)
        gc = tw + 2 * (window + eb)
        assert gc <= 2 * k1.BLOCK and -(-(tw + 2 * eb) // 32) <= 9
        assert -(-chunk // window_rows) <= k1.WARPS and run % chunk == 0
        assert k1.smem_bytes(chunk, tw, window, open_radius, run > chunk) <= k1.SMEM_MAX
    assert planned == list(range(len(planned)))  # the windows that plan are 0 up to one
    if open_radius == 2:
        assert planned[-1] >= (197 if shape == (1080, 1920) else 137)


# (shape, kind, density, batch): widths at, above and between multiples
# of 32, the five paths' grids, a serpentine, all-ones and all-zeros
# planes, blob lattices (more roots than the pool, equal sizes across the
# top-k boundary), batches of 5 and of 300 (more frames than SMs: smaller
# blocks), and grids of 65,536 cells or more: in labels mode on clusters
# (256x330; the dense 4K grid 216x384 at batches 1 and 16, its serpentine
# and blobs, whose runs cross every band edge; 217x385, whose rows do not
# divide by the cluster), in fit mode in device scratch, and the 1080x1920
# grid of a 1080p frame at coarse_factor 1 in device scratch in both.
CARD_CASES = [
    ((40, 54), "random", 0.35, 3), ((40, 54), "random", 0.6, 3),
    ((108, 192), "random", 0.3, 3), ((150, 200), "random", 0.3, 3),
    ((120, 160), "random", 0.3, 3), ((192, 108), "random", 0.35, 2),
    ((37, 33), "random", 0.35, 3), ((45, 65), "random", 0.35, 3), ((60, 203), "random", 0.35, 2),
    ((108, 192), "serpentine", 0, 2), ((40, 54), "ones", 0, 2), ((40, 54), "zeros", 0, 2),
    ((108, 192), "blobs", 0, 2), ((40, 54), "random", 0.35, 5), ((40, 54), "random", 0.35, 300),
    ((256, 330), "random", 0.3, 2), ((1080, 1920), "random", 0.3, 1),
    ((216, 384), "random", 0.3, 1), ((216, 384), "random", 0.3, 16),
    ((216, 384), "serpentine", 0, 2), ((216, 384), "blobs", 0, 2), ((217, 385), "random", 0.3, 2),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind,density,b", CARD_CASES)
def test_coarse_fit_kernel_matches_plain(shape, kind, density, b):
    dev = cuda_device()
    c = coarse_masks(kind, b, shape, density).to(dev)
    ds = 10 if shape[0] >= 100 else 4
    g1, g2, gic = k2.coarse_fit(c, P, ds)
    r1, r2, ric = k2.plain(c, P, ds)
    assert torch.equal(gic, ric)
    for got, ref in ((g1, r1), (g2, r2)):
        _assert_fit_equal(got, ref)


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
    uppers = rectify.upper_levels(k1.threshold_open_pool(grey, 7, 2, 2, chain=True)[2], shapes)
    assert all(u.dtype == torch.bfloat16 for u in uppers)
    lvl, tlx, tly = rectify.warp_windows(quads, shapes)
    valid = hv.clone()
    valid[1, :3] = False
    args = (grey, uppers, H.contiguous(), lvl, tlx, tly, valid, S, 8)
    gs, gl, gg = k4.warp_decode(*args)
    rs, rl, rg = k4.plain(*args)
    assert torch.equal(gs, rs)
    assert torch.equal(gl, rl) and torch.equal(gg, rg)


def _refine_case(rng, b, k, h, w, ds, dev, all_invalid=False):
    """Kernel 3's inputs: corners anywhere in the frame, on and past each
    border; lane 0 with exact score ties (corner 0 straight above or below
    its centroid, corner 1 level with it); inner lanes on a random
    footprint; some invalid lanes (all, with ``all_invalid``)."""
    grey = torch.from_numpy(noisy_blocks(rng, b, max(h, 9), max(w, 9))[:, :h, :w].copy())
    near = torch.from_numpy(rng.random((b, h, w)) < 0.6)
    q = np.stack([rng.uniform(-4, w + 3, (b, k, 4)), rng.uniform(-4, h + 3, (b, k, 4))], -1)
    edge = rng.random((b, k, 4)) < 0.3
    q[..., 0] = np.where(edge, rng.choice([0.0, 1.0, w - 2.0, w - 1.0, -0.5, w - 0.5], (b, k, 4)),
                         q[..., 0])
    q[..., 1] = np.where(rng.random((b, k, 4)) < 0.3,
                         rng.choice([0.0, 1.0, h - 2.0, h - 1.0, -0.5, h - 0.5], (b, k, 4)),
                         q[..., 1])
    cen = np.stack([rng.uniform(0, w, (b, k)), rng.uniform(0, h, (b, k))], -1)
    cen[:, 0, 0] = q[:, 0, 0, 0]
    cen[:, 0, 1] = q[:, 0, 1, 1]
    hc, wc = -(-h // ds), -(-w // ds)
    valid = np.zeros((b, k), bool) if all_invalid else rng.random((b, k)) < 0.8
    args = (grey, near, torch.from_numpy(q.astype(np.float32)),
            torch.from_numpy(cen.astype(np.float32)),
            torch.from_numpy(rng.random((b, hc, wc)) < 0.7),
            torch.from_numpy(rng.random((b, k)) < 0.4), torch.from_numpy(valid))
    return tuple(a.to(dev) for a in args)


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,ds,wn,b,k,all_invalid", [
    (240, 320, 20, 48, 2, 13, False),  # dense's ds and window
    (240, 320, 10, 64, 2, 13, False),  # the largest window
    (240, 320, 10, 28, 3, 7, False),  # landscape's window
    (97, 203, 2, 12, 2, 9, False),
    (120, 160, 7, 33, 2, 5, False),  # two rows a thread, three chunks a row
    (40, 30, 20, 48, 2, 5, False),  # a frame smaller than the window
    (30, 200, 10, 48, 2, 5, False),  # fewer rows than the window
    (200, 40, 20, 50, 2, 5, False),  # fewer columns than the window
    (240, 320, 20, 48, 2, 13, True),  # every lane invalid
    (240, 320, 10, 28, 300, 7, False),  # more windows than the grid's warps
    (240, 320, 20, 100, 2, 13, False),  # wider than 64: two strips
    (240, 320, 40, 130, 2, 9, False),  # three strips, a clamp box across two
    (90, 70, 10, 65, 2, 5, False),  # wider than 64, the frame smaller
])
def test_refine_kernel_windows_match_plain(h, w, ds, wn, b, k, all_invalid):
    """Kernel 3 against its plain version on synthetic corners, each of its
    window shapes (1 or 2 rows a thread, 2 to 5 chunks a row, strips of 64
    columns above 64), windows
    clipped at every border, frames smaller than the window, exact score
    ties and lanes with no valid corner."""
    dev = cuda_device()
    args = _refine_case(np.random.default_rng(h * w + wn), b, k, h, w, ds, dev, all_invalid)
    got = k3.refine_corners(*args, ds, wn)
    ref = k3.plain(*args, ds, wn)
    assert torch.equal(got, ref)
    if all_invalid:
        assert torch.equal(got, args[2])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dark", "nested"])
def test_refine_kernel_without_inner_lanes(kind):
    """``max_inner_candidates=0``: no inner lanes, an empty footprint."""
    dev = cuda_device()
    params = segment.QuadParams(max_inner_candidates=0)
    img = torch.from_numpy(make_scene(kind)[0][None]).to(dev)
    coarse, near, _ = k1.threshold_open_pool(img, 7, 2, 2)
    f1, f2, ic = k2.coarse_fit(coarse, params, 2)
    cand = segment.merge_fits(f1, f2, params, 2)
    assert not bool(cand["is_inner"].any())
    args = (img, near, cand["quads"].contiguous(), cand["centroids"], ic,
            cand["is_inner"].contiguous(), cand["valid"].contiguous(), 2,
            segment.refine_window_size(params, 2))
    assert torch.equal(k3.refine_corners(*args), k3.plain(*args))


def _warp_case(rng, h, w, b, k, dev, s=S):
    """Kernel 4's inputs on (h, w) frames: quads of sizes that take pyramid
    levels 0, 1 and 2 or more; in frame 0, lane 1 a degenerate homography
    (a repeated corner), lane 2 a homography whose w is 0 everywhere
    (constant zero samples: every Otsu score -1), lane 3 the identity onto
    a two-valued checkerboard (samples 0 and 255 only)."""
    grey = noisy_blocks(rng, b, h, w)
    grey[0, 8:72, 8:72] = np.where((np.add.outer(np.arange(64) // 5, np.arange(64) // 7)) % 2, 255, 0)
    grey = torch.from_numpy(grey).to(dev)
    sizes = [(10, 40), (70, 110), (130, min(h, w) * 0.8)]
    quads = torch.from_numpy(np.stack([
        np.concatenate([random_quads(rng, -(-k // 3), lo, hi, h, w) for lo, hi in sizes])[:k]
        for _ in range(b)])).to(dev)
    quads[0, 1] = quads[0, 1, [0, 0, 2, 3]]
    H, hv = rectify.homography_square_to_quad(quads, s)
    shapes = rectify.pyramid_level_shapes(h, w, rectify.num_levels(h, w))
    uppers = rectify.upper_levels(rectify.level1_plane(grey, chain=True), shapes)
    lvl, tlx, tly = rectify.warp_windows(quads, shapes)
    H[0, 2] = torch.tensor([[1.0, 0, 0], [0, 1, 0], [0, 0, 0]])
    H[0, 3] = torch.tensor([[1.0, 0, 12], [0, 1, 10], [0, 0, 1]])
    lvl[0, 2:4] = 0
    tlx[0, 3] = tly[0, 3] = 8
    valid = hv.clone()
    valid[0, 2:4] = True
    valid[-1, -3:] = False
    return grey, uppers, H.contiguous(), lvl, tlx, tly, valid


@pytest.mark.gpu
@pytest.mark.parametrize("m,s", [(6, S), (7, S), (8, S), (10, S), (8, 64), (6, 128), (40, 96),
                                 (8, 240)])
@pytest.mark.parametrize("shape,b,k", [((480, 640), 2, 13), ((1080, 1920), 1, 31)])
def test_warp_decode_kernel_levels_and_patches(shape, b, k, m, s):
    """Kernel 4 against its plain version: lanes on levels 0, 1 and 2 or
    more in one batch, a degenerate homography, a constant and a
    two-valued patch, each of the dictionaries' mark sizes, the largest
    patch held in registers (16 samples a thread), larger patches (read
    back from the output; more than 32 taps an output; more than 32
    outputs; above 48 KB of shared memory), lane counts of no round
    size."""
    dev = cuda_device()
    args = _warp_case(np.random.default_rng(m), *shape, b, k, dev, s)
    lvl, valid = args[3], args[6]
    assert bool((lvl[valid] == 0).any() and (lvl[valid] == 1).any() and (lvl[valid] >= 2).any())
    gs, gl, gg = k4.warp_decode(*args, s, m)
    rs, rl, rg = k4.plain(*args, s, m)
    assert torch.equal(gl, rl) and torch.equal(gg, rg)
    assert torch.equal(gs, rs)
    assert not bool(gs[0, 2].any()) and int(gl[0, 2]) == 0
    assert set(gs[0, 3].unique().tolist()) == {0.0, 255.0}


@pytest.mark.parametrize("s,m", [(S, 6), (S, 7), (S, 8), (S, 10), (128, 6), (96, 40)])
def test_resize_taps_reproduce_matrix(s, m):
    """Kernel 4's tap table holds ``rectify.triangle_resize_matrix(s, m)``
    exactly, each row as one run of taps (more than 32 at 128 -> 6), and
    its device words are the start, the count and the weights' bits."""
    start, cnt, wts = k4.resize_taps(s, m)
    dense = np.zeros((m, s), np.float32)
    for o in range(m):
        assert 0 < cnt[o] <= wts.shape[1]
        dense[o, start[o] : start[o] + cnt[o]] = wts[o, : cnt[o]]
        assert not wts[o, cnt[o] :].any()
    assert np.array_equal(dense, rectify.triangle_resize_matrix(s, m))
    words = k4.device_taps(s, m, torch.device("cpu")).numpy()
    assert np.array_equal(words[:m], start) and np.array_equal(words[m : 2 * m], cnt)
    assert np.array_equal(words[2 * m :].view(np.float32).reshape(m, -1), wts)


@pytest.mark.parametrize("m", [6, 7, 8, 10])
def test_resize_through_taps_matches_plain(m):
    """A resize summing each output's run of taps in ascending order (first
    term, then acc + term; rows, then columns), as kernel 4 does, equals
    ``rectify.resize_triangle`` bit for bit on binarized patches."""
    rng = np.random.default_rng(m)
    patches = torch.from_numpy(np.where(rng.random((6, S, S)) < 0.5, 255.0, 0.0).astype(np.float32))
    start, cnt, wts = k4.resize_taps(S, m)

    def contract(x, axis):
        outs = []
        for o in range(m):
            acc = x.select(axis, int(start[o])) * float(wts[o, 0])
            for j in range(1, cnt[o]):
                acc = acc + x.select(axis, int(start[o] + j)) * float(wts[o, j])
            outs.append(acc)
        return torch.stack(outs, dim=axis)

    got = contract(contract(patches, 1), 2)
    assert torch.equal(got, rectify.resize_triangle(patches, m))


@pytest.mark.gpu
def test_kernels_reject_bad_inputs():
    dev = cuda_device()
    grey = torch.zeros((1, 64, 64), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        k1.threshold_open_pool(grey, 7, 2, 2)
    with pytest.raises(ValueError):
        k2.coarse_fit(torch.zeros((1, 8, 8), dtype=torch.bool, device=dev),
                      segment.QuadParams(max_candidates=200), 2)
    # Kernel 3: an empty window, centroids of another shape.
    args = _refine_case(np.random.default_rng(5), 1, 3, 64, 64, 10, dev)
    with pytest.raises(ValueError):
        k3.refine_corners(*args, 10, 0)
    with pytest.raises(ValueError):
        k3.refine_corners(args[0], args[1], args[2], args[3][..., :1].contiguous(), *args[4:], 10, 28)
    # Kernel 4: more pyramid levels than a frame can have, a patch whose
    # resize does not fit an SM's shared memory, levels of another type
    # (float32: the exact pyramid of the tail route).
    grey, uppers, *rest = _warp_case(np.random.default_rng(6), 240, 320, 1, 5, dev)
    for levels, s in ((uppers * 11, S), (uppers, 1024), ([u.double() for u in uppers], S),
                      ([u.float() for u in uppers], S)):
        with pytest.raises(ValueError):
            k4.warp_decode(grey, levels, *rest, s, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["single", "multi", "dark", "nested", "rgb"])
def test_detect_on_card_matches_cpu(kind):
    dev = cuda_device()
    d = dictionaries.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    img, ids = make_scene(kind)
    got = Detector(DetectorConfig(), d, device=dev).detect(img)
    ref = Detector(DetectorConfig(), d, device="cpu").detect(img)
    assert ids <= {m.id for m in got.markers}
    assert sorted((m.id, m.code, tuple(m.corners)) for m in got.markers) == sorted(
        (m.id, m.code, tuple(m.corners)) for m in ref.markers
    )
    assert got.candidates == ref.candidates
    assert got.stats == ref.stats
    np.testing.assert_array_equal(np.stack(got.homographies), np.stack(ref.homographies))
    assert n(torch.as_tensor(got.grey)).shape == img.shape[:2]


def _label_planes(shape, density, seed, dev, b=2):
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.random((b,) + shape) < density).to(dev)
    return c, segment.label_planes(c, P)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind,density,b", CARD_CASES)
def test_coarse_labels_kernel_matches_plain(shape, kind, density, b):
    """Labels mode, with and without the inner plane."""
    dev = cuda_device()
    c = coarse_masks(kind, b, shape, density, seed=31).to(dev)
    r1, r2 = segment.label_planes(c, P)
    g1, g2 = k2.coarse_labels(c, P)
    assert torch.equal(g1, r1) and torch.equal(g2, r2)
    no_inner = segment.QuadParams(max_inner_candidates=0)
    g1, g2 = k2.coarse_labels(c, no_inner)
    assert torch.equal(g1, r1) and bool((g2 == shape[0] * shape[1]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("c", [2, 4, 8])
@pytest.mark.parametrize("shape,kind,b", [((216, 384), "random", 2), ((217, 385), "serpentine", 1),
                                          ((40, 54), "random", 3), ((37, 33), "blobs", 2)])
def test_coarse_labels_on_each_cluster_size(shape, kind, b, c, monkeypatch):
    """Labels mode on clusters of c blocks whatever the plan would pick:
    bands of 5 to 55 rows, on grids that one block holds too; the dense
    grids, whose halves do not fit a block, in device scratch on 2."""
    dev = cuda_device()
    hc, wc = shape
    band = _build.layout("a3_coarse_cluster_layout", hc, wc, c)[0]
    forced = (("cluster", c, 1024, 0) if band
              else ("scratch", 1, 1024, _build.layout("a3_coarse_layout", hc, wc, 0)[1]))
    assert bool(band) == (c > 2 or hc < 100)
    monkeypatch.setattr(k2, "plan", lambda *_: forced)
    m = coarse_masks(kind, b, shape, 0.3, seed=35).to(dev)
    r1, r2 = segment.label_planes(m, P)
    g1, g2 = k2.coarse_labels(m, P)
    assert torch.equal(g1, r1) and torch.equal(g2, r2)


def _assert_fit_equal(got, ref):
    for key in ("valid", "sizes", "qualifying", "roots"):
        assert torch.equal(got[key].cpu(), ref[key].cpu().to(got[key].dtype)), key
    assert (got["centroids"].cpu() - ref["centroids"].cpu()).abs().max() <= 1e-3
    assert k2.quad_mismatches(got, ref) == 0


def _edit_lanes(lab, roots, sizes, use):
    """Lanes that the top-k never gives but kernel 6 takes: lane 4 repeats
    lane 3's root and size, lanes 6 and 9 repeat the roots of lanes 5 and 0
    with other sizes, and lane 2 is a used lane whose root (a cell that is
    not a root) no cell holds.  Returns the edited lanes."""
    b, hc, wc = lab.shape
    flat = lab.reshape(b, -1)
    not_root = (flat != torch.arange(hc * wc, device=lab.device)).int().argmax(dim=1)
    roots[:, 4], sizes[:, 4], use[:, 4] = roots[:, 3], sizes[:, 3], use[:, 3]
    roots[:, 6], sizes[:, 6], use[:, 6] = roots[:, 5], sizes[:, 5] + 3, True
    roots[:, 9], sizes[:, 9], use[:, 9] = roots[:, 0], (sizes[:, 0] - 1).clamp(min=0), True
    roots[:, 2], sizes[:, 2], use[:, 2] = not_root.int(), 4, True
    assert not bool((flat == roots[:, 2:3]).any())
    return [2, 4, 6, 9]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,k,b,edit", [
        ((40, 54), 32, 2, False), ((192, 108), 96, 2, False), ((108, 192), 160, 2, False),
        ((108, 192), 300, 2, False), ((1080, 1920), 160, 2, False),
        ((40, 54), 31, 5, True),  # K not a multiple of the lane group (2 lanes a block)
        ((40, 54), 32, 1, True),  # one frame: a cluster of 8 blocks, a lane a block
        ((24, 30), 100, 140, True),  # more frames than SMs: clusters of 1, groups of 64
        ((108, 192), 160, 16, True),  # dense's batch: clusters of 8, groups of 20
        ((1080, 1920), 160, 1, True),
    ]
)
def test_rank_and_lane_kernels_match_plain(shape, k, b, edit):
    """Kernel 5 on clusters of ``rank_cluster(b)`` blocks and kernel 6 on
    groups of ``lane_group(k, b)`` lanes against their plain versions; with
    ``edit``, duplicate roots (equal and other sizes) and a used lane with
    no member cell (its corners all cell 0)."""
    dev = cuda_device()
    _, (lab, _) = _label_planes(shape, 0.3, 32, dev, b)
    kr = segment.rank_pool_size(k, shape[0] * shape[1])
    got = kfit.rank_roots(lab, kr, P.min_component_px)
    ref = segment.rank_pool(lab, kr, P.min_component_px)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    roots, sizes = segment.select_lanes(*ref[:2], k)
    use = sizes >= 0
    sizes = sizes.clamp(min=0)
    use[:, 1] = False  # a hole among the used lanes
    edited = _edit_lanes(lab, roots, sizes, use) if edit else []
    args = (lab, roots.contiguous(), sizes.contiguous(), use.contiguous(), 10,
            P.containment_slack)
    gq, gc, gf = kfit.fit_lanes(*args)
    rq, rc, rf = segment.fit_lanes(*args)
    assert torch.equal(gf, rf)
    assert (gc - rc).abs().max() <= 1e-3
    assert k2.quad_mismatches({"quads": gq}, {"quads": rq, "centroids": rc, "sizes": args[2]}) == 0
    assert torch.equal(gq[:, edited], rq[:, edited]) and torch.equal(gc[:, edited], rc[:, edited])
    assert not bool(gq[:, 1].any() or gc[:, 1].any() or gf[:, 1].any())
    _assert_fit_equal(kfit.fit_quads_batch(lab, 10, P, k), segment.fit_quads(lab, 10, P, k))


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 2, 4, 8])
@pytest.mark.parametrize("shape,b,k", [((40, 54), 3, 32), ((13, 70), 2, 160), ((1080, 1920), 1, 160)])
def test_rank_kernel_on_each_cluster_size(shape, b, k, c, monkeypatch):
    """Kernel 5 on clusters of c blocks whatever the batch: bands of fewer
    rows than blocks, and at c = 1 on 1080x1920 the bands in device
    scratch."""
    dev = cuda_device()
    monkeypatch.setattr(kfit, "rank_cluster", lambda b_, sms: c)
    _, (lab, _) = _label_planes(shape, 0.3, 34, dev, b)
    kr = segment.rank_pool_size(k, shape[0] * shape[1])
    for min_px in (1, 2, 3):
        got = kfit.rank_roots(lab, kr, min_px)
        ref = segment.rank_pool(lab, kr, min_px)
        for a, r in zip(got, ref):
            assert torch.equal(a, r)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind,b,k1,k2", [
    ((40, 54), "random", 2, 32, 12), ((192, 108), "random", 2, 32, 12),
    ((60, 203), "blobs", 2, 32, 12), ((108, 192), "random", 2, 32, 0),
    ((120, 160), "random", 3, 32, 12), ((60, 203), "random", 2, 32, 12),
    ((37, 33), "random", 3, 32, 12), ((108, 192), "serpentine", 2, 32, 12),
    ((40, 54), "ones", 2, 32, 12), ((40, 54), "zeros", 2, 32, 12),
    ((108, 192), "blobs", 2, 32, 12), ((108, 192), "blobs", 2, 128, 128),
    ((40, 54), "random", 5, 32, 12), ((40, 54), "random", 400, 32, 12),
    ((256, 330), "random", 2, 32, 12), ((1080, 1920), "random", 1, 32, 12),
])
def test_fused_fit_kernel_matches_plain(shape, kind, b, k1, k2):
    dev = cuda_device()
    l1, l2 = segment.label_planes(coarse_masks(kind, b, shape, 0.35, seed=33).to(dev), P)
    got = kfit.fused_fit_batch(l1, l2, 10, P, k1, k2)
    ref = kfit.fused_fit_plain(l1, l2, 10, P, k1, k2)
    _assert_fit_equal(got[0], ref[0])
    assert (got[1] is None) == (ref[1] is None) == (k2 == 0)
    if k2:
        _assert_fit_equal(got[1], ref[1])


@pytest.mark.parametrize("b,smem,threads", [
    (128, 200_000, 1024), (132, 101_760, 1024), (133, 101_760, 512), (512, 101_760, 512),
    (512, 40_000, 256), (512, 200_000, 1024), (300, 18_500, 320), (400, 18_500, 256),
    (16, 0, 1024), (2, 0, 1024), (5, 18_500, 1024), (1000, 0, 256), (264, 0, 512),
])
def test_threads_per_block(b, smem, threads):
    """Blocks of kernels 2 and 7: a batch that fits the card's 132 SMs
    once gets 1,024 threads a frame; a larger batch as many blocks an SM
    as it needs, at most 4 and as many as shared memory holds."""
    got = kfit.threads_per_block(b, smem, 132)
    assert got == threads
    assert got % 32 == 0 and 64 <= got <= 1024
    assert (1024 // got) * (smem + 1024) <= kfit.SMEM_SM or got == 1024


@pytest.mark.gpu
def test_kernel_layouts():
    """Kernels 2, 5, 6 and 7 keep the five paths' grids on chip, and a grid
    of 65,536 cells or more (a 1080p frame at coarse_factor 1) in device
    scratch sized for it (kernels 2 in labels mode and 5: unless a
    cluster's band fits)."""
    cuda_device()
    kr = segment.rank_pool_size(P.max_candidates, 108 * 192)
    smem, ints = _build.layout("a3_coarse_layout", 108, 192, kr)
    assert smem > 0 and ints == 108 * 192  # fit mode: the inner plane
    for hc, wc in ((192, 108), (120, 160), (108, 192)):
        smem, ints = _build.layout("a3_coarse_layout", hc, wc, 0)
        assert smem > 0 and ints == 0
        assert _build.layout("a3_fused_layout", hc, wc, kr)[0] > 0
    for name, args in (
        ("a3_coarse_layout", (1080, 1920, 0)), ("a3_coarse_layout", (1080, 1920, 1024)),
        ("a3_fused_layout", (1080, 1920, 1024)), ("a3_coarse_layout", (256, 330, 0)),
    ):
        smem, ints = _build.layout(name, *args)
        assert smem == 0 and ints > args[0] * args[1]
    # Kernel 2's cluster layout (labels mode): a band of rows a block on chip
    # where one block cannot hold the frame (216x384, 217x385, 256x330),
    # not 1080x1920; the fused cells' grids one block on chip.  The
    # library's layouts are coarse_layout_model's, which the CPU tests of
    # the plan use.
    grids = ((216, 384), (217, 385), (256, 330), (1080, 1920), (108, 192), (120, 160),
             (192, 108), (40, 54), (37, 33), (13, 70))
    for hc, wc in grids:
        for pool in (0, k2.fit_pool(P, hc * wc)):
            name = "a3_coarse_layout"
            assert _build.layout(name, hc, wc, pool) == coarse_layout_model(name, hc, wc, pool)
        for c in (1, 2, 3, 4, 8, 9):
            name = "a3_coarse_cluster_layout"
            assert _build.layout(name, hc, wc, c) == coarse_layout_model(name, hc, wc, c)
    for b, hc, wc in ((16, 216, 384), (2, 217, 385), (2, 256, 330), (128, 216, 384)):
        assert k2.plan(b, hc, wc, 0, 132)[:3] == ("cluster", 8, 512)
        assert 0 < _build.layout("a3_coarse_cluster_layout", hc, wc, 8)[0] <= k1.SMEM_MAX
    assert k2.plan(1, 1080, 1920, 0, 132)[:2] == ("scratch", 1)
    for b, hc, wc in ((128, 108, 192), (64, 120, 160), (1, 120, 160), (1, 108, 192)):
        assert k2.plan(b, hc, wc, k2.fit_pool(P, hc * wc), 132)[:2] == ("smem", 1)
    # Kernel 5: header and three pool arrays, then a band's row counts and
    # admission words where they fit (108 / c rows of 6 words, 1080 / c of 60).
    pools = 16 + 3 * 1024
    assert _build.layout("a3_rank_layout", 108, 192, 1024, 8) == (4 * (pools + 15 + 14 * 6), 0)
    assert _build.layout("a3_rank_layout", 108, 192, 1024, 1) == (4 * (pools + 109 + 108 * 6), 0)
    assert _build.layout("a3_rank_layout", 1080, 1920, 1024, 8) == (
        4 * (pools + 136 + 135 * 60), 0)
    assert _build.layout("a3_rank_layout", 1080, 1920, 1024, 1) == (4 * pools, 1081 + 1080 * 60)
    # Kernel 6: the staged plane and the member list as uint16 (a plane of
    # ints a block in device scratch on 1080x1920).
    assert _build.layout("a3_lanes_layout", 108, 192) == (4 * 108 * 192, 0)
    assert _build.layout("a3_lanes_layout", 1080, 1920) == (0, 1080 * 1920)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["multi", "dark", "nested"])
def test_portrait_detect_on_card_matches_cpu(kind):
    """A 240-wide, 320-high frame at coarse factor 2 takes the label route."""
    dev = cuda_device()
    d = dictionaries.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    img, ids = make_scene(kind)
    img = np.ascontiguousarray(np.rot90(img))
    cfg = DetectorConfig(coarse_factor=2)
    det = Detector(cfg, d, device=dev)
    det.detect(img)  # captures the frame's graph (its warm-up launches too)
    k2.labels_count.reset()
    kfit.fused_count.reset()
    got = det.detect(img)
    assert (k2.labels_count.launches, kfit.fused_count.launches) == (1, 1)
    ref = Detector(cfg, d, device="cpu").detect(img)
    assert ids <= {m.id for m in got.markers}
    assert sorted((m.id, m.code, tuple(m.corners)) for m in got.markers) == sorted(
        (m.id, m.code, tuple(m.corners)) for m in ref.markers
    )
    assert got.candidates == ref.candidates
    assert got.stats == ref.stats


@pytest.mark.gpu
@pytest.mark.parametrize("count,s", [(1, S), (7, S), (128, S), (4096, S), (128, 17), (1152, 17)])
def test_warp_eval_kernel_matches_plain(count, s):
    """Counts that are no multiple of the block, one sample chunk per
    window and many (``chunk_size``), S^2 no multiple of a chunk;
    coordinates inside, in the partial edge bands, on the window's edges,
    beyond them and far outside."""
    dev = cuda_device()
    rng = np.random.default_rng(41)
    windows = rng.uniform(0, 255, size=(count, 64, 64)).astype(np.float32)
    edges = [-1.0, -0.5, -1e-6, 0.0, 63.0, 63.25, 64.0 - 1e-5, 64.0]

    def coords():
        u = rng.uniform(-1.5, 64.5, size=(count, s * s))
        far = rng.random(u.shape) < 0.05
        u = np.where(far, rng.choice([-1e6, -3.0, 67.0, 1e6], u.shape), u)
        edge = rng.random(u.shape) < 0.1
        return np.where(edge, rng.choice(edges, u.shape), u).astype(np.float32)

    args = [torch.from_numpy(a).to(dev) for a in (windows, coords(), coords())]
    got = k8.warp_eval(*args)
    ref = k8.plain(*args)
    assert got.shape == ref.shape == (count, s * s)
    assert torch.equal(got, ref)  # both round wx and the windows to bfloat16


@pytest.mark.parametrize("count", [1, 7, 128, 1152, 4096, 30000])
@pytest.mark.parametrize("s", [17, 49, 64])
def test_warp_eval_chunks_cover_each_sample_once(count, s):
    """The kernel's grid (a block per window and chunk) evaluates every
    sample once; split windows make at most ``TARGET_BLOCKS`` blocks, a few
    windows chunks of one block, many windows one chunk each."""
    s2 = s * s
    chunk = k8.chunk_size(count, s2)
    assert chunk > 0 and chunk % k8.BLOCK == 0
    hits = np.zeros(s2, np.int32)
    for c in range(-(-s2 // chunk)):  # blockIdx.y
        hits[c * chunk : min(s2, (c + 1) * chunk)] += 1
    assert (hits == 1).all()
    blocks = -(-s2 // chunk) * count
    if chunk < s2:
        assert blocks <= k8.TARGET_BLOCKS
    if count <= 8:
        assert chunk == k8.BLOCK
    if count >= k8.TARGET_BLOCKS:
        assert chunk >= s2


@pytest.mark.gpu
@pytest.mark.parametrize("kind,size,cfg", [
    ("multi", (320, 240), DetectorConfig(refine_corners=False)),
    ("nested", (320, 240), DetectorConfig(refine_corners=False)),
    ("single", (160, 120), DetectorConfig()),
])
def test_tail_route_on_card_matches_cpu(kind, size, cfg):
    """Without refinement, or at coarse factor 1: kernel 1, labels mode,
    kernel 7 and kernel 8 launch once each, nothing else."""
    dev = cuda_device()
    d = dictionaries.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    img, ids = make_scene(kind, *size, scale=size[0] / 320)
    det = Detector(cfg, d, device=dev)
    det.detect(img)  # captures the frame's graph (its warm-up launches too)
    for c in COUNTS.values():
        c.reset()
    got = det.detect(img)
    tail = {"frontend", "coarse_labels", "fused_fit", "warp_eval"}
    assert {name: c.launches for name, c in COUNTS.items()} == {
        name: int(name in tail) for name in COUNTS
    }
    assert all(c.plain_calls == 0 for c in COUNTS.values())
    ref = Detector(cfg, d, device="cpu").detect(img)
    assert ids <= {m.id for m in got.markers}
    assert sorted((m.id, m.code, tuple(m.corners)) for m in got.markers) == sorted(
        (m.id, m.code, tuple(m.corners)) for m in ref.markers
    )
    assert got.candidates == ref.candidates
    assert got.stats == ref.stats
