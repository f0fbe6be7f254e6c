"""Shared pieces of the port's twin tests (tests/test_torch_*.py).

Each twin test feeds the same numpy inputs, made from a seed, to a JAX
function (on the CPU, through its XLA path) and to its counterpart in
``aruco3_tpu_torch``, and compares the outputs.  Tests of the CUDA kernels
carry the ``gpu`` marker and skip where no card is present.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_golden  # noqa: E402

# xdist runs several workers on a few cores; keep each to one thread.
torch.set_num_threads(1)


def t(x) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor."""
    return torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    """Tensor or array -> numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cuda_device() -> torch.device:
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_quads_tie_equivalent(qa, qb, centroids, sizes):
    """Fitted quads of used lanes are equal, or differ only where corner A
    is an extreme-point tie (equally far from the centroid), after which
    the other corners legitimately follow the other choice: the rule of
    ``tools/torch_golden.py``'s ``tie_lanes``."""
    differs, accepted = torch_golden.tie_lanes(n(qa), n(qb), n(centroids), n(sizes))
    bad = differs & ~accepted
    assert not bad.any(), np.argwhere(bad)


def random_quads(rng, count, lo, hi, h, w):
    """Convex, roughly square (count, 4, 2) float32 quads of side in
    [lo, hi], rotated and perturbed, clockwise in y-down coordinates."""
    out = []
    for _ in range(count):
        side = rng.uniform(lo, hi)
        c = rng.uniform([0.6 * side, 0.6 * side], [w - 0.6 * side, h - 0.6 * side])
        ang = rng.uniform(0, 2 * np.pi)
        base = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]])
        rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        out.append(base @ rot.T * side + rng.uniform(-0.08, 0.08, (4, 2)) * side + c)
    return np.array(out, np.float32)


def serpentine(h, w):
    """A one-cell-wide path winding over an (h, w) grid: rows 1, 3, 5, ...
    from column 1 to w - 2, each joined to the next at alternating ends.
    Its component is far longer than the default round limits close."""
    m = np.zeros((h, w), bool)
    rows = list(range(1, h - 1, 2))
    for i, y in enumerate(rows):
        m[y, 1 : w - 1] = True
        if i + 1 < len(rows):
            m[y + 1, w - 2 if i % 2 == 0 else 1] = True
    return m


def coarse_masks(kind, b, shape, density=0.35, seed=14):
    """(b, h, w) bool coarse masks: ``random`` (cells black with
    ``density``), ``serpentine``, ``ones``, ``zeros`` or ``blobs`` (2x2
    blobs on a 3-cell lattice with 10% of cells dropped: many components
    of equal size, more than a rank pool of 1,024 holds on 108x192)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    if kind == "random":
        c = rng.random((b, h, w)) < density
    elif kind == "serpentine":
        c = np.broadcast_to(serpentine(h, w), (b, h, w)).copy()
    elif kind == "ones":
        c = np.ones((b, h, w), bool)
    elif kind == "zeros":
        c = np.zeros((b, h, w), bool)
    elif kind == "blobs":
        yy, xx = np.mgrid[:h, :w]
        c = ((yy % 3 < 2) & (xx % 3 < 2))[None] & (rng.random((b, h, w)) < 0.9)
    else:
        raise ValueError(kind)
    return torch.from_numpy(np.ascontiguousarray(c))


def noisy_blocks(rng, batch, h, w):
    """Grey frames with dark rectangles of several sizes plus noise: enough
    structure for every mask and label stage to be non-trivial."""
    img = np.full((batch, h, w), 200.0)
    for b in range(batch):
        for _ in range(12):
            y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            dy, dx = rng.integers(4, max(5, h // 3)), rng.integers(4, max(5, w // 3))
            img[b, y0 : y0 + dy, x0 : x0 + dx] = rng.uniform(0, 90)
    img += rng.normal(0, 12, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _noise(img, seed):
    rng = np.random.default_rng(seed)
    noisy = img.astype(np.float64) + rng.normal(0, 2.0, img.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def make_scene(kind, w=320, h=240, scale=1.0):
    """The scenes of tests/test_detector.py, scaled to 320x240, rendered
    with the port's renderer (equal to the JAX package's).  ``scale``
    scales the marker quads and the plate (0.5 with a 160x120 frame gives
    the same scene at half size).  Returns the image and the marker ids it
    holds."""
    from aruco3_tpu_torch import dictionaries, render

    d = dictionaries.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    single = np.array([[100, 70], [220, 75], [215, 190], [95, 185]], float) * scale
    if kind in ("single", "rgb"):
        img = render.render_marker(d, 5, (w, h), single, noise_sigma=2.0)
        return (np.stack([img] * 3, axis=-1) if kind == "rgb" else img), {5}
    if kind == "multi":
        img = np.full((h, w), 255, np.uint8)
        quads = {
            7: np.array([[30, 30], [110, 32], [108, 110], [28, 108]], float) * scale,
            99: np.array([[190, 120], [280, 125], [275, 215], [185, 210]], float) * scale,
        }
        for mid, q in quads.items():
            img = np.minimum(img, render.render_marker(d, mid, (w, h), q))
        return _noise(img, 5), {7, 99}
    if kind == "dark":
        img = render.render_marker(
            d, 5, (w, h), single, background=0, quiet_zone_cells=2, noise_sigma=2.0
        )
        return img, {5}
    if kind == "nested":
        corners = np.array([[120, 90], [200, 95], [195, 170], [115, 165]], float) * scale
        mimg = render.render_marker(
            d, 17, (w, h), corners, background=0, quiet_zone_cells=2
        )
        plate = np.zeros((h, w), bool)
        plate[round(60 * scale) : round(205 * scale), round(75 * scale) : round(245 * scale)] = True
        return _noise(np.where(plate, mimg, 255).astype(np.uint8), 3), {17}
    raise ValueError(kind)
