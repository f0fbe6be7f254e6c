"""Frames of marker scenes, drawn from a seed and rendered on the device.

The geometry follows ``render.random_marker_scene`` (the port's and the
JAX package's renderer): each marker is a square of side ``scale`` x the
tile's short side, turned by a uniform angle, each corner moved by up to
``max_persp`` of the side, centred at least 0.7 sides from the tile's
edges; it is drawn on the host from a numpy generator seeded with the
run's seed, in that renderer's order of draws.  The pixels are rendered on
the device: each tile supersampled ``supersample`` x ``supersample`` a
pixel through the inverse homography of its marker, rounded, laid on a
white frame by the minimum, then the noise of the frame, truncated as
``render.bench_scene`` truncates it.  The noise comes from a
``torch.Generator`` on the device seeded with the run's seed.

A scene is described by a dict (a configuration's ``scene``):

* ``height``, ``width``: the frame;
* ``tile`` [h, w], ``origin`` [y, x], ``pitch`` [dy, dx], ``columns``: the
  tiles, tile j at origin + (j // columns, j % columns) * pitch;
* ``markers`` [lo, hi]: markers in a frame, in its first tiles; a count
  is drawn only where lo < hi;
* ``scale`` [lo, hi], ``max_persp``;
* ``interior_margin``: where set, a marker is drawn again (up to
  ``tries`` times) until every corner lies this far inside its tile;
* ``tile_noise``, ``frame_noise``: sigma of the Gaussian noise of each
  tile before it is rounded, and of the frame at the end;
* ``supersample``.
"""

from __future__ import annotations

import numpy as np
import torch

# Corners of the unit square, clockwise in y-down screen space.
_BASE = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]])
# Markers rendered in one pass (memory of a pass grows with it).
_CHUNK = 16
# Frames given their noise in one pass.
_NOISE_CHUNK = 16


def marker_quad(rng: np.random.Generator, width: int, height: int, scale, max_persp: float):
    """(4, 2) corners of one marker in a width x height tile, drawn in
    ``render.random_marker_scene``'s order: side, centre x, centre y,
    angle, then the corners' (4, 2) offsets."""
    side = rng.uniform(scale[0], scale[1]) * min(width, height)
    cx = rng.uniform(side * 0.7, width - side * 0.7)
    cy = rng.uniform(side * 0.7, height - side * 0.7)
    angle = rng.uniform(0, 2 * np.pi)
    rot = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
    quad = _BASE @ rot.T * side
    quad += rng.uniform(-max_persp, max_persp, size=(4, 2)) * side
    return quad + np.array([cx, cy])


def draw_layout(scene: dict, n_markers_in_dict: int, frames: int, seed: int):
    """[(frame, id, tile origin (y, x), tile-space corners (4, 2))] of
    ``frames`` frames, and the truth: per frame a list of (id, frame-space
    corners (4, 2) float64)."""
    rng = np.random.default_rng(seed)
    th, tw = scene["tile"]
    lo, hi = scene["markers"]
    margin = scene.get("interior_margin")
    tries = scene.get("tries", 1) if margin is not None else 1
    placed, truth = [], []
    for f in range(frames):
        k = int(rng.integers(lo, hi + 1)) if lo < hi else lo
        truth.append([])
        for j in range(k):
            mid = int(rng.integers(0, n_markers_in_dict))
            for _ in range(tries):
                quad = marker_quad(rng, tw, th, scene["scale"], scene["max_persp"])
                if margin is None or (
                    (quad[:, 0] > margin).all() and (quad[:, 0] < tw - margin).all()
                    and (quad[:, 1] > margin).all() and (quad[:, 1] < th - margin).all()
                ):
                    break
            y0 = scene["origin"][0] + (j // scene["columns"]) * scene["pitch"][0]
            x0 = scene["origin"][1] + (j % scene["columns"]) * scene["pitch"][1]
            placed.append((f, mid, (y0, x0), quad))
            truth[-1].append((mid, quad + np.array([x0, y0], dtype=np.float64)))
    return placed, truth


def unit_square_homography(corners: np.ndarray) -> np.ndarray:
    """3x3 homography from the unit square (0,0),(1,0),(1,1),(0,1) to
    ``corners``, float64 (``render.homography_unit_square_to_quad``)."""
    src = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    a, b = [], []
    for (x, y), (u, v) in zip(src, np.asarray(corners, dtype=np.float64)):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    h = np.linalg.solve(np.array(a), np.array(b))
    return np.concatenate([h, [1.0]]).reshape(3, 3)


def render_tiles(quads, bit_matrices, th: int, tw: int, ss: int, noise: float,
                 gen: torch.Generator, device) -> torch.Tensor:
    """(N, th, tw) float32 tiles of N markers (tile-space corners
    ``quads``, (N, m, m) bool ``bit_matrices``, True white) on white, each
    pixel the mean of ss x ss samples, plus Gaussian noise of ``noise``,
    rounded and clipped to 0..255."""
    n = len(quads)
    hinv = torch.tensor(
        np.stack([np.linalg.inv(unit_square_homography(q)) for q in quads]),
        dtype=torch.float64, device=device,
    ).to(torch.float32)
    bits = torch.as_tensor(np.stack(bit_matrices), device=device)
    m = bits.shape[-1]
    ys = (torch.arange(th * ss, device=device, dtype=torch.float32) + 0.5) / ss - 0.5
    xs = (torch.arange(tw * ss, device=device, dtype=torch.float32) + 0.5) / ss - 0.5
    y, x = ys[None, :, None], xs[None, None, :]

    def row(i):
        return (hinv[:, i, 0, None, None] * x + hinv[:, i, 1, None, None] * y
                + hinv[:, i, 2, None, None])

    sz = row(2)
    sz = torch.where(sz.abs() < 1e-12, torch.full_like(sz, 1e-12), sz)
    u, v = row(0) / sz, row(1) / sz
    inside = (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    cx = (u * m).clamp(0, m - 1).to(torch.int64)
    cy = (v * m).clamp(0, m - 1).to(torch.int64)
    white = bits[torch.arange(n, device=device)[:, None, None], cy, cx]
    shade = torch.where(inside & ~white, 0.0, 255.0)
    img = shade.reshape(n, th, ss, tw, ss).mean(dim=(2, 4))
    if noise > 0:
        img = img + noise * torch.randn(img.shape, generator=gen, device=device)
    return torch.round(img).clamp(0, 255)


def render_frames(scene: dict, dictionary, frames: int, seed: int, device) -> tuple:
    """(frames (N, H, W) uint8 on ``device``, truth) of ``frames`` scenes
    from ``seed`` (see the module docstring); ``dictionary`` gives the
    markers' bit matrices (``marker_bit_matrix``) and its size."""
    device = torch.device(device)
    placed, truth = draw_layout(scene, len(dictionary), frames, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2**63 - 1))
    h, w = scene["height"], scene["width"]
    th, tw = scene["tile"]
    out = torch.full((frames, h, w), 255.0, dtype=torch.float32, device=device)
    ss = scene.get("supersample", 3)
    for c in range(0, len(placed), _CHUNK):
        part = placed[c:c + _CHUNK]
        tiles = render_tiles([p[3] for p in part],
                             [dictionary.marker_bit_matrix(p[1]) for p in part],
                             th, tw, ss, scene.get("tile_noise", 0.0), gen, device)
        for (f, _, (y0, x0), _), tile in zip(part, tiles):
            y1, x1 = min(y0 + th, h), min(x0 + tw, w)
            region = out[f, y0:y1, x0:x1]
            region.copy_(torch.minimum(region, tile[: y1 - y0, : x1 - x0]))
    sigma = scene.get("frame_noise", 0.0)
    frames_u8 = torch.empty((frames, h, w), dtype=torch.uint8, device=device)
    for c in range(0, frames, _NOISE_CHUNK):
        part = out[c:c + _NOISE_CHUNK]
        if sigma > 0:
            part = part + sigma * torch.randn(part.shape, generator=gen, device=device)
        frames_u8[c:c + _NOISE_CHUNK] = torch.floor(part.clamp(0, 255)).to(torch.uint8)
    return frames_u8, truth

