"""Reference-parity oracle, the port's copy of ``aruco3_tpu/oracle.py``
(the same numpy code; it reads this package's dictionaries and Triangle
resize matrix).

Reference-parity oracle: a faithful numpy port of the reference detect
pipeline, used (a) to MEASURE recall/corner parity of the TPU detector
against the reference's algorithm (BASELINE.json's >=99% recall-parity
requirement — no Rust toolchain exists in this image, so the reference is
re-expressed host-side), and (b) as a portable, dependency-free CPU
fallback detector.

Pipeline, stage by stage (reference src/aruco.rs:52-121):
  * luma + adaptive mean threshold            aruco.rs:60-61
  * Suzuki-Abe border following on the WHITE foreground — imageproc's
    find_contours traces OUTER and HOLE borders, so marker quads arise as
    hole borders of the white background/quiet zone    aruco.rs:64
  * RDP simplification with eps = n_points * 0.05      aruco.rs:133
  * exactly-4-vertices, convex-hull-still-4, min-edge gate including the
    squared-vs-linear comparison quirk                 aruco.rs:136-156
  * clockwise corner enforcement                       aruco.rs:168-185
  * sequential near-duplicate suppression (order-dependent, keeps the
    larger perimeter)                                  aruco.rs:187-232
  * 49x49 bilinear warp with black default             aruco.rs:234-261
  * Otsu -> Triangle resize -> all-black border gate -> MSB-first
    4-rotation read                                    aruco.rs:263-326
  * nearest-code scan, strict-< tie-breaks, corners rotate_left(rot)
                                                       aruco.rs:74-113

The sequential border following here is exactly the control flow the TPU
framework must NOT use (it serializes); segment.py replaces it with
data-parallel CCL.  Recall parity between the two stacks is therefore a
measured property, not a structural one — tests/test_parity.py runs this
oracle A/B against the jitted detector over randomized scenes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .dictionaries import ARDictionary
from .rectify import triangle_resize_matrix


# --------------------------------------------------------------------------
# Threshold (imageproc adaptive_threshold semantics; see frontend.py)
# --------------------------------------------------------------------------
def adaptive_threshold_np(grey: np.ndarray, radius: int) -> np.ndarray:
    """Boolean white mask: pixel >= clamped-box mean, exact integer compare.

    Same semantics as frontend.adaptive_threshold (the jax implementation);
    both mirror imageproc::contrast::adaptive_threshold as called at
    reference aruco.rs:61.

    Crate pin (imageproc 0.25, src/contrast.rs adaptive_threshold): the
    crate computes the box sum over the radius-r window clamped to the
    image and whitens a pixel when it is >= the block mean; the integer
    compare here (pixel * area >= sum) avoids the division entirely, so
    the only semantics at risk is the tie policy (pixel == mean => WHITE).
    Checkable against the real crate via tests/golden/ (the
    adaptive_threshold.json uniform-image case is all ties) — see
    tests/golden/rust_validation.
    """
    g = grey.astype(np.int64)
    h, w = g.shape
    ii = np.zeros((h + 1, w + 1), dtype=np.int64)
    ii[1:, 1:] = g.cumsum(0).cumsum(1)
    ys = np.arange(h)
    xs = np.arange(w)
    y0 = np.maximum(ys - radius, 0)
    y1 = np.minimum(ys + radius, h - 1) + 1
    x0 = np.maximum(xs - radius, 0)
    x1 = np.minimum(xs + radius, w - 1) + 1
    sums = (
        ii[np.ix_(y1, x1)]
        - ii[np.ix_(y0, x1)]
        - ii[np.ix_(y1, x0)]
        + ii[np.ix_(y0, x0)]
    )
    areas = (y1 - y0)[:, None] * (x1 - x0)[None, :]
    return g * areas >= sums


# --------------------------------------------------------------------------
# Suzuki-Abe border following (imageproc find_contours semantics)
# --------------------------------------------------------------------------
# 8-neighbourhood in (dy, dx), counterclockwise starting East (paper order).
_DIRS = [(0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1)]


def find_contours_np(white: np.ndarray) -> list[np.ndarray]:
    """All borders (outer + hole) of the True regions of ``white``.

    Suzuki-Abe border following (S. Suzuki, K. Abe 1985), the algorithm
    behind imageproc::contours::find_contours (reference aruco.rs:64).
    Returns each border as an (N, 2) int array of (x, y) pixel coords in
    traversal order.  Sequential by nature — host/test use only.

    Crate pin (imageproc 0.25, src/contours.rs find_contours): nonzero
    pixels are foreground; both OUTER and HOLE borders are traced per the
    paper's NBD bookkeeping (foreground 8-connected, background
    4-connected).  Which borders exist — the property candidate
    extraction depends on — is checkable as point-sets via
    tests/golden/find_contours.json + rust_validation (traversal
    start/direction conventions may differ harmlessly).
    """
    h, w = white.shape
    # Pad by 1 so the follower needs no bounds checks; image pixel (i, j)
    # lives at f[i+1, j+1].
    f = np.zeros((h + 2, w + 2), dtype=np.int32)
    f[1:-1, 1:-1] = white
    nbd = 1
    contours: list[np.ndarray] = []

    # Border starts can only occur where the ORIGINAL mask has a
    # left-background (outer) or right-background (hole) transition — f
    # mutations never turn 0 into nonzero, so the candidate set is static.
    # Visiting only these pixels (in raster order, preserving the paper's
    # scan semantics) makes the scan O(edges) instead of O(pixels).
    left0 = np.ones_like(white)
    left0[:, 1:] = ~white[:, :-1]
    right0 = np.ones_like(white)
    right0[:, :-1] = ~white[:, 1:]
    cand = white & (left0 | right0)
    # Isolated pixels (no white 8-neighbour) short-circuit to a 1-point
    # border — the dominant case in noisy frames.
    neigh = np.zeros((h + 2, w + 2), dtype=np.int32)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            neigh[1:-1, 1:-1] += f[dy : dy + h, dx : dx + w]
    dirs = _DIRS
    for ij in np.argwhere(cand):
        i, j = int(ij[0]) + 1, int(ij[1]) + 1  # padded coords
        fij = f[i, j]
        if fij == 0:
            continue
        if fij == 1 and f[i, j - 1] == 0:
            start_dir = 4  # towards (i, j-1): West
        elif fij >= 1 and f[i, j + 1] == 0:
            start_dir = 0  # towards (i, j+1): East
        else:
            continue
        nbd += 1
        if neigh[i, j] == 0:
            f[i, j] = -nbd
            contours.append(np.array([(j - 1, i - 1)], dtype=np.int64))
            continue
        points = []
        # (3.1) clockwise search around (i, j) from start_dir.
        for t in range(8):
            d = (start_dir - t) % 8
            dy, dx = dirs[d]
            if f[i + dy, j + dx] != 0:
                found = d
                break
        i1, j1 = i + dirs[found][0], j + dirs[found][1]
        # (3.2)
        i2, j2 = i1, j1
        i3, j3 = i, j
        while True:
            # (3.3) counterclockwise from the element after (i2, j2).
            d2 = dirs.index((i2 - i3, j2 - j3))
            examined_east_zero = False
            for t in range(1, 9):
                d = (d2 + t) % 8
                dy, dx = dirs[d]
                if f[i3 + dy, j3 + dx] != 0:
                    found = d
                    break
                if d == 0:
                    examined_east_zero = True
            i4, j4 = i3 + dirs[found][0], j3 + dirs[found][1]
            # (3.4)
            points.append((j3 - 1, i3 - 1))
            if examined_east_zero:
                f[i3, j3] = -nbd
            elif f[i3, j3] == 1:
                f[i3, j3] = nbd
            # (3.5)
            if i4 == i and j4 == j and i3 == i1 and j3 == j1:
                break
            i2, j2 = i3, j3
            i3, j3 = i4, j4
        contours.append(np.array(points, dtype=np.int64))
    return contours


# --------------------------------------------------------------------------
# RDP + convex hull (imageproc geometry semantics)
# --------------------------------------------------------------------------
def _rdp_open(points: np.ndarray, eps: float) -> np.ndarray:
    """Ramer-Douglas-Peucker on an open polyline (keeps both endpoints)."""
    if len(points) < 3:
        return points
    a = points[0].astype(np.float64)
    b = points[-1].astype(np.float64)
    ab = b - a
    lab = np.hypot(*ab)
    if lab < 1e-12:
        d = np.hypot(*(points.astype(np.float64) - a).T)
    else:
        d = np.abs(
            (points[:, 0] - a[0]) * ab[1] - (points[:, 1] - a[1]) * ab[0]
        ) / lab
    k = int(np.argmax(d))
    if d[k] <= eps:
        return points[[0, -1]]
    left = _rdp_open(points[: k + 1], eps)
    right = _rdp_open(points[k:], eps)
    return np.concatenate([left[:-1], right], axis=0)


def approximate_polygon_dp(points: np.ndarray, eps: float) -> np.ndarray:
    """Closed-curve RDP: split at the point farthest from points[0], RDP
    both halves, rejoin (reference aruco.rs:133 via imageproc geometry).

    Crate pin (imageproc 0.25, src/geometry.rs approximate_polygon_dp
    with closed=true): perpendicular-distance RDP keeping endpoints; the
    closed curve is split at the vertex farthest from the start point and
    each open half is simplified.  The surviving-vertex COUNT (what the
    reference's 4-vertex gate reads, aruco.rs:136) is checkable via
    tests/golden/polygon_dp.json + rust_validation.
    """
    pts = np.asarray(points)
    if len(pts) < 3:
        return pts
    d0 = np.hypot(*(pts - pts[0]).astype(np.float64).T)
    k = int(np.argmax(d0))
    if k == 0:
        return pts[:1]
    first = _rdp_open(pts[: k + 1], eps)
    second = _rdp_open(np.concatenate([pts[k:], pts[:1]], axis=0), eps)
    return np.concatenate([first[:-1], second[:-1]], axis=0)


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull, collinear points dropped (imageproc
    convex_hull semantics as used at reference aruco.rs:143)."""
    pts = np.unique(np.asarray(points, dtype=np.int64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2:
                o, a = out[-2], out[-1]
                if (a[0] - o[0]) * (p[1] - o[1]) - (a[1] - o[1]) * (
                    p[0] - o[0]
                ) <= 0:
                    out.pop()
                else:
                    break
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1], dtype=np.int64)


# --------------------------------------------------------------------------
# Candidate filters (reference aruco.rs:124-232, exact semantics)
# --------------------------------------------------------------------------
def contours_to_candidates(
    contours: list[np.ndarray],
    min_edge_length: int,
    contour_simplification_epsilon: float,
) -> list[np.ndarray]:
    candidates = []
    for c in contours:
        if len(c) < 4:
            continue
        # Bounding-box prefilter (pure speed, identical semantics): every
        # edge must satisfy edge^2 >= min_edge_length (aruco.rs:149-156),
        # so a contour whose bbox extent is below sqrt(min_edge_length)
        # cannot survive the edge gate.
        ext = c.max(axis=0) - c.min(axis=0)
        if ext[0] * ext[0] + ext[1] * ext[1] < min_edge_length:
            continue
        eps = len(c) * contour_simplification_epsilon
        edges = approximate_polygon_dp(c, eps)
        if len(edges) != 4:
            continue
        edges = convex_hull(edges)
        if len(edges) != 4:
            continue
        # Min-edge gate with the reference's squared-vs-linear comparison
        # quirk (aruco.rs:149-156).
        d = edges - np.roll(edges, -1, axis=0)
        edge_sq = (d * d).sum(-1).min()
        if edge_sq < min_edge_length:
            continue
        candidates.append(edges)
    return candidates


def enforce_clockwise_corners(polys: list[np.ndarray]) -> None:
    for p in polys:
        dx1, dy1 = p[1] - p[0]
        dx2, dy2 = p[2] - p[0]
        if dx1 * dy2 - dy1 * dx2 < 0:
            p[[1, 3]] = p[[3, 1]]


def perimeter(poly: np.ndarray) -> float:
    d = poly - np.roll(poly, -1, axis=0)
    return float(np.hypot(d[:, 0], d[:, 1]).sum())


def discard_too_near(
    polys: list[np.ndarray], min_distance: float
) -> list[np.ndarray]:
    """Sequential, order-dependent suppression — exact port of reference
    aruco.rs:187-232 including its keep-bigger/first-wins behavior."""
    if not polys:
        return polys
    dead: set[int] = set()
    for i in range(len(polys) - 1):
        if i in dead:
            continue
        peri_i = perimeter(polys[i])
        for j in range(i + 1, len(polys)):
            if j in dead:
                continue
            diff = polys[i].astype(np.float64) - polys[j]
            dist = np.hypot(diff[:, 0], diff[:, 1]).sum() / 4.0
            if dist < min_distance and i not in dead:
                if peri_i >= perimeter(polys[j]):
                    dead.add(j)
                else:
                    dead.add(i)
    return [p for k, p in enumerate(polys) if k not in dead]


# --------------------------------------------------------------------------
# Warp + decode (reference aruco.rs:234-326)
# --------------------------------------------------------------------------
def warp_patch(grey: np.ndarray, quad: np.ndarray, size: int) -> np.ndarray:
    """Bilinear warp of a quad into a (size, size) patch, black default."""
    s = float(size)
    src = np.array(
        [[0.0, 0.0], [s, 0.0], [s, s], [0.0, s]], dtype=np.float64
    )
    a, b = [], []
    for (x, y), (u, v) in zip(src, quad.astype(np.float64)):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    try:
        hvec = np.linalg.solve(np.array(a), np.array(b))
    except np.linalg.LinAlgError:
        return None
    H = np.concatenate([hvec, [1.0]]).reshape(3, 3)

    ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    pts = np.stack(
        [xs, ys, np.ones_like(xs)], axis=-1
    ).reshape(-1, 3).astype(np.float64)
    sp = pts @ H.T
    wdiv = np.where(np.abs(sp[:, 2]) < 1e-12, 1e-12, sp[:, 2])
    sx = sp[:, 0] / wdiv
    sy = sp[:, 1] / wdiv

    him, wim = grey.shape
    inb = (sx >= 0) & (sx <= wim - 1) & (sy >= 0) & (sy <= him - 1)
    x0 = np.clip(np.floor(sx), 0, wim - 1).astype(np.int64)
    y0 = np.clip(np.floor(sy), 0, him - 1).astype(np.int64)
    x1 = np.minimum(x0 + 1, wim - 1)
    y1 = np.minimum(y0 + 1, him - 1)
    fx = sx - x0
    fy = sy - y0
    g = grey.astype(np.float64)
    top = g[y0, x0] * (1 - fx) + g[y0, x1] * fx
    bot = g[y1, x0] * (1 - fx) + g[y1, x1] * fx
    vals = np.where(inb, top * (1 - fy) + bot * fy, 0.0)
    return vals.reshape(size, size)


def otsu_level_np(patch: np.ndarray) -> int:
    """Crate pin (imageproc 0.25, src/contrast.rs otsu_level): maximise
    the between-class variance sigma_b^2(t) = (mu_T*omega - mu)^2 /
    (omega*(1-omega)) over the 256-bin histogram, class 0 = values <= t,
    first maximum wins.  Checkable via tests/golden/otsu.json +
    rust_validation."""
    vals = np.clip(np.round(patch), 0, 255).astype(np.int64).ravel()
    hist = np.bincount(vals, minlength=256).astype(np.float64)
    p = hist / hist.sum()
    bins = np.arange(256, dtype=np.float64)
    omega = p.cumsum()
    mu = (p * bins).cumsum()
    mu_t = mu[-1]
    den = omega * (1.0 - omega)
    num = (mu_t * omega - mu) ** 2
    sigma = np.where(den > 0, num / np.maximum(den, 1e-12), -1.0)
    return int(np.argmax(sigma))


def decode_patch(
    patch: np.ndarray, mark_size: int
) -> tuple[list[int], bool]:
    """Otsu -> Triangle resize -> border gate -> 4-rotation MSB-first read
    (reference aruco.rs:263-326).  Returns (codes[4], border_ok)."""
    level = otsu_level_np(patch)
    binar = np.where(patch > level, 255.0, 0.0)
    L = triangle_resize_matrix(patch.shape[0], mark_size)
    reduced = L @ binar @ L.T
    grid = reduced > 127.0  # True == white

    if grid[0, :].any() or grid[-1, :].any() or grid[:, 0].any() or grid[
        :, -1
    ].any():
        return [], False

    codes = []
    g = grid
    for _ in range(4):
        inner = g[1:-1, 1:-1]
        flat = inner.ravel()
        code = 0
        for bit in flat:  # MSB-first (aruco.rs:296-310)
            code = (code << 1) | int(bit)
        codes.append(code & 0xFFFFFFFFFFFFFFFF)
        g = np.rot90(g)  # 90 deg CCW (aruco.rs:315-326)
    return codes, True


def find_nearest_np(code_list: np.ndarray, code: int) -> tuple[int, int]:
    """Vectorised nearest-code scan; first-min wins like the strict-<
    update in reference dictionaries.rs:178-187."""
    x = code_list ^ np.uint64(code)
    d = np.zeros(x.shape, dtype=np.int64)
    v = x.copy()
    while v.any():
        d += (v & np.uint64(1)).astype(np.int64)
        v >>= np.uint64(1)
    idx = int(np.argmin(d))
    return idx, int(d[idx])


# --------------------------------------------------------------------------
# The oracle detector
# --------------------------------------------------------------------------
@dataclass
class OracleMarker:
    id: int
    code: int
    corners: list[tuple[int, int]]
    hamming_distance: int


@dataclass
class OracleDetector:
    """Host-side reference-pipeline detector (reference aruco.rs:46-122)."""

    dictionary: ARDictionary
    threshold_window: int = 7
    contour_simplification_epsilon: float = 0.05
    min_side_length_factor: float = 0.2
    min_corner_separation_factor: float = 0.1
    homography_sample_size: int = 49
    filter_high_bit_errors: bool = True

    def detect(self, image: np.ndarray) -> list[OracleMarker]:
        grey = np.asarray(image)
        if grey.ndim == 3:
            w = np.array([0.212671, 0.715160, 0.072169])
            grey = np.round(grey[..., :3].astype(np.float64) @ w).astype(
                np.uint8
            )
        h, w = grey.shape
        min_edge = int(min(h, w) * self.min_side_length_factor)
        min_sep = min(h, w) * self.min_corner_separation_factor

        white = adaptive_threshold_np(grey, self.threshold_window)
        contours = find_contours_np(white)
        polys = contours_to_candidates(
            contours, min_edge, self.contour_simplification_epsilon
        )
        enforce_clockwise_corners(polys)
        polys = discard_too_near(polys, min_sep)

        mark_size = self.dictionary.get_mark_size()
        markers = []
        for poly in polys:
            patch = warp_patch(grey, poly, self.homography_sample_size)
            if patch is None:
                continue
            codes, ok = decode_patch(patch, mark_size)
            if not ok:
                continue
            best = (0x7FFFFFFF, 0, 0, 0)  # (dist, id, code, rot)
            for rot, c in enumerate(codes):
                idx, dist = find_nearest_np(self.dictionary.code_list, c)
                if dist < best[0]:
                    best = (dist, idx, c, rot)
            dist, idx, c, rot = best
            if not self.filter_high_bit_errors or dist < self.dictionary.tau:
                corners = [(int(x), int(y)) for x, y in poly]
                corners = corners[rot:] + corners[:rot]
                markers.append(
                    OracleMarker(
                        id=idx,
                        code=c,
                        corners=corners,
                        hamming_distance=dist,
                    )
                )
        return markers
