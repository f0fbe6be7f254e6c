"""Data-parallel quad-candidate extraction; counterpart of
``aruco3_tpu/segment.py``.

Every function here is the plain PyTorch version of its JAX counterpart,
batched over any leading axes (the JAX package vmaps the single-frame
function; here the batch axis is written out).  ``jax.lax.fori_loop``
becomes a Python loop; the round counts are the same, so the floods and
the labelling are the same round-limited algorithm, not a converged one.

On the card, ``label_planes`` is kernel 2 (``ops.coarse_fit``, labels
mode, or fit mode together with ``fit_quads``), ``rank_pool`` and
``fit_lanes`` are kernels 5 and 6 and the fit of both planes kernel 7
(``ops.fit``), and the window search of ``refine_windows`` is kernel 3
(``ops.refine``); each is held bit-equal to the functions here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class QuadParams:
    """Static quad-extraction hyper-parameters (see the JAX package)."""

    max_candidates: int = 32
    coarse_factor: int = 8
    ccl_rounds: int = 3
    fill_rounds: int = 5
    min_component_px: int = 3
    containment_slack: float = 1.5
    min_containment: float = 0.80
    open_radius: int = 2
    refine_window: int = 0  # 0 = auto from coarse factor
    refine: bool = True
    max_inner_candidates: int = 12
    bg_rounds: int = 6
    inner_depths: int = 3
    inner_flood_rounds: int = 3
    inner_fill_rounds: int = 4
    inner_ccl_rounds: int = 3


# Pre-merge inner-duplicate gate, in coarse-cell units (see merge_fits).
INNER_DUP_CHEBYSHEV_DS = 2.0

# Offsets whose same-label count from a component root reaches t - 1 iff
# the 4-connected component has >= t cells (see the JAX package's proof).
ADMIT_OFFSETS = {
    2: ((0, 1), (1, 0)),
    3: ((0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (2, 0)),
}


def choose_coarse_factor(h: int, w: int, target: int = 192) -> int:
    """Pooling factor so the coarse grid's long side is ~target."""
    return max(1, int(np.ceil(max(h, w) / target)))


def rank_pool_size(k: int, p: int) -> int:
    """Size of the raster-ranked root pool that ``fit_quads`` sizes before
    its top-k (KR in the JAX package)."""
    return max(k, min(p, max(4 * k, 64, min(p // 16, 1024))))


# --------------------------------------------------------------------------
# Coarse mask + connected-component labelling
# --------------------------------------------------------------------------
def _pad1(m: torch.Tensor, value) -> torch.Tensor:
    """Pad the last two axes by one cell of ``value``."""
    shape = list(m.shape)
    shape[-2] += 2
    shape[-1] += 2
    out = m.new_full(shape, value)
    out[..., 1:-1, 1:-1] = m
    return out


def _neighbours3(m: torch.Tensor, value, op) -> torch.Tensor:
    h, w = m.shape[-2], m.shape[-1]
    p = _pad1(m, value)
    out = m
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out = op(out, p[..., dy : dy + h, dx : dx + w])
    return out


def _erode3(m: torch.Tensor) -> torch.Tensor:
    return _neighbours3(m, True, torch.logical_and)


def _dilate3(m: torch.Tensor) -> torch.Tensor:
    return _neighbours3(m, False, torch.logical_or)


def open_mask(mask: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Morphological opening with a (2r+1)^2 square (erode pads True,
    dilate pads False)."""
    out = mask
    for _ in range(radius):
        out = _erode3(out)
    for _ in range(radius):
        out = _dilate3(out)
    return out


def near_mask(black: torch.Tensor) -> torch.Tensor:
    """Opened black dilated twice by 3x3: where refinement looks for ink."""
    return _dilate3(_dilate3(black))


def pool_black(black: torch.Tensor, ds: int) -> torch.Tensor:
    """(..., H, W) bool -> (..., ceil(H/ds), ceil(W/ds)) bool; a coarse
    cell is black when count * 2 >= max(ds, 2) (padding is False)."""
    h, w = black.shape[-2], black.shape[-1]
    hp = -(-h // ds) * ds
    wp = -(-w // ds) * ds
    lead = black.shape[:-2]
    m = black.new_zeros(lead + (hp, wp), dtype=torch.int32)
    m[..., :h, :w] = black.to(torch.int32)
    pooled = m.reshape(lead + (hp // ds, ds, wp // ds, ds)).sum(dim=(-3, -1))
    return pooled * 2 >= max(ds, 2)


def _segmented_min_scan(l, mask, sentinel: int, dim: int):
    """Bidirectional segmented running-min along ``dim`` by doubling: each
    in-mask element gets the min over its contiguous in-mask run;
    out-of-mask elements come back as the sentinel."""
    n = l.shape[dim]
    shape = [1] * l.ndim
    shape[dim] = -1
    idx = torch.arange(n, device=l.device).reshape(shape)
    sent = torch.full((), sentinel, dtype=l.dtype, device=l.device)

    lf = lb = torch.where(mask, l, sent)
    bf = bb = ~mask
    shift = 1
    while shift < n:
        sl = torch.roll(lf, shift, dims=dim)
        sb = torch.roll(bf, shift, dims=dim)
        wrap = idx < shift
        sl = torch.where(wrap, sent, sl)
        sb = sb | wrap
        lf = torch.where(bf, lf, torch.minimum(lf, sl))
        bf = bf | sb

        sl = torch.roll(lb, -shift, dims=dim)
        sb = torch.roll(bb, -shift, dims=dim)
        wrap = idx >= n - shift
        sl = torch.where(wrap, sent, sl)
        sb = sb | wrap
        lb = torch.where(bb, lb, torch.minimum(lb, sl))
        bb = bb | sb
        shift *= 2
    return torch.where(mask, torch.minimum(lf, lb), sent)


_OFFS8 = [(dy, dx) for dy in (0, 1, 2) for dx in (0, 1, 2) if (dy, dx) != (1, 1)]
_OFFS4 = [(0, 1), (2, 1), (1, 0), (1, 2)]


def flood(
    medium: torch.Tensor, seed: torch.Tensor, rounds: int, diag: bool = True
) -> torch.Tensor:
    """Cells of ``medium`` connected to ``seed & medium`` through it, after
    ``rounds`` rounds of neighbour-OR + row transport + column transport
    (8-connected when ``diag``, else 4-connected)."""
    hc, wc = medium.shape[-2], medium.shape[-1]
    reach = medium & seed
    offs = _OFFS8 if diag else _OFFS4
    one = torch.ones((), dtype=torch.int32, device=medium.device)
    zero = torch.zeros((), dtype=torch.int32, device=medium.device)
    for _ in range(rounds):
        r = reach
        pads = _pad1(r, False)
        for dy, dx in offs:
            r = r | pads[..., dy : dy + hc, dx : dx + wc]
        r = r & medium
        v = torch.where(r, zero, one)
        v = _segmented_min_scan(v, medium, 2, dim=-1)
        r = medium & (v == 0)
        v = torch.where(r, zero, one)
        v = _segmented_min_scan(v, medium, 2, dim=-2)
        reach = medium & (v == 0)
    return reach


def _border(m: torch.Tensor) -> torch.Tensor:
    border = torch.zeros_like(m)
    border[..., 0, :] = True
    border[..., -1, :] = True
    border[..., :, 0] = True
    border[..., :, -1] = True
    return border


def flood_from_border(
    medium: torch.Tensor, rounds: int, diag: bool = True
) -> torch.Tensor:
    """Cells of ``medium`` connected to the grid border through it."""
    return flood(medium, _border(medium), rounds, diag=diag)


def fill_holes(black: torch.Tensor, rounds: int) -> torch.Tensor:
    """White cells not reachable from the border through white become
    black (8-connected white)."""
    white = ~black
    reach = flood_from_border(white, rounds)
    return black | (white & ~reach)


def label_components(black: torch.Tensor, rounds: int) -> torch.Tensor:
    """Round-limited 4-connected CCL: each black cell holds the minimum
    linear index its labels reached (the component root once converged);
    white cells hold the sentinel Hc*Wc.  One round = 4-neighbour min of
    the previous plane, then full row-run min, then full column-run min."""
    hc, wc = black.shape[-2], black.shape[-1]
    p = hc * wc
    idx = torch.arange(p, dtype=torch.int32, device=black.device).reshape(
        hc, wc
    )
    sent = torch.full((), p, dtype=torch.int32, device=black.device)
    lbl = torch.where(black, idx, sent)
    for _ in range(rounds):
        pads = _pad1(lbl, p)
        m = lbl
        for dy, dx in _OFFS4:
            m = torch.minimum(m, pads[..., dy : dy + hc, dx : dx + wc])
        lbl = torch.where(black, m, sent)
        lbl = _segmented_min_scan(lbl, black, p, dim=-1)
        lbl = _segmented_min_scan(lbl, black, p, dim=-2)
    return lbl


def label_planes(coarse: torch.Tensor, params: QuadParams):
    """Outer + inner label planes for (..., Hc, Wc) bool coarse masks.

    Outer: hole-filled plane, CCL.  Inner: depth-peeled labels of the
    non-border-connected black (see the JAX package for the derivation).
    """
    filled1 = fill_holes(coarse, params.fill_rounds)
    labels = label_components(filled1, params.ccl_rounds)
    hc, wc = coarse.shape[-2], coarse.shape[-1]
    sent = hc * wc
    if params.max_inner_candidates <= 0:
        return labels, torch.full_like(labels, sent)

    white = ~coarse
    bg = flood_from_border(coarse, params.bg_rounds, diag=False)
    m2 = coarse & ~bg
    seed0 = (_border(white) | _dilate3(bg)) & white
    known = flood(white, seed0, params.fill_rounds)

    level0 = flood(
        m2, m2 & _dilate3(known), params.inner_flood_rounds, diag=False
    )
    idx = torch.arange(sent, dtype=torch.int32, device=coarse.device)
    roots_ok = level0 & (labels == idx.reshape(hc, wc))
    ok = level0 & flood(filled1, roots_ok, params.ccl_rounds, diag=False)
    labels2 = torch.where(ok, labels, torch.full_like(labels, sent))
    remaining = m2 & ~ok
    known = flood(
        white,
        known | (_dilate3(level0) & white),
        params.inner_flood_rounds,
    )
    for _ in range(1, params.inner_depths):
        # An exhausted peel leaves the labels as they are (the JAX
        # package skips it at run time too).
        if not bool(remaining.any()):
            break
        level = flood(
            remaining,
            remaining & _dilate3(known),
            params.inner_flood_rounds,
            diag=False,
        )
        notlev = ~level
        reach_o = flood(notlev, known & notlev, params.inner_fill_rounds)
        lab = label_components(~reach_o, params.inner_ccl_rounds)
        labels2 = torch.where(level, lab, labels2)
        remaining = remaining & ~level
        known = flood(
            white,
            known | (_dilate3(level) & white),
            params.inner_flood_rounds,
        )
    return labels, labels2


# --------------------------------------------------------------------------
# Component selection + quad fitting
# --------------------------------------------------------------------------
def _masked_argmax(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """First index of the maximum over the masked entries (0 if none)."""
    neg = torch.full((), float("-inf"), dtype=score.dtype, device=score.device)
    return torch.argmax(torch.where(mask, score, neg), dim=-1)


def _stable_topk_desc(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, equal values in index order (the
    tie order of ``jax.lax.top_k``)."""
    return torch.sort(values, dim=-1, descending=True, stable=True).indices[
        ..., :k
    ]


def rank_pool(labels: torch.Tensor, kr: int, min_px: int):
    """The raster rank pool of (B, Hc, Wc) label planes (plain version of
    kernel 5, ``ops.fit.rank_roots``).

    A root is a cell that holds its own index and passes the admission
    pre-filter (same-label count at ``ADMIT_OFFSETS``, wrapping around the
    grid).  Returns roots_r (B, kr) int32, the root of raster rank j (0
    after the last); sizes_r (B, kr) int32, its member count (-1 after the
    last); n_roots (B,) int32, the number of admitted roots.
    """
    bsz, hc, wc = labels.shape
    dev = labels.device
    p = hc * wc
    flat = labels.reshape(bsz, p)
    idx = torch.arange(p, dtype=torch.int32, device=dev)

    is_root = flat == idx
    t = min(int(min_px), 3)
    if t > 1:
        cnt = torch.zeros_like(labels)
        for dy, dx in ADMIT_OFFSETS[t]:
            sh = torch.roll(labels, shifts=(-dy, -dx), dims=(-2, -1))
            cnt = cnt + (sh == labels).to(torch.int32)
        is_root = is_root & (cnt.reshape(bsz, p) >= t - 1)
    rank = torch.cumsum(is_root.to(torch.int32), dim=-1) - 1
    n_roots = is_root.sum(dim=-1, dtype=torch.int32)
    # Pool slot j < KR holds the root of raster rank j (0 when unused);
    # every other cell writes the spill slot KR, which is dropped.
    pooled = is_root & (rank < kr)
    roots_r = torch.zeros((bsz, kr + 1), dtype=torch.int64, device=dev)
    slot = torch.where(pooled, rank, kr).to(torch.int64)
    roots_r.scatter_(1, slot, idx.to(torch.int64).expand(bsz, p))
    roots_r = roots_r[:, :kr]
    used_r = torch.arange(kr, device=dev) < n_roots[:, None]

    counts = torch.zeros((bsz, p + 1), dtype=torch.int32, device=dev)
    counts.scatter_add_(
        1, flat.to(torch.int64), torch.ones_like(flat, dtype=torch.int32)
    )
    sizes_r = torch.where(used_r, counts.gather(1, roots_r), -1)
    return roots_r.to(torch.int32), sizes_r, n_roots


def select_lanes(roots_r: torch.Tensor, sizes_r: torch.Tensor, k: int):
    """Top-k of a rank pool by size, equal sizes in pool order (which is
    root order): (roots, sizes) (B, k) int32, size -1 on unused lanes."""
    sel = _stable_topk_desc(sizes_r, k)
    return roots_r.gather(1, sel), sizes_r.gather(1, sel)


def fit_lanes(
    labels: torch.Tensor,
    roots: torch.Tensor,
    sizes: torch.Tensor,
    use: torch.Tensor,
    ds: int,
    containment_slack: float,
):
    """The per-lane fit chain (plain version of kernel 6,
    ``ops.fit.fit_lanes``).

    labels (B, Hc, Wc) int32; roots, sizes (B, K) int32 (sizes >= 0); use
    (B, K) bool.  Returns quads (B, K, 4, 2) f32 full-res (x, y), centroids
    (B, K, 2) f32 and the containment fraction frac (B, K) f32; lanes not
    in ``use`` come back as zeros.
    """
    bsz, hc, wc = labels.shape
    dev = labels.device
    p = hc * wc
    flat = labels.reshape(bsz, p)
    idx = torch.arange(p, dtype=torch.int32, device=dev)
    member = (flat[:, None, :] == roots[:, :, None]) & use[:, :, None]

    cy = (idx // wc).to(torch.float32) * ds + (ds - 1) * 0.5
    cx = (idx % wc).to(torch.float32) * ds + (ds - 1) * 0.5

    szf = torch.clamp(sizes.to(torch.float32), min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cenx = torch.where(member, cx, zero).sum(dim=-1) / szf
    ceny = torch.where(member, cy, zero).sum(dim=-1) / szf

    def d2(x0, y0):
        dxx = cx - x0[..., None]
        dyy = cy - y0[..., None]
        return dxx * dxx + dyy * dyy

    ia = _masked_argmax(d2(cenx, ceny), member)
    ax, ay = cx[ia], cy[ia]
    ic = _masked_argmax(d2(ax, ay), member)
    qcx, qcy = cx[ic], cy[ic]
    dx = qcx - ax
    dy = qcy - ay
    cross = (cx - ax[..., None]) * dy[..., None] - (
        cy - ay[..., None]
    ) * dx[..., None]
    ib = _masked_argmax(cross, member)
    idd = _masked_argmax(-cross, member)
    bx, by = cx[ib], cy[ib]
    ddx, ddy = cx[idd], cy[idd]
    quads = torch.stack(
        [
            torch.stack([ax, ay], dim=-1),
            torch.stack([bx, by], dim=-1),
            torch.stack([qcx, qcy], dim=-1),
            torch.stack([ddx, ddy], dim=-1),
        ],
        dim=-2,
    )  # (B, K, 4, 2)

    # Containment in the expanded per-edge form of the JAX package.
    slack = containment_slack * ds
    e_from = quads
    e_to = torch.roll(quads, -1, dims=-2)
    ex = e_to[..., 0] - e_from[..., 0]  # (B, K, 4)
    ey = e_to[..., 1] - e_from[..., 1]
    elen = torch.sqrt(ex * ex + ey * ey) + 1e-6
    terms = e_from[..., 0] * e_to[..., 1] - e_to[..., 0] * e_from[..., 1]
    area2 = ((terms[..., 0] + terms[..., 1]) + terms[..., 2]) + terms[..., 3]
    sgn = torch.where(area2 >= 0, 1.0, -1.0)
    av = sgn[..., None] * ex
    bv = sgn[..., None] * ey
    c0 = bv * e_from[..., 0] - av * e_from[..., 1]
    rhs = -slack * elen - c0
    inside = None
    for e in range(4):
        cmp = cy * av[..., e, None] - cx * bv[..., e, None] >= rhs[..., e, None]
        inside = cmp if inside is None else inside & cmp
    one = torch.ones((), dtype=torch.float32, device=dev)
    frac = torch.where(member & inside, one, zero).sum(dim=-1) / szf
    quads = torch.where(use[..., None, None], quads, zero)
    return quads, torch.stack([cenx, ceny], dim=-1), frac


def twin_lanes(fit: dict, roots: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """(B, K) lanes whose (root, size) equal those of a valid lane of
    ``fit``: the same cell set, which ``merge_fits`` drops as a twin."""
    return (
        (roots[:, :, None] == fit["roots"][:, None, :])
        & (sizes[:, :, None] == fit["sizes"][:, None, :])
        & fit["valid"][:, None, :]
    ).any(dim=-1)


def lane_fits(quads, centroids, frac, roots, sizes, n_roots, params: QuadParams):
    """The fit dict of selected lanes (sizes -1 on unused lanes)."""
    sizes_pos = torch.clamp(sizes, min=0)
    valid = (
        (sizes >= 0)
        & (sizes_pos >= params.min_component_px)
        & (frac >= params.min_containment)
    )
    return {
        "quads": quads,
        "valid": valid,
        "roots": roots,
        "centroids": centroids,
        "sizes": sizes_pos,
        "qualifying": n_roots,
    }


def fit_quads(
    labels: torch.Tensor,
    ds: int,
    params: QuadParams,
    k: int | None = None,
    skip_twins_of: dict | None = None,
):
    """Top-K components of (B, Hc, Wc) label planes -> fitted quads.

    Returns a dict with leading axis B: quads (K, 4, 2) f32 full-res
    (x, y); valid (K,) bool; roots (K,) int32; centroids (K, 2) f32;
    sizes (K,) int32; qualifying () int32.  Unused lanes have zero quads.
    ``skip_twins_of``: a fit whose valid lanes' twins (``twin_lanes``) are
    not fitted and come back as zeros, as the fused fit kernel's dup skip
    leaves them.
    """
    p = labels.shape[-2] * labels.shape[-1]
    k = params.max_candidates if k is None else k
    roots_r, sizes_r, n_roots = rank_pool(
        labels, rank_pool_size(k, p), params.min_component_px
    )
    roots, sizes = select_lanes(roots_r, sizes_r, k)
    use = sizes >= 0
    sizes_pos = torch.clamp(sizes, min=0)
    if skip_twins_of is not None:
        use = use & ~twin_lanes(skip_twins_of, roots, sizes_pos)
    quads, centroids, frac = fit_lanes(
        labels, roots, sizes_pos, use, ds, params.containment_slack
    )
    return lane_fits(quads, centroids, frac, roots, sizes, n_roots, params)


def inner_footprint(labels2: torch.Tensor) -> torch.Tensor:
    """Dilated footprint of the inner label plane (sentinel = grid size)."""
    p = labels2.shape[-2] * labels2.shape[-1]
    return _dilate3(labels2 < p)


# --------------------------------------------------------------------------
# Full-resolution corner refinement
# --------------------------------------------------------------------------
def refine_window_size(params: QuadParams, ds: int) -> int:
    return params.refine_window or min(64, max(12, 2 * ds + 8))


def corner_dirs(quads: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Unit centroid->corner directions (B, K, 4, 2), +1e-6 in the norm."""
    d = quads - centroids[..., None, :]
    nrm = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    return d / (nrm + 1e-6)[..., None]


def window_origins(quads: torch.Tensor, h: int, w: int, wn: int):
    """Refinement window top-left (x, y) per corner, int64: round half to
    even, minus wn // 2, clipped into the image."""
    tlx = torch.clamp(
        torch.round(quads[..., 0]).to(torch.int64) - wn // 2, 0, max(w - wn, 0)
    )
    tly = torch.clamp(
        torch.round(quads[..., 1]).to(torch.int64) - wn // 2, 0, max(h - wn, 0)
    )
    return tlx, tly


def refine_windows(
    near: torch.Tensor,
    quads: torch.Tensor,
    centroids: torch.Tensor,
    ds: int,
    window: int,
    grey: torch.Tensor | None = None,
    inner_coarse: torch.Tensor | None = None,
    is_inner: torch.Tensor | None = None,
) -> torch.Tensor:
    """The window search of the JAX package's ``refine_corners`` given the
    near mask: each coarse corner snaps to the extreme full-res ink pixel
    within Chebyshev distance ds+2.

    near (B, H, W) bool; quads (B, K, 4, 2); centroids (B, K, 2);
    grey (B, H, W) u8 or None; inner_coarse (B, Hc, Wc) bool or None;
    is_inner (B, K) bool.  Returns refined quads (B, K, 4, 2) for every
    lane.
    """
    bsz, h, w = near.shape
    wn = window
    clamp_r = float(ds + 2)
    dev = near.device
    dirs = corner_dirs(quads, centroids)
    tlx, tly = window_origins(quads, h, w, wn)
    o = torch.arange(wn, device=dev)
    rows = tly[..., None, None] + o[:, None]  # (B, K, 4, wn, 1)
    cols = tlx[..., None, None] + o[None, :]  # (B, K, 4, 1, wn)
    rows, cols = torch.broadcast_tensors(rows, cols)
    # A frame smaller than the window: its pixels past the image are
    # neither summed nor ink (the mean still divides by wn * wn).
    inside = (rows < h) & (cols < w)
    rows, cols = rows.clamp(max=h - 1), cols.clamp(max=w - 1)
    flat_idx = (rows * w + cols).reshape(bsz, -1)
    shape = rows.shape

    def take(plane):
        return plane.reshape(bsz, -1).gather(1, flat_idx).reshape(shape)

    nearw = take(near) & inside
    if inner_coarse is not None:
        wcc = inner_coarse.shape[-1]
        cidx = ((rows // ds) * wcc + cols // ds).reshape(bsz, -1)
        up = inner_coarse.reshape(bsz, -1).gather(1, cidx).reshape(shape)
        inner_bit = nearw & up
        nearw = torch.where(is_inner[..., None, None, None], inner_bit, nearw)
    if grey is not None:
        g = torch.where(inside, take(grey).to(torch.float32), 0.0)
        mean = g.sum(dim=(-2, -1)) / float(wn * wn)
        ink = (g < mean[..., None, None]) & nearw
    else:
        ink = nearw
    xx = cols.to(torch.float32)
    yy = rows.to(torch.float32)
    near_corner = (torch.abs(xx - quads[..., 0, None, None]) <= clamp_r) & (
        torch.abs(yy - quads[..., 1, None, None]) <= clamp_r
    )
    ok = ink & near_corner
    score = xx * dirs[..., 0, None, None] + yy * dirs[..., 1, None, None]
    neg = torch.full((), float("-inf"), device=dev)
    score = torch.where(ok, score, neg).flatten(-2)
    best = torch.argmax(score, dim=-1)
    has = ok.flatten(-2).any(dim=-1)
    bx = (tlx + best % wn).to(torch.float32)
    by = (tly + best // wn).to(torch.float32)
    refined = torch.stack([bx, by], dim=-1)
    return torch.where(has[..., None], refined, quads)


# --------------------------------------------------------------------------
# Geometry filters
# --------------------------------------------------------------------------
def enforce_clockwise(quads: torch.Tensor) -> torch.Tensor:
    """Swap corners 1 and 3 of quads counter-clockwise in y-down space."""
    d1 = quads[..., 1, :] - quads[..., 0, :]
    d2 = quads[..., 2, :] - quads[..., 0, :]
    cross = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    swapped = quads[..., [0, 3, 2, 1], :]
    return torch.where((cross < 0)[..., None, None], swapped, quads)


def min_edge_gate(quads: torch.Tensor, min_edge_length: float) -> torch.Tensor:
    """The reference's quirk: squared min edge vs the linear threshold."""
    d = torch.roll(quads, -1, dims=-2) - quads
    edge_sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    return edge_sq.amin(dim=-1) >= min_edge_length


def _edge_norms(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def perimeter(quads: torch.Tensor) -> torch.Tensor:
    n = _edge_norms(torch.roll(quads, -1, dims=-2) - quads)
    return ((n[..., 0] + n[..., 1]) + n[..., 2]) + n[..., 3]


def discard_too_near(
    quads: torch.Tensor, valid: torch.Tensor, min_distance: float
) -> torch.Tensor:
    """Drop a quad iff a larger (or equal-but-earlier) valid quad lies
    within ``min_distance`` mean corner distance, minimised over cyclic
    corner shifts.  quads (..., K, 4, 2), valid (..., K)."""
    mean_d = None
    for r in range(4):
        rolled = torch.roll(quads, r, dims=-2)
        diff = rolled[..., :, None, :, :] - quads[..., None, :, :, :]
        n = _edge_norms(diff)
        d = (((n[..., 0] + n[..., 1]) + n[..., 2]) + n[..., 3]) / 4.0
        mean_d = d if mean_d is None else torch.minimum(mean_d, d)
    peri = perimeter(quads)
    k = quads.shape[-3]
    ii = torch.arange(k, device=quads.device)
    near = (mean_d < min_distance) & valid[..., :, None] & valid[..., None, :]
    near = near & (ii[:, None] != ii[None, :])
    bigger = (peri[..., :, None] > peri[..., None, :]) | (
        (peri[..., :, None] == peri[..., None, :]) & (ii[:, None] < ii[None, :])
    )
    killed = (near & bigger).any(dim=-2)
    return valid & ~killed


def merge_fits(fit: dict, fit2: dict | None, params: QuadParams, ds: int):
    """Merge the outer/inner fits (leading batch axis) into K candidate
    lanes: same-marker inner duplicates die first, then size priority with
    the outer pass winning exact ties."""
    k1 = params.max_candidates
    k2 = params.max_inner_candidates
    overflow = torch.clamp(fit["qualifying"] - k1, min=0)
    if k2 <= 0:
        return {
            "quads": fit["quads"],
            "valid": fit["valid"],
            "sizes": fit["sizes"],
            "centroids": fit["centroids"],
            "is_inner": torch.zeros_like(fit["valid"]),
            "overflow": overflow,
        }
    overflow = overflow + torch.clamp(fit2["qualifying"] - k2, min=0)
    best = None
    for s in range(4):
        q2s = torch.roll(fit2["quads"], s, dims=-2)
        dist = torch.abs(q2s[:, :, None] - fit["quads"][:, None]).amax(
            dim=(-2, -1)
        )
        best = dist if best is None else torch.minimum(best, dist)
    dup = (best <= INNER_DUP_CHEBYSHEV_DS * ds) & fit["valid"][:, None, :]
    twin = twin_lanes(fit, fit2["roots"], fit2["sizes"])
    valid2 = fit2["valid"] & ~(dup.any(dim=-1) | twin)

    quads_c = torch.cat([fit["quads"], fit2["quads"]], dim=1)
    valid_c = torch.cat([fit["valid"], valid2], dim=1)
    sizes_c = torch.cat([fit["sizes"], fit2["sizes"]], dim=1)
    cents_c = torch.cat([fit["centroids"], fit2["centroids"]], dim=1)
    prio = torch.cat(
        [
            torch.ones(k1, dtype=torch.int32, device=valid_c.device),
            torch.zeros(k2, dtype=torch.int32, device=valid_c.device),
        ]
    )
    key = torch.where(valid_c, sizes_c * 2 + prio + 1, 0)
    sel = _stable_topk_desc(key, k1)
    quads = quads_c.gather(1, sel[..., None, None].expand(-1, -1, 4, 2))
    valid = valid_c.gather(1, sel)
    sizes = sizes_c.gather(1, sel)
    centroids = cents_c.gather(1, sel[..., None].expand(-1, -1, 2))
    n_valid = valid_c.sum(dim=-1, dtype=torch.int32)
    overflow = overflow + torch.clamp(
        n_valid - valid.sum(dim=-1, dtype=torch.int32), min=0
    )
    return {
        "quads": quads,
        "valid": valid,
        "sizes": sizes,
        "centroids": centroids,
        "is_inner": sel >= k1,
        "overflow": overflow,
    }


def finalize_quads(
    quads: torch.Tensor,
    valid: torch.Tensor,
    sizes: torch.Tensor,
    overflow: torch.Tensor,
    params: QuadParams,
    min_edge_length: float,
    min_corner_separation: float,
):
    """Post-refinement geometry gates + the per-stage rejection counters
    (batched over leading axes)."""
    quads = enforce_clockwise(quads)
    v_size = sizes >= params.min_component_px
    v_contain = valid
    edge_ok = min_edge_gate(quads, min_edge_length)
    valid = valid & edge_ok
    v_before_near = valid
    valid = discard_too_near(quads, valid, min_corner_separation)

    def count(m):
        return m.sum(dim=-1, dtype=torch.int32)

    stats = {
        "components": count(v_size),
        "components_overflow": overflow,
        "reject_containment": count(v_size & ~v_contain),
        "reject_edge_length": count(v_contain & ~edge_ok),
        "reject_too_near": count(v_before_near & ~valid),
        "candidates": count(valid),
    }
    return quads, valid, stats


def fit_planes(coarse: torch.Tensor, params: QuadParams, ds: int):
    """(B, Hc, Wc) coarse masks -> (labels, fit1, fit2, inner_coarse):
    ``label_planes``, ``fit_quads`` on both planes and the dilated inner
    footprint, which is what the coarse kernel computes.  ``fit2`` is None
    and the footprint empty when ``max_inner_candidates`` is 0."""
    labels, labels2 = label_planes(coarse, params)
    fit1 = fit_quads(labels, ds, params, k=params.max_candidates)
    k2 = params.max_inner_candidates
    if k2 <= 0:
        return labels, fit1, None, torch.zeros_like(coarse)
    fit2 = fit_quads(labels2, ds, params, k=k2)
    return labels, fit1, fit2, inner_footprint(labels2)
