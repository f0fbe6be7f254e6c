"""Benchmark reference: a frozen copy of aruco3_tpu_torch/rectify.py (with the plain version of kernel 8, ops/warp_eval.py, as ``warp_eval``).

Perspective rectification and code-bit decoding; counterpart of
``aruco3_tpu/rectify.py``.

The warp samples each candidate's S x S patch bilinearly from one 64-px
window of one pyramid level, chosen from the quad's bounding box, exactly
as the JAX package's pyramid warps choose them.  Each route samples what
the JAX TPU kernels of that route sample:

* refine route (kernel 4, ``warp_samples``): the bfloat16 chain pyramid
  of ``build_packed_pyramid`` (``level1_plane(..., chain=True)``, then
  ``upper_levels``), column weights rounded to bfloat16, row weights and
  the blend float32, as the gather warp (``warp_patches_dma``) samples;
* tail route (kernel 8, ``warp_patches_mxu``): the exact float32 pyramid
  of ``build_pyramid``, windows and column weights rounded to bfloat16,
  as the Pallas kernel ``warp_eval`` samples.

The JAX XLA warp (``warp_patches_mxu`` there) rounds its row contraction
to bfloat16 too and differs from both by up to ~2 grey.

The plain functions here are batched over a leading axis.  The on-card
warp+decode kernel (``ops.warp_decode``) computes the same samples and
cell grids in the same float32 operation order.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

WARP_WIN = 64  # window side; quads bigger than ~60 px per level go up one


# --------------------------------------------------------------------------
# Homography from control points (patch square -> image quad)
# --------------------------------------------------------------------------
def homography_square_to_quad(quads: torch.Tensor, patch_size: int):
    """Closed-form homographies mapping the patch square (0,0), (s,0),
    (s,s), (0,s) to each (..., 4, 2) quad.  Returns (H (..., 3, 3),
    valid (...,)); invalid (degenerate or non-finite) lanes get identity."""
    q = quads.to(torch.float32)
    s = float(patch_size)
    u0, u1, u2, u3 = (q[..., i, 0] for i in range(4))
    v0, v1, v2, v3 = (q[..., i, 1] for i in range(4))
    d1u = u1 - u2
    d1v = v1 - v2
    d2u = u3 - u2
    d2v = v3 - v2
    su = u0 - u1 + u2 - u3
    sv = v0 - v1 + v2 - v3
    den = d1u * d2v - d2u * d1v
    valid = torch.abs(den) > 1e-12
    den_safe = torch.where(valid, den, torch.ones_like(den))
    g = (su * d2v - sv * d2u) / den_safe
    hh = (d1u * sv - d1v * su) / den_safe
    a11 = u1 - u0 + g * u1
    a12 = u3 - u0 + hh * u3
    a13 = u0
    a21 = v1 - v0 + g * v1
    a22 = v3 - v0 + hh * v3
    a23 = v0
    inv_s = float(np.float32(1.0 / s))
    H = torch.stack(
        [
            torch.stack([a11 * inv_s, a12 * inv_s, a13], dim=-1),
            torch.stack([a21 * inv_s, a22 * inv_s, a23], dim=-1),
            torch.stack([g * inv_s, hh * inv_s, torch.ones_like(g)], dim=-1),
        ],
        dim=-2,
    )
    valid = valid & torch.isfinite(H).all(dim=-1).all(dim=-1)
    eye = torch.eye(3, dtype=torch.float32, device=q.device)
    H = torch.where(valid[..., None, None], H, eye)
    return H, valid


# --------------------------------------------------------------------------
# Pyramid
# --------------------------------------------------------------------------
def num_levels(h: int, w: int) -> int:
    """Pyramid depth the detector uses for an (h, w) frame."""
    return max(1, int(math.ceil(math.log2(max(h, w) / 60.0))) + 1)


def pyramid_level_shapes(h: int, w: int, levels: int):
    """Padded (ph, pw) per level: pad to even first, then to >= 64."""
    out = []
    for _ in range(levels):
        ph = max(h + (h % 2), WARP_WIN)
        pw = max(w + (w % 2), WARP_WIN)
        out.append((ph, pw))
        h, w = ph // 2, pw // 2
    return out


def _pad_to(img: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    h, w = img.shape[-2], img.shape[-1]
    if (h, w) == (ph, pw):
        return img
    out = img.new_zeros(img.shape[:-2] + (ph, pw))
    out[..., :h, :w] = img
    return out


def _half(padded: torch.Tensor) -> torch.Tensor:
    ph, pw = padded.shape[-2], padded.shape[-1]
    lead = padded.shape[:-2]
    return (
        padded.reshape(lead + (ph // 2, 2, pw // 2, 2)).sum(dim=(-3, -1))
        * 0.25
    )


def _half_chain(padded: torch.Tensor) -> torch.Tensor:
    """One step of the JAX package's ``build_packed_pyramid`` chain (and of
    its frontend kernel's level 1): row pairs summed in float32 and rounded
    to bfloat16, then 0.25-weighted column pairs summed in float32 and
    rounded to bfloat16.  In bfloat16 arithmetic, which adds in float32 and
    rounds once: the sums of two bfloat16 grey values are exact in
    float32, and scaling by 0.25 commutes with the rounding."""
    x = padded.to(torch.bfloat16)
    r = x[..., 0::2, :] + x[..., 1::2, :]
    return (r[..., 0::2] + r[..., 1::2]) * 0.25


def level1_plane(grey: torch.Tensor, chain: bool = False) -> torch.Tensor:
    """(B, H, W) u8 -> (B, ph0/2, pw0/2) level 1 of the zero-padded level 0:
    the exact 2x2 means in float32 (``build_pyramid``'s, the tail route's),
    or with ``chain`` the bfloat16 chain of ``build_packed_pyramid`` (the
    refine route's)."""
    h, w = grey.shape[-2], grey.shape[-1]
    (ph, pw), = pyramid_level_shapes(h, w, 1)
    if chain:
        return _half_chain(_pad_to(grey, ph, pw))
    return _half(_pad_to(grey.to(torch.float32), ph, pw))


def build_pyramid(grey: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """2x2 box-mean pyramid, float32, every level padded to even and >= 64
    (batched over leading axes)."""
    out = []
    img = grey.to(torch.float32)
    for _ in range(levels):
        h, w = img.shape[-2], img.shape[-1]
        padded = _pad_to(img, max(h + (h % 2), WARP_WIN), max(w + (w % 2), WARP_WIN))
        out.append(padded)
        img = _half(padded)
    return out


def upper_levels(level1: torch.Tensor, shapes) -> list[torch.Tensor]:
    """Padded pyramid levels 1..L-1 from the unpadded level-1 plane, each
    halved from the one below as ``level1`` was made: a bfloat16 plane by
    the chain (``build_packed_pyramid``), a float32 one by exact means
    (``build_pyramid``)."""
    half = _half_chain if level1.dtype == torch.bfloat16 else _half
    out = []
    img = level1
    for ph, pw in shapes[1:]:
        padded = _pad_to(img, ph, pw)
        out.append(padded)
        img = half(padded)
    return out


# --------------------------------------------------------------------------
# Warp: level and window choice, window-space sample coordinates
# --------------------------------------------------------------------------
def warp_windows(quads: torch.Tensor, shapes):
    """Per-lane pyramid level and 64-px window origin.

    quads (..., 4, 2).  Returns (lvl, tlx, tly), each (...,) int32: level
    from the bbox side (+4 px margin), window centred on the bbox and
    clipped into the padded level (round half to even)."""
    levels = len(shapes)
    win = WARP_WIN
    bmin = quads.amin(dim=-2)
    bmax = quads.amax(dim=-2)
    side = (bmax - bmin).amax(dim=-1) + 4.0
    lvl = torch.clamp(
        torch.ceil(torch.log2(torch.clamp(side / (win - 4.0), min=1e-3))),
        0,
        levels - 1,
    ).to(torch.int32)
    center = (bmin + bmax) * 0.5
    tlx = torch.zeros_like(lvl)
    tly = torch.zeros_like(lvl)
    for level, (hl, wl) in enumerate(shapes):
        scale = float(2**level)
        cl = (center + 0.5) / scale - 0.5
        tx = torch.clamp(
            torch.round(cl[..., 0]).to(torch.int32) - win // 2, 0, wl - win
        )
        ty = torch.clamp(
            torch.round(cl[..., 1]).to(torch.int32) - win // 2, 0, hl - win
        )
        tlx = torch.where(lvl == level, tx, tlx)
        tly = torch.where(lvl == level, ty, tly)
    return lvl, tlx, tly


def sample_coords(H: torch.Tensor, patch_size: int):
    """Image-space sample coordinates of the S x S patch grid.

    H (..., 3, 3).  Returns (sx, sy, bad), each (..., S*S); ``bad`` marks
    samples whose homogeneous w is below 1e-12 (their value is 0).  Each
    row rounds as the JAX package's float32 dot does on the CPU:
    fma(h1, y, h0 * x) + h2.  The fused step is exact in float64 (a
    float32 product with a small integer y fits in 53 bits) and rounds
    once to float32."""
    s = patch_size
    o = torch.arange(s, dtype=torch.float32, device=H.device)
    ys = o.repeat_interleave(s)
    xs = o.repeat(s)

    def row(i):
        hx = (H[..., i, 0, None] * xs).to(torch.float64)
        fused = (hx + H[..., i, 1, None].to(torch.float64) * ys.to(torch.float64))
        return fused.to(torch.float32) + H[..., i, 2, None]

    sxh, syh, wdiv = row(0), row(1), row(2)
    bad = torch.abs(wdiv) < 1e-12
    wsafe = torch.where(bad, torch.ones_like(wdiv), wdiv)
    return sxh / wsafe, syh / wsafe, bad


def window_coords(sx, sy, lvl, tlx, tly):
    """Window-space coordinates (ux, uy) of image-space samples (sx, sy)
    (..., S*S) in each lane's window: ``(s + 0.5) / 2^l - 0.5 - tl``, as
    the JAX package's ``_warp_setup`` computes them under ``jit``.  At
    level 0 XLA folds ``(s + 0.5) / 1 - 0.5`` to ``s`` (the compiled
    program computes ``s - tl``), so level 0 samples at the image
    coordinates themselves, as the gather warp does."""
    scale = torch.pow(2.0, lvl.to(torch.float32))[..., None]
    at0 = (lvl == 0)[..., None]
    ux = torch.where(at0, sx, (sx + 0.5) / scale - 0.5) - tlx[..., None].to(torch.float32)
    uy = torch.where(at0, sy, (sy + 0.5) / scale - 0.5) - tly[..., None].to(torch.float32)
    return ux, uy


def _taps(u: torch.Tensor):
    """Bilinear taps of window coordinate u: the two columns floor(u) and
    floor(u) + 1, their weights max(0, 1 - |u - j|), and whether each lies
    inside the 64-px window."""
    j0 = torch.floor(u)
    j1 = j0 + 1.0
    w0 = torch.clamp(1.0 - torch.abs(u - j0), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(u - j1), min=0.0)
    in0 = (j0 >= 0.0) & (j0 < WARP_WIN)
    in1 = (j1 >= 0.0) & (j1 < WARP_WIN)
    return j0, j1, w0, w1, in0, in1


def warp_samples(
    grey: torch.Tensor,
    uppers: list[torch.Tensor],
    H: torch.Tensor,
    lvl: torch.Tensor,
    tlx: torch.Tensor,
    tly: torch.Tensor,
    patch_size: int,
) -> torch.Tensor:
    """Bilinear patch samples, plain version of the warp kernel: column
    weights rounded to bfloat16, row weights and the blend float32, as the
    JAX gather warp (``warp_gather``'s wxT) samples.

    grey (B, H, W) u8 is level 0 (zero outside the image); uppers are the
    padded levels 1..L-1 (bfloat16, from ``level1_plane(grey, chain=True)``
    and ``upper_levels``); H (B, K, 3, 3); lvl/tlx/tly (B, K) from
    ``warp_windows``.  Returns (B, K, S*S) float32.
    """
    bsz, k = lvl.shape
    sx, sy, bad = sample_coords(H, patch_size)
    ux, uy = window_coords(sx, sy, lvl, tlx, tly)
    x0, x1, wx0, wx1, inx0, inx1 = _taps(ux)
    y0, y1, wy0, wy1, iny0, iny1 = _taps(uy)
    # The gather warp rounds the column weights to bfloat16 (its wxT) and
    # keeps the row weights float32.  A sample near a cell's Otsu level
    # decodes differently otherwise.
    wx0 = wx0.to(torch.bfloat16).to(torch.float32)
    wx1 = wx1.to(torch.bfloat16).to(torch.float32)

    vals = torch.zeros_like(ux)
    planes = [grey] + list(uppers)
    for level, plane in enumerate(planes):
        sel = lvl == level
        if not bool(sel.any()):
            continue
        ph, pw = plane.shape[-2], plane.shape[-1]
        flat = plane.reshape(bsz, -1)
        ox = tlx[..., None].to(torch.float32)
        oy = tly[..., None].to(torch.float32)

        def tap(yy, xx, iny, inx):
            r = yy + oy
            c = xx + ox
            ok = iny & inx & (r >= 0) & (r < ph) & (c >= 0) & (c < pw)
            ri = torch.where(ok, r, 0.0).to(torch.int64)
            ci = torch.where(ok, c, 0.0).to(torch.int64)
            v = flat.gather(1, (ri * pw + ci).reshape(bsz, -1)).reshape(ri.shape)
            return torch.where(ok, v.to(torch.float32), 0.0)

        v00 = tap(y0, x0, iny0, inx0)
        v01 = tap(y0, x1, iny0, inx1)
        v10 = tap(y1, x0, iny1, inx0)
        v11 = tap(y1, x1, iny1, inx1)
        top = wx0 * v00 + wx1 * v01
        bot = wx0 * v10 + wx1 * v11
        v = wy0 * top + wy1 * bot
        vals = torch.where(sel[..., None], v, vals)
    return torch.where(bad, 0.0, vals)


# --------------------------------------------------------------------------
# Warp of the detector's tail route: window slices, then kernel 8
# --------------------------------------------------------------------------
def _window_slices(planes, lvl, tlx, tly) -> torch.Tensor:
    """(B, K, 64, 64) float32: each lane's window of the plane of its level.
    Every window lies inside its padded level (``warp_windows`` clips it)."""
    ar = torch.arange(WARP_WIN, device=lvl.device)
    rows = (tly[..., None] + ar)[..., :, None]
    cols = (tlx[..., None] + ar)[..., None, :]
    bi = torch.arange(lvl.shape[0], device=lvl.device).reshape(-1, 1, 1, 1)
    out = None
    for level, plane in enumerate(planes):
        ph, pw = plane.shape[-2], plane.shape[-1]
        # Lanes of other levels read a clamped window that is not kept.
        win = plane[bi, rows.clamp(max=ph - 1), cols.clamp(max=pw - 1)].to(torch.float32)
        out = win if out is None else torch.where((lvl == level)[..., None, None], win, out)
    return out


def warp_setup(grey: torch.Tensor, level1: torch.Tensor, H: torch.Tensor, quads: torch.Tensor,
               patch_size: int):
    """Windows and window-space sample coordinates of each lane; the
    counterpart of the JAX package's ``rectify._warp_setup``.

    grey (B, H, W) u8; level1 (B, ph0/2, pw0/2) f32, the frontend's
    unpadded exact pyramid level 1; H (B, K, 3, 3); quads (B, K, 4, 2).  Returns
    (windows (B, K, 64, 64) f32, ux, uy (B, K, S*S) f32, bad (B, K, S*S)
    bool), the coordinates from ``window_coords``.  Each window is sliced
    from the plane of its
    level (level 0 is the frame, zero outside the image); the JAX package's
    row-packed buffer of all levels is a layout for the TPU and is not
    built."""
    h, w = grey.shape[-2], grey.shape[-1]
    shapes = pyramid_level_shapes(h, w, num_levels(h, w))
    lvl, tlx, tly = warp_windows(quads, shapes)
    sx, sy, bad = sample_coords(H, patch_size)
    ux, uy = window_coords(sx, sy, lvl, tlx, tly)
    planes = [_pad_to(grey, *shapes[0])] + upper_levels(level1, shapes)
    return _window_slices(planes, lvl, tlx, tly), ux, uy, bad


def warp_eval(windows: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """(N, S^2) samples of (N, 64, 64) windows at (ux, uy), the dense form
    of kernel 8: weight planes ``t = wx @ windows^T`` with wx and the
    windows rounded to bfloat16 (accumulated in float32), then the row sum
    weighted by wy, in float32."""

    def bf16(x):
        return x.to(torch.bfloat16).to(torch.float32)

    j = torch.arange(WARP_WIN, dtype=torch.float32, device=windows.device)
    wx = bf16(torch.clamp(1.0 - torch.abs(ux[..., None] - j), min=0.0))
    wy = torch.clamp(1.0 - torch.abs(uy[..., None] - j), min=0.0)
    t = torch.bmm(wx, bf16(windows).transpose(1, 2))  # t[n, s, y]
    return (wy * t).sum(dim=-1)


def warp_patches_mxu(grey: torch.Tensor, level1: torch.Tensor, H: torch.Tensor,
                     quads: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, K, S, S) float32 patches through ``warp_setup`` and kernel 8
    (``warp_eval``); samples of a degenerate homography are 0.

    The counterpart of both ``rectify.warp_patches_mxu`` and
    ``rectify.warp_patches_pallas`` of the JAX package: they share
    ``_warp_setup`` and differ only in evaluating the windows with XLA
    matmuls or with the Pallas kernel ``warp_eval``."""
    s = patch_size
    windows, ux, uy, bad = warp_setup(grey, level1, H, quads, s)
    lead = ux.shape[:-1]
    vals = warp_eval(
        windows.reshape(-1, WARP_WIN, WARP_WIN), ux.reshape(-1, s * s), uy.reshape(-1, s * s)
    )
    vals = torch.where(bad, 0.0, vals.reshape(ux.shape))
    return vals.reshape(lead + (s, s))


def warp_patches(grey: torch.Tensor, H: torch.Tensor, patch_size: int) -> torch.Tensor:
    """The gather warp (the JAX package's ``rectify.warp_patches``, its
    oracle), plain PyTorch: grey (B, H, W) u8, H (B, K, 3, 3) -> (B, K, S, S)
    float32 bilinear samples of the frame itself; samples outside
    [0, W-1] x [0, H-1] or of a degenerate homography are 0."""
    him, wim = grey.shape[-2], grey.shape[-1]
    b, k = H.shape[0], H.shape[1]
    s = patch_size
    sxp, syp, bad = sample_coords(H, s)
    inb = (sxp >= 0.0) & (sxp <= wim - 1.0) & (syp >= 0.0) & (syp <= him - 1.0) & ~bad
    x0 = torch.clamp(torch.floor(sxp), 0, wim - 1)
    y0 = torch.clamp(torch.floor(syp), 0, him - 1)
    fx = sxp - x0
    fy = syp - y0
    # Lanes outside are masked below; index them at 0 (a NaN would not cast).
    x0i = torch.where(inb, x0, 0.0).to(torch.int64)
    y0i = torch.where(inb, y0, 0.0).to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=wim - 1)
    y1i = torch.clamp(y0i + 1, max=him - 1)
    flat = grey.reshape(b, -1)

    def gather(yy, xx):
        return flat.gather(1, (yy * wim + xx).reshape(b, -1)).reshape(yy.shape).to(torch.float32)

    top = gather(y0i, x0i) * (1.0 - fx) + gather(y0i, x1i) * fx
    bot = gather(y1i, x0i) * (1.0 - fx) + gather(y1i, x1i) * fx
    vals = top * (1.0 - fy) + bot * fy
    return torch.where(inb, vals, 0.0).reshape(b, k, s, s)


# --------------------------------------------------------------------------
# Otsu threshold per patch
# --------------------------------------------------------------------------
def otsu_level(patches: torch.Tensor) -> torch.Tensor:
    """Per-patch Otsu level (K,) from (K, ...) samples in [0, 255].

    Integer 256-bin histogram of the rounded (half to even) samples; W and
    M are its exact cumulative sums; the score (MT*W - M*n)^2 / (W*(n-W))
    is evaluated in float32 and the first maximum wins."""
    k = patches.shape[0]
    vals = torch.clamp(torch.round(patches.reshape(k, -1)), 0, 255).to(
        torch.int64
    )
    n = vals.shape[1]
    hist = torch.zeros((k, 256), dtype=torch.int64, device=patches.device)
    hist.scatter_add_(1, vals, torch.ones_like(vals))
    bins = torch.arange(256, dtype=torch.int64, device=patches.device)
    w_ = torch.cumsum(hist, dim=-1).to(torch.float32)
    m_ = torch.cumsum(hist * bins, dim=-1).to(torch.float32)
    mt = m_[:, -1:]
    nf = float(n)
    den = w_ * (nf - w_)
    num = mt * w_ - m_ * nf
    sigma = torch.where(den > 0.0, (num * num) / den, -1.0)
    return torch.argmax(sigma, dim=-1).to(torch.int32)


# --------------------------------------------------------------------------
# Triangle-filter resize
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def triangle_resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) row-stochastic Triangle resampling matrix with the image
    crate's semantics (centres at i+0.5, support scaled by the downscale
    ratio, weights normalised per output pixel)."""
    ratio = src / dst
    scale = max(ratio, 1.0)
    support = 1.0 * scale
    L = np.zeros((dst, src), dtype=np.float32)
    for o in range(dst):
        center = (o + 0.5) * ratio
        lo = max(int(np.floor(center - support)), 0)
        hi = min(int(np.ceil(center + support)), src - 1)
        for i in range(lo, hi + 1):
            t = abs((i + 0.5 - center) / scale)
            L[o, i] = max(0.0, 1.0 - t)
        srow = L[o].sum()
        if srow > 0:
            L[o] /= srow
    return L


def resize_triangle(patches: torch.Tensor, dst: int) -> torch.Tensor:
    """(K, S, S) -> (K, dst, dst) separable Triangle resize: rows first,
    then columns, each a float32 sum over the filter's nonzero taps in
    ascending order (the warp kernel sums in the same order)."""
    src = patches.shape[-1]
    L = triangle_resize_matrix(src, dst)

    def contract(x, axis):
        outs = []
        for o in range(dst):
            acc = None
            for i in np.nonzero(L[o])[0]:
                term = x.select(axis, int(i)) * float(L[o, i])
                acc = term if acc is None else acc + term
            outs.append(acc)
        return torch.stack(outs, dim=axis)

    return contract(contract(patches, 1), 2)


# --------------------------------------------------------------------------
# Bit extraction
# --------------------------------------------------------------------------
def otsu_cells(patches: torch.Tensor, mark_size: int):
    """(K, S, S) samples -> (Otsu levels (K,) int32, white-cell grids
    (K, m*m) bool): binarize to 0/255 with ``> level``, Triangle resize,
    ``> 127``."""
    levels = otsu_level(patches)
    binar = torch.where(
        patches > levels[:, None, None].to(torch.float32), 255.0, 0.0
    )
    reduced = resize_triangle(binar, mark_size)
    return levels, (reduced > 127.0).reshape(patches.shape[0], -1)


def decode_grids(grids: torch.Tensor, mark_size: int):
    """(K, >= m*m) white-cell grids -> (bits, border valid)."""
    k = grids.shape[0]
    m = mark_size
    return _grid_tail(grids[:, : m * m].reshape(k, m, m) != 0, m)


def decode_patches(patches: torch.Tensor, mark_size: int):
    """(K, S, S) samples -> (bits (K, 4, nb) int32 LSB-indexed, one per
    90-degree CCW rotation; valid (K,) False when a border cell is white)."""
    return decode_grids(otsu_cells(patches, mark_size)[1], mark_size)


def _grid_tail(grid: torch.Tensor, mark_size: int):
    k = grid.shape[0]
    border = torch.cat(
        [grid[:, 0, :], grid[:, -1, :], grid[:, :, 0], grid[:, :, -1]],
        dim=-1,
    )
    valid = ~border.any(dim=-1)
    inner = grid[:, 1:-1, 1:-1]
    rots = torch.stack(
        [torch.rot90(inner, r, dims=(1, 2)) for r in range(4)], dim=1
    )
    nb = (mark_size - 2) * (mark_size - 2)
    flat = rots.reshape(k, 4, nb)
    bits = torch.flip(flat, dims=(-1,)).to(torch.int32)
    return bits, valid


@functools.lru_cache(maxsize=None)
def code_word_weights(num_bits: int, device: torch.device) -> torch.Tensor:
    """(2, num_bits) int64 weights of ``bits_to_u32_pairs`` on ``device``,
    built once per device: bit i weighs 2^(i % 32) in word i // 32."""
    idx = np.arange(num_bits)
    w = np.stack([np.where(idx < 32, 1 << (idx % 32), 0), np.where(idx >= 32, 1 << (idx % 32), 0)])
    return torch.from_numpy(w.astype(np.int64)).to(device)


def bits_to_u32_pairs(bits: torch.Tensor) -> torch.Tensor:
    """(..., num_bits) {0,1} -> (..., 2) int64 holding the (lo, hi) uint32
    code words."""
    lo_w, hi_w = code_word_weights(bits.shape[-1], bits.device)
    b = bits.to(torch.int64)
    return torch.stack([(b * lo_w).sum(-1), (b * hi_w).sum(-1)], dim=-1)
