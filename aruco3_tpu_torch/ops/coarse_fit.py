"""Kernel 2 wrapper: both label planes and their quad fits.

``coarse_fit`` launches ``csrc/coarse_fit.cu`` on CUDA tensors and runs
``plain`` on CPU tensors.  For (B, Hc, Wc) bool coarse masks both return
``(fit1, fit2, inner_coarse)``: the outer and inner fits as
``segment.fit_quads`` returns them (quads, valid, roots, centroids, sizes,
qualifying, each with a leading batch axis), and the dilated footprint of
the inner label plane, (B, Hc, Wc) bool.  ``fit2`` is None when
``max_inner_candidates`` is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import segment
from . import _build

launches = 0
plain_calls = 0

# Lane and rank-pool capacities the kernel's shared arrays hold.
MAX_LANES = 128
MAX_POOL = 1024


def plain(coarse: torch.Tensor, params: segment.QuadParams, ds: int):
    """``segment.fit_planes`` without the outer label plane."""
    global plain_calls
    plain_calls += 1
    _, fit1, fit2, inner = segment.fit_planes(coarse, params, ds)
    return fit1, fit2, inner


def quad_mismatches(got: dict, ref: dict) -> int:
    """Used lanes whose quads differ other than by an extreme-point tie.

    Corner A is the member cell farthest from the centroid; when two cells
    are equally far either may win, and the other corners follow from it.
    A differing quad counts only if its corner A is not such a tie."""
    qa = got["quads"].double().cpu()
    qb = ref["quads"].double().cpu()
    cen = ref["centroids"].double().cpu()
    used = (ref["sizes"] > 0).cpu()
    differs = (qa != qb).flatten(-2).any(dim=-1) & used
    da = ((qa[..., 0, :] - cen) ** 2).sum(-1)
    db = ((qb[..., 0, :] - cen) ** 2).sum(-1)
    return int((differs & ((da - db).abs() >= 1e-2)).sum())


def _fit_buffers(b: int, k: int, dev):
    return {
        "quads": torch.empty((b, k, 4, 2), dtype=torch.float32, device=dev),
        "valid": torch.empty((b, k), dtype=torch.bool, device=dev),
        "roots": torch.empty((b, k), dtype=torch.int32, device=dev),
        "centroids": torch.empty((b, k, 2), dtype=torch.float32, device=dev),
        "sizes": torch.empty((b, k), dtype=torch.int32, device=dev),
        "qualifying": torch.empty((b,), dtype=torch.int32, device=dev),
    }


def _ptrs(fit: dict):
    return [
        fit[key].data_ptr()
        for key in ("quads", "valid", "roots", "centroids", "sizes", "qualifying")
    ]


def coarse_fit(coarse: torch.Tensor, params: segment.QuadParams, ds: int):
    """(fit1, fit2, inner_coarse) of (B, Hc, Wc) bool coarse masks; CUDA
    tensors launch the kernel, CPU tensors take ``plain``."""
    global launches
    if coarse.device.type == "cpu":
        return plain(coarse, params, ds)
    if coarse.ndim != 3:
        raise ValueError(f"coarse: expected (B, Hc, Wc), got {tuple(coarse.shape)}")
    c = _build.checked_ptr(coarse, torch.bool, name="coarse")
    b, hc, wc = coarse.shape
    p = hc * wc
    k1 = params.max_candidates
    k2 = max(params.max_inner_candidates, 0)
    if not 0 < k1 <= MAX_LANES or k2 > MAX_LANES:
        raise ValueError(f"lane counts {k1}, {k2} outside 1..{MAX_LANES}")
    kr1 = segment.rank_pool_size(k1, p)
    kr2 = segment.rank_pool_size(k2, p) if k2 else 0
    if max(kr1, kr2) > MAX_POOL:
        raise ValueError(f"rank pool {max(kr1, kr2)} exceeds {MAX_POOL}")
    dev = coarse.device
    fit1 = _fit_buffers(b, k1, dev)
    fit2 = _fit_buffers(b, k2, dev)
    inner = torch.empty((b, hc, wc), dtype=torch.bool, device=dev)
    scratch_i = torch.empty((b, 4 * p), dtype=torch.int32, device=dev)
    # Ten byte planes per frame, rows padded to at most wc + 8 bytes (used
    # only when they do not fit in shared memory).
    scratch_u8 = torch.empty((b, 10 * hc * (wc + 8)), dtype=torch.uint8, device=dev)
    err = _build.lib().a3_coarse_fit(
        c,
        *_ptrs(fit1),
        *_ptrs(fit2),
        inner.data_ptr(),
        scratch_i.data_ptr(),
        scratch_u8.data_ptr(),
        b, hc, wc, ds, k1, k2, kr1, kr2,
        params.fill_rounds,
        params.ccl_rounds,
        params.bg_rounds,
        params.inner_depths,
        params.inner_flood_rounds,
        params.inner_fill_rounds,
        params.inner_ccl_rounds,
        float(np.float32(params.containment_slack * ds)),
        float(np.float32(params.min_containment)),
        params.min_component_px,
        _build.stream(),
    )
    _build.check(err, "a3_coarse_fit")
    launches += 1
    return fit1, (fit2 if k2 else None), inner
