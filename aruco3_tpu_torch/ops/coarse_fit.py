"""Kernel 2 wrappers: both label planes, with or without their quad fits.

Both launch ``csrc/coarse_fit.cu`` on CUDA tensors and run a plain
version on CPU tensors.  For (B, Hc, Wc) bool coarse masks:

* ``coarse_fit`` (fit mode; plain: ``plain``) returns ``(fit1, fit2,
  inner_coarse)``: the outer and inner fits as ``segment.fit_quads``
  returns them (quads, valid, roots, centroids, sizes, qualifying, each
  with a leading batch axis), and the dilated footprint of the inner label
  plane, (B, Hc, Wc) bool.  ``fit2`` is None when ``max_inner_candidates``
  is 0.  It takes at most 128 lanes and a rank pool of 1024.
* ``coarse_labels`` (labels mode; plain: ``labels_plain``, which is
  ``segment.label_planes``) returns ``(labels1, labels2)``, (B, Hc, Wc)
  int32 with sentinel Hc*Wc.

The kernel's source decides where a frame's planes live
(``a3_coarse_layout``); ``fit.threads_per_block`` sizes its blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import segment
from . import Counter, _build
from .fit import MAX_LANES, MAX_POOL, fit_buffers, fit_ptrs, scratch, threads_per_block

count = Counter()
labels_count = Counter()


def plain(coarse: torch.Tensor, params: segment.QuadParams, ds: int):
    """``segment.fit_planes`` without the outer label plane."""
    count.plain_calls += 1
    _, fit1, fit2, inner = segment.fit_planes(coarse, params, ds)
    return fit1, fit2, inner


def labels_plain(coarse: torch.Tensor, params: segment.QuadParams):
    """``segment.label_planes``."""
    labels_count.plain_calls += 1
    return segment.label_planes(coarse, params)


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


def _plan(b: int, hc: int, wc: int, kr: int, dev) -> tuple[int, int]:
    """(threads, scratch ints a frame) of kernel 2 for b frames of an hc x
    wc grid; kr: the larger rank pool in fit mode, 0 in labels mode."""
    smem, per_frame = _build.layout("a3_coarse_layout", hc, wc, kr)
    return threads_per_block(b, smem, _build.sm_count(dev.index)), per_frame


def _rounds(params: segment.QuadParams):
    return (
        params.fill_rounds,
        params.ccl_rounds,
        params.bg_rounds,
        params.inner_depths,
        params.inner_flood_rounds,
        params.inner_fill_rounds,
        params.inner_ccl_rounds,
    )


def coarse_fit(coarse: torch.Tensor, params: segment.QuadParams, ds: int):
    """(fit1, fit2, inner_coarse) of (B, Hc, Wc) bool coarse masks; CUDA
    tensors launch the kernel, CPU tensors take ``plain``."""
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
    fit1 = fit_buffers(b, k1, dev)
    fit2 = fit_buffers(b, k2, dev)
    inner = torch.empty((b, hc, wc), dtype=torch.bool, device=dev)
    threads, per_frame = _plan(b, hc, wc, max(kr1, kr2), dev)
    work = scratch(b, per_frame, dev)
    err = _build.lib().a3_coarse_fit(
        c,
        *fit_ptrs(fit1),
        *fit_ptrs(fit2),
        inner.data_ptr(),
        work.data_ptr(),
        b, hc, wc, ds, k1, k2, kr1, kr2,
        *_rounds(params),
        float(np.float32(params.containment_slack * ds)),
        float(np.float32(params.min_containment)),
        params.min_component_px,
        threads,
        per_frame,
        _build.stream(),
    )
    _build.check(err, "a3_coarse_fit")
    count.launches += 1
    return fit1, (fit2 if k2 else None), inner


def coarse_labels(coarse: torch.Tensor, params: segment.QuadParams):
    """(labels1, labels2) of (B, Hc, Wc) bool coarse masks; CUDA tensors
    launch the kernel in labels mode, CPU tensors take ``labels_plain``."""
    if coarse.device.type == "cpu":
        return labels_plain(coarse, params)
    if coarse.ndim != 3:
        raise ValueError(f"coarse: expected (B, Hc, Wc), got {tuple(coarse.shape)}")
    c = _build.checked_ptr(coarse, torch.bool, name="coarse")
    b, hc, wc = coarse.shape
    dev = coarse.device
    labels1 = torch.empty((b, hc, wc), dtype=torch.int32, device=dev)
    labels2 = torch.empty((b, hc, wc), dtype=torch.int32, device=dev)
    threads, per_frame = _plan(b, hc, wc, 0, dev)
    work = scratch(b, per_frame, dev)
    err = _build.lib().a3_coarse_labels(
        c,
        labels1.data_ptr(),
        labels2.data_ptr(),
        work.data_ptr(),
        b, hc, wc,
        int(params.max_inner_candidates > 0),
        *_rounds(params),
        threads,
        per_frame,
        _build.stream(),
    )
    _build.check(err, "a3_coarse_labels")
    labels_count.launches += 1
    return labels1, labels2
