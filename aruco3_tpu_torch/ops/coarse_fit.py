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

The kernel's source decides where a frame's planes fit
(``a3_coarse_layout``, ``a3_coarse_cluster_layout``); ``plan`` picks the
layout of a launch: one block a frame with its planes in shared memory
("smem"), a cluster of ``CLUSTER`` blocks a frame, each a band of rows on
chip ("cluster", labels mode only), or one block a frame with its planes
in device scratch ("scratch").  Each wrapper's ``Counter`` keeps the
[layout, blocks a frame] of its last launch under ``coarse_layout`` (the
capture log's record of a graph takes it from there).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import segment
from . import Counter, _build
from .fit import (
    MAX_LANES, MAX_POOL, RANK_CLUSTER_MAX, fit_buffers, fit_ptrs, scratch, threads_per_block,
)

count = Counter()
labels_count = Counter()

# Kernel 2's cluster in labels mode: 8 blocks (the portable cluster) of 512
# threads a frame.  On 16 dense 4K frames (216x384) on one H100 clusters of
# 8 beat clusters of 4 at every batch from 1 to 128; at 1,024 threads a
# block fills an SM's registers, the card holds 15 clusters of 8 and 16
# frames take two waves (0.645 ms against 0.372 at 512; PERF.md).
CLUSTER = RANK_CLUSTER_MAX
CLUSTER_THREADS = 512


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


def plan(b: int, hc: int, wc: int, kr: int, sms: int, layout=_build.layout):
    """(layout, blocks a frame, threads a block, scratch ints a frame) of
    kernel 2 for b frames of an hc x wc grid on ``sms`` SMs; kr: the
    larger rank pool in fit mode, 0 in labels mode.  The layout is "smem"
    where one block holds a frame, else in labels mode "cluster" where a
    band of a cluster of ``CLUSTER`` fits a block, else "scratch".
    ``layout(name, *args)`` answers as ``_build.layout`` does for the
    library's ``a3_coarse_layout`` and ``a3_coarse_cluster_layout``."""
    smem, per_frame = layout("a3_coarse_layout", hc, wc, kr)
    if smem:
        return "smem", 1, threads_per_block(b, smem, sms), per_frame
    if kr == 0 and layout("a3_coarse_cluster_layout", hc, wc, CLUSTER)[0]:
        return "cluster", CLUSTER, CLUSTER_THREADS, 0
    return "scratch", 1, threads_per_block(b, 0, sms), per_frame


def fit_pool(params: segment.QuadParams, p: int) -> int:
    """The larger rank pool of fit mode's two planes on a grid of p cells."""
    k2 = max(params.max_inner_candidates, 0)
    kr2 = segment.rank_pool_size(k2, p) if k2 else 0
    return max(segment.rank_pool_size(params.max_candidates, p), kr2)


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
    layout, blocks, threads, per_frame = plan(b, hc, wc, max(kr1, kr2), _build.sm_count(dev.index))
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
    count.fields["coarse_layout"] = [layout, blocks]
    return fit1, (fit2 if k2 else None), inner


def coarse_labels(coarse: torch.Tensor, params: segment.QuadParams):
    """(labels1, labels2) of (B, Hc, Wc) bool coarse masks; CUDA tensors
    launch the kernel in labels mode (in ``plan``'s layout), CPU tensors
    take ``labels_plain``."""
    if coarse.device.type == "cpu":
        return labels_plain(coarse, params)
    if coarse.ndim != 3:
        raise ValueError(f"coarse: expected (B, Hc, Wc), got {tuple(coarse.shape)}")
    c = _build.checked_ptr(coarse, torch.bool, name="coarse")
    b, hc, wc = coarse.shape
    dev = coarse.device
    labels1 = torch.empty((b, hc, wc), dtype=torch.int32, device=dev)
    labels2 = torch.empty((b, hc, wc), dtype=torch.int32, device=dev)
    layout, blocks, threads, per_frame = plan(b, hc, wc, 0, _build.sm_count(dev.index))
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
        blocks,
        per_frame,
        _build.stream(),
    )
    _build.check(err, "a3_coarse_labels")
    labels_count.launches += 1
    labels_count.fields["coarse_layout"] = [layout, blocks]
    return labels1, labels2
