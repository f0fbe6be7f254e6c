"""Kernels 5, 6 and 7: the standalone fit of label planes.

Counterpart of ``aruco3_tpu/ops/fit_pallas.py``.  Each wrapper launches
its kernel from ``csrc/fit.cu`` on CUDA tensors and runs its plain version
on CPU tensors:

* ``rank_roots`` (kernel 5): the raster rank pool of a label plane, a
  frame on a cluster of ``rank_cluster`` blocks (plain:
  ``segment.rank_pool``);
* ``fit_lanes`` (kernel 6): the fit chain of selected lanes, ``lane_group``
  lanes a block (plain: ``segment.fit_lanes``);
* ``fused_fit_batch`` (kernel 7): rank pool, top-k and fit chain of both
  label planes in one launch (plain: ``fused_fit_plain``), or, when a lane
  count is above 128, ``fit_quads_batch`` on each plane: kernel 5, a
  stable top-k in torch, kernel 6.

Each kernel's source decides where a frame's state lives (shared memory
or device scratch, ``_build.layout``); ``threads_per_block`` sizes the
blocks of kernels 2 and 7 from the batch and that shared memory,
``rank_cluster`` and ``lane_group`` split kernels 5 and 6 over the SMs.

The fit dicts are those of ``segment.fit_quads``: quads (B, K, 4, 2),
valid (B, K), roots (B, K), centroids (B, K, 2), sizes (B, K) and
qualifying (B,).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import segment
from . import Counter, _build

rank_count = Counter()
lanes_count = Counter()
fused_count = Counter()

# Lanes and rank pool of kernel 7 (and of kernel 2's fit mode).
MAX_LANES = 128
MAX_POOL = 1024
SMEM_SM = 233_472  # shared memory of an H100 SM; each resident block also takes 1 KB
# Largest cluster of kernel 5 (the portable size) and lane group of kernel 6
# (csrc/fit.cu RANK_CLUSTER_MAX, LANE_GROUP_MAX).
RANK_CLUSTER_MAX = 8
LANE_GROUP_MAX = 64


def threads_per_block(b: int, smem: int, sms: int) -> int:
    """Threads of a one-frame block of kernel 2 or 7 that takes ``smem``
    bytes of shared memory, for b frames on ``sms`` SMs: 1,024 when the
    batch fills the SMs once; otherwise as many blocks an SM as the batch
    needs (at most 4, and as many as shared memory holds), 1,024 threads an
    SM between them."""
    per_sm = max(1, min(-(-b // sms), SMEM_SM // (smem + 1024), 4))
    return 1024 // per_sm // 32 * 32


def rank_cluster(b: int, sms: int) -> int:
    """Blocks of kernel 5's cluster a frame, for b frames on ``sms`` SMs:
    the largest power of two at most min(8, sms // b), and at least 1 (a
    batch that fills the SMs runs a frame a block)."""
    c = max(1, min(RANK_CLUSTER_MAX, sms // max(b, 1)))
    return 1 << (c.bit_length() - 1)


def lane_group(k: int, b: int, sms: int, on_chip: bool = True) -> int:
    """Lanes a block of kernel 6 fits, for k lanes of b frames on ``sms``
    SMs: the k lanes split over about ``sms // b`` blocks a frame (one
    block an SM), at most ``LANE_GROUP_MAX`` lanes a block.  Where a
    block's member list is not on chip (``on_chip`` False: a plane of
    device scratch a block, ``a3_lanes_layout``), the fewest blocks.
    Block x fits lanes [x * G, (x + 1) * G) of its frame."""
    if not on_chip:
        return max(1, min(LANE_GROUP_MAX, k))
    per_frame = max(1, sms // max(b, 1))
    return max(1, min(LANE_GROUP_MAX, -(-k // per_frame)))


def scratch(b: int, ints: int, dev) -> torch.Tensor:
    """Device scratch of ``ints`` a frame (or block) for b of them (one int
    when a kernel takes none)."""
    return torch.empty((b, ints) if ints else (1,), dtype=torch.int32, device=dev)


def fit_buffers(b: int, k: int, dev) -> dict:
    """Uninitialised outputs of one pass's fit, as a kernel writes them."""
    return {
        "quads": torch.empty((b, k, 4, 2), dtype=torch.float32, device=dev),
        "valid": torch.empty((b, k), dtype=torch.bool, device=dev),
        "roots": torch.empty((b, k), dtype=torch.int32, device=dev),
        "centroids": torch.empty((b, k, 2), dtype=torch.float32, device=dev),
        "sizes": torch.empty((b, k), dtype=torch.int32, device=dev),
        "qualifying": torch.empty((b,), dtype=torch.int32, device=dev),
    }


def fit_ptrs(fit: dict) -> list[int]:
    return [
        fit[key].data_ptr()
        for key in ("quads", "valid", "roots", "centroids", "sizes", "qualifying")
    ]


def _slack(containment_slack: float, ds: int) -> float:
    return float(np.float32(containment_slack * ds))


def _labels_ptr(labels: torch.Tensor, name: str, shape=None):
    if labels.ndim != 3:
        raise ValueError(f"{name}: expected (B, Hc, Wc), got {tuple(labels.shape)}")
    return _build.checked_ptr(labels, torch.int32, shape, name)


def rank_roots(labels: torch.Tensor, kr: int, min_px: int):
    """(roots_r, sizes_r, n_roots) of (B, Hc, Wc) int32 label planes, as
    ``segment.rank_pool`` returns them.  CUDA tensors launch kernel 5 (a
    frame on a cluster of ``rank_cluster`` blocks), CPU tensors take the
    plain version."""
    if labels.device.type == "cpu":
        rank_count.plain_calls += 1
        return segment.rank_pool(labels, kr, min_px)
    lab = _labels_ptr(labels, "labels")
    b, hc, wc = labels.shape
    dev = labels.device
    roots_r = torch.empty((b, kr), dtype=torch.int32, device=dev)
    sizes_r = torch.empty((b, kr), dtype=torch.int32, device=dev)
    n_roots = torch.empty((b,), dtype=torch.int32, device=dev)
    c = rank_cluster(b, _build.sm_count(dev.index))
    per_frame = _build.layout("a3_rank_layout", hc, wc, kr, c)[1]
    work = scratch(b, per_frame, dev)
    err = _build.lib().a3_rank_roots(
        lab, roots_r.data_ptr(), sizes_r.data_ptr(), n_roots.data_ptr(),
        work.data_ptr(), per_frame,
        b, hc, wc, kr, int(min_px), c, _build.stream(),
    )
    _build.check(err, "a3_rank_roots")
    rank_count.launches += 1
    return roots_r, sizes_r, n_roots


def fit_lanes(
    labels: torch.Tensor,
    roots: torch.Tensor,
    sizes: torch.Tensor,
    use: torch.Tensor,
    ds: int,
    containment_slack: float,
):
    """(quads, centroids, frac) of the selected lanes, as
    ``segment.fit_lanes`` returns them (zeros where ``use`` is False).
    CUDA tensors launch kernel 6 (``lane_group`` lanes a block), CPU
    tensors take the plain version."""
    if labels.device.type == "cpu":
        lanes_count.plain_calls += 1
        return segment.fit_lanes(labels, roots, sizes, use, ds, containment_slack)
    lab = _labels_ptr(labels, "labels")
    b, hc, wc = labels.shape
    k = roots.shape[1]
    dev = labels.device
    quads = torch.empty((b, k, 4, 2), dtype=torch.float32, device=dev)
    cents = torch.empty((b, k, 2), dtype=torch.float32, device=dev)
    frac = torch.empty((b, k), dtype=torch.float32, device=dev)
    per_block = _build.layout("a3_lanes_layout", hc, wc)[1]
    g = lane_group(k, b, _build.sm_count(dev.index), per_block == 0)
    work = scratch(b * -(-k // g), per_block, dev)
    err = _build.lib().a3_fit_lanes(
        lab,
        _build.checked_ptr(roots, torch.int32, (b, k), "roots"),
        _build.checked_ptr(sizes, torch.int32, (b, k), "sizes"),
        _build.checked_ptr(use, torch.bool, (b, k), "use"),
        quads.data_ptr(), cents.data_ptr(), frac.data_ptr(), work.data_ptr(), per_block,
        b, hc, wc, k, g, ds, _slack(containment_slack, ds), _build.stream(),
    )
    _build.check(err, "a3_fit_lanes")
    lanes_count.launches += 1
    return quads, cents, frac


def fit_quads_batch(labels: torch.Tensor, ds: int, params: segment.QuadParams, k: int) -> dict:
    """``segment.fit_quads`` of (B, Hc, Wc) label planes through kernel 5,
    a stable top-k (the tie order of ``lax.top_k``) and kernel 6."""
    p = labels.shape[1] * labels.shape[2]
    roots_r, sizes_r, n_roots = rank_roots(
        labels, segment.rank_pool_size(k, p), params.min_component_px
    )
    roots, sizes = segment.select_lanes(roots_r, sizes_r, k)
    use = sizes >= 0
    quads, cents, frac = fit_lanes(
        labels, roots.contiguous(), torch.clamp(sizes, min=0).contiguous(),
        use.contiguous(), ds, params.containment_slack,
    )
    return segment.lane_fits(quads, cents, frac, roots, sizes, n_roots, params)


def fused_fit_plain(labels1, labels2, ds, params, k1, k2):
    """``segment.fit_quads`` of both planes; the inner lanes that twin a
    valid outer lane are not fitted (zero quads, centroids and
    containment)."""
    fused_count.plain_calls += 1
    fit1 = segment.fit_quads(labels1, ds, params, k=k1)
    if k2 <= 0:
        return fit1, None
    return fit1, segment.fit_quads(labels2, ds, params, k=k2, skip_twins_of=fit1)


def fused_fit_batch(
    labels1: torch.Tensor,
    labels2: torch.Tensor | None,
    ds: int,
    params: segment.QuadParams,
    k1: int,
    k2: int,
):
    """(fit1, fit2) of the outer and inner label planes (fit2 None when k2
    is 0).  Lane counts above 128 take ``fit_quads_batch`` on each plane,
    with no twin skip; otherwise CUDA tensors launch kernel 7 and CPU
    tensors take ``fused_fit_plain``."""
    k2 = k2 if labels2 is not None else 0
    if k1 > MAX_LANES or k2 > MAX_LANES:
        fit1 = fit_quads_batch(labels1, ds, params, k1)
        fit2 = fit_quads_batch(labels2, ds, params, k2) if k2 > 0 else None
        return fit1, fit2
    if labels1.device.type == "cpu":
        return fused_fit_plain(labels1, labels2, ds, params, k1, k2)
    b, hc, wc = labels1.shape
    p = hc * wc
    lab1 = _labels_ptr(labels1, "labels1")
    lab2 = _labels_ptr(labels2, "labels2", (b, hc, wc)) if k2 > 0 else lab1
    kr1 = segment.rank_pool_size(k1, p)
    kr2 = segment.rank_pool_size(k2, p) if k2 > 0 else 0
    if max(kr1, kr2) > MAX_POOL:
        raise ValueError(f"rank pool {max(kr1, kr2)} exceeds {MAX_POOL}")
    dev = labels1.device
    smem, per_frame = _build.layout("a3_fused_layout", hc, wc, max(kr1, kr2))
    work = scratch(b, per_frame, dev)
    fit1 = fit_buffers(b, k1, dev)
    fit2 = fit_buffers(b, k2, dev)
    err = _build.lib().a3_fused_fit(
        lab1, lab2, *fit_ptrs(fit1), *fit_ptrs(fit2), work.data_ptr(),
        b, hc, wc, ds, k1, k2, kr1, kr2,
        _slack(params.containment_slack, ds),
        float(np.float32(params.min_containment)),
        params.min_component_px,
        threads_per_block(b, smem, _build.sm_count(dev.index)),
        per_frame,
        _build.stream(),
    )
    _build.check(err, "a3_fused_fit")
    fused_count.launches += 1
    return fit1, (fit2 if k2 > 0 else None)
