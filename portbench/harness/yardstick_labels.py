"""The least time kernels 2 (labels mode), 5 and 6 could take on one H100,
from the work their functions need on the cell's inputs.

A frozen copy of ``chip_smoke.py``'s ``work`` for ``coarse_labels``,
``rank_roots`` and ``fit_lanes``, counted from shapes: each input byte
read once and each output byte written once; operations counted by hand
(12 a coarse cell a labelling round for kernel 2, 10 a cell for kernel
5's rank pool, 1 a cell for kernel 6's scan of the plane).  Kernel 6's
per-member operations (40 a member cell of a fitted lane) depend on the
frame and are left out, so its count is a floor.  The same count holds
whatever implements the kernels.  The rates and ``bound_ms`` are
``yardstick``'s.
"""

from __future__ import annotations

from ..reference.segment import rank_pool_size
from .yardstick import bound_ms, coarse_shape, label_rounds

# Bytes a lane of kernel 6 reads (root 4, size 4, use 1) and writes (quad
# 32, centroid 8, containment 4).
LANE_IN_BYTES = 9
LANE_OUT_BYTES = 44


def planes(params) -> list[int]:
    """Lanes of each plane the label route fits: the outer, then the inner
    where it has lanes."""
    k2 = max(params.max_inner_candidates, 0)
    return [params.max_candidates] + ([k2] if k2 > 0 else [])


def labels_work(b: int, h: int, w: int, ds: int, params) -> tuple[int, int]:
    """(bytes, operations) of kernel 2 in labels mode on b frames' coarse
    masks: the mask (1 byte a cell) in; both int32 label planes out."""
    hc, wc = coarse_shape(h, w, ds)
    cells = b * hc * wc
    return cells * (1 + 4 + 4), 12 * label_rounds(params) * cells


def rank_roots_work(b: int, hc: int, wc: int, k: int) -> tuple[int, int]:
    """(bytes, operations) of kernel 5 on b int32 label planes for k lanes:
    the plane in; the pool's roots and sizes and each frame's root count
    out."""
    cells = b * hc * wc
    kr = rank_pool_size(k, hc * wc)
    return 4 * cells + b * (8 * kr + 4), 10 * cells


def fit_lanes_work(b: int, hc: int, wc: int, k: int) -> tuple[int, int]:
    """(bytes, operations) of kernel 6 on b int32 label planes and k lanes
    a frame (a floor: member operations left out)."""
    cells = b * hc * wc
    return 4 * cells + b * k * (LANE_IN_BYTES + LANE_OUT_BYTES), cells


def plane_bound_ms(work, b: int, h: int, w: int, ds: int, params) -> float:
    """Least milliseconds of kernel 5 or 6 (``work``: ``rank_roots_work``
    or ``fit_lanes_work``) over every plane of b frames: its launches of
    one batch."""
    hc, wc = coarse_shape(h, w, ds)
    return sum(bound_ms(*work(b, hc, wc, k))[0] for k in planes(params))
