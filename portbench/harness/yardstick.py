"""The least time a kernel could take on one H100, from the work its
function needs on the cell's inputs.

A frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``,
``PEAK_OPS_PER_S``, ``label_rounds``, ``work`` and ``bound`` for kernels 1
and 2, counted from shapes: each input byte read once and each output byte
written once; operations counted by hand (31 a pixel for kernel 1's
threshold, opening, pooling and level 1; 12 a coarse cell a labelling
round for kernel 2, and 11 a cell for each fitted plane's rank pool).
Kernel 2's per-member fit operations (40 a member cell of a fitted lane)
depend on the frame and are left out, so its count is a floor.  The same
count holds whatever implements the kernel.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the
# tensor cores (dense), at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# Bytes a lane of one fitted plane writes (quads 32, valid 1, roots 4,
# centroids 8, sizes 4) and a frame's qualifying count.
FIT_LANE_BYTES = 49
FIT_FRAME_BYTES = 4


def label_rounds(params) -> int:
    """Flood and CCL rounds of kernel 2's labelling, peel depths after the
    first not counted."""
    outer = params.fill_rounds + params.ccl_rounds
    if params.max_inner_candidates <= 0:
        return outer
    return (outer + params.bg_rounds + params.fill_rounds + 2 * params.inner_flood_rounds
            + params.ccl_rounds)


def coarse_shape(h: int, w: int, ds: int) -> tuple[int, int]:
    return -(-h // ds), -(-w // ds)


def level1_shape(h: int, w: int) -> tuple[int, int]:
    """Pyramid level 1 of a frame padded to even and at least 64."""
    ph, pw = max(64, h + h % 2), max(64, w + w % 2)
    return ph // 2, pw // 2


def frontend_work(b: int, h: int, w: int, ds: int, chain: bool) -> tuple[int, int]:
    """(bytes, operations) of kernel 1 on b (h, w) frames: grey in; near
    mask, coarse mask and level 1 (bfloat16 with ``chain``) out."""
    hc, wc = coarse_shape(h, w, ds)
    h1, w1 = level1_shape(h, w)
    nbytes = b * (h * w + h * w + hc * wc + h1 * w1 * (2 if chain else 4))
    return nbytes, 31 * b * h * w


def coarse_fit_work(b: int, h: int, w: int, ds: int, params) -> tuple[int, int]:
    """(bytes, operations) of kernel 2 in fit mode on b frames' coarse
    masks: the mask in; both planes' fits and the inner footprint out."""
    hc, wc = coarse_shape(h, w, ds)
    cells = hc * wc
    k1, k2 = params.max_candidates, max(params.max_inner_candidates, 0)
    planes = 1 + (k2 > 0)
    nbytes = b * (2 * cells + (k1 + k2) * FIT_LANE_BYTES + 2 * FIT_FRAME_BYTES)
    ops = b * (12 * label_rounds(params) * cells + 11 * cells * planes)
    return nbytes, ops


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations": which bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
