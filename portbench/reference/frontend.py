"""Benchmark reference: a frozen copy of aruco3_tpu_torch/frontend.py.

Image frontend: grayscale conversion and adaptive mean thresholding.

Counterpart of ``aruco3_tpu/frontend.py``.  ``adaptive_threshold`` compares
each pixel with the mean of the (2r+1)^2 box centred on it, the box clamped
at the image borders (variable area), in exact integer arithmetic as
``pixel * area >= sum``: ties are white.  Box sums are two clamped
cumulative-sum differences in int32.  The on-card frontend kernel
(``ops.frontend``) computes the same bits.
"""

from __future__ import annotations

import torch

# image-crate luma weights (nonlinear Rec.709).
LUMA_WEIGHTS = (0.212671, 0.715160, 0.072169)


def rgb_to_luma_u8(image: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) uint8 (C in {1, 3, 4}) -> (..., H, W) uint8 luma.

    Weighted Rec.709 luma of the raw 8-bit channels in float32, rounded
    half to even.  A (..., H, W) input is returned as it is; alpha is
    ignored.
    """
    if image.ndim >= 3 and image.shape[-1] in (3, 4):
        r = image[..., 0].to(torch.float32)
        g = image[..., 1].to(torch.float32)
        b = image[..., 2].to(torch.float32)
        w = LUMA_WEIGHTS
        luma = w[0] * r + w[1] * g + w[2] * b
        return torch.round(luma).to(torch.uint8)
    if image.ndim >= 3 and image.shape[-1] == 1:
        return image[..., 0]
    return image


def _clamped_window_sum(x: torch.Tensor, radius: int, dim: int):
    """Sums of ``x`` over [i - r, i + r] clamped to the axis, and the
    clamped window lengths (int32)."""
    n = x.shape[dim]
    cum = torch.cumsum(x, dim=dim, dtype=torch.int32)
    zero_shape = list(x.shape)
    zero_shape[dim] = 1
    cum = torch.cat([cum.new_zeros(zero_shape), cum], dim=dim)  # (n + 1)
    idx = torch.arange(n, device=x.device)
    hi = torch.clamp(idx + radius, max=n - 1) + 1
    lo = torch.clamp(idx - radius, min=0)
    sums = cum.index_select(dim, hi) - cum.index_select(dim, lo)
    return sums, (hi - lo).to(torch.int32)


def box_sum_and_area(grey: torch.Tensor, radius: int):
    """Clamped box sums and areas over (..., H, W) uint8, both int32."""
    g = grey.to(torch.int32)
    row_sums, col_counts = _clamped_window_sum(g, radius, dim=-1)
    sums, row_counts = _clamped_window_sum(row_sums, radius, dim=-2)
    areas = row_counts[:, None] * col_counts[None, :]
    return sums, areas


def adaptive_threshold(grey: torch.Tensor, window: int) -> torch.Tensor:
    """Boolean white mask: pixel >= clamped-box mean (exact integer
    compare; ``window`` is the box radius)."""
    sums, areas = box_sum_and_area(grey, window)
    return grey.to(torch.int32) * areas >= sums


def threshold_u8(grey: torch.Tensor, window: int) -> torch.Tensor:
    """uint8 0/255 view of ``adaptive_threshold``."""
    white = adaptive_threshold(grey, window)
    return white.to(torch.uint8) * 255
