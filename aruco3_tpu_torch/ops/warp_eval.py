"""Kernel 8 wrapper: bilinear evaluation of pre-sliced pyramid windows.

``warp_eval`` launches ``csrc/warp_eval.cu`` on CUDA tensors and runs
``plain`` on CPU tensors.  For windows (N, 64, 64) float32 and window-space
sample coordinates ux, uy (N, S^2) float32, both return the samples
(N, S^2) float32

    out[n, s] = sum_y wy[n, s, y] * sum_x wx[n, s, x] * windows[n, y, x]

with wx = max(0, 1 - |ux - x|) for x in 0..63 and wy the same in y: zero
weight outside the window.  Counterpart of ``aruco3_tpu/ops/warp_pallas.py``
``warp_eval``, bit for bit: wx and the windows rounded to bfloat16, wy, the
row sums and the blend float32.  A product of two bfloat16 values is exact
in float32, so each row sum of two taps rounds once whatever the order.
"""

from __future__ import annotations

import functools

import torch

from .. import rectify
from . import Counter, _build

count = Counter()


def plain(windows: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """The dense form: (N, S^2, 64) weight planes, ``t = wx @ windows^T``
    with wx and the windows rounded to bfloat16 (accumulated in float32),
    then the row sum weighted by wy, in float32."""
    count.plain_calls += 1

    def bf16(x):
        return x.to(torch.bfloat16).to(torch.float32)

    j = torch.arange(rectify.WARP_WIN, dtype=torch.float32, device=windows.device)
    wx = bf16(torch.clamp(1.0 - torch.abs(ux[..., None] - j), min=0.0))
    wy = torch.clamp(1.0 - torch.abs(uy[..., None] - j), min=0.0)
    t = torch.bmm(wx, bf16(windows).transpose(1, 2))  # t[n, s, y]
    return (wy * t).sum(dim=-1)


# Two waves of blocks of 256 threads on 132 SMs (8 such blocks an SM).
TARGET_BLOCKS = 2 * 132 * 8
BLOCK = 256


@functools.lru_cache(maxsize=64)
def chunk_size(n: int, s2: int) -> int:
    """Samples per block of the kernel's grid (a multiple of ``BLOCK``).
    Where ``n`` windows give half of ``TARGET_BLOCKS`` or more, one chunk
    per window (the kernel stages the window); else the windows' samples
    split into chunks so that the grid comes near ``TARGET_BLOCKS`` (the
    kernel reads the taps through the read-only cache)."""
    blocks_per_window = -(-s2 // BLOCK)
    chunks = min(blocks_per_window, max(1, TARGET_BLOCKS // max(n, 1)))
    return -(-blocks_per_window // chunks) * BLOCK


def warp_eval(windows: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """(N, S^2) samples of (N, 64, 64) windows at (ux, uy); see the module
    docstring.  CUDA tensors launch the kernel, CPU tensors take ``plain``."""
    if windows.device.type == "cpu":
        return plain(windows, ux, uy)
    n, s2 = ux.shape
    win = rectify.WARP_WIN
    if not (
        windows.is_cuda and windows.shape == (n, win, win) and uy.shape == ux.shape
        and windows.dtype == ux.dtype == uy.dtype == torch.float32
        and windows.is_contiguous() and ux.is_contiguous() and uy.is_contiguous()
        and windows.data_ptr() % 16 == 0 and ux.device == uy.device == windows.device
    ):
        raise ValueError(
            "expected contiguous float32 CUDA windows (N, 64, 64) (16-byte aligned) and "
            f"ux, uy (N, S2); got {tuple(windows.shape)} {windows.dtype}, "
            f"{tuple(ux.shape)} {ux.dtype}, {tuple(uy.shape)} {uy.dtype}"
        )
    out = torch.empty((n, s2), dtype=torch.float32, device=windows.device)
    err = _build.fn("a3_warp_eval")(
        windows.data_ptr(), ux.data_ptr(), uy.data_ptr(), out.data_ptr(),
        n, s2, chunk_size(n, s2), _build.stream(),
    )
    _build.check(err, "a3_warp_eval")
    count.launches += 1
    return out
