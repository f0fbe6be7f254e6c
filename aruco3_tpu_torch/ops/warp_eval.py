"""Kernel 8 wrapper: bilinear evaluation of pre-sliced pyramid windows.

``warp_eval`` launches ``csrc/warp_eval.cu`` on CUDA tensors and runs
``plain`` on CPU tensors.  For windows (N, 64, 64) float32 and window-space
sample coordinates ux, uy (N, S^2) float32, both return the samples
(N, S^2) float32

    out[n, s] = sum_y wy[n, s, y] * sum_x wx[n, s, x] * windows[n, y, x]

with wx = max(0, 1 - |ux - x|) for x in 0..63 and wy the same in y: zero
weight outside the window.  Counterpart of ``aruco3_tpu/ops/warp_pallas.py``
``warp_eval``, in float32 where the TPU kernel rounds wx and the windows to
bfloat16.
"""

from __future__ import annotations

import torch

from .. import rectify
from . import Counter, _build

count = Counter()


def plain(windows: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """The dense form: (N, S^2, 64) weight planes, ``t = wx @ windows^T``,
    then the row sum weighted by wy, in float32."""
    count.plain_calls += 1
    j = torch.arange(rectify.WARP_WIN, dtype=torch.float32, device=windows.device)
    wx = torch.clamp(1.0 - torch.abs(ux[..., None] - j), min=0.0)
    wy = torch.clamp(1.0 - torch.abs(uy[..., None] - j), min=0.0)
    t = torch.bmm(wx, windows.transpose(1, 2))  # t[n, s, y]
    return (wy * t).sum(dim=-1)


def warp_eval(windows: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """(N, S^2) samples of (N, 64, 64) windows at (ux, uy); see the module
    docstring.  CUDA tensors launch the kernel, CPU tensors take ``plain``."""
    if windows.device.type == "cpu":
        return plain(windows, ux, uy)
    if windows.ndim != 3 or ux.ndim != 2:
        raise ValueError(
            f"expected windows (N, 64, 64) and ux (N, S2), got {tuple(windows.shape)}, "
            f"{tuple(ux.shape)}"
        )
    n, s2 = ux.shape
    win = rectify.WARP_WIN
    out = torch.empty((n, s2), dtype=torch.float32, device=windows.device)
    err = _build.lib().a3_warp_eval(
        _build.checked_ptr(windows, torch.float32, (n, win, win), "windows"),
        _build.checked_ptr(ux, torch.float32, (n, s2), "ux"),
        _build.checked_ptr(uy, torch.float32, (n, s2), "uy"),
        out.data_ptr(),
        n, s2,
        _build.stream(),
    )
    _build.check(err, "a3_warp_eval")
    count.launches += 1
    return out
