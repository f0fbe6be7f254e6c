"""Kernel 1 wrapper: threshold, opening, pooling, near mask and level 1.

``threshold_open_pool`` launches ``csrc/frontend.cu`` on CUDA tensors and
runs ``plain`` on CPU tensors.  Both return, for (B, H, W) uint8 grey
frames:

* coarse (B, ceil(H/ds), ceil(W/ds)) bool — the pooled opened black mask;
* near (B, H, W) bool — the opened mask dilated twice by 3x3;
* level1 (B, ph0/2, pw0/2) float32 — pyramid level 1 (2x2 means of the
  frame zero-padded to even and >= 64).
"""

from __future__ import annotations

import torch

from .. import frontend, rectify, segment
from . import _build

launches = 0
plain_calls = 0


def _shapes(h: int, w: int, ds: int):
    (ph0, pw0), = rectify.pyramid_level_shapes(h, w, 1)
    return (-(-h // ds), -(-w // ds)), (ph0 // 2, pw0 // 2)


def plain(grey: torch.Tensor, window: int, open_radius: int, ds: int):
    """The same three outputs from the ported XLA functions."""
    global plain_calls
    plain_calls += 1
    white = frontend.adaptive_threshold(grey, window)
    opened = segment.open_mask(~white, open_radius)
    return (
        segment.pool_black(opened, ds),
        segment.near_mask(opened),
        rectify.level1_plane(grey),
    )


def threshold_open_pool(
    grey: torch.Tensor, window: int, open_radius: int, ds: int
):
    """(coarse, near, level1) of (B, H, W) uint8 frames; see the module
    docstring.  CUDA tensors launch the kernel, CPU tensors take ``plain``."""
    global launches
    if grey.device.type == "cpu":
        return plain(grey, window, open_radius, ds)
    if grey.ndim != 3:
        raise ValueError(f"grey: expected (B, H, W), got {tuple(grey.shape)}")
    b, h, w = grey.shape
    g = _build.checked_ptr(grey, torch.uint8, name="grey")
    (hc, wc), (h1, w1) = _shapes(h, w, ds)
    dev = grey.device
    opened = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    near = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    coarse = torch.empty((b, hc, wc), dtype=torch.bool, device=dev)
    level1 = torch.empty((b, h1, w1), dtype=torch.float32, device=dev)
    err = _build.lib().a3_frontend(
        g,
        opened.data_ptr(),
        near.data_ptr(),
        coarse.data_ptr(),
        level1.data_ptr(),
        b, h, w, window, open_radius, ds, h1, w1,
        _build.stream(),
    )
    _build.check(err, "a3_frontend")
    launches += 1
    return coarse, near, level1
