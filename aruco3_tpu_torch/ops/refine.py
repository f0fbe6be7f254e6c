"""Kernel 3 wrapper: full-resolution corner refinement.

``refine_corners`` launches ``csrc/refine.cu`` on CUDA tensors and runs
``plain`` on CPU tensors.  Both return refined (B, K, 4, 2) float32
corners: valid lanes snapped to the extreme ink pixel of each corner's
window (``segment.refine_windows``), invalid lanes unchanged.
"""

from __future__ import annotations

import torch

from .. import segment
from . import _build

launches = 0
plain_calls = 0


def plain(grey, near, quads, centroids, inner_coarse, is_inner, valid, ds, wn):
    """``segment.refine_windows`` on the valid lanes."""
    global plain_calls
    plain_calls += 1
    refined = segment.refine_windows(
        near, quads, centroids, ds, wn, grey, inner_coarse, is_inner
    )
    return torch.where(valid[..., None, None], refined, quads)


def refine_corners(
    grey: torch.Tensor,
    near: torch.Tensor,
    quads: torch.Tensor,
    centroids: torch.Tensor,
    inner_coarse: torch.Tensor,
    is_inner: torch.Tensor,
    valid: torch.Tensor,
    ds: int,
    wn: int,
) -> torch.Tensor:
    """grey (B, H, W) u8, near (B, H, W) bool, quads (B, K, 4, 2) f32,
    centroids (B, K, 2) f32, inner_coarse (B, Hc, Wc) bool, is_inner and
    valid (B, K) bool -> refined quads (B, K, 4, 2).  CUDA tensors launch
    the kernel, CPU tensors take ``plain``."""
    global launches
    if grey.device.type == "cpu":
        return plain(grey, near, quads, centroids, inner_coarse, is_inner, valid, ds, wn)
    b, h, w = grey.shape
    k = quads.shape[1]
    hc, wc = inner_coarse.shape[1:]
    dirs = segment.corner_dirs(quads, centroids).contiguous()
    out = torch.empty((b, k, 4, 2), dtype=torch.float32, device=grey.device)
    err = _build.lib().a3_refine(
        _build.checked_ptr(grey, torch.uint8, (b, h, w), "grey"),
        _build.checked_ptr(near, torch.bool, (b, h, w), "near"),
        _build.checked_ptr(quads, torch.float32, (b, k, 4, 2), "quads"),
        _build.checked_ptr(dirs, torch.float32, (b, k, 4, 2), "dirs"),
        _build.checked_ptr(inner_coarse, torch.bool, (b, hc, wc), "inner_coarse"),
        _build.checked_ptr(is_inner, torch.bool, (b, k), "is_inner"),
        _build.checked_ptr(valid, torch.bool, (b, k), "valid"),
        out.data_ptr(),
        b, k, h, w, hc, wc, ds, wn,
        _build.stream(),
    )
    _build.check(err, "a3_refine")
    launches += 1
    return out
