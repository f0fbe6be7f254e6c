"""Kernel 4 wrapper: warp each candidate and decode its cell grid.

``warp_decode`` launches ``csrc/warp_decode.cu`` on CUDA tensors and runs
``plain`` on CPU tensors.  Both return, for the lanes of (B, K):

* samples (B, K, S, S) float32 — the bilinear patch samples;
* levels (B, K) int32 — the Otsu level of each patch;
* grids (B, K, m*m) bool — the white-cell grid after Triangle resize.

Invalid lanes come back as zeros.
"""

from __future__ import annotations

import torch

from .. import rectify
from . import Counter, _build

count = Counter()


def plain(grey, uppers, H, lvl, tlx, tly, valid, patch_size, mark_size):
    """``rectify.warp_samples`` + ``rectify.otsu_cells``."""
    count.plain_calls += 1
    b, k = lvl.shape
    s = patch_size
    samples = rectify.warp_samples(grey, uppers, H, lvl, tlx, tly, s)
    levels, grids = rectify.otsu_cells(samples.reshape(b * k, s, s), mark_size)
    samples = torch.where(valid[..., None], samples, 0.0)
    levels = torch.where(valid, levels.reshape(b, k), 0)
    grids = grids.reshape(b, k, -1) & valid[..., None]
    return samples.reshape(b, k, s, s), levels, grids


def warp_decode(
    grey: torch.Tensor,
    uppers: list[torch.Tensor],
    H: torch.Tensor,
    lvl: torch.Tensor,
    tlx: torch.Tensor,
    tly: torch.Tensor,
    valid: torch.Tensor,
    patch_size: int,
    mark_size: int,
):
    """grey (B, H, W) u8 is pyramid level 0 and ``uppers`` the padded
    float32 levels 1..L-1; H (B, K, 3, 3) f32; lvl/tlx/tly (B, K) int32
    from ``rectify.warp_windows``; valid (B, K) bool.  Returns (samples,
    levels, grids); CUDA tensors launch the kernel, CPU tensors take
    ``plain``."""
    if grey.device.type == "cpu":
        return plain(grey, uppers, H, lvl, tlx, tly, valid, patch_size, mark_size)
    b, h, w = grey.shape
    k = lvl.shape[1]
    s, m = patch_size, mark_size
    dev = grey.device
    for i, u in enumerate(uppers):
        _build.checked_ptr(u, torch.float32, name=f"level {i + 1}")
        if u.shape[0] != b:
            raise ValueError(f"level {i + 1}: batch {u.shape[0]} != {b}")
    level_ptrs = torch.tensor([u.data_ptr() for u in uppers], dtype=torch.int64, device=dev)
    level_dims = torch.tensor(
        [list(u.shape[1:]) for u in uppers], dtype=torch.int32, device=dev
    ).reshape(-1)
    lmat = torch.from_numpy(rectify.triangle_resize_matrix(s, m)).to(dev)
    samples = torch.empty((b, k, s, s), dtype=torch.float32, device=dev)
    levels = torch.empty((b, k), dtype=torch.int32, device=dev)
    grids = torch.empty((b, k, m * m), dtype=torch.bool, device=dev)
    err = _build.lib().a3_warp_decode(
        _build.checked_ptr(grey, torch.uint8, name="grey"),
        level_ptrs.data_ptr(),
        level_dims.data_ptr(),
        _build.checked_ptr(H, torch.float32, (b, k, 3, 3), "H"),
        _build.checked_ptr(lvl, torch.int32, (b, k), "lvl"),
        _build.checked_ptr(tlx, torch.int32, (b, k), "tlx"),
        _build.checked_ptr(tly, torch.int32, (b, k), "tly"),
        _build.checked_ptr(valid, torch.bool, (b, k), "valid"),
        lmat.data_ptr(),
        samples.data_ptr(),
        levels.data_ptr(),
        grids.data_ptr(),
        b * k, k, h, w, s, m,
        _build.stream(),
    )
    _build.check(err, "a3_warp_decode")
    count.launches += 1
    return samples, levels, grids
