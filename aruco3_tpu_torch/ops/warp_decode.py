"""Kernel 4 wrapper: warp each candidate and decode its cell grid.

``warp_decode`` launches ``csrc/warp_decode.cu`` on CUDA tensors and runs
``plain`` on CPU tensors.  Both return, for the lanes of (B, K):

* samples (B, K, S, S) float32 — the bilinear patch samples;
* levels (B, K) int32 — the Otsu level of each patch;
* grids (B, K, m*m) bool — the white-cell grid after Triangle resize.

Invalid lanes come back as zeros.  The launch takes the level pointers
by value and the resize table (``resize_taps``) from a device buffer
built once per (S, m, device): the wrapper copies nothing to the device
per call and never waits on it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import rectify
from . import Counter, _build

count = Counter()


@functools.lru_cache(maxsize=None)
def resize_taps(s: int, m: int):
    """Rows of ``rectify.triangle_resize_matrix(s, m)`` as runs of taps:
    (start (m,) int32, count (m,) int32, weights (m, T) float32), row o's
    nonzero weights at columns start[o] .. start[o] + count[o] - 1 in
    weights[o, :count[o]], T the longest run (each row's nonzero taps are
    one run)."""
    L = rectify.triangle_resize_matrix(s, m)
    runs = []
    for row in L:
        nz = np.nonzero(row)[0]
        runs.append((int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0))
    T = max(1, max(hi - lo for lo, hi in runs))
    start = np.array([lo for lo, _ in runs], np.int32)
    cnt = np.array([hi - lo for lo, hi in runs], np.int32)
    w = np.zeros((m, T), np.float32)
    for o, (lo, hi) in enumerate(runs):
        w[o, : hi - lo] = L[o, lo:hi]
    return start, cnt, w


@functools.lru_cache(maxsize=None)
def device_taps(s: int, m: int, device: torch.device) -> torch.Tensor:
    """``resize_taps(s, m)`` as the kernel reads it, one int32 buffer on
    ``device``: start, count, then the weights' float32 bits."""
    start, cnt, w = resize_taps(s, m)
    words = np.concatenate([start, cnt, w.view(np.int32).ravel()])
    return torch.from_numpy(words).to(device)


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
    bfloat16 levels 1..L-1 of the chain (``rectify.level1_plane(grey,
    chain=True)`` and ``rectify.upper_levels``); H (B, K, 3, 3) f32;
    lvl/tlx/tly (B, K) int32
    from ``rectify.warp_windows``; valid (B, K) bool.  Returns (samples,
    levels, grids); CUDA tensors launch the kernel, CPU tensors take
    ``plain``."""
    if grey.device.type == "cpu":
        return plain(grey, uppers, H, lvl, tlx, tly, valid, patch_size, mark_size)
    b, h, w = grey.shape
    k = lvl.shape[1]
    s, m = patch_size, mark_size
    dev = grey.device
    ptrs = (ctypes.c_longlong * max(1, len(uppers)))()
    dims = (ctypes.c_int * max(2, 2 * len(uppers)))()
    for i, u in enumerate(uppers):
        if not (u.is_cuda and u.dtype == torch.bfloat16 and u.is_contiguous()
                and u.dim() == 3 and u.shape[0] == b):
            raise ValueError(f"level {i + 1}: expected a contiguous bfloat16 CUDA tensor "
                             f"(B={b}, h, w), got {u.dtype} {tuple(u.shape)} on {u.device}")
        ptrs[i] = u.data_ptr()
        dims[2 * i], dims[2 * i + 1] = u.shape[1], u.shape[2]
    taps = device_taps(s, m, dev)
    samples = torch.empty((b, k, s, s), dtype=torch.float32, device=dev)
    levels = torch.empty((b, k), dtype=torch.int32, device=dev)
    grids = torch.empty((b, k, m * m), dtype=torch.bool, device=dev)
    err = _build.lib().a3_warp_decode(
        _build.checked_ptr(grey, torch.uint8, name="grey"),
        ptrs,
        dims,
        len(uppers),
        _build.checked_ptr(H, torch.float32, (b, k, 3, 3), "H"),
        _build.checked_ptr(lvl, torch.int32, (b, k), "lvl"),
        _build.checked_ptr(tlx, torch.int32, (b, k), "tlx"),
        _build.checked_ptr(tly, torch.int32, (b, k), "tly"),
        _build.checked_ptr(valid, torch.bool, (b, k), "valid"),
        taps.data_ptr(),
        samples.data_ptr(),
        levels.data_ptr(),
        grids.data_ptr(),
        b * k, k, h, w, s, m, resize_taps(s, m)[2].shape[1],
        _build.stream(),
    )
    _build.check(err, "a3_warp_decode")
    count.launches += 1
    return samples, levels, grids
