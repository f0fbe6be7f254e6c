"""Kernel 1 wrapper: threshold, opening, pooling, near mask and level 1.

``threshold_open_pool`` launches ``csrc/frontend.cu`` on CUDA tensors and
runs ``plain`` on CPU tensors.  Both return, for (B, H, W) uint8 grey
frames:

* coarse (B, ceil(H/ds), ceil(W/ds)) bool — the pooled opened black mask;
* near (B, H, W) bool — the opened mask dilated twice by 3x3;
* level1 (B, ph0/2, pw0/2) — pyramid level 1 of the frame zero-padded to
  even and >= 64: float32 exact 2x2 means (the tail route's, XLA's
  ``build_pyramid``), or with ``chain=True`` bfloat16, the chain of the
  JAX frontend kernel's ``emit_level1`` and ``build_packed_pyramid``
  (the refine route's; ``rectify.level1_plane``);
* with ``opened=True``, also the opened black mask (B, H, W) bool.

``plan`` sizes the kernel's tiles; ``tiles`` lists what each tile writes.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import frontend, rectify, segment
from . import Counter, _build

count = Counter()

BLOCK = 288  # threads of a block; a tile is about this many grey columns wide
WARPS = BLOCK // 32
MAX_ROWS = 128  # tile rows at most
SMEM_MAX = 232_448  # shared memory a block may have
SMEM_TWO = 115_712  # ... and two blocks an SM (each with 1 KB reserved)
# The morphology keeps a window of 32 (or, for radii above 4, 64) mask rows
# in a warp; 2 * (2 r + 2) rows of each are its halo.
MAX_OPEN_RADIUS = 14


def _shapes(h: int, w: int, ds: int):
    (ph0, pw0), = rectify.pyramid_level_shapes(h, w, 1)
    return (-(-h // ds), -(-w // ds)), (ph0 // 2, pw0 // 2)


def smem_bytes(th: int, tw: int, window: int, open_radius: int) -> int:
    """Shared memory of one th x tw tile (the layout of ``csrc/frontend.cu``:
    two mask-word planes, column sums, staged grey)."""
    eb = 2 * open_radius + 2
    eg = window + eb
    mr, gr, gc = th + 2 * eb, th + 2 * eg, tw + 2 * eg
    nw = -(-(tw + 2 * eb) // 32)
    wide = (2 * window + 1) * 255 > 65535
    go = (4 - eg % 4) % 4
    pc = gc | 1 if wide else gc + (2 - gc) % 4
    pg = (go + gc + 3) // 8 * 8 + 4

    def r16(n):
        return -(-n // 16) * 16

    return r16(2 * nw * mr * 4) + r16(mr * pc * (4 if wide else 2)) + r16(gr * pg)


@functools.lru_cache(maxsize=64)
def plan(h: int, w: int, window: int, open_radius: int, ds: int) -> tuple[int, int]:
    """(th, tw): output rows and columns of a tile for (h, w) frames.  Both
    are multiples of lcm(ds, 2), so every coarse cell and level-1 cell lies
    inside one tile; where w is a multiple of 16, tw is too, so that rows
    store whole 16-byte chunks.  tw keeps the grey halo within ``BLOCK``
    columns and the mask row within 9 words; th at most one morphology
    window a warp and ``MAX_ROWS``.  Each takes the size that stages the
    fewest grey pixels over the frame (halo included), th among the
    heights whose tile lets two blocks share an SM, else the tallest that
    fits in shared memory.  Raises where not even one cell fits, and for an
    open radius above ``MAX_OPEN_RADIUS``."""
    if window < 0 or not 0 <= open_radius <= MAX_OPEN_RADIUS or ds < 1:
        raise ValueError(
            f"frontend: window {window}, open radius {open_radius} (at most "
            f"{MAX_OPEN_RADIUS}), ds {ds}"
        )
    step = ds * 2 // math.gcd(ds, 2)
    eb = 2 * open_radius + 2
    eg = window + eb
    (_, _), (h1, w1) = _shapes(h, w, ds)
    rows, cols = 2 * h1, 2 * w1  # what the grid covers

    def staged(n, t, halo):  # grey rows (or columns) staged over n
        return -(-n // t) * (t + halo)

    wstep = step * 16 // math.gcd(step, 16) if w % 16 == 0 else step
    widest = min(BLOCK - 2 * eg, 32 * 9 - 2 * eb)
    widths = (list(range(wstep, widest + 1, wstep)) or list(range(step, widest + 1, step))
              or [step])
    tw = min(widths, key=lambda t: (staged(cols, t, 2 * eg), -t))
    window_rows = (32 if eb <= 10 else 64) - 2 * eb  # exact rows of a morphology window
    heights = range(step, min(MAX_ROWS, WARPS * window_rows) + 1, step)
    while True:
        two = [t for t in heights if smem_bytes(t, tw, window, open_radius) <= SMEM_TWO]
        if two:
            return min(two, key=lambda t: (staged(rows, t, 2 * eg), -t)), tw
        one = [t for t in heights if smem_bytes(t, tw, window, open_radius) <= SMEM_MAX]
        if one:
            return max(one), tw
        if tw <= step:
            raise ValueError(
                f"frontend: window {window} with open radius {open_radius} at ds {ds} "
                "does not fit the kernel's shared memory"
            )
        tw -= step


def tiles(h: int, w: int, ds: int, th: int, tw: int):
    """Yield, for each tile of the kernel's grid over one frame, the row and
    column ranges it writes: ((y, x) pixels, (cy, cx) coarse cells, (yi,
    xi) level-1 cells), each as ((start, stop), (start, stop)) — the
    kernel's index arithmetic, for tests."""
    (hc, wc), (h1, w1) = _shapes(h, w, ds)
    for y0 in range(0, max(h, 2 * h1), th):
        for x0 in range(0, max(w, 2 * w1), tw):
            yield (
                ((y0, min(y0 + th, h)), (x0, min(x0 + tw, w))),
                ((y0 // ds, min(y0 // ds + th // ds, hc)), (x0 // ds, min(x0 // ds + tw // ds, wc))),
                ((y0 // 2, min(y0 // 2 + th // 2, h1)), (x0 // 2, min(x0 // 2 + tw // 2, w1))),
            )


def plain(grey: torch.Tensor, window: int, open_radius: int, ds: int, opened: bool = False,
          chain: bool = False):
    """The same outputs from the ported XLA functions."""
    count.plain_calls += 1
    white = frontend.adaptive_threshold(grey, window)
    black = segment.open_mask(~white, open_radius)
    out = (segment.pool_black(black, ds), segment.near_mask(black),
           rectify.level1_plane(grey, chain))
    return out + (black,) if opened else out


def threshold_open_pool(
    grey: torch.Tensor, window: int, open_radius: int, ds: int, opened: bool = False,
    chain: bool = False,
):
    """(coarse, near, level1[, opened]) of (B, H, W) uint8 frames; see the
    module docstring.  CUDA tensors launch the kernel, CPU tensors take
    ``plain``."""
    if grey.device.type == "cpu":
        return plain(grey, window, open_radius, ds, opened, chain)
    if grey.ndim != 3:
        raise ValueError(f"grey: expected (B, H, W), got {tuple(grey.shape)}")
    b, h, w = grey.shape
    g = _build.checked_ptr(grey, torch.uint8, name="grey")
    th, tw = plan(h, w, window, open_radius, ds)
    (hc, wc), (h1, w1) = _shapes(h, w, ds)
    dev = grey.device
    near = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    black = torch.empty((b, h, w), dtype=torch.bool, device=dev) if opened else None
    coarse = torch.empty((b, hc, wc), dtype=torch.bool, device=dev)
    level1 = torch.empty((b, h1, w1), dtype=torch.bfloat16 if chain else torch.float32,
                         device=dev)
    err = _build.fn("a3_frontend")(
        g,
        near.data_ptr(),
        None if black is None else black.data_ptr(),
        coarse.data_ptr(),
        level1.data_ptr(),
        int(chain),
        b, h, w, window, open_radius, ds, th, tw, hc, wc, h1, w1,
        _build.stream(),
    )
    _build.check(err, "a3_frontend")
    count.launches += 1
    return (coarse, near, level1) if black is None else (coarse, near, level1, black)
