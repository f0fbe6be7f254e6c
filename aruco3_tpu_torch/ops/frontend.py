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

``plan`` sizes the kernel's strips, runs and chunks; ``tiles`` lists what
each chunk of each block's walk writes.  The wrapper keeps [rows a block
walks, chunk rows, blocks a launch] in its Counter's ``fields`` as
``frontend_layout``, which a graph's capture record logs.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import frontend, rectify, segment
from . import Counter, _build

count = Counter()

BLOCK = 288  # threads of a block; a strip is about this many grey columns wide
WARPS = BLOCK // 32
MAX_ROWS = 128  # rows of a frame-alone tile at most
CHUNK_MAX = 64  # rows of a walk's chunk at most: taller chunks would leave one block an SM
CHUNK_COST = 8  # a chunk's barriers and windows, in rows of work, as the plan weighs them
SMEM_MAX = 232_448  # shared memory a block may have
SMEM_SM = 233_472  # an SM's shared memory, of which each block reserves 1 KB
SMS = 132  # SMs of an H100 SXM, where the caller names no card
# The morphology keeps a window of 32 (or, for radii above 4, 64) mask rows
# in a warp; 2 * (2 r + 2) rows of each are its halo.
MAX_OPEN_RADIUS = 14


def smem_per_block(n: int) -> int:
    """Shared memory a block may take for n blocks to share an SM."""
    return min(SMEM_SM // n - 1024, SMEM_MAX)


def _shapes(h: int, w: int, ds: int):
    (ph0, pw0), = rectify.pyramid_level_shapes(h, w, 1)
    return (-(-h // ds), -(-w // ds)), (ph0 // 2, pw0 // 2)


def smem_bytes(rows: int, tw: int, window: int, open_radius: int, walk: bool) -> int:
    """Shared memory of a block with chunks of ``rows`` rows, ``tw`` wide
    (the layout of ``csrc/frontend.cu``: black words, column sums or the
    chunk's near and opened words, the grey ring, the row table); a walk of
    more than one chunk keeps the next chunk's rows and table too."""
    eb = 2 * open_radius + 2
    eg = window + eb
    mr, gc = rows + 2 * eb, tw + 2 * eg
    nw = -(-(tw + 2 * eb) // 32)
    pg = 16 * ((gc + 33) // 16 | 1)
    nr = (2 * rows if walk else rows) + 2 * eg
    wide = (2 * window + 1) * 255 > 65535
    pc = gc | 1 if wide else gc + (2 - gc) % 4

    def r16(n):
        return -(-n // 16) * 16

    sums = max(r16(mr * pc * (4 if wide else 2)), r16(2 * nw * rows * 4))
    return r16(nw * mr * 4) + sums + nr * pg + r16((2 if walk else 1) * (rows + 2 * eg) * 4)


@functools.lru_cache(maxsize=256)
def plan(b: int, h: int, w: int, window: int, open_radius: int, ds: int,
         sms: int = SMS) -> tuple[int, int, int]:
    """(run, chunk, tw) for b (h, w) frames on ``sms`` SMs: a block owns a
    strip of tw columns of one frame and walks ``run`` of its rows in
    chunks of ``chunk`` rows.  All three are multiples of lcm(ds, 2), so
    every coarse cell and level-1 cell lies inside one chunk of one strip;
    where w is a multiple of 16, tw is too, so that rows store whole
    16-byte chunks.  tw stages the fewest grey columns over the frame (halo
    included) with the halo within ``BLOCK`` columns and the mask row within
    9 words; for windows whose halo alone is wider (above ~137 at open
    radius 2) tw is lcm(ds, 2) and a thread sums two grey columns.

    Where the frames have at least as many strips as the card has SMs, the
    blocks walk: chunks of at most ``CHUNK_MAX`` rows (one morphology window
    a warp) that let two blocks share an SM (else one; the kernel's
    registers hold two), and, among the chunks and runs that give at least
    a wave of resident blocks, the fewest waves times what a block walks
    (its rows, ``CHUNK_COST`` rows a chunk, its halo rows), fewer blocks on
    a tie.  Otherwise (a frame
    alone), or where no walk fills the card, a block takes one chunk, a
    tile: among the heights that let two blocks share an SM the one that
    stages the fewest grey rows, else the tallest that fits.  Raises where
    not even one cell fits, and for an open radius above
    ``MAX_OPEN_RADIUS``."""
    if window < 0 or not 0 <= open_radius <= MAX_OPEN_RADIUS or ds < 1 or b < 1:
        raise ValueError(
            f"frontend: window {window}, open radius {open_radius} (at most "
            f"{MAX_OPEN_RADIUS}), ds {ds}, batch {b}"
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
    strips = -(-cols // tw)
    if b * strips < sms:
        # Fewer strips than SMs: the tiles of a frame alone, its grid no larger than before
        # the walk.  One-chunk walks of 40 and 8 rows (216 and 240 blocks) time within the
        # runs' spread of these tiles (1080p 0.0208 / 0.0212 ms, VGA 0.0197 / 0.0201; H100).
        th, tile_tw = _tile(rows, tw, step, window, open_radius, window_rows)
        return th, th, tile_tw
    for per_sm in (2, 1):
        fit = [t for t in range(step, min(CHUNK_MAX, WARPS * window_rows) + 1, step)
               if smem_bytes(t, tw, window, open_radius, True) <= smem_per_block(per_sm)]
        if fit:
            break
    resident = sms * per_sm
    # (waves x what a block walks: its rows, its chunks' fixed cost and its
    # halo rows; blocks) of each walk whose blocks fill the card at least once.
    walks = []
    for chunk in fit:
        chunks = -(-rows // chunk)
        for n in range(1, chunks + 1):
            blocks = b * strips * -(-chunks // n)
            if blocks < resident:
                break
            cost = -(-blocks // resident) * (n * (chunk + CHUNK_COST) + 2 * eg)
            walks.append((cost, blocks, n * chunk, chunk))
    if walks:
        _, _, run, chunk = min(walks)
        return run, chunk, tw
    th, tile_tw = _tile(rows, tw, step, window, open_radius, window_rows)
    return th, th, tile_tw


def _tile(rows, tw, step, window, open_radius, window_rows):
    """(th, tw) of a tile, a block's one chunk: among the heights that
    let two blocks share an SM the one that stages the fewest grey rows,
    else the tallest that fits in shared memory, narrowing tw until one
    does."""
    eg = window + 2 * open_radius + 2
    heights = range(step, min(MAX_ROWS, WARPS * window_rows) + 1, step)
    while True:
        two = [t for t in heights
               if smem_bytes(t, tw, window, open_radius, False) <= smem_per_block(2)]
        if two:
            return min(two, key=lambda t: (-(-rows // t) * (t + 2 * eg), -t)), tw
        one = [t for t in heights if smem_bytes(t, tw, window, open_radius, False) <= SMEM_MAX]
        if one:
            return max(one), tw
        if tw <= step:
            raise ValueError(
                f"frontend: window {window} with open radius {open_radius} does not fit the "
                "kernel's shared memory"
            )
        tw -= step


def grid(b: int, h: int, w: int, ds: int, run: int, tw: int) -> tuple[int, int, int]:
    """(strips, runs a strip, frames): the kernel's grid."""
    (_, _), (h1, w1) = _shapes(h, w, ds)
    return -(-2 * w1 // tw), -(-2 * h1 // run), b


def tiles(h: int, w: int, ds: int, run: int, chunk: int, tw: int):
    """Yield, for each block of the kernel's grid over one frame and each
    chunk of its walk, ((by, bx), k, ranges): the ranges the chunk writes,
    ((y, x) pixels, (cy, cx) coarse cells, (yi, xi) level-1 cells), each as
    ((start, stop), (start, stop)) — the kernel's index arithmetic, for
    tests."""
    (hc, wc), (h1, w1) = _shapes(h, w, ds)
    rows = max(h, 2 * h1)
    for by in range(-(-rows // run)):
        y0 = by * run
        for bx in range(-(-max(w, 2 * w1) // tw)):
            x0 = bx * tw
            for k in range(-(-min(run, rows - y0) // chunk)):
                y = y0 + k * chunk
                yield (by, bx), k, (
                    ((y, min(y + chunk, h)), (x0, min(x0 + tw, w))),
                    ((y // ds, min(y // ds + chunk // ds, hc)),
                     (x0 // ds, min(x0 // ds + tw // ds, wc))),
                    ((y // 2, min(y // 2 + chunk // 2, h1)), (x0 // 2, min(x0 // 2 + tw // 2, w1))),
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
    dev = grey.device
    run, chunk, tw = plan(b, h, w, window, open_radius, ds, _build.sm_count(dev.index))
    (hc, wc), (h1, w1) = _shapes(h, w, ds)
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
        b, h, w, window, open_radius, ds, run, chunk, tw, hc, wc, h1, w1,
        _build.stream(),
    )
    _build.check(err, "a3_frontend")
    count.launches += 1
    count.fields["frontend_layout"] = [run, chunk, math.prod(grid(b, h, w, ds, run, tw))]
    return (coarse, near, level1) if black is None else (coarse, near, level1, black)
