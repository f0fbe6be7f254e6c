"""Spatial sharding: one large frame split row-wise across the ranks; the
counterpart of ``aruco3_tpu/parallel/spatial.py``.

The full-resolution threshold and opening, the only stages whose cost
scales with the pixel count, run sharded, each rank on a horizontal band
of the frame:

  1. halo exchange: each rank sends its boundary rows to its neighbours
     (``batch_isend_irecv``; the threshold box and the opening need
     window + 2 * open_radius rows of context);
  2. per band, the exact adaptive threshold and opening with the frame's
     border semantics kept through global row indices
     (``_threshold_open_tile``), and the pooling;
  3. the black, coarse and grey bands are gathered in row order
     (``all_gather_into_tensor``) and the candidate tail
     (``detector.detect_from_masks``), whose cost does not grow with the
     resolution, runs replicated on every rank.

The process group is the caller's; see ``parallel.sharding`` for the
devices (NCCL: ``cuda:<local rank>``; gloo: the CPU).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import segment
from ..detector import Detector, detect_from_masks, frame_of
from .sharding import gather_rows, parallel_geometry, rank_device

OPEN_RADIUS = 2  # as the JAX ``build_spatial_detect``, whatever the config says


def _threshold_open_tile(
    grey_ext: torch.Tensor,
    row0: int,
    h: int,
    w: int,
    window: int,
    open_radius: int,
    halo: int,
) -> torch.Tensor:
    """Exact adaptive threshold + opening for the central rows of a band.

    grey_ext: (Hs + 2*halo, W) u8 with the neighbours' halos (zeros outside
    the image).  row0: global index of the first central row.  Returns the
    opened black mask of the central Hs rows, equal to the whole frame's.
    """
    g = grey_ext.to(torch.int32)
    n_ext = g.shape[0]
    dev = g.device

    # Box sums over the zero-padded extended band (columns zero-padded too).
    gp = torch.nn.functional.pad(g, (window, window))
    cum_w = torch.nn.functional.pad(torch.cumsum(gp, dim=1, dtype=torch.int32), (1, 0))
    row_sums = cum_w[:, 2 * window + 1 :] - cum_w[:, : -(2 * window) - 1]  # (n_ext, W)
    cum_h = torch.nn.functional.pad(
        torch.cumsum(row_sums, dim=0, dtype=torch.int32), (0, 0, 1, 0)
    )
    # The row cumsum edge-padded by ``window`` on both sides: rows beyond
    # the band count as empty; the halo covers what the opening reads.
    i = torch.arange(n_ext, device=dev)
    sums = cum_h[(i + window + 1).clamp(max=n_ext)] - cum_h[(i - window).clamp(min=0)]

    # Clamped counts from global coordinates.
    rows_abs = row0 - halo + i[:, None]
    cols_abs = torch.arange(w, device=dev)[None, :]
    crow = (rows_abs + window).clamp(0, h - 1) - (rows_abs - window).clamp(0, h - 1) + 1
    ccol = (cols_abs + window).clamp(0, w - 1) - (cols_abs - window).clamp(0, w - 1) + 1
    inside = (rows_abs >= 0) & (rows_abs < h)

    white = g * (crow * ccol).to(torch.int32) >= sums
    black = ~white | ~inside

    # Opening with the whole frame's border semantics: erosion sees black
    # outside the image; the eroded mask is cleared outside before the
    # dilation (cf. segment.open_mask's pad values).
    for _ in range(open_radius):
        black = segment._erode3(black)
    black = black & inside
    for _ in range(open_radius):
        black = segment._dilate3(black)
    black = black & inside
    return black[halo : n_ext - halo]


def _exchange_halos(band: torch.Tensor, halo: int, group=None):
    """(rows from the rank above, rows from the rank below): ``halo`` rows
    each, zeros at the frame's top and bottom edges."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    from_above = torch.zeros((halo,) + band.shape[1:], dtype=band.dtype, device=band.device)
    from_below = torch.zeros_like(from_above)

    def peer(r):
        return r if group is None else dist.get_global_rank(group, r)

    ops = []
    if rank + 1 < world:  # my bottom rows go down, the next rank's top rows come up
        ops.append(dist.P2POp(dist.isend, band[-halo:].contiguous(), peer(rank + 1), group))
        ops.append(dist.P2POp(dist.irecv, from_below, peer(rank + 1), group))
    if rank > 0:
        ops.append(dist.P2POp(dist.isend, band[:halo].contiguous(), peer(rank - 1), group))
        ops.append(dist.P2POp(dist.irecv, from_above, peer(rank - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_above, from_below


def build_spatial_detect(detector: Detector, height: int, width: int, group=None):
    """A single-frame, row-sharded detect step: this rank's (H / world, W)
    uint8 band -> the frame's outputs (as ``detector.detect_arrays``), the
    same on every rank.  H must divide by world * coarse_factor (pad the
    frame otherwise, as ``detect_spatial`` does).

    The quad parameters are the JAX package's (``sharding.parallel_geometry``),
    and so is the open radius, 2.
    """
    cfg = detector.config
    dictionary = detector.dictionary
    device = rank_device(group)
    params, min_edge, min_sep, ds = parallel_geometry(cfg, height, width)
    world = dist.get_world_size(group)
    halo = cfg.threshold_window + 2 * OPEN_RADIUS
    if height % (world * ds):
        raise ValueError(f"H={height} must divide by ranks * coarse factor ({world}*{ds})")
    hs = height // world
    if hs < halo:
        raise ValueError(f"a band of {hs} rows is narrower than the halo of {halo}")

    def step(band):
        band = torch.as_tensor(band).to(device).reshape(hs, width)
        from_above, from_below = _exchange_halos(band, halo, group)
        grey_ext = torch.cat([from_above, band, from_below])
        row0 = dist.get_rank(group) * hs
        black_band = _threshold_open_tile(
            grey_ext, row0, height, width, cfg.threshold_window, OPEN_RADIUS, halo
        )
        coarse_band = segment.pool_black(black_band, ds)
        # Gather the masks and the grey frame; the candidate tail, whose
        # cost does not grow with the resolution, runs on every rank.
        black = gather_rows(black_band, group)
        coarse = gather_rows(coarse_band, group)
        grey = gather_rows(band, group)
        out = detect_from_masks(
            grey[None], black[None], coarse[None], dictionary, cfg, params, min_edge, min_sep, ds
        )
        return frame_of(out, 0)

    return step


def detect_spatial(detector: Detector, frame, group=None) -> dict:
    """One-shot: split one (H, W) uint8 frame's rows over the ranks and
    detect; every rank passes the whole frame and gets the outputs."""
    frame = torch.as_tensor(frame)
    h, w = frame.shape
    world = dist.get_world_size(group)
    ds = detector.config.coarse_factor or segment.choose_coarse_factor(h, w)
    pad = (-h) % (world * ds)
    if pad:
        # Pad with white (background) rows; markers never extend there.
        frame = torch.nn.functional.pad(frame, (0, 0, 0, pad), value=255)
        h += pad
    step = build_spatial_detect(detector, h, w, group)
    hs = h // world
    rank = dist.get_rank(group)
    return step(frame[rank * hs : (rank + 1) * hs])
