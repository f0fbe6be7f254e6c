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

The JAX package compiles the three steps as one program.  Here, on a
card, the work between the collectives is replayed from CUDA graphs in
the detector's graph cache: the band graph (``band_stage``: step 2, a
graph a rank and world size, since the band's first row is fixed per
rank) and the masks graph (``masks_stage``: the candidate tail, a graph
a frame shape).  The halo exchange and the gathers run eagerly between
them: a graph holds no NCCL operation.  Under gloo, which is how a
caller asks for the CPU, the step runs eagerly.

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


def band_stage(row0: int, height: int, width: int, window: int, halo: int, ds: int):
    """The band graph's function: a rank's (Hs + 2*halo, W) uint8 band with
    its halos, whose first central row is the frame's row ``row0`` ->
    (its opened black mask (Hs, W) bool, that mask's pooling (Hs / ds,
    ceil(W / ds)) bool)."""

    def stage(grey_ext):
        black = _threshold_open_tile(grey_ext, row0, height, width, window, OPEN_RADIUS, halo)
        return black, segment.pool_black(black, ds)

    return stage


def masks_stage(dictionary, cfg, params, min_edge, min_sep, ds):
    """The masks graph's function: the candidate tail
    (``detector.detect_from_masks``) of (1, H, W) grey, (1, H, W) black
    and (1, H / ds, ceil(W / ds)) coarse masks -> its batched outputs."""

    def stage(grey, black, coarse):
        return detect_from_masks(grey, black, coarse, dictionary, cfg, params, min_edge, min_sep,
                                 ds)

    return stage


def build_spatial_detect(detector: Detector, height: int, width: int, group=None,
                         graphs: bool = True):
    """A single-frame, row-sharded detect step: this rank's (H / world, W)
    uint8 band -> the frame's outputs (as ``detector.detect_arrays``), the
    same on every rank.  H must divide by world * coarse_factor (pad the
    frame otherwise, as ``detect_spatial`` does).

    On a card the two stages replay their CUDA graphs (``graphs=False``
    runs them eagerly, as under gloo: the twin the graphs are held
    against).  The quad parameters are the JAX package's
    (``sharding.parallel_geometry``), and so is the open radius, 2.
    """
    cfg = detector.config
    dictionary = detector.dictionary
    device = rank_device(group)
    params, min_edge, min_sep, ds = parallel_geometry(cfg, height, width)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    halo = cfg.threshold_window + 2 * OPEN_RADIUS
    if height % (world * ds):
        raise ValueError(f"H={height} must divide by ranks * coarse factor ({world}*{ds})")
    hs = height // world
    if hs < halo:
        raise ValueError(f"a band of {hs} rows is narrower than the halo of {halo}")

    def make_band():
        return band_stage(rank * hs, height, width, cfg.threshold_window, halo, ds)

    def make_masks():
        return masks_stage(dictionary, cfg, params, min_edge, min_sep, ds)

    if device.type == "cuda" and graphs:
        cache = detector.graphs  # the step holds the cache; no graph holds the detector
        band_key = ("spatial_band", height, width, world, rank, str(device))
        masks_key = ("spatial_masks", height, width, str(device))
        masks_in = (((1, height, width), torch.uint8), ((1, height, width), torch.bool),
                    ((1, height // ds, -(-width // ds)), torch.bool))

        def run_band(grey_ext):
            return cache.get(band_key, make_band, [(grey_ext.shape, torch.uint8)], device)(grey_ext)

        def run_masks(grey, black, coarse):
            return cache.get(masks_key, make_masks, masks_in, device)(grey, black, coarse)
    else:
        run_band, run_masks = make_band(), make_masks()

    def step(band):
        band = torch.as_tensor(band).to(device).reshape(hs, width)
        from_above, from_below = _exchange_halos(band, halo, group)
        black_band, coarse_band = run_band(torch.cat([from_above, band, from_below]))
        # Gather the masks and the grey frame; the candidate tail, whose
        # cost does not grow with the resolution, runs on every rank.
        black = gather_rows(black_band, group)
        coarse = gather_rows(coarse_band, group)
        grey = gather_rows(band, group)
        return frame_of(run_masks(grey[None], black[None], coarse[None]), 0)

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
