"""Multi-device execution: frame-batch data parallelism over
``torch.distributed``; the counterpart of ``aruco3_tpu/parallel/sharding.py``.

The reference is single-threaded per frame; its only parallelism is
per-frame independence.  Here the frame batch is the scaling axis: each
rank runs the identical detect(+pose) step on its own rows of the batch,
with no collective on that path (detections are per frame).  Only
``detect_sharded``, the one-shot wrapper, gathers the outputs so that
every rank holds the whole batch's.

The process group is the caller's (``torch.distributed.init_process_group``
with an address or a store, a world size and a rank).  Under NCCL each
rank runs on ``cuda:<local rank>`` (its rank modulo the node's card
count); under gloo, which is how a caller asks for the CPU, on the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import pose as pose_mod
from .. import segment
from ..detector import Detector, detect_batch_arrays

OUTPUT_KEYS = ("marker_valid", "marker_id", "marker_dist", "marker_corners", "marker_code")
POSE_KEYS = ("pose_rotations", "pose_translations", "pose_errors")


def rank_device(group=None) -> torch.device:
    """The device this rank runs on: ``cuda:<local rank>`` under NCCL, the
    CPU under any other backend."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", dist.get_rank(group) % torch.cuda.device_count())
    return torch.device("cpu")


def parallel_geometry(cfg, height: int, width: int):
    """(params, min_edge, min_sep, ds) as the JAX package's
    ``build_sharded_detect`` and ``build_spatial_detect`` derive them: the
    quad parameters take only
    ``max_candidates``, ``coarse_factor``, ``ccl_rounds`` and ``refine``
    from the config (the JAX package is the parity contract; at the
    default config they equal ``Detector.geometry``'s)."""
    ds = cfg.coarse_factor or segment.choose_coarse_factor(height, width)
    params = segment.QuadParams(
        max_candidates=cfg.max_candidates,
        coarse_factor=ds,
        ccl_rounds=cfg.ccl_rounds,
        refine=cfg.refine_corners,
    )
    min_edge = min(width, height) * cfg.min_side_length_factor
    min_sep = min(width, height) * cfg.min_corner_separation_factor
    return params, min_edge, min_sep, ds


def shard_frames(frames, group=None) -> torch.Tensor:
    """This rank's rows of a (B, ...) batch; B must divide by the world size."""
    frames = torch.as_tensor(frames)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    b = frames.shape[0]
    if b % world:
        raise ValueError(f"batch {b} does not divide by the world size {world}")
    n = b // world
    return frames[rank * n : (rank + 1) * n]


def build_sharded_detect(
    detector: Detector,
    height: int,
    width: int,
    channels: int = 1,
    with_pose: bool = False,
    marker_size_mm: float = 40.0,
    group=None,
):
    """A detect(+pose) step for this rank's shard: (b, H, W[, C]) uint8 ->
    dict of batched outputs on the rank's device (``rank_device``), with
    the quad parameters of ``parallel_geometry``.  On a card the step
    replays a CUDA graph of detect(+pose) a shard shape, kept in the
    detector's graph cache (as the JAX package jits the sharded step); the
    collectives stay outside it."""
    cfg = detector.config
    dictionary = detector.dictionary
    device = rank_device(group)
    params, min_edge, min_sep, ds = parallel_geometry(cfg, height, width)
    frame_dims = (height, width) if channels == 1 else (height, width, channels)

    def make():
        scale = torch.tensor([float(width), float(height)], dtype=torch.float32, device=device)

        def local_step(frames):
            """Runs on this rank over its local frame shard."""
            out = detect_batch_arrays(frames, dictionary, cfg, params, min_edge, min_sep, ds)
            res = {k: out[k] for k in OUTPUT_KEYS}
            if with_pose:
                # Normalize per axis by the image dims (reference pose.rs:59-62)
                # and solve IPPE for every candidate lane (masked lanes produce
                # garbage poses that carry marker_valid=False).
                rot, tr, err = pose_mod.solve_normalized_batch(
                    out["marker_corners"] / scale, marker_size_mm
                )
                res["pose_rotations"] = rot
                res["pose_translations"] = tr
                res["pose_errors"] = err
            return res

        return local_step

    eager = make() if device.type != "cuda" else None

    def step(frames):
        frames = torch.as_tensor(frames)
        if tuple(frames.shape[1:]) != frame_dims:
            raise ValueError(f"frames {tuple(frames.shape)}, step built for (b, {frame_dims})")
        if eager is not None:
            return eager(frames.to(device))
        key = ("sharded", tuple(frames.shape), with_pose, marker_size_mm, str(device))
        return detector.graphs.get(key, make, [(frames.shape, frames.dtype)], device)(frames)

    return step


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked along the first axis in rank order, on
    every rank (``all_gather_into_tensor``; booleans travel as bytes)."""
    world = dist.get_world_size(group)
    send = t.contiguous().view(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    whole = torch.empty((world * send.shape[0],) + send.shape[1:], dtype=send.dtype,
                        device=send.device)
    dist.all_gather_into_tensor(whole, send, group=group)
    return whole.view(torch.bool) if t.dtype == torch.bool else whole


def detect_sharded(
    detector: Detector,
    frames,
    with_pose: bool = False,
    marker_size_mm: float = 40.0,
    group=None,
) -> dict:
    """One-shot wrapper: every rank passes the whole (B, H, W[, C]) batch,
    runs its shard, and gets the whole batch's outputs (on its device)."""
    frames = torch.as_tensor(frames)
    h, w = frames.shape[1], frames.shape[2]
    channels = 1 if frames.ndim == 3 else frames.shape[-1]
    step = build_sharded_detect(
        detector, h, w, channels, with_pose=with_pose, marker_size_mm=marker_size_mm,
        group=group,
    )
    res = step(shard_frames(frames, group))
    return {k: gather_rows(v, group) for k, v in res.items()}
