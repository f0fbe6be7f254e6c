"""The comparison that decides ``correct``: the timed path's results on the
host against the reference's on the same frames.

Three numbers, each with its limit from the configuration's ``check``:

* ``lanes_apart``: lanes whose marker_valid differs, or where both are
  valid and marker_id, marker_dist or marker_code differ (exact: limit 0);
* ``corner_gap_px``: the largest gap of a marker corner, in pixels, over
  the lanes valid on both sides;
* ``pose_gap``: over the same lanes and both IPPE poses, the largest gap
  of a rotation entry or of a translation relative to the reference's
  translation norm.
"""

from __future__ import annotations

import numpy as np
import torch

# Frames the reference takes at once.
BLOCK = 16
# The fields the timed path copies to the host, in their order.
FIELDS = ("marker_valid", "marker_id", "marker_dist", "marker_code", "marker_corners",
          "rotations", "translations", "errors")


def reference_results(frames: torch.Tensor, dictionary, cfg, width: int, height: int,
                      marker_mm: float) -> dict:
    """The reference's fields (numpy, leading axis over ``frames``), run in
    blocks of ``BLOCK`` frames on the frames' device."""
    from ..reference import detect as ref

    parts = []
    for i in range(0, frames.shape[0], BLOCK):
        out = ref.detect_batch(frames[i:i + BLOCK], dictionary, cfg)
        rot, tr, err = ref.solve_pose(out["marker_corners"], width, height, marker_mm)
        out.update(rotations=rot, translations=tr, errors=err)
        parts.append({k: out[k].cpu().numpy() for k in FIELDS})
    return {k: np.concatenate([p[k] for p in parts]) for k in FIELDS}


def compare(got: dict, want: dict) -> dict:
    """The three numbers for the rows of ``got`` against the same rows of
    ``want`` (numpy dicts of ``FIELDS``)."""
    vg, vw = got["marker_valid"].astype(bool), want["marker_valid"].astype(bool)
    both = vg & vw
    same = ((got["marker_id"] == want["marker_id"]) & (got["marker_dist"] == want["marker_dist"])
            & (got["marker_code"] == want["marker_code"]).all(axis=-1))
    lanes_apart = int(((vg != vw) | (both & ~same)).sum())
    corner_gap = 0.0
    pose_gap = 0.0
    if both.any():
        cg = np.abs(got["marker_corners"][both].astype(np.float64)
                    - want["marker_corners"][both].astype(np.float64))
        corner_gap = float(np.nan_to_num(cg, nan=np.inf).max())
        rg = np.abs(got["rotations"][both].astype(np.float64)
                    - want["rotations"][both].astype(np.float64)).max(axis=(-2, -1))
        tw = want["translations"][both].astype(np.float64)
        tg = (np.linalg.norm(got["translations"][both].astype(np.float64) - tw, axis=-1)
              / np.maximum(np.linalg.norm(tw, axis=-1), 1e-9))
        pose_gap = float(np.nan_to_num(np.maximum(rg, tg), nan=np.inf).max())
    return {"lanes_apart": lanes_apart, "corner_gap_px": corner_gap, "pose_gap": pose_gap}


def worst(readings: list[dict]) -> dict:
    """Each number's worst over several comparisons."""
    out = {"lanes_apart": 0, "corner_gap_px": 0.0, "pose_gap": 0.0}
    for r in readings:
        out["lanes_apart"] += r["lanes_apart"]
        out["corner_gap_px"] = max(out["corner_gap_px"], r["corner_gap_px"])
        out["pose_gap"] = max(out["pose_gap"], r["pose_gap"])
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    return all(numbers[k] <= limits[k] for k in numbers), table
