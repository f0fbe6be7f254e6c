#!/usr/bin/env python3
"""Pose-accuracy simulator on the PyTorch/CUDA port: render -> detect ->
IPPE -> compare.  The counterpart of ``examples/pose_accuracy_sim.py``.

Sweeps a seeded camera orbit around marker 17 of ``ARUCO_DEFAULT`` (40
mm, a 640x480 camera with a 60 degree horizontal field of view), detects
each rendered view with the port's detector on the card (``--cpu`` asks
for the CPU), solves its pose through the camera's intrinsics and reports
the translation and normal-axis error against the pose it was rendered
from.

Usage: python examples/torch_pose_accuracy_sim.py [n_views] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from aruco3_tpu_torch import ARDictionary, CameraIntrinsics, Detector, DetectorConfig, pose
from aruco3_tpu_torch.render import project_marker_corners, render_marker

IMAGE_SIZE = (640, 480)
MARKER_MM = 40.0
MARKER_ID = 17


def camera() -> CameraIntrinsics:
    """The simulated camera's intrinsics in pixels (focal in mm times px
    per mm)."""
    w, h = IMAGE_SIZE
    intr = CameraIntrinsics.new_from_fov_horizontal(np.deg2rad(60.0), 36.0, w, h)
    px_per_mm = w / 36.0
    return CameraIntrinsics.new(w, h, intr.focal_x * px_per_mm, intr.focal_y * px_per_mm)


def orbit_views(n_views: int, dictionary: ARDictionary, intr_px: CameraIntrinsics):
    """Yields (image (480, 640) u8, rotation (3, 3), translation (3,) mm)
    of each view, the marker facing the camera from a seeded yaw, pitch
    and position (one generator, seed 0, for the poses and the noise)."""
    rng = np.random.default_rng(0)
    for _ in range(n_views):
        yaw = rng.uniform(-0.6, 0.6)
        pitch = rng.uniform(-0.5, 0.5)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        r_yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        r_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        # Face the camera: flip Y/Z of the canonical marker frame.
        rot = r_yaw @ r_pitch @ np.diag([1.0, -1.0, -1.0])
        trans = np.array([rng.uniform(-30, 30), rng.uniform(-20, 20), rng.uniform(250, 450)])
        corners = project_marker_corners(rot, trans, MARKER_MM, intr_px)
        img = render_marker(dictionary, MARKER_ID, IMAGE_SIZE, corners, noise_sigma=2.0, rng=rng)
        yield img, rot, trans


def simulate(n_views: int = 24, device: str = "cuda") -> dict:
    """Render, detect on ``device`` and solve each of ``n_views`` views.

    Returns {"views": per view {"image": the rendered frame, "ids": the
    ids found, "translation" (3,) and "normal" (3,) of the best pose of
    marker 17, or None where it was missed, "t_err_mm", "r_err_deg" (None
    where missed)}, "detected": the views where marker 17 was found,
    "t_errs", "r_errs": their errors}."""
    dictionary = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    detector = Detector(DetectorConfig(), dictionary, device=device)
    intr_px = camera()
    views = []
    for img, rot, trans in orbit_views(n_views, dictionary, intr_px):
        det = detector.detect(img)
        view = {"image": img, "ids": [m.id for m in det.markers], "translation": None,
                "normal": None, "t_err_mm": None, "r_err_deg": None}
        match = [m for m in det.markers if m.id == MARKER_ID]
        if match:
            best, _alt = pose.solve_with_intrinsics(match[0].corners, MARKER_MM, intr_px)
            t_est = np.asarray(best.translation, np.float64)
            z_est = np.asarray(best.rotation, np.float64)[:, 2]
            view.update(
                translation=t_est,
                normal=z_est,
                t_err_mm=float(np.linalg.norm(t_est - trans)),
                r_err_deg=float(np.degrees(np.arccos(np.clip(np.dot(rot[:, 2], z_est), -1, 1)))),
            )
        views.append(view)
    found = [v for v in views if v["t_err_mm"] is not None]
    return {
        "views": views,
        "detected": len(found),
        "t_errs": np.array([v["t_err_mm"] for v in found]),
        "r_errs": np.array([v["r_err_deg"] for v in found]),
    }


def report(result: dict) -> list[str]:
    """The lines the JAX example prints for ``simulate``'s result."""
    t_errs, r_errs = result["t_errs"], result["r_errs"]
    lines = [f"views: {len(result['views'])}  detected: {result['detected']}"]
    if len(t_errs):
        lines.append(
            f"translation error mm: mean={t_errs.mean():.2f} "
            f"p95={np.percentile(t_errs, 95):.2f} max={t_errs.max():.2f}"
        )
        lines.append(
            f"normal-axis error deg: mean={r_errs.mean():.2f} "
            f"p95={np.percentile(r_errs, 95):.2f} max={r_errs.max():.2f}"
        )
    return lines


def main() -> None:
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    device = "cpu" if "--cpu" in sys.argv[1:] else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --cpu to detect on the CPU")
    print("\n".join(report(simulate(int(args[0]) if args else 24, device))))


if __name__ == "__main__":
    main()
