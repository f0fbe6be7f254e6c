"""Pinhole camera model; counterpart of ``aruco3_tpu/camera.py``.

Math methods accept Python scalars, numpy arrays or torch tensors and
broadcast, so one intrinsics object serves the scalar API and the batched
pose path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class CameraIntrinsics:
    image_width: int
    image_height: int
    focal_x: float
    focal_y: float
    principal_x: float
    principal_y: float

    @staticmethod
    def new(
        image_width: int,
        image_height: int,
        focal_x: float,
        focal_y: float,
        principal_x: float | None = None,
        principal_y: float | None = None,
    ) -> "CameraIntrinsics":
        """Principal point defaults to the image centre."""
        return CameraIntrinsics(
            image_width=image_width,
            image_height=image_height,
            focal_x=focal_x,
            focal_y=focal_y,
            principal_x=(
                principal_x if principal_x is not None else image_width / 2.0
            ),
            principal_y=(
                principal_y if principal_y is not None else image_height / 2.0
            ),
        )

    @staticmethod
    def new_from_fov_horizontal(
        horizontal_fov_radians: float,
        sensor_width_mm: float,
        resolution_x: int,
        resolution_y: int,
    ) -> "CameraIntrinsics":
        """Intrinsics from horizontal FOV, keeping the reference's
        vfov = hfov / aspect approximation."""
        aspect_ratio = resolution_x / resolution_y
        vertical_fov_radians = horizontal_fov_radians / aspect_ratio
        sensor_height_mm = sensor_width_mm / aspect_ratio
        horizontal_focal_length_mm = (sensor_width_mm * 0.5) / math.tan(
            horizontal_fov_radians * 0.5
        )
        vertical_focal_length_mm = (sensor_height_mm * 0.5) / math.tan(
            vertical_fov_radians * 0.5
        )
        return CameraIntrinsics(
            image_width=resolution_x,
            image_height=resolution_y,
            focal_x=horizontal_focal_length_mm,
            focal_y=vertical_focal_length_mm,
            principal_x=resolution_x * 0.5,
            principal_y=resolution_y * 0.5,
        )

    def project(self, x, y, z):
        """Camera space -> homogeneous image coords."""
        return (
            x * self.focal_x + z * self.principal_x,
            y * self.focal_y + z * self.principal_y,
            z,
        )

    def project_culled(self, x, y, z):
        """Perspective-divide projection; None when z <= 0 for scalars,
        (u, v, valid_mask) for tensors."""
        if np.isscalar(x) and np.isscalar(y) and np.isscalar(z):
            if z <= 0.0:
                return None
            return (
                (x * self.focal_x) / z + self.principal_x,
                (y * self.focal_y) / z + self.principal_y,
            )
        x, y, z = (torch.as_tensor(v) for v in (x, y, z))
        valid = z > 0.0
        zsafe = torch.where(valid, z, torch.ones_like(z))
        return (
            (x * self.focal_x) / zsafe + self.principal_x,
            (y * self.focal_y) / zsafe + self.principal_y,
            valid,
        )

    def unproject(self, x, y):
        """Image plane -> normalized camera coords at z=1."""
        return (
            (x - self.principal_x) / self.focal_x,
            (y - self.principal_y) / self.focal_y,
        )

    def k_matrix(self) -> np.ndarray:
        """3x3 K matrix."""
        return np.array(
            [
                [self.focal_x, 0.0, self.principal_x],
                [0.0, self.focal_y, self.principal_y],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        )

    def k_matrix_3x4(self) -> np.ndarray:
        """3x4 [K | 0] matrix."""
        return np.concatenate(
            [self.k_matrix(), np.zeros((3, 1), dtype=np.float32)], axis=1
        )


@dataclass(frozen=True)
class CameraExtrinsics:
    """World pose of the camera."""

    basis: np.ndarray = field(
        default_factory=lambda: np.eye(3, dtype=np.float32)
    )
    origin: np.ndarray = field(
        default_factory=lambda: np.zeros(3, dtype=np.float32)
    )


@dataclass(frozen=True)
class CameraModel:
    """Intrinsics + extrinsics bundle."""

    intrinsics: CameraIntrinsics
    extrinsics: CameraExtrinsics
