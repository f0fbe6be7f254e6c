"""IPPE (Infinitesimal Plane-based Pose Estimation), batched; counterpart
of ``aruco3_tpu/pose.py``.

Recovers the two physically plausible 6-DoF poses of a square fiducial
from its four image corners, OpenCV chirality (+Z forward, +Y down, +X
right).  ``solve_normalized_batch`` is the structure-of-arrays solve the
detector's pose step uses: every quantity is a (batch,)-shaped component
tensor, so the solve is elementwise float32 math over the marker lanes.
The 3x3-matrix helpers below it keep the reference-shaped API.
"""

from __future__ import annotations

import functools
import numbers
from dataclasses import dataclass

import numpy as np
import torch

from .camera import CameraIntrinsics
from .utils import profiling

_DEGENERATE_EPS = 1e-6  # find_rotation_to_z stability guard
_Z_CLAMP = 1e-5  # reprojection z clamp


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclass
class MarkerPose:
    """Rigid transform placing a canonical marker into the camera frame;
    a single pose (rotation (3, 3)) or a batch (rotation (..., 3, 3))."""

    error: torch.Tensor
    rotation: torch.Tensor
    translation: torch.Tensor

    @staticmethod
    def default() -> "MarkerPose":
        """Identity pose with sentinel error 1e31."""
        return MarkerPose(
            error=_f32(1e31),
            rotation=torch.eye(3, dtype=torch.float32),
            translation=torch.zeros(3, dtype=torch.float32),
        )

    def apply_transform_to_points(self, points):
        """R @ p + t for (..., N, 3) points."""
        pts = torch.as_tensor(points, dtype=self.rotation.dtype)
        return pts @ self.rotation.transpose(-1, -2) + self.translation[
            ..., None, :
        ]

    def apply_transform_to_vectors(self, vectors):
        return self.apply_transform_to_points(vectors)

    def apply_inverse_transform_to_points(self, points):
        """R^T @ (p - t)."""
        pts = torch.as_tensor(points, dtype=self.rotation.dtype)
        return (pts - self.translation[..., None, :]) @ self.rotation

    def apply_inverse_transform_to_vectors(self, vectors):
        return self.apply_inverse_transform_to_points(vectors)


def make_marker_square(marker_size_mm) -> torch.Tensor:
    """Canonical object points (..., 4, 3), clockwise from top-left at
    z=0, +Y up / +X right."""
    hw = 0.5 * _f32(marker_size_mm)
    zeros = torch.zeros_like(hw)
    return torch.stack(
        [
            torch.stack([-hw, hw, zeros], dim=-1),
            torch.stack([hw, hw, zeros], dim=-1),
            torch.stack([hw, -hw, zeros], dim=-1),
            torch.stack([-hw, -hw, zeros], dim=-1),
        ],
        dim=-2,
    )


@functools.lru_cache(maxsize=None)
def marker_square_on(marker_size_mm: float, device: torch.device) -> torch.Tensor:
    """``make_marker_square(marker_size_mm)`` on ``device``, built once per
    size and device."""
    return make_marker_square(marker_size_mm).to(device)


@functools.lru_cache(maxsize=None)
def _flip_z(device: torch.device) -> torch.Tensor:
    """diag(1, 1, -1) on ``device``, built once per device."""
    return torch.diag(torch.tensor([1.0, 1.0, -1.0])).to(device)


def compute_homography_from_marker_square(
    marker_size_mm, target_points: torch.Tensor
) -> torch.Tensor:
    """Closed-form homography (H[2,2] = 1) from the canonical square to
    (..., 4, 2) normalized image points.  A marker size given as a number
    stays on the host (no tensor is built from it); a tensor is moved to
    the points' device."""
    tp = target_points.to(torch.float32)
    if isinstance(marker_size_mm, numbers.Real):
        # 1 / (2 * hw) with hw = 0.5 * size: float32 1 / size, as the tensor
        # path rounds it.
        inv2 = float(np.float32(1.0) / np.float32(marker_size_mm))
    else:
        hw = torch.broadcast_to(0.5 * _f32(marker_size_mm).to(tp.device), tp.shape[:-2])
        inv2 = 1.0 / (2.0 * hw)
    u0, u1, u2, u3 = (tp[..., i, 0] for i in range(4))
    v0, v1, v2, v3 = (tp[..., i, 1] for i in range(4))
    d1u, d1v = u1 - u2, v1 - v2
    d2u, d2v = u3 - u2, v3 - v2
    su = u0 - u1 + u2 - u3
    sv = v0 - v1 + v2 - v3
    den = d1u * d2v - d2u * d1v
    den = torch.where(torch.abs(den) < 1e-20, torch.full_like(den, 1e-20), den)
    g = (su * d2v - sv * d2u) / den
    hh = (d1u * sv - d1v * su) / den
    a11 = u1 - u0 + g * u1
    a12 = u3 - u0 + hh * u3
    a21 = v1 - v0 + g * v1
    a22 = v3 - v0 + hh * v3
    h00 = a11 * inv2
    h01 = -a12 * inv2
    h02 = 0.5 * (a11 + a12) + u0
    h10 = a21 * inv2
    h11 = -a22 * inv2
    h12 = 0.5 * (a21 + a22) + v0
    h20 = g * inv2
    h21 = -hh * inv2
    h22 = 0.5 * (g + hh) + 1.0
    s = 1.0 / h22
    return torch.stack(
        [
            torch.stack([h00 * s, h01 * s, h02 * s], dim=-1),
            torch.stack([h10 * s, h11 * s, h12 * s], dim=-1),
            torch.stack([h20 * s, h21 * s, torch.ones_like(h22)], dim=-1),
        ],
        dim=-2,
    )


def find_rotation_to_z(vec) -> torch.Tensor:
    """Rotation aligning ``vec`` with +Z, batched; diag(1, 1, -1) when
    |1 + az| < 1e-6."""
    v = _f32(vec)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ax, ay, az = v[..., 0], v[..., 1], v[..., 2]
    degenerate = torch.abs(1.0 + az) < _DEGENERATE_EPS
    d = 1.0 / torch.where(degenerate, torch.ones_like(az), 1.0 + az)
    ax2, ay2, axay = ax * ax, ay * ay, ax * ay
    r = torch.stack(
        [
            -ax2 * d + 1.0, -axay * d, -ax,
            -axay * d, -ay2 * d + 1.0, -ay,
            ax, ay, 1.0 - (ax2 + ay2) * d,
        ],
        dim=-1,
    ).reshape(v.shape[:-1] + (3, 3))
    flip = _flip_z(v.device).expand(r.shape)
    return torch.where(degenerate[..., None, None], flip, r)


def compute_rotations(jacobian, translation2):
    """The two IPPE rotation candidates from the (..., 2, 2) jacobian at
    the marker origin and the (..., 2) origin projection."""
    jacobian = _f32(jacobian)
    translation2 = _f32(translation2)
    tx, ty = translation2[..., 0], translation2[..., 1]
    t3 = torch.stack([tx, ty, torch.ones_like(tx)], dim=-1)
    rv = find_rotation_to_z(t3).transpose(-1, -2)
    b = rv[..., :2, :2] - translation2[..., :, None] * rv[..., 2:3, :2]
    det = b[..., 0, 0] * b[..., 1, 1] - b[..., 0, 1] * b[..., 1, 0]
    binv = torch.stack(
        [b[..., 1, 1], -b[..., 0, 1], -b[..., 1, 0], b[..., 0, 0]], dim=-1
    ).reshape(b.shape) * (1.0 / det)[..., None, None]
    a = binv @ jacobian
    ata00 = a[..., 0, 0] ** 2 + a[..., 0, 1] ** 2
    ata01 = a[..., 0, 0] * a[..., 1, 0] + a[..., 0, 1] * a[..., 1, 1]
    ata11 = a[..., 1, 0] ** 2 + a[..., 1, 1] ** 2
    gamma = torch.sqrt(
        0.5 * (ata00 + ata11 + torch.sqrt((ata00 - ata11) ** 2 + 4.0 * ata01**2))
    )
    rt = a / gamma[..., None, None]
    rt00, rt01 = rt[..., 0, 0], rt[..., 0, 1]
    rt10, rt11 = rt[..., 1, 0], rt[..., 1, 1]
    b0 = torch.sqrt(torch.clamp(1.0 - rt00**2 - rt10**2, min=0.0))
    b1 = torch.sqrt(torch.clamp(1.0 - rt01**2 - rt11**2, min=0.0))
    sp = -rt00 * rt01 - rt10 * rt11
    b1 = torch.where(sp < 0.0, -b1, b1)

    def assemble(b0, b1):
        c0 = torch.stack([rt00, rt10, b0], dim=-1)
        c1 = torch.stack([rt01, rt11, b1], dim=-1)
        c2 = torch.linalg.cross(c0, c1)
        return rv @ torch.stack([c0, c1, c2], dim=-1)

    return assemble(b0, b1), assemble(-b0, -b1)


def compute_translation(object_points, normalized_image_points, rot):
    """Least-squares translation for a rotation candidate (3x3 normal
    equations)."""
    object_points = _f32(object_points)
    normalized_image_points = _f32(normalized_image_points)
    rp = object_points @ _f32(rot).transpose(-1, -2)
    a2 = -normalized_image_points[..., 0]
    b2 = -normalized_image_points[..., 1]
    batch = rp.shape[:-2]
    n = torch.full(batch, float(object_points.shape[-2]))
    zero = torch.zeros(batch)
    sa = a2.sum(-1)
    sb = b2.sum(-1)
    sab = (a2 * a2 + b2 * b2).sum(-1)
    ata = torch.stack([n, zero, sa, zero, n, sb, sa, sb, sab], dim=-1).reshape(
        batch + (3, 3)
    )
    rx, ry, rz = rp[..., 0], rp[..., 1], rp[..., 2]
    bx = -a2 * rz - rx
    by = -b2 * rz - ry
    atb = torch.stack(
        [bx.sum(-1), by.sum(-1), (a2 * bx + b2 * by).sum(-1)], dim=-1
    )
    return torch.linalg.solve(ata, atb[..., None])[..., 0]


def compute_reprojection_error(
    rotation, translation, object_points, normalized_image_points
):
    """Sum of per-point reprojection distances, z clamped at 1e-5."""
    proj = _f32(object_points) @ _f32(rotation).transpose(-1, -2) + _f32(
        translation
    )[..., None, :]
    pts = _f32(normalized_image_points)
    z = torch.clamp(proj[..., 2], min=_Z_CLAMP)
    dx = proj[..., 0] / z - pts[..., 0]
    dy = proj[..., 1] / z - pts[..., 1]
    return torch.sqrt(dx * dx + dy * dy).sum(-1)


def solve_canonical_form(object_points, normalized_image_points, homography):
    """IPPE core: homography -> two candidate poses, unsorted.

    Returns (rotations (..., 2, 3, 3), translations (..., 2, 3),
    errors (..., 2))."""
    h = homography
    j00 = h[..., 0, 0] - h[..., 2, 0] * h[..., 0, 2]
    j01 = h[..., 0, 1] - h[..., 2, 1] * h[..., 0, 2]
    j10 = h[..., 1, 0] - h[..., 2, 0] * h[..., 1, 2]
    j11 = h[..., 1, 1] - h[..., 2, 1] * h[..., 1, 2]
    tx = h[..., 0, 2]
    ty = h[..., 1, 2]

    inv_norm = torch.rsqrt(tx * tx + ty * ty + 1.0)
    ax = tx * inv_norm
    ay = ty * inv_norm
    az = inv_norm
    degenerate = torch.abs(1.0 + az) < _DEGENERATE_EPS
    d = 1.0 / torch.where(degenerate, torch.ones_like(az), 1.0 + az)
    ax2, ay2, axay = ax * ax, ay * ay, ax * ay
    one = torch.ones_like(ax)
    zero = torch.zeros_like(ax)

    def sel(val, flip_val):
        return torch.where(degenerate, flip_val, val)

    rv00 = sel(-ax2 * d + 1.0, one)
    rv01 = sel(-axay * d, zero)
    rv02 = sel(ax, zero)
    rv10 = sel(-axay * d, zero)
    rv11 = sel(-ay2 * d + 1.0, one)
    rv12 = sel(ay, zero)
    rv20 = sel(-ax, zero)
    rv21 = sel(-ay, zero)
    rv22 = sel(1.0 - (ax2 + ay2) * d, -one)

    b00 = rv00 - tx * rv20
    b01 = rv01 - tx * rv21
    b10 = rv10 - ty * rv20
    b11 = rv11 - ty * rv21
    idet = 1.0 / (b00 * b11 - b01 * b10)
    a00 = (b11 * j00 - b01 * j10) * idet
    a01 = (b11 * j01 - b01 * j11) * idet
    a10 = (b00 * j10 - b10 * j00) * idet
    a11 = (b00 * j11 - b10 * j01) * idet

    ata00 = a00 * a00 + a01 * a01
    ata01 = a00 * a10 + a01 * a11
    ata11 = a10 * a10 + a11 * a11
    dd = ata00 - ata11
    gamma = torch.sqrt(
        0.5 * (ata00 + ata11 + torch.sqrt(dd * dd + 4.0 * (ata01 * ata01)))
    )
    inv_g = 1.0 / gamma
    rt00, rt01 = a00 * inv_g, a01 * inv_g
    rt10, rt11 = a10 * inv_g, a11 * inv_g

    b0 = torch.sqrt(torch.clamp(1.0 - rt00 * rt00 - rt10 * rt10, min=0.0))
    b1 = torch.sqrt(torch.clamp(1.0 - rt01 * rt01 - rt11 * rt11, min=0.0))
    sp = -rt00 * rt01 - rt10 * rt11
    b1 = torch.where(sp < 0.0, -b1, b1)

    ox = [object_points[..., k, 0] for k in range(4)]
    oy = [object_points[..., k, 1] for k in range(4)]
    oz = [object_points[..., k, 2] for k in range(4)]
    u = [normalized_image_points[..., k, 0] for k in range(4)]
    v = [normalized_image_points[..., k, 1] for k in range(4)]
    sa = -(u[0] + u[1] + u[2] + u[3])
    sb = -(v[0] + v[1] + v[2] + v[3])
    sab = u[0] * u[0] + v[0] * v[0]
    for k in range(1, 4):
        sab = sab + (u[k] * u[k] + v[k] * v[k])

    def candidate(sign):
        c0x, c0y, c0z = rt00, rt10, sign * b0
        c1x, c1y, c1z = rt01, rt11, sign * b1
        c2x = c0y * c1z - c0z * c1y
        c2y = c0z * c1x - c0x * c1z
        c2z = c0x * c1y - c0y * c1x

        def row(r0, r1, r2):
            return (
                r0 * c0x + r1 * c0y + r2 * c0z,
                r0 * c1x + r1 * c1y + r2 * c1z,
                r0 * c2x + r1 * c2y + r2 * c2z,
            )

        R00, R01, R02 = row(rv00, rv01, rv02)
        R10, R11, R12 = row(rv10, rv11, rv12)
        R20, R21, R22 = row(rv20, rv21, rv22)

        r0 = zero
        r1 = zero
        r2 = zero
        rpx, rpy, rpz = [], [], []
        for k in range(4):
            px = R00 * ox[k] + R01 * oy[k] + R02 * oz[k]
            py = R10 * ox[k] + R11 * oy[k] + R12 * oz[k]
            pz = R20 * ox[k] + R21 * oy[k] + R22 * oz[k]
            rpx.append(px)
            rpy.append(py)
            rpz.append(pz)
            bxk = u[k] * pz - px
            byk = v[k] * pz - py
            r0 = r0 + bxk
            r1 = r1 + byk
            r2 = r2 - u[k] * bxk - v[k] * byk
        denz = 4.0 * sab - sa * sa - sb * sb
        tz = (4.0 * r2 - sa * r0 - sb * r1) / denz
        tx_ = (r0 - sa * tz) * 0.25
        ty_ = (r1 - sb * tz) * 0.25

        err = zero
        for k in range(4):
            z = torch.clamp(rpz[k] + tz, min=_Z_CLAMP)
            dx = (rpx[k] + tx_) / z - u[k]
            dy = (rpy[k] + ty_) / z - v[k]
            err = err + torch.sqrt(dx * dx + dy * dy)

        rot = torch.stack(
            [
                torch.stack([R00, R01, R02], dim=-1),
                torch.stack([R10, R11, R12], dim=-1),
                torch.stack([R20, R21, R22], dim=-1),
            ],
            dim=-2,
        )
        return rot, torch.stack([tx_, ty_, tz], dim=-1), err

    r1_, t1_, e1_ = candidate(one)
    r2_, t2_, e2_ = candidate(-one)
    return (
        torch.stack([r1_, r2_], dim=-3),
        torch.stack([t1_, t2_], dim=-2),
        torch.stack([e1_, e2_], dim=-1),
    )


def solve_normalized_batch(normalized_image_points, marker_size_mm):
    """Batched IPPE solve, lower-error pose first.

    normalized_image_points (..., 4, 2); marker_size_mm scalar or (...).
    Returns (rotations (..., 2, 3, 3), translations (..., 2, 3),
    errors (..., 2)).  Spans (``utils.profiling.span``): ``aruco3.pose``
    around the solve; ``aruco3.pose.homography``, ``.canonical`` and
    ``.order`` around its three parts.
    """
    with profiling.span("aruco3.pose"):
        pts = torch.as_tensor(normalized_image_points, dtype=torch.float32)
        if isinstance(marker_size_mm, numbers.Real):
            obj = marker_square_on(float(marker_size_mm), pts.device)
        else:
            obj = make_marker_square(_f32(marker_size_mm).to(pts.device))
        obj = torch.broadcast_to(obj, pts.shape[:-2] + (4, 3))
        with profiling.span("aruco3.pose.homography"):
            homography = compute_homography_from_marker_square(marker_size_mm, pts)
        with profiling.span("aruco3.pose.canonical"):
            rotations, translations, errors = solve_canonical_form(obj, pts, homography)
        with profiling.span("aruco3.pose.order"):
            swap = errors[..., 1] < errors[..., 0]
            rotations = torch.where(
                swap[..., None, None, None], rotations.flip(-3), rotations
            )
            translations = torch.where(
                swap[..., None, None], translations.flip(-2), translations
            )
            errors = torch.where(swap[..., None], errors.flip(-1), errors)
        return rotations, translations, errors


# --------------------------------------------------------------------------
# Reference-parity scalar API
# --------------------------------------------------------------------------
def _pair_from_batch(rotations, translations, errors):
    def p(i):
        return MarkerPose(
            error=errors[i], rotation=rotations[i], translation=translations[i]
        )

    return p(0), p(1)


def solve_with_normalized_points(normalized_image_points, marker_size_mm):
    """(best, alt) poses from 4 normalized image points."""
    pts = _f32(normalized_image_points).reshape(4, 2)
    return _pair_from_batch(*solve_normalized_batch(pts, marker_size_mm))


def solve_with_undistorted_points(image_points, marker_size_mm, image_size):
    """Normalize pixel coords per axis by the image dims, then solve."""
    pts = _f32(image_points).reshape(4, 2)
    w, h = image_size
    pts = pts / torch.tensor([float(w), float(h)])
    return solve_with_normalized_points(pts, marker_size_mm)


def solve_with_intrinsics(
    image_points, marker_size_mm, camera_intrinsics: CameraIntrinsics
):
    """Unproject pixel corners through the camera, then solve."""
    pts = _f32(image_points).reshape(4, 2)
    x, y = camera_intrinsics.unproject(pts[..., 0], pts[..., 1])
    return solve_with_normalized_points(
        torch.stack([x, y], dim=-1), marker_size_mm
    )


def estimate_pose(image_points, marker_size_mm, image_size):
    """Alias of ``solve_with_undistorted_points``."""
    return solve_with_undistorted_points(image_points, marker_size_mm, image_size)
