"""IPPE pose solve wrapper: ``csrc/pose.cu`` on CUDA tensors, ``plain`` on
CPU tensors.

``solve`` takes N lanes of normalized image corners (N, 4, 2) float32 and
a marker size (a number, or N per-lane sizes) and returns (rotations
(N, 2, 3, 3), translations (N, 2, 3), errors (N, 2)) float32, the
lower-error pose first: ``pose.solve_normalized_batch`` on one axis of
lanes.  The kernel is the whole solve in one launch, bit for bit the plain
version's arithmetic on the card; it replaces no TPU kernel (the JAX
package's pose is XLA's).
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from .. import pose
from ..utils import profiling
from . import Counter, _build

count = Counter()


def plain(pts: torch.Tensor, marker_size_mm):
    """The solve in PyTorch: ``pose.compute_homography_from_marker_square``,
    ``pose.solve_canonical_form``, then the lower-error pose first.  Spans
    ``aruco3.pose.homography``, ``.canonical`` and ``.order`` around the
    three parts."""
    count.plain_calls += 1
    if isinstance(marker_size_mm, numbers.Real):
        obj = pose.marker_square_on(float(marker_size_mm), pts.device)
    else:
        obj = pose.make_marker_square(
            torch.as_tensor(marker_size_mm, dtype=torch.float32).to(pts.device))
    obj = torch.broadcast_to(obj, pts.shape[:-2] + (4, 3))
    with profiling.span("aruco3.pose.homography"):
        homography = pose.compute_homography_from_marker_square(marker_size_mm, pts)
    with profiling.span("aruco3.pose.canonical"):
        rotations, translations, errors = pose.solve_canonical_form(obj, pts, homography)
    with profiling.span("aruco3.pose.order"):
        swap = errors[..., 1] < errors[..., 0]
        rotations = torch.where(swap[..., None, None, None], rotations.flip(-3), rotations)
        translations = torch.where(swap[..., None, None], translations.flip(-2), translations)
        errors = torch.where(swap[..., None], errors.flip(-1), errors)
    return rotations, translations, errors


def solve(pts: torch.Tensor, marker_size_mm):
    """pts (N, 4, 2) float32; marker_size_mm a number or (N,) float32 on
    the points' device -> (rotations (N, 2, 3, 3), translations (N, 2, 3),
    errors (N, 2)).  CUDA tensors launch the kernel, CPU tensors take
    ``plain``."""
    if pts.device.type == "cpu":
        return plain(pts, marker_size_mm)
    if pts.dtype != torch.float32 or pts.dim() != 3 or tuple(pts.shape[1:]) != (4, 2):
        raise ValueError(f"expected float32 points (N, 4, 2), got {tuple(pts.shape)} {pts.dtype}")
    pts = pts.contiguous()
    n = pts.shape[0]
    sizes, hw, inv2 = None, 0.0, 0.0
    if isinstance(marker_size_mm, numbers.Real):
        size = np.float32(marker_size_mm)
        hw = float(np.float32(0.5) * size)
        # 1 / (2 * hw): the float32 1 / size, as the plain version rounds it.
        inv2 = float(np.float32(1.0) / size)
    else:
        sizes = _build.checked_ptr(marker_size_mm, torch.float32, (n,), "marker_size_mm")
        if marker_size_mm.device != pts.device:
            raise ValueError("marker_size_mm: expected a tensor on the points' device")
    dev = pts.device
    rotations = torch.empty((n, 2, 3, 3), dtype=torch.float32, device=dev)
    translations = torch.empty((n, 2, 3), dtype=torch.float32, device=dev)
    errors = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return rotations, translations, errors
    err = _build.fn("a3_ippe")(
        pts.data_ptr(), sizes, hw, inv2, rotations.data_ptr(), translations.data_ptr(),
        errors.data_ptr(), n, _build.stream(),
    )
    _build.check(err, "a3_ippe")
    count.launches += 1
    return rotations, translations, errors
