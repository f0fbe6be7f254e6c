"""Synthetic marker rendering — ground-truth generator for tests and the
on-card smoke run.  Counterpart of ``aruco3_tpu/render.py``: the same numpy
code, importing this package's dictionary and camera so that it runs where
jax is not installed.
"""

from __future__ import annotations

import numpy as np

from .camera import CameraIntrinsics
from .dictionaries import ARDictionary


def homography_unit_square_to_quad(corners: np.ndarray) -> np.ndarray:
    """DLT homography mapping (0,0),(1,0),(1,1),(0,1) to 4 image corners."""
    src = np.array(
        [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], dtype=np.float64
    )
    dst = np.asarray(corners, dtype=np.float64)
    a = []
    b = []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    h = np.linalg.solve(np.array(a), np.array(b))
    return np.concatenate([h, [1.0]]).reshape(3, 3)


def render_marker(
    dictionary: ARDictionary,
    marker_id: int,
    image_size: tuple[int, int],
    corners: np.ndarray,
    background: int = 255,
    marker_white: int = 255,
    marker_black: int = 0,
    supersample: int = 3,
    noise_sigma: float = 0.0,
    rng: np.random.Generator | None = None,
    quiet_zone_cells: int = 0,
) -> np.ndarray:
    """Render one marker into a (H, W) uint8 grayscale image.

    corners: (4, 2) image-space (x, y) positions of the marker's outer
    corners, clockwise from the marker's top-left cell corner.

    quiet_zone_cells: width (in marker cells) of a white quiet zone drawn
    around the marker before the background starts — needed for markers on
    dark backgrounds, where the background itself is not the quiet zone.
    """
    w, h = image_size
    m = dictionary.get_mark_size()
    bit_matrix = dictionary.marker_bit_matrix(marker_id)  # True == white

    H = homography_unit_square_to_quad(np.asarray(corners, dtype=np.float64))
    Hinv = np.linalg.inv(H)

    ss = supersample
    ys, xs = np.meshgrid(
        (np.arange(h * ss) + 0.5) / ss - 0.5,
        (np.arange(w * ss) + 0.5) / ss - 0.5,
        indexing="ij",
    )
    pts = np.stack([xs, ys, np.ones_like(xs)], axis=-1)  # (h*ss, w*ss, 3)
    src = pts @ Hinv.T
    sz = src[..., 2]
    sz = np.where(np.abs(sz) < 1e-12, 1e-12, sz)
    u = src[..., 0] / sz
    v = src[..., 1] / sz

    inside = (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    cell_x = np.clip((u * m).astype(np.int64), 0, m - 1)
    cell_y = np.clip((v * m).astype(np.int64), 0, m - 1)
    cell_white = bit_matrix[cell_y, cell_x]
    qz = quiet_zone_cells / m
    in_quiet = (
        (u >= -qz) & (u < 1 + qz) & (v >= -qz) & (v < 1 + qz) & ~inside
    )
    shade = np.where(
        inside,
        np.where(cell_white, float(marker_white), float(marker_black)),
        np.where(in_quiet, float(marker_white), float(background)),
    )
    img = shade.reshape(h, ss, w, ss).mean(axis=(1, 3))

    if noise_sigma > 0:
        rng = rng or np.random.default_rng(0)
        img = img + rng.normal(0.0, noise_sigma, size=img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def project_marker_corners(
    pose_rotation: np.ndarray,
    pose_translation: np.ndarray,
    marker_size_mm: float,
    intrinsics: CameraIntrinsics,
) -> np.ndarray:
    """Project the canonical marker square through a pose + camera.

    The canonical square is clockwise from top-left with +Y up
    (reference pose.rs:83-93); returns (4, 2) pixel corners.
    """
    hw = 0.5 * marker_size_mm
    square = np.array(
        [[-hw, hw, 0.0], [hw, hw, 0.0], [hw, -hw, 0.0], [-hw, -hw, 0.0]]
    )
    cam = square @ np.asarray(pose_rotation).T + np.asarray(pose_translation)
    u = cam[:, 0] * intrinsics.focal_x / cam[:, 2] + intrinsics.principal_x
    v = cam[:, 1] * intrinsics.focal_y / cam[:, 2] + intrinsics.principal_y
    return np.stack([u, v], axis=-1)


def random_marker_scene(
    dictionary: ARDictionary,
    marker_id: int,
    image_size: tuple[int, int] = (640, 480),
    rng: np.random.Generator | None = None,
    min_scale: float = 0.25,
    max_scale: float = 0.6,
    max_persp: float = 0.12,
    noise_sigma: float = 2.0,
):
    """Randomized single-marker scene.

    Returns (image (H, W) u8, corners (4, 2) float ground truth, angle).
    The marker is an axis-ish aligned square, randomly rotated in-plane and
    perturbed per-corner to create mild perspective.
    """
    rng = rng or np.random.default_rng(0)
    w, h = image_size
    side = rng.uniform(min_scale, max_scale) * min(w, h)
    cx = rng.uniform(side * 0.7, w - side * 0.7)
    cy = rng.uniform(side * 0.7, h - side * 0.7)
    angle = rng.uniform(0, 2 * np.pi)
    base = np.array(
        [[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]]
    )  # clockwise in y-down screen space
    rot = np.array(
        [[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]]
    )
    quad = base @ rot.T * side
    quad += rng.uniform(-max_persp, max_persp, size=(4, 2)) * side
    quad += np.array([cx, cy])
    img = render_marker(
        dictionary,
        marker_id,
        image_size,
        quad,
        noise_sigma=noise_sigma,
        rng=rng,
    )
    return img, quad, angle


def bench_scene(
    dictionary: ARDictionary,
    image_size: tuple[int, int] = (1920, 1080),
    seed: int = 0,
    noise_sigma: float = 2.0,
):
    """The 8-marker 1080p frame that ``bench.py`` times.

    Eight random markers of ``dictionary``, each rendered into a 480x360
    tile placed on a 2x4 grid, then Gaussian noise of ``noise_sigma``.
    Returns (frame (H, W) u8, truth [(id, corners (4, 2) float64)]).
    """
    w, h = image_size
    rng = np.random.default_rng(seed)
    frame = np.full((h, w), 255, dtype=np.uint8)
    truth = []
    for i in range(8):
        mid = int(rng.integers(0, len(dictionary)))
        for _try in range(20):
            img, cor, _ = random_marker_scene(
                dictionary,
                mid,
                (480, 360),
                rng=rng,
                min_scale=0.45,
                max_scale=0.7,
                noise_sigma=0.0,
            )
            c = np.asarray(cor, dtype=np.float64)
            # Only fully interior placements keep a visible true corner.
            if (
                (c[:, 0] > 8).all()
                and (c[:, 0] < 472).all()
                and (c[:, 1] > 8).all()
                and (c[:, 1] < 352).all()
            ):
                break
        y0 = (i // 4) * 520 + 40
        x0 = (i % 4) * 470 + 10
        frame[y0 : y0 + 360, x0 : x0 + 480] = np.minimum(
            frame[y0 : y0 + 360, x0 : x0 + 480], img
        )
        truth.append((mid, np.asarray(cor, dtype=np.float64) + [x0, y0]))
    frame = np.clip(
        frame.astype(np.float64) + rng.normal(0, noise_sigma, frame.shape),
        0,
        255,
    ).astype(np.uint8)
    return frame, truth
