"""Minimal zero-dependency image IO + annotation helpers for the examples.

PGM/PPM (netpbm) are the only formats written — they need no external
libraries and every image tool can open them.
"""

from __future__ import annotations

import numpy as np


def write_pgm(path: str, img: np.ndarray) -> None:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def write_ppm(path: str, img: np.ndarray) -> None:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def read_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    parts = data.split(b"\n", 3)
    assert parts[0].strip() == b"P5", "only binary PGM supported"
    w, h = (int(t) for t in parts[1].split())
    return np.frombuffer(parts[3], dtype=np.uint8, count=w * h).reshape(h, w)


def draw_line(img: np.ndarray, p0, p1, value) -> None:
    """Bresenham-ish line draw in place (grayscale or RGB image)."""
    x0, y0 = int(round(p0[0])), int(round(p0[1]))
    x1, y1 = int(round(p1[0])), int(round(p1[1]))
    n = max(abs(x1 - x0), abs(y1 - y0), 1)
    for t in range(n + 1):
        x = x0 + (x1 - x0) * t // n
        y = y0 + (y1 - y0) * t // n
        if 0 <= y < img.shape[0] and 0 <= x < img.shape[1]:
            img[y, x] = value


def draw_marker_overlay(img: np.ndarray, markers) -> np.ndarray:
    """Return an RGB copy of a grayscale image with marker quads drawn."""
    rgb = np.stack([img] * 3, axis=-1).astype(np.uint8)
    for m in markers:
        for i in range(4):
            draw_line(
                rgb, m.corners[i], m.corners[(i + 1) % 4], (255, 0, 0)
            )
        # Corner 0 (marker top-left) gets a cross, like the reference's
        # debug renderer (aruco.rs:388).
        cx, cy = m.corners[0]
        draw_line(rgb, (cx - 4, cy), (cx + 4, cy), (0, 0, 255))
        draw_line(rgb, (cx, cy - 4), (cx, cy + 4), (0, 0, 255))
    return rgb
