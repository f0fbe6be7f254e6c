#!/usr/bin/env python3
"""Detect markers in an image and write an annotated copy, on the
PyTorch/CUDA port: the counterpart of ``examples/detect_image.py``.

Loads a PGM (or synthesizes a random 800x600 marker scene when no path is
given), runs the port's detector on the card (``--cpu`` asks for the
CPU), prints each marker's id / Hamming distance / corners, and writes
DEBUG_detected.ppm.

Usage:
  python examples/torch_detect_image.py [image.pgm] [DICT_NAME] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig
from aruco3_tpu_torch.render import random_marker_scene
from aruco3_tpu_torch.utils.imageio import draw_marker_overlay, read_pgm, write_ppm


def detect_image(
    path: str | None = None,
    dict_name: str = "ARUCO_DEFAULT",
    device: str = "cuda",
    size: tuple[int, int] = (800, 600),
    rng: np.random.Generator | None = None,
    out: str = "DEBUG_detected.ppm",
) -> dict:
    """Detect the markers of the PGM at ``path``, or of a synthesized
    ``size`` (W, H) scene holding one random marker of the dictionary, on
    ``device``, and write the frame with the markers drawn to ``out``.

    Returns {"truth": (id, corners) of the synthesized marker or None,
    "detection": the ``Detection``, "output": ``out``}."""
    dictionary = ARDictionary.new_from_named_dict(dict_name)
    if path is not None:
        img = read_pgm(path)
        truth = None
    else:
        rng = rng or np.random.default_rng()
        mid = int(rng.integers(0, len(dictionary)))
        img, corners, _ = random_marker_scene(dictionary, mid, size, rng=rng)
        truth = (mid, corners)
    detection = Detector(DetectorConfig(), dictionary, device=device).detect(img)
    write_ppm(out, draw_marker_overlay(detection.grey, detection.markers))
    return {"truth": truth, "detection": detection, "output": out}


def report(result: dict) -> list[str]:
    """The lines the JAX example prints for ``detect_image``'s result."""
    truth, detection = result["truth"], result["detection"]
    lines = [] if truth is None else [f"synthesized scene with marker id={truth[0]}"]
    lines += [f"candidates: {len(detection.candidates)}", f"stage stats: {detection.stats}"]
    lines += [
        f"marker id={m.id} hamming={m.hamming_distance} corners={m.corners} code={m.code:#x}"
        for m in detection.markers
    ]
    if truth and not any(m.id == truth[0] for m in detection.markers):
        lines.append("NOTE: ground-truth marker was not recovered")
    lines.append(f"wrote {result['output']}")
    return lines


def main() -> None:
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    device = "cpu" if "--cpu" in sys.argv[1:] else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --cpu to detect on the CPU")
    result = detect_image(
        args[0] if args else None, args[1] if len(args) > 1 else "ARUCO_DEFAULT", device
    )
    print("\n".join(report(result)))


if __name__ == "__main__":
    main()
