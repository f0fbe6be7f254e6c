#!/usr/bin/env python3
"""Live multi-stream AR loop on synthetic cameras, on the PyTorch/CUDA
port: the counterpart of ``examples/stream_demo.py``.

Four producer threads synthesize VGA (or WxH) camera feeds of a moving
marker and push frames into the native ring buffers; the port's
``StreamPipeline`` batches them through the detector's CUDA graph on the
card (``--cpu`` asks for the CPU) while the next batch assembles.  Prints
per-second throughput, then each stream's last marker and its corners.

``--list-cameras`` enumerates the sources and ``--camera-index=N`` runs
the one selected source instead of all four; the sources are synthetic.

Usage: python examples/torch_stream_demo.py [seconds] [WxH]
           [--camera-index=N] [--list-cameras] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import threading
import time

import numpy as np
import torch

from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig, pose
from aruco3_tpu_torch.render import render_marker
from aruco3_tpu_torch.runtime.stream import StreamPipeline

CAMERA_SOURCES = [
    {"index": 0, "name": "synthetic-cam-0 (orbit marker 7)", "marker": 7},
    {"index": 1, "name": "synthetic-cam-1 (orbit marker 23)", "marker": 23},
    {"index": 2, "name": "synthetic-cam-2 (orbit marker 42)", "marker": 42},
    {"index": 3, "name": "synthetic-cam-3 (orbit marker 99)", "marker": 99},
]


def list_cameras() -> list[str]:
    """One line per available source."""
    return [f"[{src['index']}] {src['name']}" for src in CAMERA_SOURCES]


def select_sources(camera_index: int | None) -> list[dict]:
    """All four sources, or the one of ``camera_index`` (ValueError where
    there is none)."""
    if camera_index is None:
        return CAMERA_SOURCES
    sources = [s for s in CAMERA_SOURCES if s["index"] == camera_index]
    if not sources:
        raise ValueError(f"no camera with index {camera_index}; run with --list-cameras")
    return sources


def run_demo(
    seconds: float = 5.0,
    size: tuple[int, int] = (640, 480),
    camera_index: int | None = None,
    device: str = "cuda",
    log=print,
) -> dict:
    """Run the sources (all four, or the one of ``camera_index``) through a
    ``StreamPipeline`` on ``device`` for ``seconds``, calling ``log`` with
    each second's throughput line.

    Returns {"ticks": per second {"alive", "frames", "batches", "fps"},
    "last": stream -> (marker id, its 4 corners, the translation of its
    best pose (mm))}."""
    sources = select_sources(camera_index)
    w, h = size
    dictionary = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    detector = Detector(DetectorConfig(), dictionary, device=device)
    pipe = StreamPipeline(detector, (h, w), n_streams=len(sources), batch=8)
    stop = threading.Event()

    def camera(stream_idx: int, marker_id: int):
        rng = np.random.default_rng(stream_idx)
        t0 = time.time()
        while not stop.is_set():
            # Marker orbits the frame center.
            t = time.time() - t0
            side = 0.35 * min(w, h)
            cx = w / 2 + 0.25 * w * np.cos(t + stream_idx)
            cy = h / 2 + 0.25 * h * np.sin(0.7 * t + stream_idx)
            ang = 0.5 * t
            base = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]])
            rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
            quad = base @ rot.T * side + [cx, cy]
            frame = render_marker(dictionary, marker_id, (w, h), quad, noise_sigma=2.0, rng=rng)
            pipe.push(stream_idx, frame)
            time.sleep(1 / 60)  # 60 fps per camera

    last = {}

    def consume(items):
        for item in items:
            out = item["outputs"]
            valid = out["marker_valid"].cpu().numpy()
            ids = out["marker_id"].cpu().numpy()
            corners = out["marker_corners"].cpu().numpy()
            for lane, s in enumerate(item["stream_ids"]):
                if s < 0 or not valid[lane].any():
                    continue
                k = int(np.argmax(valid[lane]))
                pts = [tuple(map(float, c)) for c in corners[lane, k]]
                best, _ = pose.solve_with_undistorted_points(pts, 40.0, (w, h))
                last[int(s)] = (int(ids[lane][k]), pts, np.asarray(best.translation))

    threads = [threading.Thread(target=camera, args=(i, src["marker"]), daemon=True)
               for i, src in enumerate(sources)]
    pipe.start()
    for th in threads:
        th.start()
    ticks = []
    t_end = time.time() + seconds
    try:
        while time.time() < t_end:
            time.sleep(1.0)
            consume(pipe.drain())
            st = pipe.stats
            tick = {"alive": len(last), "frames": st.frames, "batches": st.batches,
                    "fps": st.frames / max(st.detect_seconds, 1e-9)}
            ticks.append(tick)
            log(f"streams alive={tick['alive']} frames={tick['frames']} "
                f"batches={tick['batches']} device-side fps={tick['fps']:.1f}")
    finally:
        stop.set()
        for th in threads:
            th.join()
        pipe.stop()
    consume(pipe.drain())  # the batches completed in the last second
    return {"ticks": ticks, "last": last}


def main() -> None:
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    device = "cpu" if "--cpu" in sys.argv[1:] else "cuda"
    if "--list-cameras" in args:
        print("\n".join(list_cameras()))
        return
    camera_index = None
    for a in list(args):
        if a.startswith("--camera-index"):
            camera_index = int(a.split("=", 1)[1]) if "=" in a else int(args[args.index(a) + 1])
            args = [x for x in args if not x.startswith("--camera-index")]
            if str(camera_index) in args:
                args.remove(str(camera_index))
    seconds = float(args[0]) if len(args) > 0 else 5.0
    size = tuple(int(t) for t in args[1].split("x")) if len(args) > 1 else (640, 480)
    try:
        select_sources(camera_index)
    except ValueError as e:
        raise SystemExit(str(e))
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --cpu to detect on the CPU")
    result = run_demo(seconds, size, camera_index, device)
    for s, (mid, pts, _) in sorted(result["last"].items()):
        print(f"stream {s}: marker {mid} at {np.round(pts, 1).tolist()}")


if __name__ == "__main__":
    main()
