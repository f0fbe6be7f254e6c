"""Detect + pose ms per batch of chip_smoke.py's paths, for the port of the
checkout this runs in: three timings of ``REPS`` batches each, at the
path's phase-5 batch (``chip_smoke.BATCHES``).

    cd <checkout> && python <repo>/tools/torch_ab_batch.py <label> [path ...]

The frames, detectors and timing are those of the ``chip_smoke.py`` beside
this tool (loaded by file), the port is the checkout's: run it in two
checkouts in turns (parent, change, change, parent) in one call to compare
them on one card.  A checkout whose ``Detector`` keeps CUDA graphs is timed
through its graph of detect + pose (``chip_smoke.pose_graph``), an older
one eagerly (``chip_smoke.pose_step``).  Paths default to all five.  Needs the card.
"""

import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import torch

REPS = 5

sys.path.insert(0, os.getcwd())
spec = importlib.util.spec_from_file_location(
    "smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)

label = sys.argv[1]
wanted = sys.argv[2:] or list(cs.BATCHES)
paths, _ = cs.path_inputs()
for path in wanted:
    det, frames = paths[path]
    batch = cs.BATCHES[path]
    big = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(frames[0], (batch,) + frames.shape[1:]))).cuda()
    # The checkout's main path: its graph of detect + pose where its
    # Detector keeps graphs, else the eager detect + pose.
    step = (cs.pose_graph(det, big.shape) if hasattr(det, "graphs")
            else cs.pose_step(det, *big.shape[1:]))
    ms = [cs.cuda_ms(lambda: step(big), reps=REPS) for _ in range(3)]
    print(f"ab tree={label} path={path} batch={batch} ms_per_batch="
          + " ".join(f"{m:.3f}" for m in ms), flush=True)
    del big
