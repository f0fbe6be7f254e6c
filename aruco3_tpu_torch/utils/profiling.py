"""Tracing / profiling helpers; the counterpart of
``aruco3_tpu/utils/profiling.py`` with the same API.

  * ``drain`` — wait for every computation feeding a result: synchronises
    the device of each CUDA tensor in a dict, list or tuple.
  * ``StageTimer`` — wall-clock stage timing; ``time_fn`` times a function
    with CUDA events where its result lies on the card.
  * ``trace`` — context manager around ``torch.profiler`` (CUDA activity
    when a card is present) writing a Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict

import torch


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _cuda_devices(tree) -> list[torch.device]:
    return list(dict.fromkeys(t.device for t in _tensors(tree) if t.is_cuda))


def drain(tree) -> None:
    """Force completion of every computation feeding ``tree``: synchronise
    each CUDA device holding one of its tensors (CPU tensors are done)."""
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates per-stage wall times; ``report()`` pretty-prints."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def time_fn(self, name: str, fn, *args, iters: int = 1):
        """Time ``fn`` over ``iters`` calls after one warm-up call: with
        CUDA events on the stream of the card that holds its result, else
        with the host clock, draining once at the end."""
        out = fn(*args)
        drain(out)
        devices = _cuda_devices(out)
        if devices:
            stream = torch.cuda.current_stream(devices[0])
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(iters):
                out = fn(*args)
            stop.record(stream)
            drain(out)
            stop.synchronize()
            seconds = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*args)
            drain(out)
            seconds = time.perf_counter() - t0
        self.totals[name] += seconds / iters
        self.counts[name] += 1
        return out

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:32s} {t * 1000:9.2f} ms total  x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` over the body (CPU activity, and CUDA activity
    when a card is present); writes ``trace.json``, a Chrome trace, into
    ``log_dir`` (default: ``aruco3_tpu_torch_trace`` in the temporary
    directory).  A no-op where the profiler cannot start; what the body
    raises propagates."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "aruco3_tpu_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.start()
    except RuntimeError:
        prof = None
    try:
        yield log_dir
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
