"""A short steady stretch under ``torch.profiler``, reduced to what the
per-layer metrics read.

The profiler records the device's activity alone (no host operations: on
a path bound by the host, recording each host operation would slow the
host and inflate the device's idle share).  The harness keeps its own
host spans on the wall clock (``Spans``), which the profiler's absolute
timestamps share.  ``Trace`` holds the device operations of the stretch
(name, start, end in microseconds), the host spans (names starting with
``portbench.``), the stretch, and the steps and frames it covered.
Device time is the union of the device operations' intervals inside the
stretch, so that operations that overlap count once.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

# Host spans the harness opens.
PREFIX = "portbench."


@dataclass
class Trace:
    device_ops: list = field(default_factory=list)  # (name, start_us, end_us)
    spans: list = field(default_factory=list)  # (name, start_us, end_us)
    window: tuple = (0.0, 0.0)  # the stretch, us
    steps: int = 0
    frames: int = 0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def clipped(self):
        """Device operations clipped to the stretch (empty ones dropped)."""
        lo, hi = self.window
        out = []
        for name, s, e in self.device_ops:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                out.append((name, s, e))
        return out

    def busy_intervals(self):
        """The union of the clipped device operations, as sorted disjoint
        (start, end) intervals."""
        merged = []
        for _, s, e in sorted(self.clipped(), key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(iv) for iv in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_gaps(self):
        """(start, end) of each stretch of the window with no device
        operation."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def host_at(self, t: float) -> str:
        """The innermost harness span open at ``t`` (``loop``, the
        harness's own loop, if none)."""
        best = None
        for name, s, e in self.spans:
            if s <= t < e and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0][len(PREFIX):] if best else "loop"

    def seconds_by_name(self, select=lambda name: True):
        """{device operation name: seconds} of the clipped operations whose
        name ``select`` takes."""
        out = {}
        for name, s, e in self.clipped():
            if select(name):
                out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out

    def count(self, select) -> int:
        return sum(1 for name, _, _ in self.clipped() if select(name))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by the harness span open in their middle."""
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[name[:120], secs] for name, secs in ops],
            "idle_gaps": [[self.host_at((s + e) / 2), (e - s) / 1e6] for s, e in gaps],
        }


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


class Spans:
    """Host spans on the wall clock, in microseconds: ``with spans("x"):``
    records ("portbench.x", start, end)."""

    def __init__(self):
        self.spans = []

    @contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((PREFIX + name, t0 / 1e3, time.time_ns() / 1e3))


def trace_start_us(prof) -> float:
    """The profiler's time origin on the wall clock, in microseconds."""
    results = prof.profiler.kineto_results
    if hasattr(results, "trace_start_ns"):
        return results.trace_start_ns() / 1e3
    return float(results.trace_start_us())


def from_profile(prof, spans: Spans, window: tuple, steps: int, frames: int) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile``'s device
    events, with the harness's ``spans`` and the stretch ``window`` (wall
    clock, microseconds)."""
    from torch.autograd import DeviceType

    origin = trace_start_us(prof)
    tr = Trace(spans=list(spans.spans), window=window, steps=steps, frames=frames)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            tr.device_ops.append((ev.name, origin + ev.time_range.start,
                                  origin + ev.time_range.end))
    return tr
