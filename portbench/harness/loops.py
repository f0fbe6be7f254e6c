"""The closed loop that drives the program, and the arithmetic of its
records.

``closed_loop`` keeps ``in_flight`` steps outstanding: it hands a step's
frames to the program, starts the copy of its results to the host, and
waits for the oldest outstanding step's copy before it hands in another.
Each step leaves a ``Record``: when its frames were handed in, when the
public calls returned, and when its results were on the host.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from .check import FIELDS


@dataclass
class Record:
    handin: float
    returned: float
    done: float
    frames: int


class Slot:
    """Host buffers one step's results are copied into (pinned where the
    results are on the card), and the event that marks the copy done."""

    def __init__(self):
        self.host = None
        self.event = None

    def start(self, out: dict) -> None:
        if self.host is None:
            pin = out[FIELDS[0]].is_cuda
            self.host = {k: torch.empty(out[k].shape, dtype=out[k].dtype, pin_memory=pin)
                         for k in FIELDS}
        for k in FIELDS:
            self.host[k].copy_(out[k], non_blocking=True)
        if out[FIELDS[0]].is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def snapshot(self) -> dict:
        return {k: self.host[k].numpy().copy() for k in FIELDS}


def closed_loop(step, source, in_flight: int, seconds: float | None = None,
                steps: int | None = None, keep=lambda i: False, span=None):
    """Drive ``step`` (frames -> device results) with ``source(i)`` ->
    (frame indices, frames) until ``seconds`` have passed since the first
    hand-in, or ``steps`` steps were handed in; then wait for the steps
    outstanding.  ``span(name)`` opens a host span where given.  Returns
    (records, kept: [(frame indices, host results)] of the steps ``keep``
    takes, start time)."""
    span = span or (lambda name: nullcontext())
    slots = [Slot() for _ in range(in_flight)]
    pending = deque()
    records, kept = [], []
    t0 = time.perf_counter()
    end = t0 + seconds if seconds is not None else None
    i = 0
    while True:
        while len(pending) < in_flight and (
            (end is None or time.perf_counter() < end) and (steps is None or i < steps)
        ):
            idx, frames = source(i)
            slot = slots[i % in_flight]
            handin = time.perf_counter()
            with span("step"):
                out = step(frames)
            returned = time.perf_counter()
            with span("readback"):
                slot.start(out)
            pending.append((i, idx, slot, handin, returned))
            i += 1
        if not pending:
            break
        j, idx, slot, handin, returned = pending.popleft()
        with span("wait"):
            slot.wait()
        done = time.perf_counter()
        records.append(Record(handin, returned, done, len(idx)))
        if keep(j):
            kept.append((np.asarray(idx), slot.snapshot()))
    return records, kept, t0


def in_window(records, t0: float, seconds: float):
    """The records of steps handed in and finished inside [t0, t0 + seconds]."""
    return [r for r in records if r.handin >= t0 and r.done <= t0 + seconds]


def frames_per_s(records, t0: float, seconds: float) -> float:
    """Frames whose results reached the host inside the window, over the
    window's seconds."""
    return sum(r.frames for r in in_window(records, t0, seconds)) / seconds


def latencies_ms(records, t0: float, seconds: float) -> np.ndarray:
    """Hand-in to results on the host, in ms, of every step of the window."""
    return np.array([1e3 * (r.done - r.handin) for r in in_window(records, t0, seconds)])


def host_ms(records, t0: float, seconds: float) -> float:
    """Mean host ms from hand-in until the public calls returned."""
    rs = in_window(records, t0, seconds)
    return 1e3 * sum(r.returned - r.handin for r in rs) / max(len(rs), 1)
