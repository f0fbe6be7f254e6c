"""Tracing / profiling helpers.

  * ``span(name)`` — a host span around the body, on the wall clock
    (``time.time_ns``, the clock the profiler's absolute timestamps map
    onto), recorded only while a ``torch.profiler`` runs (torch's own
    profiler state: outside one a span costs one flag read).  Each record
    is (name, id, parent id, start_ns, end_ns), the parent the innermost
    span open on the same thread; records go into a list of at most
    ``SPAN_CAP`` (``spans()``, ``dropped()``, ``clear()``).
  * ``stage_map`` — used by ``runtime.graph`` around a capture: every span
    opened inside marks the capture graph's kernel-node count at its enter
    and exit, profiler or not; ``stages`` turns the marks into the graph's
    ordered (stage, kernel nodes), ``substages`` splits each stage by the
    spans one level below it.  ``log_capture`` / ``captures()`` keep one
    record a captured graph (the capture log).
  * ``drain`` — wait for every computation feeding a result: synchronises
    the device of each CUDA tensor in a dict, list or tuple.
  * ``trace`` — context manager around ``torch.profiler`` (CUDA activity
    when a card is present) writing a Chrome trace, the spans on a track
    of their own, into a directory.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import threading
import time

import torch

# Most span records kept (``dropped()`` counts the rest) and most capture
# records kept.
SPAN_CAP = 1 << 16
CAPTURE_CAP = 1 << 12

_profiler_enabled = torch._C._autograd._profiler_enabled
_records: list = []
_dropped = 0
_captures: list = []
_ids = itertools.count(1)
_local = threading.local()
# During a capture: (thread id, kernel-node counter, marks, base depth).
_marking = None


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "start", "record", "marks")

    def __init__(self, name: str, record: bool):
        self.name = name
        self.record = record
        self.marks = None

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        marking = _marking
        if marking is not None and marking[0] == threading.get_ident():
            self.marks = marking
            marking[2].append((self.name, len(stack) - marking[3], "enter", marking[1]()))
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        global _dropped
        _stack().pop()
        marking = self.marks
        if marking is not None:
            depth = len(_stack()) - marking[3]
            marking[2].append((self.name, depth, "exit", marking[1]()))
        if self.record:
            if len(_records) < SPAN_CAP:
                _records.append((self.name, self.id, self.parent, self.start, end))
            else:
                _dropped += 1
        return False


_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager timing its body as span ``name`` while a
    ``torch.profiler`` runs (or marking a capture's stage map); else a
    shared no-op."""
    if _marking is None:
        return _Span(name, True) if _profiler_enabled() else _NULL
    return _Span(name, _profiler_enabled())


def spans() -> list:
    """The span records, (name, id, parent id or None, start_ns, end_ns),
    in the order the spans ended."""
    return list(_records)


def dropped() -> int:
    """Span records the cap left out since the last ``clear()``."""
    return _dropped


def clear() -> None:
    """Forget every span record and the count of those dropped."""
    global _dropped
    _records.clear()
    _dropped = 0


@contextlib.contextmanager
def stage_map(count):
    """Inside, on this thread: each span marks ``count()`` (the capture
    graph's kernel nodes so far) at its enter and exit.  Yields the list
    of marks, (name, depth below the spans open at the start, "enter" or
    "exit", count)."""
    global _marking
    marks = []
    previous = _marking
    _marking = (threading.get_ident(), count, marks, len(_stack()))
    try:
        yield marks
    finally:
        _marking = previous


def _split(marks, lo: int, hi: int, depth: int) -> list:
    """[(span, kernel nodes)] of the nodes [lo, hi) split by the spans of
    ``marks`` at ``depth``, "other" for the nodes outside them."""
    out, done, opened = [], lo, None
    for name, d, kind, n in marks:
        if d != depth:
            continue
        if kind == "enter":
            if n > done:
                out.append(("other", n - done))
            opened, done = n, n
        elif opened is not None:
            out.append((name, n - opened))
            opened, done = None, n
    if hi > done:
        out.append(("other", hi - done))
    return out


def stages(marks, total: int) -> list:
    """The ordered [(stage, kernel nodes)] of a capture from its marks:
    one entry a span opened at the outermost depth, and "other" for the
    nodes captured outside every such span; the counts sum to ``total``."""
    return _split(marks, 0, total, 0)


def substages(marks, total: int) -> list:
    """For each entry of ``stages(marks, total)``, in order, its kernel
    nodes split by the spans one level below it ([(span, kernel nodes)],
    "other" for the stage's nodes outside them); each list sums to its
    stage's count."""
    out, done, inner, start = [], 0, None, 0
    for mark in marks:
        name, depth, kind, n = mark
        if depth == 0 and kind == "enter":
            if n > done:
                out.append([("other", n - done)])
            inner, start, done = [], n, n
        elif depth == 0 and inner is not None:
            out.append(_split(inner, start, n, 1))
            inner, done = None, n
        elif inner is not None:
            inner.append(mark)
    if total > done:
        out.append([("other", total - done)])
    return out


def log_capture(record: dict) -> None:
    """Append one captured graph's record to the capture log."""
    if len(_captures) < CAPTURE_CAP:
        _captures.append(record)


def captures() -> list:
    """The capture log: one dict a captured graph (``runtime.graph``), in
    the order of capture."""
    return list(_captures)


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def drain(tree) -> None:
    """Force completion of every computation feeding ``tree``: synchronise
    each CUDA device holding one of its tensors (CPU tensors are done)."""
    for dev in dict.fromkeys(t.device for t in _tensors(tree) if t.is_cuda):
        torch.cuda.synchronize(dev)


def _add_spans(path: str, records: list) -> None:
    """Add ``records`` to the Chrome trace at ``path`` as complete events
    of a process of their own, on the trace's time base."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = "aruco3 spans"
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": pid}})
    for name, sid, parent, start, end in records:
        events.append({"ph": "X", "name": name, "cat": "aruco3", "pid": pid, "tid": 0,
                       "ts": (start - base) / 1e3, "dur": (end - start) / 1e3,
                       "args": {"id": sid, "parent": parent}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` over the body (CPU activity, and CUDA activity
    when a card is present); writes ``trace.json``, a Chrome trace with
    the body's spans added, into ``log_dir`` (default: a new directory
    made by ``tempfile.mkdtemp``).  A no-op where the profiler cannot
    start; what the body raises propagates."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="aruco3_tpu_torch_trace_")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.start()
    except RuntimeError:
        prof = None
    first = len(_records)
    try:
        yield log_dir
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, "trace.json")
            prof.export_chrome_trace(path)
            _add_spans(path, _records[first:])
