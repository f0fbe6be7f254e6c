"""The program's own spans and capture log, read beside the device trace.

The port records host spans (``aruco3.*``) on the wall clock while a
``torch.profiler`` runs, and one record a captured CUDA graph (its input
shape, warm-up and capture ms, kernel nodes, pool bytes and
``stage_kernels``, the kernel nodes split by the stage spans in order),
in ``aruco3_tpu_torch.utils.profiling``.  A program without them (no
``spans`` or ``captures`` there) gives None, and so does every reader.

A step on the port's one stream runs on the device, in order: the copy
into the graph's input, the replay's kernels, the clones of its outputs
(copies, and a kernel for each output that is not contiguous), the
pose's kernels and the copy of the results to the host.  ``replays``
finds each replay's kernels in the trace by that order, and refuses
(None) a stretch where they do not hold the graph's kernel nodes in its
stage map's order.
"""

from __future__ import annotations

import re

from .runner import kernel_of
from .trace import is_copy as _is_copy

# CUDA runs a graph's copy and fill nodes as kernels of its own
# (``memcpy32_post`` and the like), which the trace lists as kernels.
_GRAPH_COPY = re.compile(r"^mem(cpy|set)\w*$")


def is_copy(name: str) -> bool:
    """A copy or a fill: the profiler's own, or a graph's copy node run as
    CUDA's own kernel."""
    return _is_copy(name) or _GRAPH_COPY.match(name) is not None

# Where the stage map must put the port's kernels: wrapper -> stage span.
STAGE_OF = {"frontend": "aruco3.frontend", "coarse_fit": "aruco3.segment",
            "refine": "aruco3.segment", "warp_decode": "aruco3.rectify"}


def _profiling():
    try:
        from aruco3_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def records():
    """The program's span records (name, id, parent id, start_ns, end_ns),
    or None where it keeps none."""
    fn = getattr(_profiling(), "spans", None)
    return fn() if fn is not None else None


def capture_log():
    """The program's capture log (one dict a captured graph), or None
    where it keeps none."""
    fn = getattr(_profiling(), "captures", None)
    return fn() if fn is not None else None


def span_intervals(recs, name: str, window: tuple) -> list:
    """(start_us, end_us) of the spans named ``name``, clipped to
    ``window`` (wall clock, us; empty ones dropped)."""
    lo, hi = window
    out = []
    for n, _, _, start, end in recs:
        if n == name:
            s, e = max(start / 1e3, lo), min(end / 1e3, hi)
            if e > s:
                out.append((s, e))
    return out


def span_ms(ctx, name: str, per: str):
    """Host ms of the spans named ``name`` inside the traced stretch,
    a frame (``per="frames"``) or a step (``per="steps"``); None where no
    such span was recorded."""
    recs = records()
    count = getattr(ctx.trace, per, 0) if ctx.trace is not None else 0
    if not recs or count == 0:
        return None
    spans = span_intervals(recs, name, ctx.trace.window)
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / count


def innermost(recs, t: float, prefix: str = "aruco3."):
    """The shortest span named ``prefix...`` open at ``t`` (wall clock,
    us), or None."""
    best = None
    for name, _, _, start, end in recs:
        if name.startswith(prefix) and start / 1e3 <= t < end / 1e3:
            if best is None or end - start < best[1]:
                best = (name, end - start)
    return best[0] if best else None


def cell_graph(ctx):
    """The last capture log record of the cell's input shape, (batch,
    height, width) uint8, or None."""
    log = capture_log()
    if not log:
        return None
    scene = ctx.config["scene"]
    shape = [[[ctx.batch, scene["height"], scene["width"]], "uint8"]]
    found = [g for g in log if g.get("shape") == shape]
    return found[-1] if found else None


def stage_ranges(stage_kernels) -> list:
    """[(stage, first, end)] kernel offsets inside a replay, in order."""
    out, at = [], 0
    for stage, n in stage_kernels:
        out.append((stage, at, at + n))
        at += n
    return out


def replays(ops, nodes: int, stage_kernels, kernels: dict, steps: int):
    """Each replay in a stretch's device operations ``ops`` (sorted by
    start) as (its kernels [(name, start, end)], the index in ``ops`` of
    its first operation, the index after its last kernel), or None where
    the stretch does not show ``steps`` replays of ``nodes`` kernels each,
    in the stage map's order.

    A replay begins at the first kernel after the copy that precedes its
    kernel 1 (or at the stretch's first operation, where the stretch cut
    that copy off) and holds the next ``nodes`` kernels (copies among them
    are not counted).  Every replay must hold one kernel 1, at one offset,
    and put each kernel of ``STAGE_OF`` it launches inside that stage's
    range, kernels 1-4 at least once."""
    if nodes <= 0 or sum(n for _, n in stage_kernels) != nodes:
        return None
    ranges = stage_ranges(stage_kernels)
    out, offset = [], None
    for i, (name, _, _) in enumerate(ops):
        if kernel_of(name, kernels) != "frontend":
            continue
        j = i - 1
        while j >= 0 and not is_copy(ops[j][0]):
            j -= 1
        run, k = [], j + 1
        while k < len(ops) and len(run) < nodes:
            if not is_copy(ops[k][0]):
                run.append(ops[k])
            k += 1
        if len(run) < nodes or sum(kernel_of(op[0], kernels) == "frontend" for op in run) != 1:
            return None
        if offset is None:
            offset = i - j - 1
        if i - j - 1 != offset or not _in_stages(run, ranges, kernels):
            return None
        out.append((run, j + 1, k))
    return out if len(out) == steps else None


def _in_stages(run, ranges, kernels) -> bool:
    seen = set()
    for at, (name, _, _) in enumerate(run):
        wrapper = kernel_of(name, kernels)
        if wrapper not in STAGE_OF:
            continue
        stage = next((st for st, lo, hi in ranges if lo <= at < hi), None)
        if stage != STAGE_OF[wrapper]:
            return False
        seen.add(wrapper)
    return seen == set(STAGE_OF)


def cell_replays(ctx):
    """(the cell's graph record, its replays in the traced stretch), or
    None."""
    if ctx.trace is None or ctx.trace.steps == 0:
        return None
    g = cell_graph(ctx)
    if g is None or "stage_kernels" not in g:
        return None
    ops = sorted(ctx.trace.clipped(), key=lambda op: op[1])
    found = replays(ops, g["kernel_nodes"], g["stage_kernels"], ctx.kernels, ctx.trace.steps)
    return None if found is None else (g, ops, found)


def stage_device_ms(ctx, stage: str):
    """Device ms a replay of the kernels in stage ``stage``'s node ranges."""
    found = cell_replays(ctx)
    if found is None:
        return None
    g, _, runs = found
    ranges = [(lo, hi) for st, lo, hi in stage_ranges(g["stage_kernels"]) if st == stage]
    if not ranges:
        return None
    us = sum(e - s for run, _, _ in runs for at, (_, s, e) in enumerate(run)
             if any(lo <= at < hi for lo, hi in ranges))
    return us / 1e3 / len(runs)


def between_replays_ms(ctx):
    """Device ms a replay of the kernels (copies left out) from each
    replay's last kernel to the next replay's first (to the stretch's end
    after the last): the pose's, and the clones' of outputs that are not
    contiguous."""
    found = cell_replays(ctx)
    if found is None:
        return None
    _, ops, runs = found
    us = 0.0
    for r, (_, _, after) in enumerate(runs):
        upto = runs[r + 1][1] if r + 1 < len(runs) else len(ops)
        us += sum(e - s for name, s, e in ops[after:upto] if not is_copy(name))
    return us / 1e3 / len(runs)


def copy_in_offsets(trace, recs) -> list:
    """For each host-to-device copy in the stretch, (how far (us) it lies
    outside the nearest ``aruco3.graph.copy_in`` span, 0 inside; its start
    less the span's; the span's end less its end)."""
    spans = span_intervals(recs, "aruco3.graph.copy_in", trace.window)
    out = []
    for name, s, e in trace.clipped():
        if name.startswith("Memcpy HtoD") and spans:
            lo, hi = min(spans, key=lambda sp: max(sp[0] - s, e - sp[1], 0.0))
            out.append((max(lo - s, e - hi, 0.0), s - lo, hi - e))
    return out
