"""The capture log's ``substage_kernels``, read beside the device trace:
each stage's kernel nodes split by the program's spans one level below
it, in order.  A program whose records lack them gives None."""

from __future__ import annotations

from .program_trace import cell_replays, stage_ranges


def substage_ranges(g) -> list | None:
    """[(stage, substage, first, end)] kernel offsets inside a replay of
    the graph record ``g``, or None where it has no ``substage_kernels``
    or they do not add up to their stages."""
    subs = g.get("substage_kernels")
    stages = stage_ranges(g["stage_kernels"])
    if subs is None or len(subs) != len(stages):
        return None
    out = []
    for (stage, lo, hi), parts in zip(stages, subs):
        if sum(n for _, n in parts) != hi - lo:
            return None
        at = lo
        for name, n in parts:
            out.append((stage, name, at, at + n))
            at += n
    return out


def substage_device_ms(ctx, stage: str, substage: str):
    """Device ms a replay of the kernels in ``substage``'s node ranges
    inside ``stage``; None unless every replay is found
    (``program_trace.replays``) and the record splits that stage."""
    found = cell_replays(ctx)
    if found is None:
        return None
    g, _, runs = found
    ranges = substage_ranges(g)
    if ranges is None:
        return None
    mine = [(lo, hi) for st, sub, lo, hi in ranges if st == stage and sub == substage]
    if not mine:
        return None
    us = sum(e - s for run, _, _ in runs for at, (_, s, e) in enumerate(run)
             if any(lo <= at < hi for lo, hi in mine))
    return us / 1e3 / len(runs)
