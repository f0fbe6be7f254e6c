"""Seconds the program spent building its CUDA graphs: the warm-up and
the capture (with instantiation) of every graph in its capture log,
summed.  Part of ``setup_s``."""

from portbench.harness import program_trace


def read(ctx):
    log = program_trace.capture_log()
    if not log:
        return None
    return sum(g["warmup_ms"] + g["capture_ms"] for g in log) / 1e3
