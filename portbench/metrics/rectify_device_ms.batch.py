"""Device milliseconds a batch of the graph's kernels in the
``aruco3.rectify`` stage: each replay's kernels in the traced stretch,
split by the graph's stage map (its capture log record's
``stage_kernels``).  None unless every replay shows the graph's kernel
nodes with kernels 1-4 in their stages (``program_trace.replays``)."""

from portbench.harness import program_trace


def read(ctx):
    return program_trace.stage_device_ms(ctx, "aruco3.rectify")
