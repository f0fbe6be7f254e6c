"""Device milliseconds a batch of the graph's kernels in the
``aruco3.segment.fit`` node range: kernel 2 in either mode, kernel 7 or
kernels 5 and 6, and the merge's torch operations; each replay's kernels
in the traced stretch, split by the capture log record's
``substage_kernels``.  None unless every replay shows the graph's kernel
nodes with kernels 1-4 in their stages (``program_trace.replays``) and
the record splits the segment stage."""

from portbench.harness import program_substages


def read(ctx):
    return program_substages.substage_device_ms(ctx, "aruco3.segment", "aruco3.segment.fit")
