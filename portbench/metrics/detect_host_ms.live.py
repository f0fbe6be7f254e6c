"""Host milliseconds a frame inside the program's ``detect_batch``
(its ``aruco3.detect`` span: the graph lookup, the frame's copy in, the
replay's launch and the output clones), summed over the traced stretch
and divided by its frames.  Read under the profiler, which slows each
launch on the host."""

from portbench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "aruco3.detect", "frames")
