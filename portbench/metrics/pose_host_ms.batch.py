"""Host milliseconds a batch inside the program's eager pose solve (its
``aruco3.pose`` span), summed over the traced stretch and divided by its
steps.  Read under the profiler, which slows each launch on the host."""

from portbench.harness import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "aruco3.pose", "steps")
