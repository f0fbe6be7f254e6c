"""Device milliseconds a frame of every operation that is neither one of
the port's eight kernels (``kernels.json``) nor a copy or a fill: the
torch glue of segment, rectify, match and pose."""

from portbench.harness.trace import is_copy


def read(ctx):
    if ctx.trace is None or ctx.trace.frames == 0:
        return None
    secs = ctx.trace.seconds_by_name(lambda n: not is_copy(n) and not ctx.is_port_kernel(n))
    if not secs:
        return None
    return 1e3 * sum(secs.values()) / ctx.trace.frames
