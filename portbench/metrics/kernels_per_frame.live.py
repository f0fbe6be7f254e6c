"""Device kernels a frame in the traced stretch (copies and fills left
out): what launches cost a small frame."""

from portbench.harness.trace import is_copy


def read(ctx):
    if ctx.trace is None or ctx.trace.frames == 0:
        return None
    n = ctx.trace.count(lambda name: not is_copy(name))
    return n / ctx.trace.frames if n else None
