"""Device milliseconds a batch of device-to-device copies: the graph's
copy of the frames into its static input and the clones of its outputs."""


def read(ctx):
    if ctx.trace is None or ctx.trace.steps == 0:
        return None
    secs = ctx.trace.seconds_by_name(lambda n: n.startswith("Memcpy DtoD"))
    if not secs:
        return None
    return 1e3 * sum(secs.values()) / ctx.trace.steps
