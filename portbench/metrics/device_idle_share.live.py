"""Share of the traced stretch of steady single frames in which no operation ran
on the device, in percent: 100 x (1 - union of the device operations'
intervals / the stretch's wall time)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
