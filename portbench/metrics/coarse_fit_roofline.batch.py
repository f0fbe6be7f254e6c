"""Kernel 2's share of its roofline in fit mode (the fused route), in
percent: the least time one H100 could take for its work on the cell's
batch (``yardstick.coarse_fit_work``, a floor) over its device time a
launch in the trace.  Nothing to read where the cell's frames take
another route."""

from portbench.harness import yardstick


def read(ctx):
    if ctx.trace is None or ctx.route != "fused":
        return None
    secs, launches = ctx.kernel_seconds("coarse_fit")
    if launches == 0 or secs <= 0:
        return None
    scene = ctx.config["scene"]
    params, _, _, ds = ctx.geometry
    least_ms, _ = yardstick.bound_ms(*yardstick.coarse_fit_work(
        ctx.batch, scene["height"], scene["width"], ds, params))
    return 100.0 * least_ms / (1e3 * secs / launches)
