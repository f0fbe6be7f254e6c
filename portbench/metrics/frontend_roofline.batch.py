"""Kernel 1's share of its roofline, in percent: the least time one H100
could take for its work on the cell's batch (``yardstick.frontend_work``,
counted from the shapes) over its device time a launch in the trace."""

from portbench.harness import yardstick


def read(ctx):
    if ctx.trace is None:
        return None
    secs, launches = ctx.kernel_seconds("frontend")
    if launches == 0 or secs <= 0:
        return None
    scene = ctx.config["scene"]
    _, _, _, ds = ctx.geometry
    least_ms, _ = yardstick.bound_ms(*yardstick.frontend_work(
        ctx.batch, scene["height"], scene["width"], ds, chain=ctx.route != "tail"))
    return 100.0 * least_ms / (1e3 * secs / launches)
