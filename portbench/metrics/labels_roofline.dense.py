"""Kernel 2's share of its roofline in labels mode, in percent: the least
time one H100 could take for its work on the cell's batch
(``yardstick_labels.labels_work``) over its device time a launch in the
trace.  Nothing to read unless the cell's graph record reads route
"labels"."""

from portbench.harness import program_trace, yardstick, yardstick_labels


def read(ctx):
    g = program_trace.cell_graph(ctx)
    if ctx.trace is None or g is None or g.get("route") != "labels":
        return None
    secs, launches = ctx.kernel_seconds("coarse_fit")
    if launches == 0 or secs <= 0:
        return None
    scene = ctx.config["scene"]
    params, _, _, ds = ctx.geometry
    least_ms, _ = yardstick.bound_ms(*yardstick_labels.labels_work(
        ctx.batch, scene["height"], scene["width"], ds, params))
    return 100.0 * least_ms / (1e3 * secs / launches)
