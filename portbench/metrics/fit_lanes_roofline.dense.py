"""Kernel 6's share of its roofline, in percent: the least time one H100
could take for its launches on the cell's batch, one a fitted plane
(``yardstick_labels.fit_lanes_work``, a floor), over its device time for
as many launches in the trace.  Nothing to read unless the cell's graph
record reads route "labels"."""

from portbench.harness import program_trace, yardstick_labels


def read(ctx):
    g = program_trace.cell_graph(ctx)
    if ctx.trace is None or g is None or g.get("route") != "labels":
        return None
    secs, launches = ctx.kernel_seconds("fit_lanes")
    if launches == 0 or secs <= 0:
        return None
    scene = ctx.config["scene"]
    params, _, _, ds = ctx.geometry
    least_ms = yardstick_labels.plane_bound_ms(yardstick_labels.fit_lanes_work, ctx.batch,
                                               scene["height"], scene["width"], ds, params)
    per_batch_ms = 1e3 * secs / launches * len(yardstick_labels.planes(params))
    return 100.0 * least_ms / per_batch_ms
