"""Device kernels a frame outside the graph: the traced stretch's kernels
(copies and fills left out, the graph's copy nodes, which CUDA runs as
kernels, too) less the cell's graph's kernel nodes a replay (its
capture log record), over the stretch's frames.  On the live path these
are the eager pose's launches."""

from portbench.harness import program_trace


def read(ctx):
    if ctx.trace is None or ctx.trace.frames == 0:
        return None
    g = program_trace.cell_graph(ctx)
    if g is None:
        return None
    n = (ctx.trace.count(lambda name: not program_trace.is_copy(name))
         - ctx.trace.steps * g["kernel_nodes"])
    return n / ctx.trace.frames if n >= 0 else None
