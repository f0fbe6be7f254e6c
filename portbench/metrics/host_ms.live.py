"""Host milliseconds a frame from its hand-in until the public calls
(``detect_batch``, then the pose solve) returned, before the wait for the
results; the mean over the frames of the measured window."""

from portbench.harness import loops


def read(ctx):
    if not loops.in_window(ctx.records, ctx.t0, ctx.seconds):
        return None
    return loops.host_ms(ctx.records, ctx.t0, ctx.seconds)
