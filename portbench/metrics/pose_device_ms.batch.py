"""Device milliseconds a batch of the kernels (copies left out) between
one replay's last kernel and the next replay's first in the traced
stretch: the eager pose's.  None unless every replay is found
(``program_trace.replays``)."""

from portbench.harness import program_trace


def read(ctx):
    return program_trace.between_replays_ms(ctx)
