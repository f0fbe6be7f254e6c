"""Hand-written CUDA kernels, each beside its plain PyTorch version:
``frontend`` (kernel 1), ``coarse_fit`` (kernel 2, fit and labels modes),
``refine`` (kernel 3), ``warp_decode`` (kernel 4), ``fit`` (kernels 5-7)
and ``warp_eval`` (kernel 8).

Every kernel wrapper owns a ``Counter``: ``launches`` goes up by one where
the wrapper launches its kernel and nowhere else, ``plain_calls`` where it
runs the plain version (CPU tensors).  A captured CUDA graph
(``runtime.graph``) adds the launches it captured on every replay."""

_ALL: list["Counter"] = []


class Counter:
    """Launches of one kernel and calls of its plain version."""

    __slots__ = ("launches", "plain_calls")

    def __init__(self):
        self.reset()
        _ALL.append(self)

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


def counters() -> tuple[Counter, ...]:
    """Every kernel wrapper's ``Counter`` created so far."""
    return tuple(_ALL)
