"""Hand-written CUDA kernels, each beside its plain PyTorch version:
``frontend`` (kernel 1), ``coarse_fit`` (kernel 2, fit and labels modes),
``refine`` (kernel 3), ``warp_decode`` (kernel 4), ``fit`` (kernels 5-7),
``warp_eval`` (kernel 8) and ``ippe`` (kernel 9, the IPPE pose solve of
``pose.solve_normalized_batch``: one launch for what is about 690 torch
operations eagerly; it replaces no TPU kernel, the JAX pose being XLA's).

Every kernel wrapper owns a ``Counter``: ``launches`` goes up by one where
the wrapper launches its kernel and nowhere else, ``plain_calls`` where it
runs the plain version (CPU tensors); ``fields`` holds what the wrapper
chose for its last launch where the capture log should name it (kernel
2's ``coarse_layout``).  A captured CUDA graph (``runtime.graph``) adds
the launches it captured on every replay, and the fields of the wrappers
it captured to its capture log record."""

_ALL: list["Counter"] = []


class Counter:
    """Launches of one kernel, calls of its plain version and the fields of
    its last launch."""

    __slots__ = ("launches", "plain_calls", "fields")

    def __init__(self):
        self.reset()
        _ALL.append(self)

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0
        self.fields = {}


def counters() -> tuple[Counter, ...]:
    """Every kernel wrapper's ``Counter`` created so far."""
    return tuple(_ALL)
