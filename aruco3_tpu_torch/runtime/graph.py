"""One captured CUDA graph per input shape: the port's counterpart of
``jax.jit`` for a function of fixed-shape device tensors.

``Graph`` runs the function once on a side stream over zero inputs of
the graph's shapes (the warm-up: it builds the kernels and fills the lazy
device tables, such as kernel 4's tap table and the codebooks), then
captures it with ``torch.cuda.graph``.  The graph reads those tables where
they lie, so they must outlive it: the port caches them for the life of
the process, and a ``Graph`` keeps its function (and what that closes
over, such as a pose step's scale).  A call
copies its arguments into the graph's static inputs on the current
stream, replays the graph there and clones every output on the same
stream, so each call returns fresh tensors, as a JAX call does:

* the copies of call N+1 are ordered after replay N, which may still be
  reading the static inputs;
* replay N+1 overwrites the static outputs only after call N's clones.

A capture that fails raises, naming the graph's input specs; there is no
eager fallback.  While it captures, each ``utils.profiling.span`` the
function opens marks the capture graph's kernel nodes so far (libcuda
``cuStreamGetCaptureInfo``), which gives the graph's stage map
(``stage_kernels``), and the spans one level below each stage split its
nodes again (``substage_kernels``); every capture adds a record to the
profiling capture log.  Kernel launch counts (``ops.counters``) stay counts
of kernels launched on the card: the increments the wrappers made while
the graph was captured are taken back and added again on every replay.

``GraphCache`` keeps at most ``maxsize`` graphs, least recently used out
first, sharing one memory pool: replays run one after another on one
stream and their outputs are cloned out before the next replay, so no two
graphs' intermediates are live at once.
"""

from __future__ import annotations

import ctypes
import functools
import gc
import time
from collections import OrderedDict
from typing import Callable

import torch

from .. import ops
from ..utils import profiling

# cuGraphNodeGetType's CU_GRAPH_NODE_TYPE_KERNEL; cuStreamGetCaptureInfo's
# CU_STREAM_CAPTURE_STATUS_ACTIVE.
_KERNEL_NODE = 0
_CAPTURE_ACTIVE = 1


@functools.lru_cache(maxsize=1)
def _libcuda() -> ctypes.CDLL:
    return ctypes.CDLL("libcuda.so.1")


def _clone(tree):
    """Fresh copies of the tensors in nested dicts, tuples and lists."""
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def kernel_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """Kernel nodes of a graph captured with ``keep_graph=True`` (libcuda
    API ``cuGraphGetNodes``)."""
    return _kernel_nodes_of(ctypes.c_void_p(graph.raw_cuda_graph()))


def capturing_kernel_nodes() -> int:
    """Kernel nodes captured so far into the current stream's capture
    graph (libcuda ``cuStreamGetCaptureInfo``); 0 where the stream is not
    capturing."""
    cuda = _libcuda()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    status, handle = ctypes.c_int(0), ctypes.c_void_p(None)
    uid = ctypes.c_uint64(0)
    rc = cuda.cuStreamGetCaptureInfo_v2(stream, ctypes.byref(status), ctypes.byref(uid),
                                        ctypes.byref(handle), None, None)
    if rc != 0:
        raise RuntimeError(f"cuStreamGetCaptureInfo failed ({rc})")
    if status.value != _CAPTURE_ACTIVE or not handle.value:
        return 0
    return _kernel_nodes_of(handle)


def _kernel_nodes_of(handle: ctypes.c_void_p) -> int:
    cuda = _libcuda()
    count = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(handle, None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed ({rc})")
    if count.value == 0:  # an empty array is refused
        return 0
    nodes = (ctypes.c_void_p * count.value)()
    rc = cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed ({rc})")
    kinds = ctypes.c_int(0)
    n = 0
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kinds)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        n += kinds.value == _KERNEL_NODE
    return n


def _pairs(specs) -> list:
    """[(shape, dtype)] of ``specs``, a non-empty sequence of (shape,
    dtype) pairs; ValueError for anything else."""
    try:
        pairs = [(tuple(int(n) for n in s), d) for s, d in specs]
    except (TypeError, ValueError):
        pairs = []
    if not pairs or not all(isinstance(d, torch.dtype) for _, d in pairs):
        raise ValueError(f"input specs are a non-empty sequence of (shape, dtype) pairs, "
                         f"not {specs!r}")
    return pairs


class Graph:
    """``fn`` captured for inputs of ``specs``, a sequence of (shape, dtype)
    pairs, one for each argument of ``fn``, on the CUDA device ``device``.

    ``warmup_ms`` is the host time of the warm-up, ``capture_ms`` that of
    the capture and instantiation, ``pool_bytes`` what the memory pool grew
    by during it, ``kernel_nodes`` the graph's kernel nodes and
    ``stage_kernels`` their split, in order, by the spans the function
    opened at its outermost level ([(stage, kernel nodes)], "other" for
    nodes outside them; the counts sum to ``kernel_nodes``),
    ``substage_kernels`` each stage's nodes split by the spans one level
    below it (``profiling.substages``).  The capture log record holds
    these, then the caller's ``record`` as it is, then the ``fields`` of
    each kernel wrapper the capture launched."""

    def __init__(self, fn: Callable, specs, device, pool=None, record: dict | None = None):
        specs = _pairs(specs)
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph runs on a CUDA device, not {dev}")
        self.fn = fn
        with torch.cuda.device(dev):
            self.inputs = [torch.zeros(s, dtype=d, device=dev) for s, d in specs]
            t0 = time.perf_counter()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn(*self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            self.warmup_ms = 1e3 * (time.perf_counter() - t0)

            before = {id(c): c.launches for c in ops.counters()}
            torch.cuda.empty_cache()  # as the capture does first
            reserved = torch.cuda.memory_reserved(dev)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.perf_counter()
            # No collection during the capture: a graph that the cyclic
            # collector destroyed now (cudaGraphExecDestroy) would
            # invalidate it.
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                    with profiling.stage_map(capturing_kernel_nodes) as marks:
                        self.outputs = fn(*self.inputs)
            except Exception as e:
                raise RuntimeError(f"CUDA graph capture on inputs {specs} failed: {e}") from e
            finally:
                if collecting:
                    gc.enable()
            self.kernel_nodes = kernel_nodes(self.graph)
            self.graph.instantiate()
            self.capture_ms = 1e3 * (time.perf_counter() - t0)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.stage_kernels = profiling.stages(marks, self.kernel_nodes)
        self.substage_kernels = profiling.substages(marks, self.kernel_nodes)
        self.launches = []
        fields = {}
        for c in ops.counters():
            n = c.launches - before.get(id(c), 0)
            if n:
                c.launches -= n  # captured, not launched
                self.launches.append((c, n))
                fields.update(c.fields)
        profiling.log_capture({
            "shape": [[list(s), str(d).removeprefix("torch.")] for s, d in specs],
            "warmup_ms": self.warmup_ms, "capture_ms": self.capture_ms,
            "kernel_nodes": self.kernel_nodes, "pool_bytes": self.pool_bytes,
            "stage_kernels": self.stage_kernels, "substage_kernels": self.substage_kernels,
            **(record or {}), **fields})

    def fresh(self):
        """Clones of the static outputs on the current stream."""
        return _clone(self.outputs)

    def __call__(self, *xs: torch.Tensor):
        """Copy the arguments in, replay, return fresh outputs (all on the
        current stream of the graph's device; no host sync unless an
        argument is a host tensor)."""
        if len(xs) != len(self.inputs) or any(
            x.shape != i.shape or x.dtype != i.dtype for x, i in zip(xs, self.inputs)
        ):
            raise ValueError(
                f"graph captured for {[(tuple(i.shape), i.dtype) for i in self.inputs]}, "
                f"got {[(tuple(x.shape), x.dtype) for x in xs]}"
            )
        with torch.cuda.device(self.inputs[0].device):
            with profiling.span("aruco3.graph.copy_in"):
                for i, x in zip(self.inputs, xs):
                    i.copy_(x, non_blocking=x.is_cuda)
            with profiling.span("aruco3.graph.replay"):
                self.graph.replay()
            for c, n in self.launches:
                c.launches += n
            with profiling.span("aruco3.graph.clone"):
                return self.fresh()


class GraphCache:
    """At most ``maxsize`` ``Graph``s by key, least recently used out first,
    all in one memory pool (a new one after a failed capture)."""

    def __init__(self, maxsize: int = 32):
        self.maxsize = maxsize
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: OrderedDict = OrderedDict()

    def get(self, key, make: Callable[[], Callable], specs, device,
            describe: Callable[[], dict] | None = None) -> Graph:
        """The graph of ``key``; where the cache does not hold it, the
        function ``make()`` returns, captured for ``specs`` on ``device`` (as
        ``Graph`` takes them), with ``describe()``'s dict in its capture log
        record.  ``make`` and ``describe`` run once per capture, so the
        device constants ``make`` builds are built once per graph and a hit
        costs neither."""
        g = self.graphs.get(key)
        if g is None:
            record = describe() if describe is not None else None
            with profiling.span("aruco3.graph.capture"):
                try:
                    g = self.graphs[key] = Graph(make(), specs, device, self.pool, record)
                except RuntimeError:
                    # torch's allocator keeps the pool of a failed capture
                    # marked as recording and refuses every later capture
                    # into it.
                    self.pool = torch.cuda.graph_pool_handle()
                    raise
            while len(self.graphs) > self.maxsize:
                self.graphs.popitem(last=False)
        else:
            self.graphs.move_to_end(key)
        return g
