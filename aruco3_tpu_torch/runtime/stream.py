"""Streaming runtime: multi-camera ingest -> batched detection on the card;
the counterpart of ``aruco3_tpu/runtime/stream.py``.

Producers push frames into native lock-free ring buffers (C++,
``csrc/stream_buffer.cpp``), a batch assembler packs them round-robin into
fixed-shape (B, H, W) batches, and the detector runs on the card while the
next batch is being assembled (double-buffered host pipeline).  Covers
BASELINE config 5 (4 concurrent 1080p streams; mixed dictionaries by
running one StreamPipeline per dictionary).

The ring library is built with g++ at first use into
``build/aruco3_tpu_torch/``, named by a hash of its source, flags and
compiler; where there is no g++, a numpy fallback with the same semantics
keeps the API usable (``FrameRing.native`` says which one a ring uses).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..ops import _build

RING_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "stream_buffer.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_UNSET = object()
_LIB = _UNSET
_LIB_LOCK = threading.Lock()


def ring_library_path(gxx: str) -> Path:
    """Where the ring library built by compiler ``gxx`` lives."""
    version = subprocess.run(
        [gxx, "--version"], capture_output=True, text=True, check=True
    ).stdout.splitlines()[0]
    h = hashlib.sha256(" ".join(GXX_FLAGS + [version]).encode())
    h.update(RING_SOURCE.read_bytes())
    return _build.BUILD_DIR / f"libaruco3stream_{h.hexdigest()[:16]}.so"


def build_ring(gxx: str) -> Path:
    """Compile the ring library with ``gxx`` unless it exists; raises if
    the compiler fails."""
    out = ring_library_path(gxx)
    if out.exists():
        return out
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp_out = os.path.join(tmp, out.name)
        _build._run([[gxx, *GXX_FLAGS, "-o", tmp_out, str(RING_SOURCE)]])
        os.replace(tmp_out, out)  # atomic: a concurrent build never sees a partial file
    return out


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.stream_ring_create.restype = ctypes.c_void_p
    lib.stream_ring_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.stream_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.stream_ring_push.restype = ctypes.c_uint64
    lib.stream_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.stream_ring_pop.restype = ctypes.c_int64
    lib.stream_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.stream_ring_size.restype = ctypes.c_int64
    lib.stream_ring_size.argtypes = [ctypes.c_void_p]
    lib.stream_ring_dropped.restype = ctypes.c_uint64
    lib.stream_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.stream_ring_enqueued.restype = ctypes.c_uint64
    lib.stream_ring_enqueued.argtypes = [ctypes.c_void_p]
    lib.batch_assemble.restype = ctypes.c_int64
    lib.batch_assemble.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rgb_to_luma_u8.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int,
    ]
    return lib


def _lib():
    """The native ring library, built at first use; None where there is
    no g++ (the numpy fallback).  A build that starts and fails raises."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is _UNSET:
            gxx = shutil.which("g++")
            _LIB = None if gxx is None else _load(build_ring(gxx))
        return _LIB


class FrameRing:
    """Fixed-shape frame ring with drop-oldest backpressure.

    Native (lock-free C++) where the ring library builds (``native`` is
    True); numpy+lock fallback otherwise.
    """

    def __init__(self, frame_shape: tuple[int, ...], capacity: int = 8):
        self.frame_shape = tuple(frame_shape)
        self.slot_bytes = int(np.prod(frame_shape))
        self.capacity = capacity
        self._lib = _lib()
        self.native = self._lib is not None
        if self.native:
            self._h = self._lib.stream_ring_create(self.slot_bytes, capacity)
        else:
            self._buf = [None] * capacity
            self._seq = [0] * capacity
            self._head = 0
            self._tail = 0
            self._next_seq = 0
            self._dropped = 0
            self._enq = 0
            self._lock = threading.Lock()

    def push(self, frame: np.ndarray) -> int:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.shape != self.frame_shape:
            raise ValueError(f"frame shape {frame.shape}, ring holds {self.frame_shape}")
        if self.native:
            return int(
                self._lib.stream_ring_push(
                    self._h, frame.ctypes.data_as(ctypes.c_char_p)
                )
            )
        with self._lock:
            if self._head - self._tail >= self.capacity:
                self._tail += 1
                self._dropped += 1
            slot = self._head % self.capacity
            self._buf[slot] = frame.copy()
            self._seq[slot] = self._next_seq
            self._next_seq += 1
            self._head += 1
            self._enq += 1
            return self._next_seq - 1

    def pop(self) -> tuple[np.ndarray, int] | None:
        if self.native:
            out = np.empty(self.frame_shape, dtype=np.uint8)
            seq = int(
                self._lib.stream_ring_pop(
                    self._h, out.ctypes.data_as(ctypes.c_char_p)
                )
            )
            if seq < 0:
                return None
            return out, seq
        with self._lock:
            if self._tail >= self._head:
                return None
            slot = self._tail % self.capacity
            out = self._buf[slot]
            seq = self._seq[slot]
            self._tail += 1
            return out, seq

    def __len__(self) -> int:
        if self.native:
            return int(self._lib.stream_ring_size(self._h))
        with self._lock:
            return self._head - self._tail

    @property
    def dropped(self) -> int:
        if self.native:
            return int(self._lib.stream_ring_dropped(self._h))
        return self._dropped

    @property
    def enqueued(self) -> int:
        if self.native:
            return int(self._lib.stream_ring_enqueued(self._h))
        return self._enq

    def __del__(self):
        if getattr(self, "native", False):
            self._lib.stream_ring_destroy(self._h)


def assemble_batch(
    rings: list[FrameRing], batch: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Round-robin rings into a (batch, *frame_shape) array.

    Returns (frames, stream_ids, seqs, n_real); padding lanes carry
    stream_id == -1 and repeat the last real frame.
    """
    shape = rings[0].frame_shape
    out = np.zeros((batch,) + shape, dtype=np.uint8)
    ids = np.full(batch, -1, dtype=np.int64)
    seqs = np.full(batch, -1, dtype=np.int64)
    if all(r.native for r in rings):
        lib = rings[0]._lib
        handles = (ctypes.c_void_p * len(rings))(
            *[r._h for r in rings]
        )
        n = int(
            lib.batch_assemble(
                handles,
                len(rings),
                batch,
                out.ctypes.data_as(ctypes.c_char_p),
                rings[0].slot_bytes,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        )
        return out, ids, seqs, n
    # Fallback: same round-robin semantics in Python.
    filled = 0
    start = 0
    while filled < batch:
        progress = False
        for i in range(len(rings)):
            if filled >= batch:
                break
            item = rings[(start + i) % len(rings)].pop()
            if item is None:
                continue
            frame, seq = item
            out[filled] = frame
            ids[filled] = (start + i) % len(rings)
            seqs[filled] = seq
            filled += 1
            progress = True
        start = (start + 1) % len(rings)
        if not progress:
            break
    for j in range(filled, batch):
        if filled > 0:
            out[j] = out[filled - 1]
    return out, ids, seqs, filled


def rgb_to_luma_host(rgb: np.ndarray) -> np.ndarray:
    """Host-side Rec.709 luma (native where the ring library is built);
    matches ``frontend.rgb_to_luma_u8`` up to 1 LSB on exact halves."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    c = rgb.shape[-1]
    n = int(np.prod(rgb.shape[:-1]))
    out = np.empty(rgb.shape[:-1], dtype=np.uint8)
    lib = _lib()
    if lib is not None and c in (3, 4):
        lib.rgb_to_luma_u8(
            rgb.ctypes.data_as(ctypes.c_char_p),
            out.ctypes.data_as(ctypes.c_char_p),
            n,
            c,
        )
        return out
    w = np.array([0.212671, 0.715160, 0.072169])
    luma = (rgb[..., :3].astype(np.float64) * w).sum(-1)
    return np.round(luma).astype(np.uint8)


@dataclass
class StreamStats:
    batches: int = 0
    frames: int = 0
    padded: int = 0
    results_dropped: int = 0
    detect_seconds: float = 0.0
    per_stream_dropped: dict = field(default_factory=dict)


class StreamPipeline:
    """Multi-stream detection pipeline.

    Producers call ``push(stream_idx, frame)``; a worker thread assembles
    batches and runs ``detector.detect_batch``; results (the detector's
    tensors on its device, plus provenance) arrive on ``results`` as dicts.
    Double-buffered: batch N+1 assembles on the host while batch N runs on
    the card.  On the card each batch goes through one of two pinned host
    buffers and a side CUDA stream, then replays the detector's CUDA graph
    of its shape on the compute stream; its outputs carry ``done``, the
    CUDA event recorded after the graph's output clones.  An exception of
    the worker is raised again by ``stop``.
    """

    def __init__(
        self,
        detector,
        frame_shape: tuple[int, int],
        n_streams: int = 4,
        batch: int = 8,
        ring_capacity: int = 8,
    ):
        self.detector = detector
        self.rings = [
            FrameRing(frame_shape, ring_capacity) for _ in range(n_streams)
        ]
        self.batch = batch
        self.frame_shape = frame_shape
        self.results: queue.Queue = queue.Queue(maxsize=4)
        self.stats = StreamStats()
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._worker = None
        # Card path: two pinned staging buffers (batch N's copy may still
        # be in flight while batch N+1 is written) and the copy stream.
        self._staging: list[torch.Tensor] = []
        self._slot = 0
        self._copy_stream = None

    def push(self, stream_idx: int, frame: np.ndarray) -> int:
        return self.rings[stream_idx].push(frame)

    def start(self):
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def stop(self):
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=10)
        if self.error is not None:
            raise self.error

    # The three pipeline hooks below are what tests override to measure
    # the overlap property with synthetic timings.
    def _assemble(self):
        return assemble_batch(self.rings, self.batch)

    def _dispatch(self, frames: np.ndarray):
        """Enqueue one batch on the detector's device; on the card returns
        without waiting for it."""
        dev = self.detector.device
        if dev.type != "cuda":
            return self.detector.detect_batch(torch.from_numpy(frames))
        with torch.cuda.device(dev):
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(dev)
                self._staging = [
                    torch.empty(frames.shape, dtype=torch.uint8, pin_memory=True)
                    for _ in range(2)
                ]
            # This buffer's last copy belongs to batch N-2, which the
            # worker has synced before dispatching batch N.
            host = self._staging[self._slot]
            self._slot ^= 1
            host.copy_(torch.from_numpy(frames))
            with torch.cuda.stream(self._copy_stream):
                batch = host.to(dev, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self._copy_stream)
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(copied)
            batch.record_stream(compute)
            # The graph's own copy of ``batch`` into its static input runs on
            # the compute stream, after the previous batch's replay (which
            # may still read that input); its outputs are clones, so the next
            # replay leaves them alone.
            out = self.detector.detect_batch(batch)
            done = torch.cuda.Event()
            done.record(compute)
        out["done"] = done
        return out

    def _sync(self, out) -> None:
        """Block until a dispatched batch has completed on the card."""
        if "done" in out:
            out["done"].synchronize()

    def _run(self):
        try:
            self._loop()
        except Exception as e:  # the worker's boundary: ``stop`` raises it
            self.error = e

    def _loop(self):
        # Double-buffered: batch N runs on the device while batch N+1
        # assembles on the host; N is only synced after N+1 has been
        # assembled and dispatched behind it (the device queue is FIFO).
        pending = None  # (t_dispatch, outputs, ids, seqs, n)
        while not self._stop.is_set():
            frames, ids, seqs, n = self._assemble()
            if n == 0 and pending is None:
                time.sleep(0.001)
                continue
            fresh = None
            if n > 0:
                t0 = time.perf_counter()
                out = self._dispatch(frames)
                fresh = (t0, out, ids, seqs, n)
            if pending is not None:
                self._complete(pending)
            pending = fresh
        if pending is not None:
            self._complete(pending)

    def _complete(self, pending) -> None:
        t0, out, ids, seqs, n = pending
        self._sync(out)
        self.stats.detect_seconds += time.perf_counter() - t0
        self.stats.batches += 1
        self.stats.frames += n
        self.stats.padded += self.batch - n
        item = {"outputs": out, "stream_ids": ids, "seqs": seqs, "n": n}
        # Drop-oldest when the consumer lags (live streams must not
        # stall the device loop behind a slow consumer).
        while True:
            try:
                self.results.put_nowait(item)
                break
            except queue.Full:
                try:
                    self.results.get_nowait()
                    self.stats.results_dropped += 1
                except queue.Empty:
                    pass

    def drain(self, max_items: int = 64):
        items = []
        try:
            while len(items) < max_items:
                items.append(self.results.get_nowait())
        except queue.Empty:
            pass
        return items
