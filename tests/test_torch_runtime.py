"""The port's streaming runtime (``runtime.stream``) on the CPU: the frame
ring, drop-oldest, round-robin assembly and luma on the native ring
(built here with g++) and on the numpy fallback, with equal results; the
double-buffered overlap; an end-to-end pipeline against ``detect_batch``;
and the profiling and image-IO helpers (``utils.profiling``,
``utils.imageio``)."""

import os
import time

import numpy as np
import pytest
import torch

from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig, frontend
from aruco3_tpu_torch.runtime import stream as rt
from aruco3_tpu_torch.utils import imageio, profiling
from torch_twin import make_scene, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["native", "numpy"])
def ring_kind(request, monkeypatch):
    """Run a test on the native ring, then on the numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(rt, "_lib", lambda: None)
    return request.param


def test_ring_source_is_a_copy_of_the_jax_native_source():
    with open(os.path.join(REPO, "native", "stream_buffer.cpp"), "rb") as f:
        assert rt.RING_SOURCE.read_bytes() == f.read()


def test_native_ring_builds_into_the_port_build_dir():
    lib = rt._lib()
    assert lib is not None, "g++ is on this machine: the native ring must build"
    path = rt.ring_library_path(rt.shutil.which("g++"))
    assert path.exists() and path.parent == rt._build.BUILD_DIR
    assert rt.FrameRing((2, 2)).native


def test_ring_push_pop_order(ring_kind):
    ring = rt.FrameRing((4, 6), capacity=4)
    assert ring.native == (ring_kind == "native")
    frames = [np.full((4, 6), i, dtype=np.uint8) for i in range(3)]
    seqs = [ring.push(f) for f in frames]
    assert seqs == [0, 1, 2]
    assert len(ring) == 3 and ring.enqueued == 3
    for i in range(3):
        out, seq = ring.pop()
        assert seq == i
        assert (out == i).all()
    assert ring.pop() is None
    with pytest.raises(ValueError):
        ring.push(np.zeros((4, 5), np.uint8))


def test_ring_drop_oldest(ring_kind):
    ring = rt.FrameRing((2, 2), capacity=2)
    for i in range(5):
        ring.push(np.full((2, 2), i, dtype=np.uint8))
    assert ring.dropped == 3
    out, seq = ring.pop()
    assert seq == 3 and (out == 3).all()
    out, seq = ring.pop()
    assert seq == 4 and (out == 4).all()


def _assembled():
    rings = [rt.FrameRing((2, 2), capacity=8) for _ in range(3)]
    for s, ring in enumerate(rings):
        for i in range(2 + s):
            ring.push(np.full((2, 2), 10 * s + i, dtype=np.uint8))
    return rt.assemble_batch(rings, 8)


def test_batch_assemble_round_robin(ring_kind):
    frames, ids, seqs, n = _assembled()
    assert n == 8
    # Round robin: first three lanes come from distinct streams.
    assert sorted(ids[:3].tolist()) == [0, 1, 2]
    for f, s, q in zip(frames, ids, seqs):
        assert (f == 10 * s + q).all()
    frames, ids, seqs, n = rt.assemble_batch([rt.FrameRing((2, 2))], 4)
    assert n == 0 and (ids == -1).all()


def test_batch_assemble_pads_with_the_last_frame(ring_kind):
    rings = [rt.FrameRing((2, 2), capacity=8) for _ in range(3)]
    for s, ring in enumerate(rings):
        for i in range(2):
            ring.push(np.full((2, 2), 10 * s + i, dtype=np.uint8))
    frames, ids, seqs, n = rt.assemble_batch(rings, 8)
    assert n == 6
    assert (ids[6:] == -1).all() and (seqs[6:] == -1).all()
    np.testing.assert_array_equal(frames[6], frames[5])
    np.testing.assert_array_equal(frames[7], frames[5])


def test_native_and_numpy_rings_agree(monkeypatch):
    native = _assembled()
    monkeypatch.setattr(rt, "_lib", lambda: None)
    fallback = _assembled()
    for a, b in zip(native, fallback):
        np.testing.assert_array_equal(a, b)


def test_rgb_to_luma_matches_device(ring_kind):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(16, 17, 3), dtype=np.uint8)
    host = rt.rgb_to_luma_host(rgb)
    dev = frontend.rgb_to_luma_u8(t(rgb)).numpy()
    # Rounding of float32 vs float64 luma can differ by 1 LSB on exact .5s.
    assert np.abs(host.astype(int) - dev.astype(int)).max() <= 1


def test_stream_pipeline_overlaps_assembly_with_device():
    """Host assembly of batch N+1 overlaps the in-flight batch N: with a
    slow 'device' (50 ms) and slow assembly (30 ms), pipelined batches take
    ~max(50, 30) each, well under the 80 ms serial sum."""
    dev_s, asm_s, batches = 0.05, 0.03, 8
    events = []

    class FakePipeline(rt.StreamPipeline):
        def __init__(self):
            super().__init__(detector=None, frame_shape=(2, 2), n_streams=1, batch=1)
            self._served = 0

        def _assemble(self):
            if self._served >= batches:
                return (np.zeros((1, 2, 2), np.uint8), np.full(1, -1, np.int64),
                        np.full(1, -1, np.int64), 0)
            self._served += 1
            events.append(("assemble_start", time.perf_counter()))
            time.sleep(asm_s)
            events.append(("assemble_end", time.perf_counter()))
            return (np.zeros((1, 2, 2), np.uint8), np.zeros(1, np.int64),
                    np.arange(1, dtype=np.int64) + self._served, 1)

        def _dispatch(self, frames):
            return {"deadline": time.perf_counter() + dev_s}

        def _sync(self, out):
            while time.perf_counter() < out["deadline"]:
                time.sleep(0.001)
            events.append(("complete", time.perf_counter()))

    pipe = FakePipeline()
    t0 = time.perf_counter()
    pipe.start()
    deadline = time.time() + 30
    while time.time() < deadline and pipe.stats.batches < batches:
        time.sleep(0.005)
    elapsed = time.perf_counter() - t0
    pipe.stop()
    assert pipe.stats.batches == batches
    serial = batches * (dev_s + asm_s)
    assert elapsed < serial * 0.85, (elapsed, serial)
    starts = [s for k, s in events if k == "assemble_start"]
    completes = [s for k, s in events if k == "complete"]
    overlapped = sum(1 for i in range(1, min(len(starts), len(completes)))
                     if starts[i] < completes[i - 1])
    assert overlapped >= (batches - 1) // 2, events


def test_stream_pipeline_raises_the_workers_error():
    class Broken(rt.StreamPipeline):
        def _dispatch(self, frames):
            raise RuntimeError("dispatch failed")

    pipe = Broken(detector=None, frame_shape=(2, 2), n_streams=1, batch=1)
    pipe.push(0, np.zeros((2, 2), np.uint8))
    pipe.start()
    pipe._worker.join(timeout=10)
    assert not pipe._worker.is_alive()
    with pytest.raises(RuntimeError, match="dispatch failed"):
        pipe.stop()


def test_stream_pipeline_end_to_end():
    """4 streams of 120x160, batch 4, 8 frames through a CPU detector: each
    result lane equals ``detect_batch`` of the frame it came from."""
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    det = Detector(DetectorConfig(), d, device="cpu")
    kinds = ("single", "multi", "dark", "nested")
    frames = np.stack([make_scene(k, 160, 120, scale=0.5)[0] for k in kinds])
    ref = det.detect_batch(frames)
    pipe = rt.StreamPipeline(det, (120, 160), n_streams=4, batch=4)
    assert all(r.native for r in pipe.rings)
    for i in range(2):
        for s in range(4):
            pipe.push(s, frames[(s + i) % 4])
    pipe.start()
    items = []
    deadline = time.time() + 60
    while time.time() < deadline and sum(it["n"] for it in items) < 8:
        items += pipe.drain()
        time.sleep(0.01)
    pipe.stop()
    assert pipe.stats.frames == 8 and pipe.stats.batches == 2
    lanes = 0
    for item in items:
        out = item["outputs"]
        for lane, (s, seq) in enumerate(zip(item["stream_ids"], item["seqs"])):
            if s < 0:
                continue
            f = (int(s) + int(seq)) % 4
            valid = out["marker_valid"][lane]
            assert torch.equal(valid, ref["marker_valid"][f])
            assert torch.equal(out["marker_id"][lane][valid], ref["marker_id"][f][valid])
            assert torch.equal(out["marker_corners"][lane][valid],
                               ref["marker_corners"][f][valid])
            lanes += 1
    assert lanes == 8


def test_stage_timer_and_drain():
    timer = profiling.StageTimer()
    with timer.stage("sleep"):
        time.sleep(0.01)
    x = torch.arange(6.0)
    out = timer.time_fn("double", lambda a: {"y": [a * 2, (a,)]}, x, iters=3)
    assert torch.equal(out["y"][0], x * 2)
    profiling.drain(out)  # CPU tensors: nothing to wait for
    profiling.drain({"a": 1, "b": [None]})
    assert timer.totals["sleep"] >= 0.01 and timer.counts["double"] == 1
    report = timer.report()
    assert report.splitlines()[0].startswith("sleep") and "double" in report


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == str(tmp_path / "tr")
    assert os.path.getsize(os.path.join(log_dir, "trace.json")) > 0
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(str(tmp_path / "tr2")):
            1 / 0
    assert os.path.exists(tmp_path / "tr2" / "trace.json")


def test_imageio_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(24, 31), dtype=np.uint8)
    imageio.write_pgm(str(tmp_path / "a.pgm"), img)
    np.testing.assert_array_equal(imageio.read_pgm(str(tmp_path / "a.pgm")), img)
    det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict("ARUCO_DEFAULT"),
                   device="cpu")
    scene, ids = make_scene("single")
    markers = det.detect(scene).markers
    assert {m.id for m in markers} == ids
    rgb = imageio.draw_marker_overlay(scene, markers)
    assert rgb.shape == scene.shape + (3,)
    x, y = markers[0].corners[0]
    assert tuple(rgb[y, x]) == (0, 0, 255)
    imageio.write_ppm(str(tmp_path / "b.ppm"), rgb)
    data = (tmp_path / "b.ppm").read_bytes()
    assert data.startswith(b"P6\n320 240\n255\n") and data.endswith(rgb.tobytes())
