"""The port's masks route, streaming runtime, CUDA graphs and spatial step
on the card, against the same functions on the CPU or run eagerly.
Imports no JAX; the tests need the card and skip elsewhere:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_paths_gpu.py
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig
from aruco3_tpu_torch.detector import detect_arrays, detect_from_masks, to_host
from aruco3_tpu_torch.ops import coarse_fit as k2
from aruco3_tpu_torch.ops import fit as kfit
from aruco3_tpu_torch.ops import frontend as k1
from aruco3_tpu_torch.ops import refine as k3
from aruco3_tpu_torch.ops import warp_eval as k8
from aruco3_tpu_torch.runtime import stream as rt
from torch_twin import cuda_device, make_scene

KINDS = ("single", "multi", "dark", "nested")
COUNTS = {"frontend": k1.count, "coarse_labels": k2.labels_count, "fused_fit": kfit.fused_count,
          "refine": k3.count, "warp_eval": k8.count}


def _summary(det):
    return sorted((m.id, m.code, tuple(m.corners)) for m in det.markers), det.stats


@pytest.mark.gpu
@pytest.mark.parametrize("w, h, refine", [(320, 240, True), (320, 240, False), (160, 120, True)])
def test_detect_from_masks_on_card_matches_cpu(w, h, refine):
    """Both routes of ``detect_from_masks``: kernel 3 then kernel 8 (320x240
    at ds 2 with refinement), and kernel 8 alone (no refinement, or ds 1)."""
    dev = cuda_device()
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    det = Detector(DetectorConfig(refine_corners=refine), d, device="cpu")
    frames = torch.from_numpy(np.stack([make_scene(k, w, h, w / 320)[0] for k in KINDS]))
    params, min_edge, min_sep, ds = det.geometry(h, w)
    coarse, _, _, black = k1.plain(frames, det.config.threshold_window, params.open_radius, ds,
                                   opened=True)
    ref = detect_from_masks(frames, black, coarse, d, det.config, params, min_edge, min_sep, ds)
    for c in COUNTS.values():
        c.reset()
    got = detect_from_masks(frames.to(dev), black.to(dev), coarse.to(dev), d, det.config,
                            params, min_edge, min_sep, ds)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in COUNTS.items()}
    assert launches == {"frontend": 0, "coarse_labels": 1, "fused_fit": 1,
                        "refine": int(refine and ds > 1), "warp_eval": 1}
    assert all(c.plain_calls == 0 for c in COUNTS.values())
    for b, kind in enumerate(KINDS):
        assert _summary(to_host(got, b)) == _summary(to_host(ref, b)), kind
        assert {m.id for m in to_host(got, b).markers} == make_scene(kind)[1]


@pytest.mark.gpu
def test_detect_arrays_on_card_matches_cpu():
    dev = cuda_device()
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    det = Detector(DetectorConfig(), d, device="cpu")
    img, ids = make_scene("nested")
    params, min_edge, min_sep, ds = det.geometry(*img.shape)
    ref = detect_arrays(torch.from_numpy(img), d, det.config, params, min_edge, min_sep, ds)
    k1.count.reset()
    got = detect_arrays(torch.from_numpy(img).to(dev), d, det.config, params, min_edge, min_sep,
                        ds)
    assert k1.count.launches == 1
    for key in ("marker_valid", "marker_id", "marker_code", "quads"):
        assert torch.equal(got[key].cpu(), ref[key]), key
    valid = ref["marker_valid"]
    assert {int(i) for i in ref["marker_id"][valid]} == ids


@pytest.mark.gpu
def test_stream_pipeline_on_card():
    """Two batches through the pinned, side-stream dispatch: every lane
    equals ``detect_batch`` of its frame on the card."""
    dev = cuda_device()
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    det = Detector(DetectorConfig(), d, device=dev)
    frames = np.stack([make_scene(k)[0] for k in KINDS])
    ref = det.detect_batch(frames)
    pipe = rt.StreamPipeline(det, (240, 320), n_streams=4, batch=4)
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
    assert pipe.stats.batches == 2 and len(pipe._staging) == 2
    for item in items:
        out = item["outputs"]
        assert out["done"].query()
        for lane, (s, seq) in enumerate(zip(item["stream_ids"], item["seqs"])):
            f = (int(s) + int(seq)) % 4
            for key in ("marker_valid", "marker_id", "marker_corners"):
                assert torch.equal(out[key][lane], ref[key][f]), key


# --- Detector.detect_batch through its CUDA graph (runtime.graph) ---------

# (config, frame (w, h), transpose): every route of ``detect_batch_arrays``.
ROUTES = {
    "fused": (DetectorConfig(), (320, 240), False),
    "labels": (DetectorConfig(), (320, 240), True),  # portrait 240x320: kernel 7
    "labels_k5_k6": (DetectorConfig(max_candidates=160), (320, 240), False),
    "tail_noref": (DetectorConfig(refine_corners=False), (320, 240), False),
    "tail_gather": (DetectorConfig(refine_corners=False, warp_impl="gather"), (320, 240), False),
    "tail_ds1": (DetectorConfig(), (160, 120), False),
}


def _frames(w, h, transpose, kinds=KINDS):
    imgs = [make_scene(k, w, h, w / 320)[0] for k in kinds]
    if transpose:
        imgs = [np.ascontiguousarray(i.T) for i in imgs]
    return torch.from_numpy(np.stack(imgs))


def _assert_same(got, ref):
    """Every tensor equal: integers and booleans bit for bit, floats too
    (NaN where NaN)."""
    assert sorted(got) == sorted(ref)
    for key in ref:
        if isinstance(ref[key], dict):
            _assert_same(got[key], ref[key])
        else:
            torch.testing.assert_close(got[key], ref[key], rtol=0, atol=0, equal_nan=True,
                                       msg=key)


def _eager(det, frames):
    from aruco3_tpu_torch.detector import detect_batch_arrays

    return detect_batch_arrays(frames, det.dictionary, det.config, *det.geometry(*frames.shape[1:3]))


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_detect_batch_graph_equals_eager(route):
    """The graphed ``detect_batch`` on each route equals eager
    ``detect_batch_arrays`` bit for bit, and a replay adds the launches
    the capture recorded (no plain version)."""
    from aruco3_tpu_torch import ops

    dev = cuda_device()
    cfg, (w, h), transpose = ROUTES[route]
    det = Detector(cfg, ARDictionary.new_from_named_dict("ARUCO_DEFAULT"), device=dev)
    frames = _frames(w, h, transpose).to(dev)
    det.detect_batch(frames)  # captures
    for c in ops.counters():
        c.reset()
    ref = _eager(det, frames)
    torch.cuda.synchronize()
    eager_counts = [c.launches for c in ops.counters()]
    for c in ops.counters():
        c.reset()
    got = det.detect_batch(frames)
    torch.cuda.synchronize()
    assert [c.launches for c in ops.counters()] == eager_counts
    assert sum(eager_counts) > 0 and all(c.plain_calls == 0 for c in ops.counters())
    _assert_same(got, ref)
    assert list(det.graphs.graphs) == [tuple(frames.shape)]


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_graph_stage_map_and_spans(route):
    """A capture splits the graph's kernel nodes by the detector's four
    stage spans, in order, and logs itself; under a profiler of the device
    alone a replay records its copy-in, replay and clone spans inside
    ``aruco3.detect`` and launches the graph's kernel nodes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aruco3_tpu_torch.utils import profiling

    dev = cuda_device()
    cfg, (w, h), transpose = ROUTES[route]
    det = Detector(cfg, ARDictionary.new_from_named_dict("ARUCO_DEFAULT"), device=dev)
    frames = _frames(w, h, transpose).to(dev)
    det.detect_batch(frames)  # captures
    g = det.graphs.graphs[tuple(frames.shape)]
    stages = ["aruco3.frontend", "aruco3.segment", "aruco3.rectify", "aruco3.match"]
    assert [s for s, _ in g.stage_kernels if s != "other"] == stages
    assert all(n > 0 for _, n in g.stage_kernels)
    assert sum(n for _, n in g.stage_kernels) == g.kernel_nodes
    log = profiling.captures()[-1]
    assert log["shape"] == [[list(frames.shape), "uint8"]]
    assert log["kernel_nodes"] == g.kernel_nodes and log["stage_kernels"] == g.stage_kernels
    assert log["warmup_ms"] > 0 and log["capture_ms"] > 0
    torch.cuda.synchronize()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        det.detect_batch(frames)
        torch.cuda.synchronize()
    recs = {r[0]: r for r in profiling.spans()}
    assert set(recs) == {"aruco3.detect", "aruco3.graph.copy_in", "aruco3.graph.replay",
                         "aruco3.graph.clone"}
    top = recs["aruco3.detect"]
    for name in ("aruco3.graph.copy_in", "aruco3.graph.replay", "aruco3.graph.clone"):
        assert recs[name][2] == top[1] and top[3] <= recs[name][3] <= recs[name][4] <= top[4]
    # CUDA runs a graph's copy nodes as kernels of its own
    # (``memcpy32_post``): they are no kernel nodes.
    kernels = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA
               and not ev.name.startswith(("Memcpy", "Memset", "memcpy", "memset"))]
    assert len(kernels) == g.kernel_nodes
    profiling.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,cfg,b,want", [
    (2160, 3840, DetectorConfig(coarse_factor=10, max_candidates=160), 2, ["cluster", 8]),
    (1080, 1920, DetectorConfig(coarse_factor=1, refine_corners=False), 1, ["scratch", 1]),
])
def test_graph_record_names_kernel_2_layout(h, w, cfg, b, want):
    """The capture record's ``coarse_layout`` is the layout kernel 2's
    wrapper launched: a 216x384 grid (the dense 4K cell's) on clusters of 8
    blocks, a 1080x1920 grid (ds 1) in device scratch."""
    from aruco3_tpu_torch.utils import profiling

    dev = cuda_device()
    det = Detector(cfg, ARDictionary.new_from_named_dict("ARUCO_DEFAULT"), device=dev)
    frames = torch.from_numpy(np.stack([make_scene(k, w, h, w / 320)[0] for k in KINDS[:b]])).to(dev)
    k2.labels_count.reset()
    det.detect_batch(frames)  # captures
    log = profiling.captures()[-1]
    assert log["route"] in ("labels", "tail") and log["coarse_layout"] == want
    assert log["coarse_layout"] == k2.labels_count.fields["coarse_layout"]
    assert k2.labels_count.launches == 2  # the warm-up's and the first replay's


@pytest.mark.gpu
@pytest.mark.parametrize("b,walks", [(1, False), (64, True)])
def test_graph_record_names_frontend_layout(b, walks):
    """The capture record's ``frontend_layout`` is the layout kernel 1's
    wrapper launched, [rows a block walks, chunk rows, blocks]: at 64 VGA
    frames (the VGA batch cell's shape) the blocks walk their strips in
    several chunks, a frame alone takes one chunk a block."""
    import math

    from aruco3_tpu_torch.utils import profiling

    dev = cuda_device()
    det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict("ARUCO_DEFAULT"), device=dev)
    frames = torch.from_numpy(np.stack(
        [make_scene(KINDS[i % len(KINDS)], 640, 480, 2.0)[0] for i in range(b)])).to(dev)
    k1.count.reset()
    det.detect_batch(frames)  # captures
    log = profiling.captures()[-1]
    run, chunk, blocks = log["frontend_layout"]
    assert log["frontend_layout"] == k1.count.fields["frontend_layout"]
    assert (run > chunk) == walks and run % chunk == 0
    params, _, _, ds = det.geometry(480, 640)
    tw = k1.plan(b, 480, 640, det.config.threshold_window, params.open_radius, ds)[2]
    assert blocks == math.prod(k1.grid(b, 480, 640, ds, run, tw))
    assert k1.count.launches == 2  # the warm-up's and the first replay's


ROUTE_OF = {"fused": "fused", "labels": "labels", "labels_k5_k6": "labels",
            "tail_noref": "tail", "tail_gather": "tail", "tail_ds1": "tail"}
SEGMENT_PARTS = ["aruco3.segment.fit", "aruco3.segment.refine", "aruco3.segment.finalize"]


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_graph_substages_route_and_lanes(route):
    """A capture's log record splits each stage's kernel nodes by the spans
    one level below it (the segment stage by its fit, refinement and
    finalize, the other stages not at all), each split adding up to its
    stage's nodes, and names the route, the [outer, inner] lanes and
    kernel 2's layout."""
    from aruco3_tpu_torch.utils import profiling

    dev = cuda_device()
    cfg, (w, h), transpose = ROUTES[route]
    det = Detector(cfg, ARDictionary.new_from_named_dict("ARUCO_DEFAULT"), device=dev)
    frames = _frames(w, h, transpose).to(dev)
    det.detect_batch(frames)  # captures
    g = det.graphs.graphs[tuple(frames.shape)]
    log = profiling.captures()[-1]
    assert log["route"] == det.route(*frames.shape[1:3]) == ROUTE_OF[route]
    assert log["lanes"] == [cfg.max_candidates, cfg.max_inner_candidates]
    assert log["coarse_layout"] == ["smem", 1]  # kernel 2, one block a frame on chip
    subs = log["substage_kernels"]
    assert subs == g.substage_kernels and len(subs) == len(g.stage_kernels)
    for (stage, n), parts in zip(g.stage_kernels, subs):
        assert sum(k for _, k in parts) == n, stage
        names = [s for s, _ in parts if s != "other"]
        assert names == (SEGMENT_PARTS if stage == "aruco3.segment" else []), stage
    fit = dict(subs[[s for s, _ in g.stage_kernels].index("aruco3.segment")])
    assert fit["aruco3.segment.fit"] > 0 and fit["aruco3.segment.finalize"] > 0
    assert (fit["aruco3.segment.refine"] > 0) == (ROUTE_OF[route] != "tail")


@pytest.mark.gpu
def test_nested_spans_leave_the_stage_map_of_the_fused_1080p_graph(monkeypatch):
    """The segment stage's nested spans add no kernel node and move no
    stage boundary: the fused 1080p graph's ``kernel_nodes`` and
    ``stage_kernels`` with them equal those of the same capture without
    them."""
    from aruco3_tpu_torch.utils import profiling

    dev = cuda_device()
    frames = torch.zeros((2, 1080, 1920), dtype=torch.uint8, device=dev)
    d = ARDictionary.new_from_named_dict("ARUCO_MIP_36H12")

    def capture():
        det = Detector(DetectorConfig(), d, device=dev)
        assert det.route(1080, 1920) == "fused"
        det.detect_batch(frames)
        return det.graphs.graphs[tuple(frames.shape)], profiling.captures()[-1]

    with_parts, log = capture()
    span = profiling.span
    monkeypatch.setattr(profiling, "span", lambda name: (
        contextlib.nullcontext() if name.startswith("aruco3.segment.") else span(name)))
    without = capture()[0]
    assert with_parts.kernel_nodes == without.kernel_nodes
    assert with_parts.stage_kernels == without.stage_kernels == log["stage_kernels"]
    seg = [s for s, _ in log["stage_kernels"]].index("aruco3.segment")
    assert [s for s, _ in without.substage_kernels[seg]] == ["other"]
    assert [s for s, _ in with_parts.substage_kernels[seg]] == SEGMENT_PARTS


@pytest.mark.gpu
def test_graph_outputs_are_fresh_and_shapes_alternate():
    """Call N's outputs stay as they were after call N+1 on other frames;
    two shapes alternated through one detector stay equal to eager."""
    dev = cuda_device()
    det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict("ARUCO_DEFAULT"),
                   device=dev)
    a = _frames(320, 240, False, ("single", "multi")).to(dev)
    b = _frames(320, 240, False, ("dark", "nested")).to(dev)
    c = _frames(160, 120, False).to(dev)
    out_a = det.detect_batch(a)
    ref_a = _eager(det, a)
    out_b = det.detect_batch(b)
    torch.cuda.synchronize()
    _assert_same(out_a, ref_a)
    _assert_same(out_b, _eager(det, b))
    for frames in (c, a, c, b):
        _assert_same(det.detect_batch(frames), _eager(det, frames))
    assert set(det.graphs.graphs) == {tuple(a.shape), tuple(c.shape)}


@pytest.mark.gpu
def test_graph_cache_keeps_the_most_recent(monkeypatch):
    """At most ``GRAPH_CACHE_SIZE`` graphs, the least recently used out."""
    from aruco3_tpu_torch import detector

    dev = cuda_device()
    monkeypatch.setattr(detector, "GRAPH_CACHE_SIZE", 2)
    det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict("ARUCO_DEFAULT"),
                   device=dev)
    frames = _frames(160, 120, False).to(dev)
    for b in (1, 2, 1, 3):
        _assert_same(det.detect_batch(frames[:b]), _eager(det, frames[:b]))
    assert [k[0] for k in det.graphs.graphs] == [1, 3]


@pytest.mark.gpu
def test_detect_single_frame_equals_eager():
    dev = cuda_device()
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    det = Detector(DetectorConfig(), d, device=dev)
    img, ids = make_scene("multi")
    got = det.detect(img)
    ref = to_host(_eager(det, torch.from_numpy(img)[None].to(dev)), 0)
    assert _summary(got) == _summary(ref)
    assert got.candidates == ref.candidates
    assert {m.id for m in got.markers} == ids
    assert list(det.graphs.graphs) == [(1, 240, 320)]


@pytest.mark.gpu
def test_detect_sharded_on_card_equals_detect_batch_and_pose():
    """``detect_sharded`` at NCCL world size 1 (a graph of detect + pose)
    against ``detect_batch`` + ``solve_normalized_batch``."""
    import torch.distributed as dist

    from aruco3_tpu_torch import pose
    from aruco3_tpu_torch.parallel import sharding

    dev = cuda_device()
    det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict("ARUCO_DEFAULT"),
                   device=dev)
    frames = _frames(320, 240, False)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        got = sharding.detect_sharded(det, frames, with_pose=True)
    finally:
        dist.destroy_process_group()
    out = det.detect_batch(frames)
    scale = torch.tensor([320.0, 240.0], device=dev)
    rot, tr, err = pose.solve_normalized_batch(out["marker_corners"] / scale, 40.0)
    ref = {k: out[k] for k in sharding.OUTPUT_KEYS}
    ref.update(pose_rotations=rot, pose_translations=tr, pose_errors=err)
    _assert_same(got, ref)


@pytest.mark.gpu
def test_detector_with_graphs_is_freed_without_the_collector():
    """A detector's graphs hold no reference back to it, so dropping it
    frees it (and destroys its graphs) at once, never in a collection that
    could fall inside another graph's capture."""
    import gc
    import weakref

    dev = cuda_device()
    det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict("ARUCO_DEFAULT"),
                   device=dev)
    det.detect_batch(_frames(160, 120, False).to(dev))
    gone = weakref.ref(det)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del det
        assert gone() is None
    finally:
        if collecting:
            gc.enable()


@pytest.mark.gpu
def test_graph_takes_several_inputs():
    """A ``Graph`` of a function of three tensors of three types: each call
    copies every argument in; a wrong count, shape or type is refused."""
    from aruco3_tpu_torch.runtime import graph

    dev = cuda_device()
    specs = (((4, 8), torch.float32), ((4, 8), torch.int32), ((3,), torch.bool))

    def fn(a, b, c):
        return {"sum": a + b.to(a.dtype), "any": c.any(), "rows": a.sum(dim=1)}

    g = graph.Graph(fn, specs, dev)
    for seed in (1, 2):
        gen = torch.Generator().manual_seed(seed)
        a = torch.randn(4, 8, generator=gen).to(dev)
        b = torch.randint(-5, 5, (4, 8), generator=gen, dtype=torch.int32).to(dev)
        c = torch.tensor([False, seed == 2, False], device=dev)
        _assert_same(g(a, b, c), fn(a, b, c))
    with pytest.raises(ValueError, match="graph captured for"):
        g(a, b)
    with pytest.raises(ValueError, match="graph captured for"):
        g(a, b.float(), c)
    assert len(g.inputs) == 3 and g.kernel_nodes > 0


@pytest.mark.gpu
def test_failed_capture_names_its_specs_and_caches_nothing():
    """A function that syncs the host (``.item()``) runs in the warm-up but
    fails its capture: a RuntimeError that names the input specs, chained
    to torch's own, and no graph under the key; the cache then captures
    another function as before."""
    from aruco3_tpu_torch.runtime import graph

    dev = cuda_device()
    cache = graph.GraphCache(2)
    specs = [((4, 8), torch.float32)]
    with pytest.raises(RuntimeError, match=r"inputs \[\(\(4, 8\), torch.float32\)\]") as e:
        cache.get("item", lambda: (lambda x: x * x.sum().item()), specs, dev)
    assert e.value.__cause__ is not None
    assert "item" not in cache.graphs
    x = torch.randn(4, 8).to(dev)
    got = cache.get("sum", lambda: (lambda x: x * x.sum()), specs, dev)(x)
    torch.testing.assert_close(got, x * x.sum(), rtol=0, atol=0)
    assert list(cache.graphs) == ["sum"]


def _nccl_world_of_one():
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    return dist


def _landscape():
    from aruco3_tpu_torch import render

    d = ARDictionary.new_from_named_dict("ARUCO_MIP_36H12")
    frame, truth = render.bench_scene(d, (1920, 1080), seed=0, noise_sigma=2.0)
    return d, frame, {mid for mid, _ in truth}


@pytest.mark.gpu
def test_spatial_graphs_equal_eager_step():
    """``detect_spatial`` at NCCL world size 1 on the 1080p frame replays
    its band and masks graphs: the outputs equal the eager step's bit for
    bit, a replay launches what the eager step launches (kernels 2 labels,
    7, 3, 8; no plain version), and the ids are ``Detector.detect``'s."""
    from aruco3_tpu_torch import ops
    from aruco3_tpu_torch.parallel import spatial

    dev = cuda_device()
    d, frame, truth = _landscape()
    det = Detector(DetectorConfig(), d, device=dev)
    grey = torch.from_numpy(frame).to(dev)
    dist = _nccl_world_of_one()
    try:
        spatial.detect_spatial(det, grey)  # captures
        for c in ops.counters():
            c.reset()
        got = spatial.detect_spatial(det, grey)
        torch.cuda.synchronize()
        replay_counts = [c.launches for c in ops.counters()]
        for c in ops.counters():
            c.reset()
        ref = spatial.build_spatial_detect(det, *frame.shape, graphs=False)(grey)
        torch.cuda.synchronize()
        assert [c.launches for c in ops.counters()] == replay_counts
    finally:
        dist.destroy_process_group()
    assert sum(replay_counts) > 0 and all(c.plain_calls == 0 for c in ops.counters())
    assert k1.count.launches == 0 and k2.labels_count.launches == 1
    _assert_same(got, ref)
    assert {k[0] for k in det.graphs.graphs} == {"spatial_band", "spatial_masks"}
    ids = {int(i) for i in got["marker_id"][got["marker_valid"]]}
    assert ids == {m.id for m in det.detect(frame).markers} and truth <= ids


@pytest.mark.gpu
def test_detector_with_spatial_graphs_is_freed_without_the_collector():
    """The spatial graphs hold no reference back to the detector: dropping
    it frees it and its graphs at once."""
    import gc
    import weakref

    from aruco3_tpu_torch.parallel import spatial

    dev = cuda_device()
    det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict("ARUCO_DEFAULT"),
                   device=dev)
    dist = _nccl_world_of_one()
    try:
        spatial.detect_spatial(det, _frames(320, 240, False)[1].to(dev))
    finally:
        dist.destroy_process_group()
    graphs = [weakref.ref(g) for g in det.graphs.graphs.values()]
    assert len(graphs) == 2
    gone = weakref.ref(det)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del det
        assert gone() is None and all(g() is None for g in graphs)
    finally:
        if collecting:
            gc.enable()
