"""The port's span recorder (``utils.profiling``) on the CPU: spans only
under a profiler, their nesting through ``detect_batch`` and the pose
solve, the profiler's clock, the cap, the stage map a capture builds from
its spans, and ``drain``."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig, pose
from aruco3_tpu_torch.utils import profiling
from torch_twin import make_scene

STAGES = ["aruco3.frontend", "aruco3.segment", "aruco3.rectify", "aruco3.match"]
POSE_PARTS = ["aruco3.pose.homography", "aruco3.pose.canonical", "aruco3.pose.order"]
SEGMENT_PARTS = ["aruco3.segment.fit", "aruco3.segment.refine", "aruco3.segment.finalize"]
# (config, frame (w, h), transpose, the route ``Detector.route`` names).
ROUTES = {
    "fused": (DetectorConfig(), (320, 240), False, "fused"),
    "labels": (DetectorConfig(), (320, 240), True, "labels"),  # portrait: kernel 7
    "labels_k5_k6": (DetectorConfig(max_candidates=160), (320, 240), False, "labels"),
    "tail": (DetectorConfig(refine_corners=False), (320, 240), False, "tail"),
}


@pytest.fixture(autouse=True)
def _one_thread_no_records():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear()
    yield
    profiling.clear()
    torch.set_num_threads(threads)


def _detect_and_pose():
    det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict("ARUCO_DEFAULT"),
                   device="cpu")
    img, ids = make_scene("single", 160, 120, 0.5)
    out = det.detect_batch(torch.from_numpy(img)[None])
    rot, _, _ = pose.solve_normalized_batch(out["marker_corners"] / torch.tensor([160.0, 120.0]),
                                            40.0)
    return out, rot, ids


def test_no_span_is_recorded_outside_a_profiler():
    assert profiling.span("aruco3.x") is profiling.span("aruco3.y")  # the shared no-op
    with profiling.span("aruco3.x"):
        pass
    out, _, ids = _detect_and_pose()
    assert {int(i) for i in out["marker_id"][out["marker_valid"]]} == ids
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_detect_and_pose_spans_nest_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        _detect_and_pose()
    recs = profiling.spans()
    by_name = {}
    for name, sid, parent, start, end in recs:
        assert name not in by_name and start <= end
        by_name[name] = (sid, parent, start, end)
    assert set(by_name) == {"aruco3.detect", "aruco3.pose", *STAGES, *SEGMENT_PARTS, *POSE_PARTS}
    for outer, inner in (("aruco3.detect", STAGES), ("aruco3.pose", POSE_PARTS),
                         ("aruco3.segment", SEGMENT_PARTS)):
        sid, parent, start, end = by_name[outer]
        assert parent == (by_name["aruco3.detect"][0] if outer == "aruco3.segment" else None)
        kids = [by_name[n] for n in inner]
        assert all(k[1] == sid and start <= k[2] <= k[3] <= end for k in kids)
        assert [k[2] for k in kids] == sorted(k[2] for k in kids)  # in the pipeline's order
    assert by_name["aruco3.detect"][3] <= by_name["aruco3.pose"][2]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_segment_parts_nest_inside_the_segment_span_on_every_route(route):
    """On each route ``aruco3.segment`` holds the fit, the refinement (empty
    where nothing is refined) and the finalize, in that order, and nothing
    else; ``Detector.route`` names the route the frames take."""
    cfg, (w, h), transpose, name = ROUTES[route]
    img, ids = make_scene("single", w, h)
    if transpose:  # the mirror image: another code of the dictionary
        img, ids = np.ascontiguousarray(img.T), {320}
    det = Detector(cfg, ARDictionary.new_from_named_dict("ARUCO_DEFAULT"), device="cpu")
    assert det.route(*img.shape) == name
    with profile(activities=[ProfilerActivity.CPU]):
        out = det.detect_batch(torch.from_numpy(img)[None])
    assert {int(i) for i in out["marker_id"][out["marker_valid"]]} == ids
    recs = profiling.spans()
    (seg,) = [r for r in recs if r[0] == "aruco3.segment"]
    kids = [r for r in recs if r[2] == seg[1]]
    assert [k[0] for k in sorted(kids, key=lambda r: r[3])] == SEGMENT_PARTS
    assert all(seg[3] <= k[3] <= k[4] <= seg[4] for k in kids)
    assert not any(r[2] == k[1] for k in kids for r in recs)


def test_spans_share_the_profilers_clock():
    """An ``aten::mm`` inside a span lies inside it once the profiler's
    times are put on the wall clock through ``trace_start_ns``, as the
    benchmark's trace reader puts them."""
    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("aruco3.test"):
            time.sleep(0.002)
            a @ a
            time.sleep(0.002)
    (name, _, _, start, end), = profiling.spans()
    origin_us = prof.profiler.kineto_results.trace_start_ns() / 1e3
    mm = [ev for ev in prof.events() if ev.name == "aten::mm"]
    assert len(mm) == 1
    s, e = origin_us + mm[0].time_range.start, origin_us + mm[0].time_range.end
    assert start / 1e3 < s <= e < end / 1e3


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.span(f"aruco3.s{i}"):
                pass
    assert [r[0] for r in profiling.spans()] == ["aruco3.s0", "aruco3.s1", "aruco3.s2"]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_stage_map_splits_a_capture_by_its_outermost_spans():
    """Inside ``stage_map`` every span marks the counter, profiler or not;
    ``stages`` keeps the outermost spans, names the rest "other", and the
    counts sum to the total."""
    nodes = iter(range(100))
    with profiling.span("aruco3.outside"):  # a no-op here: no profiler
        with profiling.stage_map(lambda: next(nodes) * 10) as marks:
            with profiling.span("aruco3.frontend"):
                with profiling.span("aruco3.inner"):
                    pass
            with profiling.span("aruco3.segment"):
                pass
    assert [m[:3] for m in marks] == [
        ("aruco3.frontend", 0, "enter"), ("aruco3.inner", 1, "enter"),
        ("aruco3.inner", 1, "exit"), ("aruco3.frontend", 0, "exit"),
        ("aruco3.segment", 0, "enter"), ("aruco3.segment", 0, "exit")]
    assert [m[3] for m in marks] == [0, 10, 20, 30, 40, 50]
    assert profiling.stages(marks, 65) == [
        ("aruco3.frontend", 30), ("other", 10), ("aruco3.segment", 10), ("other", 15)]
    assert profiling.spans() == []
    assert profiling.span("aruco3.after") is profiling.span("aruco3.again")
    with profile(activities=[ProfilerActivity.CPU]):  # spans of a traced capture nest
        with profiling.span("aruco3.capture"):
            with profiling.stage_map(lambda: 7) as marks:
                with profiling.span("aruco3.frontend"):
                    pass
    assert [m[:2] for m in marks] == [("aruco3.frontend", 0)] * 2
    assert profiling.stages(marks, 9) == [("other", 7), ("aruco3.frontend", 0), ("other", 2)]


def test_substages_split_each_stage_by_the_spans_one_level_below():
    """``substages`` gives, for each entry of ``stages``, its nodes split by
    the spans one level down ("other" for the rest); each list sums to its
    stage's count, and spans two levels down do not split it."""
    nodes = iter(range(100))
    with profiling.stage_map(lambda: next(nodes) * 10) as marks:
        with profiling.span("aruco3.frontend"):  # 0 .. 10
            pass
        with profiling.span("aruco3.segment"):  # 20 .. 90
            with profiling.span("aruco3.segment.fit"):  # 30 .. 60
                with profiling.span("aruco3.segment.fit.deep"):
                    pass
            with profiling.span("aruco3.segment.refine"):  # 70 .. 80
                pass
    stages = profiling.stages(marks, 100)
    assert stages == [("aruco3.frontend", 10), ("other", 10), ("aruco3.segment", 70),
                      ("other", 10)]
    subs = profiling.substages(marks, 100)
    assert subs == [[("other", 10)], [("other", 10)],
                    [("other", 10), ("aruco3.segment.fit", 30), ("other", 10),
                     ("aruco3.segment.refine", 10), ("other", 10)],
                    [("other", 10)]]
    assert [sum(n for _, n in p) for p in subs] == [n for _, n in stages]
    assert profiling.substages([], 5) == [[("other", 5)]] and profiling.stages([], 5) == [
        ("other", 5)]


def test_drain_waits_on_nothing_for_host_tensors():
    x = torch.arange(6.0)
    profiling.drain({"y": [x * 2, (x,)]})  # CPU tensors: nothing to wait for
    profiling.drain({"a": 1, "b": [None]})
    profiling.drain([])
