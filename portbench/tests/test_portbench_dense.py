"""The dense 4K AprilTag configuration on the CPU at a cut size, its
yardstick of kernels 2 (labels mode), 5 and 6, and the readers of the
capture log's ``substage_kernels`` and ``route``.

The cut scene keeps the configuration's detector (ds 10, 160 lanes): its
frames take the label route with kernels 5 and 6 (their plain versions
here), as the 4K frames do on the card."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from aruco3_tpu_torch.ops import fit as kfit  # noqa: E402
from aruco3_tpu_torch.utils import profiling  # noqa: E402
from portbench.harness import control, program_substages, runner, scenes, trace  # noqa: E402
from portbench.harness import yardstick_labels as yl  # noqa: E402
from portbench.reference import detect as ref  # noqa: E402
from portbench.reference.dictionaries import ARDictionary  # noqa: E402
from test_portbench_check import small_run  # noqa: E402
from test_portbench_program_trace import GRAPH, context, graph_record, stretch  # noqa: E402

CELL = "apriltag36h11_4k_dense.batch16"
CONFIG = runner.load_config("apriltag36h11_4k_dense")
# Six 160-px tiles (tags of 96-112 px), 2 x 3, on a 480 x 640 frame.
CUT = dict(height=480, width=640, tile=[160, 160], origin=[0, 0], pitch=[160, 160], columns=3,
           markers=[6, 6])
# The same tiles at x 640-1120 of a 1280-px-wide frame, where bfloat16's
# spacing is 4 px.
WIDE = dict(CUT, width=1280, origin=[0, 640])


def test_the_configuration_takes_the_label_route_above_128_lanes():
    cfg = ref.DetectorConfig(**CONFIG["detector"])
    scene = CONFIG["scene"]
    assert ref.route(cfg, scene["height"], scene["width"]) == "labels"
    assert ref.route(cfg, CUT["height"], CUT["width"]) == "labels"
    params, _, _, ds = ref.geometry(cfg, scene["height"], scene["width"])
    assert (ds, params.max_candidates, params.max_inner_candidates) == (10, 160, 12)
    assert scene["markers"] == [144, 144] and CONFIG["reduced"] == []
    rows = -(-scene["markers"][0] // scene["columns"])
    assert rows * scene["pitch"][0] == scene["height"]
    assert scene["columns"] * scene["pitch"][1] == scene["width"]


def test_the_cut_scene_equals_the_reference_through_kernels_5_and_6():
    frames, _ = scenes.render_frames(dict(CONFIG["scene"], **CUT),
                                     ARDictionary.new_from_named_dict("APRILTAG_36H11"), 2, 5, "cpu")
    cfg = ref.DetectorConfig(**CONFIG["detector"])
    out = ref.detect_batch(frames, ARDictionary.new_from_named_dict("APRILTAG_36H11"), cfg)
    assert int(out["marker_valid"].sum()) >= 10  # of 12 tags drawn
    for c in (kfit.rank_count, kfit.lanes_count, kfit.fused_count):
        c.reset()
    r = small_run(CELL, scene=CUT)
    assert r["correct"] and r["run"]["compared_rows"] > 0
    assert r["checks"]["lanes_apart"]["value"] == 0
    # Two planes a step, each through kernel 5's and kernel 6's plain versions.
    assert kfit.rank_count.plain_calls == kfit.lanes_count.plain_calls > 0
    assert kfit.rank_count.plain_calls % 2 == 0 and kfit.fused_count.plain_calls == 0


@pytest.mark.parametrize("fault", ["answer", "half"])
def test_the_planted_faults_are_not_correct(fault):
    make = control.AlteredAnswer if fault == "answer" else control.HalfBatch
    r = small_run(CELL, program=lambda c, d: make(c, d, runner.Program), scene=CUT)
    assert not r["correct"] and r["checks"]["lanes_apart"]["value"] >= 1


def test_the_precision_control_is_not_correct():
    r = small_run(CELL, program=control.Control, scene=WIDE)
    assert not r["correct"]
    assert r["checks"]["corner_gap_px"]["value"] > r["checks"]["corner_gap_px"]["limit"]


# --- the yardstick against chip_smoke.py's count ---------------------------


def test_yardstick_labels_counts_as_chip_smoke_does():
    """Bytes and operations of kernels 2 (labels mode), 5 and 6 as
    ``chip_smoke.work`` counts them on the plain versions' own inputs and
    outputs (kernel 6 less its 40 operations a member cell)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from aruco3_tpu_torch import segment
    from aruco3_tpu_torch.detector import quad_params, DetectorConfig
    from aruco3_tpu_torch.ops import coarse_fit as k2

    b, hc, wc = 3, 24, 40
    cfg = DetectorConfig(**CONFIG["detector"])
    params = quad_params(cfg, 10)
    coarse = torch.from_numpy(np.random.default_rng(3).random((b, hc, wc)) < 0.3)
    labels = k2.coarse_labels(coarse, params)
    assert chip_smoke.work("coarse_labels", (coarse, params), labels) == yl.labels_work(
        b, hc * 10, wc * 10, 10, params)
    for k in yl.planes(params):
        kr = segment.rank_pool_size(k, hc * wc)
        assert kr == yl.rank_pool_size(k, hc * wc)
        pool = kfit.rank_roots(labels[0], kr, params.min_component_px)
        assert chip_smoke.work("rank_roots", (labels[0], kr), pool) == yl.rank_roots_work(
            b, hc, wc, k)
        roots, sizes = segment.select_lanes(pool[0], pool[1], k)
        use = sizes >= 0
        sizes = torch.clamp(sizes, min=0)
        args = (labels[0], roots, sizes, use)
        got = kfit.fit_lanes(*args, 10, params.containment_slack)
        nbytes, ops = chip_smoke.work("fit_lanes", args, got)
        assert int(sizes[use].sum()) > 0
        assert (nbytes, ops - 40 * int(sizes[use].sum())) == yl.fit_lanes_work(b, hc, wc, k)


def test_the_dense_cells_bounds():
    """At the cell's shapes: 16 frames, a 216 x 384 grid, rank pools of
    1,024 on both planes; kernel 2's labelling rounds bound it by
    operations, kernels 5 and 6 by bytes."""
    cfg = ref.DetectorConfig(**CONFIG["detector"])
    params, _, _, ds = ref.geometry(cfg, 2160, 3840)
    assert [yl.rank_pool_size(k, 216 * 384) for k in yl.planes(params)] == [1024, 1024]
    ms, by = yl.bound_ms(*yl.labels_work(16, 2160, 3840, ds, params))
    ops = 12 * yl.label_rounds(params) * 16 * 82944
    assert by == "operations" and ms == pytest.approx(ops / 67e12 * 1e3)
    for work in (yl.rank_roots_work, yl.fit_lanes_work):
        assert yl.bound_ms(*work(16, 216, 384, 160))[1] == "bytes"
    both = yl.plane_bound_ms(yl.fit_lanes_work, 16, 2160, 3840, ds, params)
    assert both == pytest.approx(sum(yl.bound_ms(*yl.fit_lanes_work(16, 216, 384, k))[0]
                                     for k in (160, 12)))


# --- readers of substage_kernels and route ---------------------------------

# The segment stage of ``GRAPH`` (coarse_kernel, merge, refine_kernel) split
# as the program's nested spans split it.
SUBSTAGES = [[("other", 2)],
             [("aruco3.segment.fit", 2), ("aruco3.segment.refine", 1),
              ("aruco3.segment.finalize", 0)],
             [("other", 2)], [("other", 1)]]


@pytest.fixture
def program(monkeypatch):
    state = {"spans": [], "captures": [graph_record(substage_kernels=SUBSTAGES, route="fused",
                                                    lanes=[32, 12])]}
    monkeypatch.setattr(profiling, "spans", lambda: list(state["spans"]))
    monkeypatch.setattr(profiling, "captures", lambda: list(state["captures"]))
    return state


def read(name, ctx):
    return runner.load_metric(name)(ctx)


def test_fit_device_ms_reads_the_fit_substage(program):
    ctx = context(stretch())
    # Kernel i of a replay takes i + 1 us: the fit holds kernels 2 and 3.
    assert read("fit_device_ms.batch", ctx) == pytest.approx((3 + 4) / 1e3)
    ranges = program_substages.substage_ranges(program["captures"][0])
    assert [(sub, lo, hi) for st, sub, lo, hi in ranges if st == "aruco3.segment"] == [
        ("aruco3.segment.fit", 2, 4), ("aruco3.segment.refine", 4, 5),
        ("aruco3.segment.finalize", 5, 5)]
    assert GRAPH[2][1] == GRAPH[4][1] == "aruco3.segment"


def test_fit_device_ms_reads_nothing_without_a_sound_split(program):
    program["captures"] = [graph_record()]  # a program that predates the split
    assert read("fit_device_ms.batch", context(stretch())) is None
    bad = [list(s) for s in SUBSTAGES]
    bad[1] = [("aruco3.segment.fit", 2)]  # short of the stage's 3 nodes
    program["captures"] = [graph_record(substage_kernels=bad)]
    assert read("fit_device_ms.batch", context(stretch())) is None
    assert read("fit_device_ms.batch", context(None)) is None


def labels_trace(ms: dict, steps=1):
    """A stretch of ``steps`` replays' worth of kernels 2, 5 and 6 (kernels
    5 and 6 twice a replay), each taking the given device ms."""
    tr = trace.Trace(steps=steps, frames=16 * steps)
    t, names = 0.0, {"coarse_fit": ["coarse_kernel"], "rank_roots": ["rank_roots_kernel"] * 2,
                     "fit_lanes": ["fit_lanes_kernel"] * 2}
    for _ in range(steps):
        for kernel, cuda_names in names.items():
            for n in cuda_names:
                tr.device_ops.append((f"void {n}(Args)", t, t + ms[kernel] * 1e3))
                t += ms[kernel] * 1e3 + 1.0
    tr.window = (0.0, t)
    return tr


DENSE_METRICS = ("labels_roofline.dense", "rank_roots_roofline.dense", "fit_lanes_roofline.dense")


@pytest.mark.parametrize("route", ["labels", "fused", "tail", None])
def test_the_label_route_rooflines_read_only_on_route_labels(program, route):
    record = graph_record(batch=16, h=2160, w=3840, lanes=[160, 12])
    if route is not None:
        record["route"] = route
    program["captures"] = [record]
    # Device ms a launch of the same order as the dense path's alone on the
    # card (PERF.md's kernel table: kernel 2 labels mode, 5 and 6).
    ctx = context(labels_trace({"coarse_fit": 0.15, "rank_roots": 0.015, "fit_lanes": 0.02}),
                  "apriltag36h11_4k_dense", "batch16")
    for m in DENSE_METRICS:
        share = read(m, ctx)
        if route == "labels":
            assert 0 < share <= 100.0, m
        else:
            assert share is None, m


def test_a_roofline_share_is_the_least_time_over_the_device_time(program):
    program["captures"] = [graph_record(batch=16, h=2160, w=3840, route="labels")]
    ctx = context(labels_trace({"coarse_fit": 0.2, "rank_roots": 0.01, "fit_lanes": 0.04}, 2),
                  "apriltag36h11_4k_dense", "batch16")
    params, _, _, ds = ctx.geometry
    least = yl.bound_ms(*yl.labels_work(16, 2160, 3840, ds, params))[0]
    assert read("labels_roofline.dense", ctx) == pytest.approx(100 * least / 0.2)
    least5 = yl.plane_bound_ms(yl.rank_roots_work, 16, 2160, 3840, ds, params)
    assert read("rank_roots_roofline.dense", ctx) == pytest.approx(100 * least5 / (2 * 0.01))
    least6 = yl.plane_bound_ms(yl.fit_lanes_work, 16, 2160, 3840, ds, params)
    assert read("fit_lanes_roofline.dense", ctx) == pytest.approx(100 * least6 / (2 * 0.04))


def test_the_new_readers_find_nothing_where_the_program_keeps_no_log(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "captures")
    tr = labels_trace({"coarse_fit": 0.15, "rank_roots": 0.015, "fit_lanes": 0.02})
    for m in ("fit_device_ms.batch",) + DENSE_METRICS:
        assert read(m, context(tr, "apriltag36h11_4k_dense", "batch16")) is None
        assert read(m, context(None, "apriltag36h11_4k_dense", "batch16")) is None
