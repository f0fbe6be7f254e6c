"""The readers of the program's spans and capture log
(``harness/program_trace.py`` and the metrics that use it) on hand-made
traces and capture logs: the values they should give, and None where the
replays do not show the graph's stage map or the program keeps no spans."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from aruco3_tpu_torch.utils import profiling  # noqa: E402
from portbench.harness import program_trace, runner, trace  # noqa: E402
from portbench.reference import detect as ref  # noqa: E402

NEW = ("detect_host_ms.live", "detect_host_ms.batch", "pose_host_ms.live", "pose_host_ms.batch",
       "pose_kernels_per_frame.live", "segment_device_ms.batch", "rectify_device_ms.batch",
       "match_device_ms.batch", "pose_device_ms.batch", "graph_build_s")

# One replay's kernels in capture order, with the stage map that splits them.
GRAPH = [("void at::native::elementwise_kernel<luma>()", "aruco3.frontend"),
         ("void frontend_kernel(Args)", "aruco3.frontend"),
         ("void (anonymous namespace)::coarse_kernel<Fit>(Args)", "aruco3.segment"),
         ("void at::native::elementwise_kernel<merge>()", "aruco3.segment"),
         ("void refine_kernel(Args)", "aruco3.segment"),
         ("void at::native::elementwise_kernel<homography>()", "aruco3.rectify"),
         ("void warp_decode_kernel<10>(Args)", "aruco3.rectify"),
         ("void at::native::reduce_kernel<match>()", "aruco3.match")]
STAGES = [("aruco3.frontend", 2), ("aruco3.segment", 3), ("aruco3.rectify", 2),
          ("aruco3.match", 1)]
POSE = ["void at::native::elementwise_kernel<pose_a>()", "void at::native::reduce_kernel<pose_b>()"]
DTOD, HTOD, DTOH = ("Memcpy DtoD (Device -> Device)", "Memcpy HtoD (Pageable -> Device)",
                    "Memcpy DtoH (Device -> Pinned)")


def step_ops(t0, copy_in=DTOD, clones=(DTOD, DTOD), copy_node_after=None):
    """One step's device operations from ``t0`` (us): the copy in, the
    replay (kernel i takes i + 1 us; a copy node run as CUDA's own
    kernel after kernel ``copy_node_after``), the clones (1 us each), the
    pose (3 us each) and the readback, each 1 us after the last."""
    replay = [(n, i + 1.0) for i, (n, _) in enumerate(GRAPH)]
    if copy_node_after is not None:
        replay.insert(copy_node_after + 1, ("memcpy32_post", 1.0))
    ops, t = [], t0
    for name, dur in ([(copy_in, 2.0)] + replay + [(c, 1.0) for c in clones]
                      + [(n, 3.0) for n in POSE] + [(DTOH, 1.0)]):
        ops.append((name, t, t + dur))
        t += dur + 1.0
    return ops, t


def stretch(steps=2, frames_per_step=128, **kw):
    tr = trace.Trace(steps=steps, frames=steps * frames_per_step)
    t = 10.0
    for _ in range(steps):
        ops, t = step_ops(t, **kw)
        tr.device_ops += ops
    tr.window = (0.0, t + 10.0)
    return tr


def context(tr, config="mip36h12_1080p", traffic="batch128"):
    c = runner.load_config(config)
    t = runner.load_traffic(traffic)
    cfg = ref.DetectorConfig(**c["detector"])
    h, w = c["scene"]["height"], c["scene"]["width"]
    return runner.Context(c, t, tr, [], 0.0, 1.0, runner.kernel_names(),
                          ref.geometry(cfg, h, w), ref.route(cfg, h, w))


def graph_record(batch=128, h=1080, w=1920, stages=STAGES, **kw):
    return {"shape": [[[batch, h, w], "uint8"]], "warmup_ms": 1500.0, "capture_ms": 250.0,
            "kernel_nodes": sum(n for _, n in stages), "pool_bytes": 1 << 20,
            "stage_kernels": [list(s) for s in stages], **kw}


@pytest.fixture
def program(monkeypatch):
    """The program's span records and capture log, set by the test."""
    state = {"spans": [], "captures": [graph_record()]}
    monkeypatch.setattr(profiling, "spans", lambda: list(state["spans"]))
    monkeypatch.setattr(profiling, "captures", lambda: list(state["captures"]))
    return state


def read(name, ctx):
    return runner.load_metric(name)(ctx)


def test_replays_are_found_and_split_by_the_stage_map(program):
    tr = stretch()
    ctx = context(tr)
    ops = sorted(tr.clipped(), key=lambda op: op[1])
    runs = program_trace.replays(ops, 8, STAGES, ctx.kernels, 2)
    assert [[op[0] for op in run] for run, _, _ in runs] == [[n for n, _ in GRAPH]] * 2
    assert [(first, after) for _, first, after in runs] == [(1, 9), (15, 23)]
    # Kernel i of a replay takes i + 1 us; each stage's sum a batch, in ms.
    assert read("segment_device_ms.batch", ctx) == pytest.approx((3 + 4 + 5) / 1e3)
    assert read("rectify_device_ms.batch", ctx) == pytest.approx((6 + 7) / 1e3)
    assert read("match_device_ms.batch", ctx) == pytest.approx(8 / 1e3)
    assert read("pose_device_ms.batch", ctx) == pytest.approx(6 / 1e3)
    # Kernel 1 plus the four metrics give every non-copy device ms a batch.
    whole = sum(e - s for n, s, e in tr.clipped() if not trace.is_copy(n)) / 1e3 / 2
    parts = 2 / 1e3 + sum(read(f"{m}_device_ms.batch", ctx)
                          for m in ("segment", "rectify", "match", "pose"))
    assert parts == pytest.approx(whole - 1 / 1e3)  # all but the luma kernel


def test_a_clone_kernel_after_the_replay_counts_with_the_pose(program):
    """An output that is not contiguous is cloned by a kernel, right after
    the replay's last kernel."""
    clone = "void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>()"
    tr = stretch(clones=(clone, DTOD))
    ctx = context(tr)
    assert read("segment_device_ms.batch", ctx) == pytest.approx((3 + 4 + 5) / 1e3)
    assert read("match_device_ms.batch", ctx) == pytest.approx(8 / 1e3)
    assert read("pose_device_ms.batch", ctx) == pytest.approx(7 / 1e3)


def test_graph_copy_nodes_run_as_kernels_count_as_copies(program):
    program["captures"] = [graph_record(batch=1, h=480, w=640)]
    tr = stretch(steps=2, frames_per_step=1, copy_in=HTOD, copy_node_after=3)
    ctx = context(tr, "aruco_default_vga", "live1")
    assert read("pose_kernels_per_frame.live", ctx) == pytest.approx(2.0)
    assert read("kernels_per_frame.live", ctx) == pytest.approx(8 + 1 + 2)
    program["captures"] = [graph_record()]
    ctx = context(stretch(copy_node_after=3))
    assert read("segment_device_ms.batch", ctx) == pytest.approx((3 + 4 + 5) / 1e3)
    assert read("rectify_device_ms.batch", ctx) == pytest.approx((6 + 7) / 1e3)


def test_a_short_replay_reads_nothing(program):
    tr = stretch()
    second = [i for i, op in enumerate(tr.device_ops) if op[0].startswith("void refine")][1]
    del tr.device_ops[second]
    ctx = context(tr)
    for m in ("segment", "rectify", "match", "pose"):
        assert read(f"{m}_device_ms.batch", ctx) is None


def test_kernel_1_outside_the_frontend_reads_nothing(program):
    program["captures"] = [graph_record(stages=[("aruco3.frontend", 1), ("aruco3.segment", 4),
                                                ("aruco3.rectify", 2), ("aruco3.match", 1)])]
    ctx = context(stretch())
    for m in ("segment", "rectify", "match", "pose"):
        assert read(f"{m}_device_ms.batch", ctx) is None
    program["captures"] = [graph_record(stages=[("aruco3.frontend", 2), ("aruco3.segment", 5),
                                                ("aruco3.rectify", 0), ("aruco3.match", 1)])]
    assert read("rectify_device_ms.batch", context(stretch())) is None  # kernel 4 in segment


def test_a_copy_in_cut_off_by_the_stretch_still_finds_the_replays(program):
    """The device's clock may put the first copy before the stretch."""
    tr = stretch()
    tr.window = (tr.device_ops[0][2] + 0.5, tr.window[1])
    assert read("segment_device_ms.batch", context(tr)) == pytest.approx((3 + 4 + 5) / 1e3)


def test_a_stretch_with_another_count_of_steps_reads_nothing(program):
    tr = stretch()
    tr.steps = 3
    assert read("segment_device_ms.batch", context(tr)) is None


def test_host_spans_a_frame_and_a_batch_clipped_to_the_stretch(program):
    ms = 1_000_000  # ns
    program["spans"] = [("aruco3.detect", 1, None, 1 * ms, 3 * ms),
                        ("aruco3.pose.canonical", 3, 2, 4 * ms, 5 * ms),
                        ("aruco3.pose", 2, None, 3 * ms, 7 * ms),
                        ("aruco3.detect", 4, None, 9 * ms, 12 * ms)]  # 1 ms of it in the window
    tr = trace.Trace(steps=2, frames=2)
    tr.window = (0.0, 10_000.0)  # us
    ctx = context(tr, "aruco_default_vga", "live1")
    assert read("detect_host_ms.live", ctx) == pytest.approx(3.0 / 2)
    assert read("pose_host_ms.live", ctx) == pytest.approx(4.0 / 2)
    tr.frames = 256
    ctx = context(tr)
    assert read("detect_host_ms.batch", ctx) == pytest.approx(3.0 / 2)
    assert read("pose_host_ms.batch", ctx) == pytest.approx(4.0 / 2)
    assert program_trace.innermost(program["spans"], 4500.0) == "aruco3.pose.canonical"
    assert program_trace.innermost(program["spans"], 8000.0) is None


def test_pose_kernels_a_frame_and_the_graph_build(program):
    program["captures"] = [graph_record(batch=1, h=480, w=640), graph_record(batch=2)]
    tr = stretch(steps=3, frames_per_step=1, copy_in=HTOD)
    ctx = context(tr, "aruco_default_vga", "live1")
    assert read("pose_kernels_per_frame.live", ctx) == pytest.approx(2.0)
    kernels = read("kernels_per_frame.live", ctx)
    assert read("pose_kernels_per_frame.live", ctx) + 8 == pytest.approx(kernels)
    assert read("graph_build_s", ctx) == pytest.approx(2 * 1.75)
    program["captures"] = [graph_record(batch=2, h=480, w=640)]  # not the cell's shape
    assert read("pose_kernels_per_frame.live", ctx) is None


def test_copy_in_offsets_against_the_copy_in_spans():
    tr = stretch(steps=2, frames_per_step=1, copy_in=HTOD)
    starts = [s for n, s, _ in tr.device_ops if n == HTOD]  # each 2 us long
    recs = [("aruco3.graph.copy_in", 1, None, int((starts[0] - 1) * 1e3), int((starts[0] + 3) * 1e3)),
            ("aruco3.graph.copy_in", 2, None, int(starts[1] * 1e3), int((starts[1] + 1.5) * 1e3))]
    assert program_trace.copy_in_offsets(tr, recs) == [
        (0.0, pytest.approx(1.0), pytest.approx(1.0)),
        (pytest.approx(0.5), 0.0, pytest.approx(-0.5))]


def test_readers_find_nothing_where_the_program_keeps_no_spans(monkeypatch):
    """A program without ``spans`` and ``captures`` (one that predates
    them) and an untraced run give None, and raise nothing."""
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "captures")
    for m in NEW:
        assert read(m, context(stretch())) is None
        assert read(m, context(None)) is None
