"""The arithmetic the metrics rest on: rates and tails from timestamps,
device time from a trace, and rooflines from shapes."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import loops, runner, trace, yardstick  # noqa: E402
from portbench.reference import detect as ref  # noqa: E402


def steady(n, step_ms, t0=100.0, in_flight=1):
    """n closed-loop steps of step_ms each, one frame each."""
    out, t = [], t0
    for _ in range(n):
        out.append(loops.Record(t, t + 0.0002, t + step_ms / 1e3, 1))
        t += step_ms / 1e3
    return out


def test_rate_and_tail_of_a_steady_loop():
    recs = steady(1000, 2.0)
    assert loops.frames_per_s(recs, 100.0, 2.0) == pytest.approx(500.0)
    lat = loops.latencies_ms(recs, 100.0, 2.0)
    assert len(lat) == 1000
    assert np.percentile(lat, 50) == pytest.approx(2.0)
    assert np.percentile(lat, 95) == pytest.approx(2.0)
    assert loops.host_ms(recs, 100.0, 2.0) == pytest.approx(0.2)


def test_a_stall_inside_the_window_moves_the_tail_and_the_rate():
    recs = steady(1000, 2.0)
    stalled = []
    shift = 0.0
    for i, r in enumerate(recs):
        extra = 0.030 if 400 <= i < 460 else 0.0  # 60 frames 30 ms late
        stalled.append(loops.Record(r.handin + shift, r.returned + shift,
                                    r.done + shift + extra, 1))
        shift += extra
    lat = loops.latencies_ms(stalled, 100.0, 2.0)
    assert np.percentile(lat, 95) > 30.0
    assert np.percentile(lat, 50) == pytest.approx(2.0)
    assert loops.frames_per_s(stalled, 100.0, 2.0) < 0.6 * 500.0


def test_steps_outside_the_window_do_not_count():
    recs = steady(10, 100.0)  # 1 s of steps, window of 0.5 s
    assert loops.frames_per_s(recs, 100.0, 0.5) == pytest.approx(10.0)
    assert len(loops.latencies_ms(recs, 100.0, 0.5)) == 5


def make_trace():
    tr = trace.Trace(steps=2, frames=8)
    tr.window = (0.0, 100.0)
    tr.device_ops = [("void frontend_kernel(Args)", 10.0, 30.0),
                     ("void (anonymous namespace)::coarse_kernel<Fit>(Args)", 25.0, 40.0),
                     ("Memcpy DtoD (Device -> Device)", 50.0, 54.0),
                     ("void at::native::elementwise_kernel<128, 2>(int)", 60.0, 70.0),
                     ("late op", 95.0, 120.0)]
    tr.spans = [("portbench.step", 0.0, 45.0), ("portbench.wait", 45.0, 100.0)]
    return tr


def test_busy_time_counts_overlaps_once_and_clips_to_the_window():
    tr = make_trace()
    assert tr.busy_intervals() == [(10.0, 40.0), (50.0, 54.0), (60.0, 70.0), (95.0, 100.0)]
    assert tr.busy_s() == pytest.approx(49e-6)
    assert tr.window_s == pytest.approx(100e-6)
    gaps = tr.idle_gaps()
    assert gaps[0] == (0.0, 10.0) and gaps[-1] == (70.0, 95.0)
    bd = tr.breakdown()
    assert bd["idle_gaps"][0] == ["wait", pytest.approx(25e-6)]
    assert bd["device_ops"][0][0] == "void frontend_kernel(Args)"


def test_kernel_names_match_whole_words():
    k = runner.kernel_names()
    assert runner.kernel_of("void (anonymous namespace)::coarse_kernel<Fit>(Args)", k) == "coarse_fit"
    assert runner.kernel_of("void warp_decode_kernel<10>(unsigned char const*)", k) == "warp_decode"
    assert runner.kernel_of("void my_frontend_kernel2(int)", k) is None


def context(tr, config="mip36h12_1080p", traffic="batch128"):
    c = runner.load_config(config)
    t = runner.load_traffic(traffic)
    cfg = ref.DetectorConfig(**c["detector"])
    h, w = c["scene"]["height"], c["scene"]["width"]
    return runner.Context(c, t, tr, [], 0.0, 1.0, runner.kernel_names(),
                          ref.geometry(cfg, h, w), ref.route(cfg, h, w))


def test_readers_on_a_known_trace():
    ctx = context(make_trace())
    read = runner.load_metric
    assert read("device_idle_share.batch")(ctx) == pytest.approx(51.0)
    assert read("graph_copy_ms.batch")(ctx) == pytest.approx(4e-3 / 2)
    # glue: the elementwise kernel and the late op's 5 us in the window.
    assert read("glue_device_ms.batch")(ctx) == pytest.approx(15e-3 / 8)
    assert read("kernels_per_frame.live")(ctx) == pytest.approx(4 / 8)


def test_readers_find_nothing_in_an_empty_trace():
    ctx = context(None)
    for m in ("device_idle_share.batch", "frontend_roofline.batch", "coarse_fit_roofline.batch",
              "glue_device_ms.batch", "graph_copy_ms.batch", "kernels_per_frame.live"):
        assert runner.load_metric(m)(ctx) is None


def test_bounds_of_known_shapes():
    # Kernel 1 on 128 1080p frames at ds 10 (bfloat16 level 1): bytes bound.
    ms, by = yardstick.bound_ms(*yardstick.frontend_work(128, 1080, 1920, 10, True))
    assert by == "bytes" and ms == pytest.approx(0.19887, rel=1e-4)
    cfg = ref.DetectorConfig()
    params, _, _, ds = ref.geometry(cfg, 1080, 1920)
    ms2, by2 = yardstick.bound_ms(*yardstick.coarse_fit_work(128, 1080, 1920, ds, params))
    assert by2 == "operations" and 0.013 < ms2 < 0.0147


@pytest.mark.parametrize("kernel,measured_ms", [("frontend", 1.0232), ("coarse_fit", 0.3204)])
def test_roofline_share_of_measured_times_stays_at_most_one(kernel, measured_ms):
    # Device ms a 1080p batch of 128 measured alone on the card (PERF.md).
    tr = trace.Trace(steps=1, frames=128)
    tr.window = (0.0, 5000.0)
    name = {"frontend": "frontend_kernel", "coarse_fit": "coarse_kernel"}[kernel]
    tr.device_ops = [(f"void {name}(Args)", 0.0, measured_ms * 1e3)]
    share = runner.load_metric(f"{kernel}_roofline.batch")(context(tr))
    assert 0 < share <= 100.0


def test_coarse_fit_roofline_reads_nothing_off_the_fused_route():
    tr = trace.Trace(steps=1, frames=128)
    tr.window = (0.0, 1.0)
    tr.device_ops = [("void coarse_kernel(Args)", 0.0, 1.0)]
    ctx = context(tr)
    ctx.route = "labels"
    assert runner.load_metric("coarse_fit_roofline.batch")(ctx) is None
    assert np.isfinite(runner.load_metric("frontend_roofline.batch")(context(tr)) or 0.0)
