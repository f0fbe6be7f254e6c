"""The check that decides ``correct``, driven through a whole run on the
CPU at a small size: a sound run passes; the precision control and each
fault a cell can have (an answer altered where it is produced, half of a
batch left out) come out as not correct.  The look for a card is skipped
(``run_cell`` is called directly, with the CPU as the device)."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import control, runner  # noqa: E402

SPEC = runner.benchmark_spec(ROOT)
SMALL = dict(height=240, width=320, tile=[240, 320], origin=[0, 0], pitch=[240, 320],
             columns=1, markers=[1, 1])


def small_run(cell_name, program=None, traffic=None, seed=2**31 + 77, device="cpu",
              scene=SMALL):
    """A run of the cell on 2-frame batches of a 4-frame pool (3 frames of
    the live mixes), frames of ``scene`` (the configuration's own where
    None), windows of 0.5 s."""
    cell = runner.find_cell(SPEC, cell_name)
    config = runner.load_config(cell["config"])
    overrides = {
        "config": {"reference_frames": 3, "scene": dict(config["scene"], **(scene or {}))},
        "traffic": {"batch": 2, "pool": 4, "kept_batches": 10**6, "trace_steps": 2,
                    "warm_steps": 1, **(traffic or {})},
    }
    if runner.load_traffic(cell["traffic"])["mode"] == "live":
        overrides["traffic"] = {"pool": 3, "trace_steps": 2, "warm_steps": 1}
    return runner.run_cell(cell, SPEC, seed, 0.5, False, time.perf_counter(), device=device,
                           program=program, overrides=overrides)


def test_a_sound_run_is_correct():
    r = small_run("mip36h12_1080p.batch128")
    assert r["correct"] and r["run"]["compared_rows"] > 0
    assert r["checks"]["lanes_apart"]["value"] == 0
    assert list(r)[-1] == "checks"


def test_the_precision_control_is_not_correct():
    # At 1080p: bfloat16 holds the integers below 256 exactly, so on small
    # frames the control's corners would not move.
    r = small_run("mip36h12_1080p.batch128", program=control.Control, scene=None)
    assert not r["correct"]
    assert any(row["value"] > row["limit"] for row in r["checks"].values())


@pytest.mark.parametrize("cell", ["mip36h12_1080p.batch128", "aruco_default_vga.live1"])
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell):
    r = small_run(cell, program=lambda c, d: control.AlteredAnswer(c, d, runner.Program))
    assert not r["correct"] and r["checks"]["lanes_apart"]["value"] >= 1


def test_half_of_the_batch_left_out_is_not_correct():
    r = small_run("mip36h12_1080p.batch128",
                  program=lambda c, d: control.HalfBatch(c, d, runner.Program))
    assert not r["correct"] and r["checks"]["lanes_apart"]["value"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_each_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = runner.run_cell(runner.find_cell(SPEC, cell), SPEC, 2**31 + 991, 1.0, False,
                        time.perf_counter())
    assert r["correct"] and r["device"]["platform"] == "gpu"
