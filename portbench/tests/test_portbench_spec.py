"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import runner  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads", "layer", "moves"}


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"][1] == "portbench/run.py" and len(SPEC["command"]) <= 32
    assert 1 <= SPEC["run_seconds"] <= 51


def test_check_fits_the_day_with_24_cells():
    cells = 24
    total = 2 + 14 * cells * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(set(names)) == len(names)
    for e in SPEC[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert line_ok(e[key]), (e["name"], key)
    if section in ("end_to_end", "per_layer"):
        for e in SPEC[section]:
            assert set(e) <= METRIC_KEYS


def test_cells_name_known_configs_and_mixes():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for cell in SPEC["workloads"]:
        assert cell["config"] in configs and cell["chips"] in (1, 4)
        assert NAME.match(cell["traffic"])
        config = runner.load_config(cell["config"])
        traffic = runner.load_traffic(cell["traffic"])
        assert config["name"] == cell["config"]
        assert traffic["mode"] in ("batch", "live")
        assert set(config["check"]) == {"lanes_apart", "corner_gap_px", "pose_gap"}
    for c in SPEC["configs"]:
        assert Path(ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert runner.load_config(c["name"])["reduced"] == c["reduced"] == []
        assert any(cell["config"] == c["name"] for cell in SPEC["workloads"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    cells = [c["name"] for c in SPEC["workloads"]]
    for cell in cells:
        e2e = [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m.get("workloads", cells) for m in SPEC["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for cell in m["workloads"]:
        e2e = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
        assert cell in e2e.get("workloads", [cell])
    assert callable(runner.load_metric(metric))


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_benchmark_files_are_named_from_name_characters():
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
