"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole, since the port's name begins with the JAX package's), and
a reference that imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import runner  # noqa: E402

PROBE = """
import sys
sys.path.insert(0, {root!r})
import portbench.harness.runner as runner, portbench.harness.control
import portbench.reference.detect
for m in runner.benchmark_spec(runner.HERE.parent)["per_layer"]:
    runner.load_metric(m["name"])
runner.Program(runner.load_config("aruco_default_vga"), "cpu")
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_top_level_names_compared_whole():
    assert runner.forbidden_modules(["aruco3_tpu_torch", "aruco3_tpu_torch.ops", "numpy"]) == []
    assert runner.forbidden_modules(["aruco3_tpu.detector", "jax", "jaxlib.xla", "flax"]) == [
        "aruco3_tpu.detector", "flax", "jax", "jaxlib.xla"]


def test_nothing_the_benchmark_loads_is_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, check=True)
    loaded = set(out.stdout.strip().splitlines()[-1].split(","))
    assert "aruco3_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & set(runner.FORBIDDEN)


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert imported(path) <= {"__future__", "dataclasses", "functools", "math", "numbers",
                                  "numpy", "os", "torch"}, path.name


def test_no_benchmark_file_imports_jax_or_reads_the_jax_bench():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not imported(path) & set(runner.FORBIDDEN), path
        text = path.read_text()
        if path.parent.name != "tests":
            assert "bench.py" not in text.replace("bench.py's", "") and "benches/" not in text, path
