"""One run of one cell: set-up, the measured window, the traced stretch,
the reference check, and the result line.

Everything a cell needs is found by name under the benchmark's folder:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``
and the cell's entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import check, loops, scenes, trace

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder
FORBIDDEN = ("jax", "jaxlib", "flax", "aruco3_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def load_traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def load_metric(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_names() -> dict:
    """The port's eight kernels: wrapper name -> CUDA kernel name."""
    return load_json(HERE / "kernels.json")


def kernel_of(name: str, kernels: dict) -> str | None:
    """The wrapper of the port's kernel a device operation ``name`` is
    (its CUDA name appears in ``name`` as a whole word: profiler names carry
    return types, namespaces, template arguments and parameters), else
    None."""
    for wrapper, cuda_name in kernels.items():
        if re.search(r"(?<![A-Za-z0-9_])" + cuda_name + r"(?![A-Za-z0-9_])", name):
            return wrapper
    return None


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


@dataclass
class Context:
    """What a per-layer metric's reader gets."""

    config: dict
    traffic: dict
    trace: trace.Trace | None
    records: list
    t0: float
    seconds: float
    kernels: dict
    geometry: tuple  # (params, min_edge, min_sep, ds) of the reference's rules
    route: str

    @property
    def batch(self) -> int:
        return self.traffic["batch"]

    def is_port_kernel(self, name: str) -> bool:
        return kernel_of(name, self.kernels) is not None

    def kernel_seconds(self, wrapper: str) -> tuple[float, int]:
        """(device seconds, launches) of one of the port's kernels in the
        traced stretch."""
        def mine(n):
            return kernel_of(n, self.kernels) == wrapper

        return sum(self.trace.seconds_by_name(mine).values()), self.trace.count(mine)


class Program:
    """The system under test, driven through its public calls:
    ``Detector.detect_batch``, then ``pose.solve_normalized_batch`` of the
    marker corners over the frame's size."""

    def __init__(self, config: dict, device):
        from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig, pose

        self.detector = Detector(DetectorConfig(**config["detector"]),
                                 ARDictionary.new_from_named_dict(config["dictionary"]),
                                 device=device)
        self.pose = pose
        scene = config["scene"]
        self.scale = torch.tensor([float(scene["width"]), float(scene["height"])], device=device)
        self.marker_mm = float(config["marker_mm"])
        self.span = None

    def __call__(self, frames) -> dict:
        span = self.span or (lambda name: _null())
        with span("detect_batch"):
            out = self.detector.detect_batch(frames)
        with span("pose"):
            rot, tr, err = self.pose.solve_normalized_batch(
                out["marker_corners"] / self.scale, self.marker_mm)
        return {"marker_valid": out["marker_valid"], "marker_id": out["marker_id"],
                "marker_dist": out["marker_dist"], "marker_code": out["marker_code"],
                "marker_corners": out["marker_corners"], "rotations": rot,
                "translations": tr, "errors": err}


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@dataclass
class Frames:
    """The cell's pool: device frames (batch mixes) or host frames (live
    mixes), and the order the loop takes them in."""

    device_pool: torch.Tensor
    host_pool: list | None
    offsets: np.ndarray | None
    order: np.ndarray | None
    batch: int

    def source(self, i: int):
        if self.host_pool is None:
            o = int(self.offsets[i % len(self.offsets)])
            return np.arange(o, o + self.batch), self.device_pool[o:o + self.batch]
        k = int(self.order[i % len(self.order)])
        return [k], self.host_pool[k]


def make_frames(config: dict, traffic: dict, dictionary, seed: int, device) -> Frames:
    pool, _ = scenes.render_frames(config["scene"], dictionary, traffic["pool"], seed, device)
    rng = np.random.default_rng([seed, 1])
    b = traffic["batch"]
    if traffic["mode"] == "live":
        # Pageable host frames, one (1, H, W) tensor each, as a camera SDK
        # hands them over.
        host = pool.cpu()
        frames = [torch.from_numpy(host[k:k + 1].numpy().copy()) for k in range(pool.shape[0])]
        order = np.concatenate([rng.permutation(pool.shape[0]) for _ in range(64)])
        return Frames(pool, frames, None, order, b)
    offsets = rng.integers(0, traffic["pool"] - b + 1, size=4096)
    return Frames(pool, None, offsets, None, b)


def card_ready(chips: int) -> str | None:
    """None where the run may go on; else why it may not."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA devices; the cell asks for {chips}"
    return None


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(cell: dict, spec: dict, seed: int, seconds: float, traced: bool, t_start: float,
             device="cuda", program=None, overrides=None) -> dict:
    """Run one cell and return the result line's object (``correct`` and
    its numbers always; metrics as ``traced`` selects).  ``program`` makes
    the system under test from (config, device) (``Program`` by default);
    ``overrides`` replaces keys of the configuration and the traffic (tests
    run small sizes on the CPU with it)."""
    from ..reference import detect as ref
    from ..reference.dictionaries import ARDictionary as RefDictionary

    overrides = overrides or {}
    config = {**load_config(cell["config"]), **overrides.get("config", {})}
    traffic = {**load_traffic(cell["traffic"]), **overrides.get("traffic", {})}
    device = torch.device(device)
    on_card = device.type == "cuda"
    scene = config["scene"]
    h, w = scene["height"], scene["width"]
    ref_dict = RefDictionary.new_from_named_dict(config["dictionary"])
    ref_cfg = ref.DetectorConfig(**config["detector"])

    # Set-up: frames, the program, a warm-up of the cell's one shape.
    phases = {"start": time.perf_counter() - t_start}
    frames = make_frames(config, traffic, ref_dict, seed, device)
    pool_sum = int(frames.device_pool.sum(dtype=torch.int64))
    phases["frames"] = time.perf_counter() - t_start
    step = (program or Program)(config, device)
    phases["program"] = time.perf_counter() - t_start
    in_flight = traffic["in_flight"]
    warm = traffic.get("warm_steps", 4 * in_flight)
    loops.closed_loop(step, frames.source, in_flight, steps=warm)  # captures the graph
    phases["first_steps"] = time.perf_counter() - t_start
    rec, _, t = loops.closed_loop(step, frames.source, in_flight, steps=warm)
    step_s = max((rec[-1].done - t) / warm, 1e-4)
    if "kept_batches" in traffic:
        every = max(1, round(seconds / step_s / traffic["kept_batches"]))
        phase = int(np.random.default_rng([seed, 2]).integers(every))
        keep = lambda i: i % every == phase  # noqa: E731
    else:
        keep = lambda i: True  # noqa: E731
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    # The measured window.
    records, kept, t0 = loops.closed_loop(step, frames.source, in_flight, seconds=seconds,
                                          keep=keep)
    attempted = sum(r.frames for r in records if r.handin < t0 + seconds)

    tr = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        spans = trace.Spans()
        step.span = spans
        n = traffic["trace_steps"]
        act = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
        with profile(activities=[act]) as prof:
            w0 = time.time_ns() / 1e3
            trec, _, _ = loops.closed_loop(step, frames.source, in_flight, steps=n, span=spans)
            if on_card:
                torch.cuda.synchronize()
            w1 = time.time_ns() / 1e3
        step.span = None
        tr = trace.from_profile(prof, spans, (w0, w1), steps=len(trec),
                                frames=sum(r.frames for r in trec))

    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del step
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # The check: the reference on a sample of the frames the window's kept
    # steps covered, drawn from the seed.
    seen = np.unique(np.concatenate([idx for idx, _ in kept])) if kept else np.array([], int)
    rng = np.random.default_rng([seed, 3])
    n_ref = min(config["reference_frames"], len(seen))
    sample = np.sort(rng.choice(seen, size=n_ref, replace=False)) if n_ref else seen
    pool_intact = int(frames.device_pool.sum(dtype=torch.int64)) == pool_sum
    t_ref = time.perf_counter()
    want = check.reference_results(
        frames.device_pool[torch.as_tensor(sample, device=device, dtype=torch.long)],
        ref_dict, ref_cfg, w, h, config["marker_mm"])
    ref_s = time.perf_counter() - t_ref
    row_of = {int(f): r for r, f in enumerate(sample)}
    readings, compared = [], 0
    for idx, got in kept:
        rows = [j for j, f in enumerate(idx) if int(f) in row_of]
        if rows:
            sel = [row_of[int(idx[j])] for j in rows]
            readings.append(check.compare({k: v[rows] for k, v in got.items()},
                                          {k: v[sel] for k, v in want.items()}))
            compared += len(rows)
    numbers = check.worst(readings)
    limits = config["check"]
    correct, table = check.judge(numbers, limits)
    correct = correct and compared > 0 and pool_intact

    # Every frame handed in is waited for, and a step that raises ends the
    # run: none fails without ending it.
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": 0}
    metrics = {}
    if not traced:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        if traffic["mode"] == "live":
            lat = loops.latencies_ms(records, t0, seconds)
            metrics["latency_p50_ms"] = {"value": float(np.percentile(lat, 50)), "unit": "ms"}
            metrics["latency_p95_ms"] = {"value": float(np.percentile(lat, 95)), "unit": "ms"}
        else:
            metrics["frames_per_s"] = {"value": loops.frames_per_s(records, t0, seconds),
                                       "unit": "frames/s"}
    else:
        params, min_edge, min_sep, ds = ref.geometry(ref_cfg, h, w)
        ctx = Context(config, traffic, tr, records, t0, seconds, kernel_names(),
                      (params, min_edge, min_sep, ds), ref.route(ref_cfg, h, w))
        for m in spec["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            value = load_metric(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(memory_peak),
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["run"] = {"seed": seed, "frames_in_window": int(sum(
        r.frames for r in loops.in_window(records, t0, seconds))), "steps": len(records),
        "kept_steps": len(kept), "reference_frames": int(n_ref), "compared_rows": compared,
        "reference_s": ref_s, "pool_intact": pool_intact,
        "card": power_limit() if on_card else "cpu", "setup_phases_s": phases}
    result["checks"] = table
    return result
