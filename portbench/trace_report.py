"""One traced run of a cell, with what its trace says beyond the metrics:
the checks of the program's spans against the harness's and the device's,
the graph's stage map, the idle gaps by the program's innermost span and
the pose's host time by part.  Not part of a benchmark run.

    python3 portbench/trace_report.py --workload <cell> --seed <n> --seconds <s> [--out FILE]
        [--ops FILE]

Prints one JSON object (and writes it to ``--out``):

* ``metrics``: the traced run's per-layer metrics, as its result line has them;
* ``reconcile``: the program's ``aruco3.detect`` / ``aruco3.pose`` totals
  over the harness's ``portbench.detect_batch`` / ``portbench.pose``;
  the graph's kernel nodes, its copy nodes (run as CUDA's own kernels)
  and ``pose_kernels_per_frame.live`` against ``kernels_per_frame.live``
  (live cells); kernel 1's device ms plus the four stage metrics over the
  stretch's device ms of kernels other than copies (batch cells);
* ``copy_in``: how far (us) each host-to-device copy lies outside its
  ``aruco3.graph.copy_in`` span (the largest, how many, those past 20 us
  as (outside, start less the span's, the span's end less the copy's
  end), and the least of the last two);
* ``graphs``: the capture log; ``stretch_host_ms``: host ms a frame
  inside the harness's ``portbench.step`` spans of the stretch, beside the
  window's untraced ``host_ms.live``;
* ``idle_by_span``: the stretch's idle device time by the innermost
  ``aruco3.`` span open in each gap's middle (ms, with the gaps' count),
  and the ten longest gaps; ``pose_parts_ms``: host ms a step of each
  ``aruco3.pose.*`` span; ``spans_dropped``.

``--ops`` writes the stretch's first 6,000 device operations, one JSON
list (name, start us, end us) a line, in the order they started.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT  # noqa: E402  (caches and the import path, as a run sets them)


def report(result: dict, tr, recs: list, log: list, dropped: int, kernels: dict, cell: dict) -> dict:
    from portbench.harness import program_trace as pt
    from portbench.harness import runner
    from portbench.harness.runner import kernel_of
    from portbench.harness.trace import is_copy

    metrics = {k: v["value"] for k, v in result["metrics"].items()}

    def host_total(name, spans):
        return sum(e - s for s, e in spans) / 1e3 if spans else None

    harness = {n: [(s, e) for m, s, e in tr.spans if m == n]
               for n in ("portbench.detect_batch", "portbench.pose", "portbench.step")}
    ours = {n: pt.span_intervals(recs, n, tr.window) for n in ("aruco3.detect", "aruco3.pose")}
    rec = {}
    for mine, theirs in (("aruco3.detect", "portbench.detect_batch"), ("aruco3.pose", "portbench.pose")):
        a, b = host_total(mine, ours[mine]), host_total(theirs, harness[theirs])
        rec[mine] = {"ms": a, "harness_ms": b, "ratio": a / b if a and b else None}
    scene = runner.load_config(cell["config"])["scene"]
    batch = runner.load_traffic(cell["traffic"])["batch"]
    shape = [[[batch, scene["height"], scene["width"]], "uint8"]]
    graph = next((g for g in reversed(log) if g["shape"] == shape), None)
    if "kernels_per_frame.live" in metrics and graph is not None:
        per_frame = graph["kernel_nodes"] * tr.steps / tr.frames
        copies = tr.count(lambda n: pt.is_copy(n) and not is_copy(n)) / tr.frames
        rec["kernels"] = {"graph_nodes_a_frame": per_frame, "graph_copy_kernels_a_frame": copies,
                          "pose_kernels_per_frame": metrics.get("pose_kernels_per_frame.live"),
                          "kernels_per_frame": metrics["kernels_per_frame.live"]}
    if "segment_device_ms.batch" in metrics:
        k1 = sum(e - s for n, s, e in tr.clipped() if kernel_of(n, kernels) == "frontend")
        whole = sum(e - s for n, s, e in tr.clipped() if not pt.is_copy(n))
        parts = k1 / 1e3 / tr.steps + sum(metrics.get(f"{m}_device_ms.batch") or 0.0
                                          for m in ("segment", "rectify", "match", "pose"))
        rec["device"] = {"kernel1_plus_stages_ms": parts, "non_copy_ms": whole / 1e3 / tr.steps,
                         "ratio": parts / (whole / 1e3 / tr.steps) if whole else None}
    offsets = pt.copy_in_offsets(tr, recs)
    gaps = tr.idle_gaps()
    by_span = {}
    for s, e in gaps:
        name = pt.innermost(recs, (s + e) / 2) or tr.host_at((s + e) / 2)
        ms, n = by_span.get(name, (0.0, 0))
        by_span[name] = (ms + (e - s) / 1e3, n + 1)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    parts = {n: host_total(n, pt.span_intervals(recs, n, tr.window))
             for n in ("aruco3.pose.homography", "aruco3.pose.canonical", "aruco3.pose.order")}
    step = host_total("portbench.step", harness["portbench.step"])
    return {
        "workload": cell["name"], "seed": result["run"]["seed"], "card": result["run"]["card"],
        "correct": result["correct"], "metrics": metrics, "reconcile": rec,
        "copy_in": {"count": len(offsets),
                    "max_us": max(o[0] for o in offsets) if offsets else None,
                    "past_20us": sorted((o for o in offsets if o[0] > 20.0), reverse=True),
                    "least_lead_us": min(o[1] for o in offsets) if offsets else None,
                    "least_margin_us": min(o[2] for o in offsets) if offsets else None},
        "graphs": log,
        "stage_sums_hold": all(sum(n for _, n in g["stage_kernels"]) == g["kernel_nodes"]
                               for g in log),
        "stretch_host_ms": {"step_a_frame": step / tr.frames if step else None,
                            "untraced_host_ms_live": metrics.get("host_ms.live")},
        "idle_by_span": {k: [round(v[0], 4), v[1]] for k, v in
                         sorted(by_span.items(), key=lambda kv: -kv[1][0])},
        "longest_gaps": [[pt.innermost(recs, (s + e) / 2) or tr.host_at((s + e) / 2),
                          round((e - s) / 1e3, 4)] for s, e in longest],
        "pose_parts_ms": {k: (v / tr.steps if v is not None else None) for k, v in parts.items()},
        "steps": tr.steps, "frames": tr.frames, "spans": len(recs), "spans_dropped": dropped,
        "device": result["device"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    ap.add_argument("--ops")
    args = ap.parse_args(argv)

    from aruco3_tpu_torch.utils import profiling
    from portbench.harness import program_trace, runner, trace

    spec = runner.benchmark_spec(ROOT)
    cell = runner.find_cell(spec, args.workload)
    why_not = runner.card_ready(cell["chips"])
    if why_not:
        print(f"portbench: no run: {why_not}", file=sys.stderr)
        return 2
    kept = []
    from_profile = trace.from_profile

    def keep(*a, **kw):
        kept.append(from_profile(*a, **kw))
        return kept[-1]

    trace.from_profile = keep
    result = runner.run_cell(cell, spec, args.seed, args.seconds, True, T_START)
    recs = program_trace.records() or []
    out = report(result, kept[0], recs, program_trace.capture_log() or [],
                 getattr(profiling, "dropped", lambda: 0)(), runner.kernel_names(), cell)
    if args.ops:
        with open(args.ops, "w") as f:
            for name, s, e in sorted(kept[0].clipped(), key=lambda op: op[1])[:6000]:
                f.write(json.dumps([name[:100], s, e]) + "\n")
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
