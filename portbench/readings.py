"""Readings of the numbers the check compares, over many seeds in one
process: of the program (the lower readings), of the precision control
(``--control``) or of a planted fault (``--fault answer|half``), at the
cell's own size.  Not part of a benchmark run; the limits in each
configuration's ``check`` were set from its output.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 3 [--control]

Prints one JSON line a seed, then a line with each number's largest and
smallest reading.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT  # noqa: E402,F401  (caches and the import path, as a run sets them)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("answer", "half"))
    args = ap.parse_args(argv)

    from portbench.harness import control, runner

    spec = runner.benchmark_spec(ROOT)
    cell = runner.find_cell(spec, args.workload)
    why_not = runner.card_ready(cell["chips"])
    if why_not:
        print(f"portbench: no run: {why_not}", file=sys.stderr)
        return 2
    program, overrides = None, {}
    if args.control:
        program = control.Control
        overrides = {"traffic": {"warm_steps": 1, "kept_batches": 10**6}}
    elif args.fault == "answer":
        program = lambda c, d: control.AlteredAnswer(c, d, runner.Program)  # noqa: E731
    elif args.fault == "half":
        program = lambda c, d: control.HalfBatch(c, d, runner.Program)  # noqa: E731
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = runner.run_cell(cell, spec, seed, args.seconds, False, t, program=program,
                            overrides=overrides)
        row = {"seed": seed, "correct": r["correct"],
               **{k: v["value"] for k, v in r["checks"].items()},
               **{k: v["value"] for k, v in r["metrics"].items()}, **r["run"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = list(r["checks"])
    print(json.dumps({"workload": args.workload, "control": args.control, "fault": args.fault,
                      "max": {k: max(x[k] for x in rows) for k in names},
                      "min": {k: min(x[k] for x in rows) for k in names},
                      "correct": [x["correct"] for x in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
