"""The port's benchmark: one run of one cell on one machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Set-up (frames rendered on the card from
the seed, the detector, one warm-up and capture of the cell's shape) is
timed as ``setup_s``; then the window runs for ``--seconds``; with
``--trace 1`` a short stretch under ``torch.profiler`` follows it and the
per-layer metrics are read from it.  Then the reference recomputes a
sample of the window's frames drawn from the seed and decides
``correct``.  The last line of standard output is the result, a JSON
object; the numbers compared, each with its limit, are the last lines of
standard error.  Exits with another code than 0, and prints no result,
where no card (or too few) is found, or where JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent  # the checkout
# Build and kernel caches at fixed paths inside the checkout.
CACHE = ROOT / "build" / "portbench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "cuda"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import runner

    spec = runner.benchmark_spec(ROOT)
    cell = runner.find_cell(spec, args.workload)
    why_not = runner.card_ready(cell["chips"])
    if why_not:
        print(f"portbench: no run: {why_not}", file=sys.stderr)
        return 2
    result = runner.run_cell(cell, spec, args.seed, args.seconds, bool(args.trace), T_START)
    found = runner.forbidden_modules()
    if found:
        print(f"portbench: no result: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
