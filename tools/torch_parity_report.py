#!/usr/bin/env python
"""Reference-parity measurement of the PyTorch/CUDA port: the counterpart
of tools/parity_report.py, with the same arguments, the same ``--suite``
protocol and the same seed (1234).  Imports no JAX.

Runs the randomized scene mix (plain/dark/multi/nested) through the port's
detector on the card and through the reference-pipeline oracle
(``aruco3_tpu_torch.oracle``, numpy, in ``cpu_count - 1`` worker processes)
and prints recall/parity/corner statistics, per scene family, with the
scenes where the two differ (``missed``: oracle only; ``port_only``).

Usage:
  python tools/torch_parity_report.py [n_scenes] [width height] [dict]
      one configuration (defaults 500 scenes, 320x240, ARUCO_DEFAULT)
  python tools/torch_parity_report.py --suite [n_scenes_per_config]
      ARUCO_DEFAULT@320x240 + ARUCO_MIP_36H12@1920x1080 +
      APRILTAG_36H11@1920x1080, the 1080p configs at 3/8 of n (at least 60)

The first line is the card as ``nvidia-smi`` names it, with its power limit.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from aruco3_tpu_torch.parity import run_parity  # noqa: E402

WORKERS = max(1, (os.cpu_count() or 2) - 1)


def one(name, n, size, seed=1234):
    t0 = time.time()
    res = run_parity(
        dictionary_name=name, n_scenes=n, image_size=size, seed=seed, workers=WORKERS
    )
    s = res.summary()
    s["dictionary"] = name
    s["image_size"] = list(size)
    s["oracle_found"] = res.oracle_found
    s["both_found"] = res.both_found
    s["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(s), flush=True)
    return s


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "workers": WORKERS}), flush=True)
    if len(sys.argv) > 1 and sys.argv[1] == "--suite":
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 400
        n_hd = max(60, (3 * n) // 8)
        configs = [
            ("ARUCO_DEFAULT", n, (320, 240)),
            ("ARUCO_MIP_36H12", n_hd, (1920, 1080)),
            ("APRILTAG_36H11", n_hd, (1920, 1080)),
        ]
        results = [one(name, nn, size) for name, nn, size in configs]
        total_oracle = sum(r["oracle_found"] for r in results)
        total_both = sum(r["both_found"] for r in results)
        print(
            json.dumps(
                {
                    "suite_markers": sum(r["n_markers"] for r in results),
                    "suite_oracle_found": total_oracle,
                    "suite_both_found": total_both,
                    "suite_parity": round(total_both / max(total_oracle, 1), 4),
                }
            )
        )
        return
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 500
    size = (
        (int(sys.argv[2]), int(sys.argv[3]))
        if len(sys.argv) > 3
        else (320, 240)
    )
    name = sys.argv[4] if len(sys.argv) > 4 else "ARUCO_DEFAULT"
    one(name, n, size)


if __name__ == "__main__":
    main()
