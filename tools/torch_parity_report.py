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
  python tools/torch_parity_report.py --suite [n_scenes_per_config] [--golden]
      ARUCO_DEFAULT@320x240 + ARUCO_MIP_36H12@1920x1080 +
      APRILTAG_36H11@1920x1080, the 1080p configs at 3/8 of n (at least 60)

``--golden`` (the suite at n <= 400, the scenes the JAX records hold)
also holds every scene's detections against the JAX package's
(``tests/torch_golden/scenes.npz``, made on the CPU by
``tools/torch_make_golden.py``; ``tools/torch_golden.py`` compares: JAX's
quads decoded by the Pallas warp of the port's route) and prints per
dictionary, next to the oracle: the truth markers both JAX and the port
miss, those only JAX finds, those only the port finds, those the oracle
finds and JAX misses, the scenes whose markers differ (corners apart), the
(scene, lane) pairs where JAX's XLA warp decodes otherwise than its
Pallas warp, and the comparator's counts.  Exits 1 if a scene differs.

The first line is the card as ``nvidia-smi`` names it, with its power limit.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_golden as golden  # noqa: E402
from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig  # noqa: E402
from aruco3_tpu_torch.detector import Marker  # noqa: E402
from aruco3_tpu_torch.parity import matching, reference_scenes, run_parity, score  # noqa: E402

WORKERS = max(1, (os.cpu_count() or 2) - 1)


def against_jax(name, scenes, outs, det) -> dict:
    """The port's detections of the suite's scenes against the JAX records
    and the oracle, truth marker by truth marker: (scene, id) lists."""
    rec = golden.head(golden.subset(golden.load("scenes"), f"suite/{name}"), len(scenes))
    images = [img for _, img, _, _ in scenes]
    rep = golden.compare_scenes(f"suite/{name}", rec, images, outs,
                                lambda k: golden.port_fits(det, images[k][None]))
    route = golden.held(rec)  # the decode of the Pallas warp of the port's route
    lists = {"both_miss": [], "jax_only": [], "port_only": [], "oracle_not_jax": []}
    for k, (_, _, truths, orc) in enumerate(scenes):
        jm, pm = (golden.unpack(route, "", k), golden.markers_of(outs[k], 0))
        jax_m, port_m = ([Marker(int(i), 0, [tuple(c) for c in cs.tolist()], 0)
                          for i, cs in zip(m["id"], m["corners"])] for m in (jm, pm))
        for mid, truth in truths:
            j, p, o = (bool(matching(m, mid, truth)) for m in (jax_m, port_m, orc))
            if not (j and p):
                key = "jax_only" if j else "port_only" if p else "both_miss"
                lists[key].append([k, mid])
            if o and not j:
                lists["oracle_not_jax"].append([k, mid])
    return {"jax": rep.counts(), **lists,
            "scenes_differ": sorted({d.item for d in rep.differences}),
            "corners_differ": sorted({d.item for d in rep.differences if d.field == "corners"}),
            "ties": rep.ties, "xla_warp_apart": rep.warp_split,
            "differences": [str(d) for d in rep.differences[:20]]}


def one(name, n, size, seed=1234, jax=False):
    t0 = time.time()
    if jax:
        scenes = reference_scenes(name, n, size, seed, WORKERS)
        det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict(name), device="cuda")
        outs = []
        res = score(det, scenes, outputs=outs)
    else:
        res = run_parity(
            dictionary_name=name, n_scenes=n, image_size=size, seed=seed, workers=WORKERS
        )
    s = res.summary()
    s["dictionary"] = name
    s["image_size"] = list(size)
    s["oracle_found"] = res.oracle_found
    s["both_found"] = res.both_found
    if jax:
        s["against_jax"] = against_jax(name, scenes, outs, det)
    s["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(s), flush=True)
    return s


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "workers": WORKERS}), flush=True)
    jax = "--golden" in sys.argv[1:]
    args = [a for a in sys.argv[1:] if a != "--golden"]
    if args and args[0] == "--suite":
        n = int(args[1]) if len(args) > 1 else 400
        n_hd = max(60, (3 * n) // 8)
        configs = [
            ("ARUCO_DEFAULT", n, (320, 240)),
            ("ARUCO_MIP_36H12", n_hd, (1920, 1080)),
            ("APRILTAG_36H11", n_hd, (1920, 1080)),
        ]
        results = [one(name, nn, size, jax=jax) for name, nn, size in configs]
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
        return 1 if any(r.get("against_jax", {}).get("scenes_differ") for r in results) else 0
    n = int(args[0]) if args else 500
    size = (int(args[1]), int(args[2])) if len(args) > 2 else (320, 240)
    name = args[3] if len(args) > 3 else "ARUCO_DEFAULT"
    one(name, n, size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
