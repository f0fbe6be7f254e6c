#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line of numbers:

1. device: the card (``nvidia-smi`` name and power limit) and versions;
   fails without CUDA;
2. build: compiles the four kernels from ``aruco3_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (4 frames of 1080p, ds 10, each kernel fed the
   previous kernel's real outputs); raises if a contract is broken;
4. main path: ``Detector.detect_batch`` + ``pose.solve_normalized_batch``
   on 16 copies of the 8-marker 1080p bench scene; every marker must be
   found within 2 px with a finite pose, every kernel launched and no
   plain version called;
5. timing: detect + pose at batch 128 in frames/s, and each kernel against
   its plain version (CUDA events, after warm-up).

Then one JSON line with the kernels, the ``nvidia-smi`` line, and the last
line ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

FRAME_HW = (1080, 1920)
DICT_NAME = "ARUCO_MIP_36H12"
MARKER_MM = 40.0
KERNELS = [
    # name, CUDA source, TPU kernel it replaces
    ("frontend", "aruco3_tpu_torch/csrc/frontend.cu", "aruco3_tpu/ops/frontend_pallas.py:294"),
    ("coarse_fit", "aruco3_tpu_torch/csrc/coarse_fit.cu", "aruco3_tpu/ops/coarse_pallas.py:872"),
    ("refine", "aruco3_tpu_torch/csrc/refine.cu", "aruco3_tpu/ops/refine_pallas.py:47"),
    ("warp_decode", "aruco3_tpu_torch/csrc/warp_decode.cu", "aruco3_tpu/ops/warp_gather.py:53"),
]


def log(phase: str, **nums) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in nums.items()), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def mismatches(a, b) -> int:
    return int((a != b).sum())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def stage_inputs(frames, det):
    """The main path's intermediate tensors for ``frames`` (kernel route)."""
    from aruco3_tpu_torch import rectify, segment
    from aruco3_tpu_torch.ops import coarse_fit, frontend, refine

    params, min_edge, min_sep, ds = det.geometry(*frames.shape[1:])
    wn = segment.refine_window_size(params, ds)
    coarse, near, level1 = frontend.threshold_open_pool(
        frames, det.config.threshold_window, params.open_radius, ds
    )
    fit1, fit2, ic = coarse_fit.coarse_fit(coarse, params, ds)
    cand = segment.merge_fits(fit1, fit2, params, ds)
    refine_args = (
        frames, near, cand["quads"].contiguous(), cand["centroids"], ic,
        cand["is_inner"].contiguous(), cand["valid"].contiguous(), ds, wn,
    )
    quads = refine.refine_corners(*refine_args)
    quads, valid, _ = segment.finalize_quads(
        quads, cand["valid"], cand["sizes"], cand["overflow"], params, min_edge, min_sep
    )
    s = det.config.homography_sample_size
    H, h_valid = rectify.homography_square_to_quad(quads, s)
    h, w = frames.shape[1:]
    shapes = rectify.pyramid_level_shapes(h, w, rectify.num_levels(h, w))
    lvl, tlx, tly = rectify.warp_windows(quads, shapes)
    warp_args = (
        frames, rectify.upper_levels(level1, shapes), H.contiguous(), lvl, tlx, tly,
        valid & h_valid, s, det.dictionary.get_mark_size(),
    )
    frontend_args = (frames, det.config.threshold_window, params.open_radius, ds)
    return {
        "frontend": frontend_args,
        "coarse_fit": (coarse, params, ds),
        "refine": refine_args,
        "warp_decode": warp_args,
    }


def compare_kernels(args) -> dict:
    """Phase 3: each kernel against its plain version; returns the max
    absolute error of each, raising on a broken contract."""
    import torch

    from aruco3_tpu_torch.ops import coarse_fit, frontend, refine, warp_decode

    errs = {}
    got = frontend.threshold_open_pool(*args["frontend"])
    ref = frontend.plain(*args["frontend"])
    mis = [mismatches(a, b) for a, b in zip(got, ref)]
    log("kernel frontend", coarse_mismatch=mis[0], near_mismatch=mis[1], level1_mismatch=mis[2])
    require(sum(mis) == 0, "frontend: outputs differ from the plain version")
    errs["frontend"] = float((got[2] - ref[2]).abs().max())

    (g1, g2, gic) = coarse_fit.coarse_fit(*args["coarse_fit"])
    (r1, r2, ric) = coarse_fit.plain(*args["coarse_fit"])
    counts = {"inner_coarse": mismatches(gic, ric)}
    cen_err = 0.0
    for tag, g, r in (("outer", g1, r1), ("inner", g2, r2)):
        for key in ("roots", "sizes", "qualifying", "valid"):
            counts[f"{tag}_{key}"] = mismatches(g[key], r[key].to(g[key].dtype))
        counts[f"{tag}_quads_non_tie"] = coarse_fit.quad_mismatches(g, r)
        cen_err = max(cen_err, float((g["centroids"] - r["centroids"]).abs().max()))
    log("kernel coarse_fit", centroid_max_abs_err=cen_err, **counts)
    require(sum(counts.values()) == 0, "coarse_fit: outputs differ from the plain version")
    require(cen_err <= 1e-3, "coarse_fit: centroids differ by more than 1e-3 px")
    errs["coarse_fit"] = cen_err

    valid = args["refine"][6]
    got = refine.refine_corners(*args["refine"])
    ref = refine.plain(*args["refine"])
    mis = mismatches(got[valid], ref[valid])
    log("kernel refine", valid_lanes=int(valid.sum()), corner_mismatch=mis)
    require(mis == 0, "refine: refined corners differ on valid lanes")
    errs["refine"] = float((got[valid] - ref[valid]).abs().max()) if valid.any() else 0.0

    valid = args["warp_decode"][6]
    gs, gl, gg = warp_decode.warp_decode(*args["warp_decode"])
    rs, rl, rg = warp_decode.plain(*args["warp_decode"])
    err = float((gs - rs).abs().max())
    lm = mismatches(gl[valid], rl[valid])
    gm = mismatches(gg[valid], rg[valid])
    log("kernel warp_decode", valid_lanes=int(valid.sum()), sample_max_abs_err=err,
        otsu_mismatch=lm, grid_mismatch=gm)
    require(err <= 1e-3, "warp_decode: samples differ by more than 1e-3 grey")
    require(lm == 0 and gm == 0, "warp_decode: Otsu levels or cell grids differ")
    errs["warp_decode"] = err
    torch.cuda.synchronize()
    return errs


def detect_and_pose(det, frames):
    import torch

    from aruco3_tpu_torch import pose

    out = det.detect_batch(frames)
    h, w = frames.shape[1:]
    scale = torch.tensor([float(w), float(h)], device=frames.device)
    rot, tr, err = pose.solve_normalized_batch(out["marker_corners"] / scale, MARKER_MM)
    return out, rot, tr, err


def check_main_path(out, tr, truth) -> float:
    """Every ground-truth marker in every frame within 2 px (cyclic), with
    a finite pose; returns the worst corner error."""
    valid = out["marker_valid"].cpu().numpy()
    ids = out["marker_id"].cpu().numpy()
    corners = out["marker_corners"].double().cpu().numpy()
    tr = tr.cpu().numpy()
    worst = 0.0
    for f in range(valid.shape[0]):
        for mid, tc in truth:
            errs = [
                min(np.abs(np.roll(corners[f, k], r, axis=0) - tc).max() for r in range(4))
                for k in np.nonzero(valid[f])[0]
                if ids[f, k] == mid
            ]
            require(bool(errs) and min(errs) <= 2.0, f"frame {f}: marker {mid} missed")
            worst = max(worst, min(errs))
        require(bool(np.isfinite(tr[f][valid[f]]).all()), f"frame {f}: non-finite pose")
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs an NVIDIA card")
    card = smi_line()
    log("device", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        count=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig, render
    from aruco3_tpu_torch.ops import _build, coarse_fit, frontend, refine, warp_decode

    t0 = time.perf_counter()
    _build.lib()
    log("build", seconds=round(time.perf_counter() - t0, 3), library=_build.library_path().name)

    dictionary = ARDictionary.new_from_named_dict(DICT_NAME)
    det = Detector(DetectorConfig(), dictionary, device="cuda")
    h, w = FRAME_HW
    scene, truth = render.bench_scene(dictionary, (w, h), seed=0, noise_sigma=2.0)
    four = np.stack(
        [scene] + [render.bench_scene(dictionary, (w, h), seed=s)[0] for s in (1, 2, 3)]
    )
    args = stage_inputs(torch.from_numpy(four).cuda(), det)
    errs = compare_kernels(args)

    # name -> (module, kernel wrapper); each module also has `plain`.
    kernels = {
        "frontend": (frontend, frontend.threshold_open_pool),
        "coarse_fit": (coarse_fit, coarse_fit.coarse_fit),
        "refine": (refine, refine.refine_corners),
        "warp_decode": (warp_decode, warp_decode.warp_decode),
    }
    frames16 = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(scene, (16, h, w)))).cuda()
    for mod, _ in kernels.values():
        mod.launches = 0
        mod.plain_calls = 0
    out, rot, tr, perr = detect_and_pose(det, frames16)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, (mod, _) in kernels.items()}
    plains = {name: mod.plain_calls for name, (mod, _) in kernels.items()}
    worst = check_main_path(out, tr, truth)
    log("main path", frames=16, markers_per_frame=int(out["marker_valid"][0].sum()),
        worst_corner_err_px=round(worst, 3),
        **{f"launches_{k}": v for k, v in launches.items()},
        **{f"plain_calls_{k}": v for k, v in plains.items()})
    require(all(v > 0 for v in launches.values()), "a kernel of the path was not launched")
    require(all(v == 0 for v in plains.values()), "a plain version ran on the main path")

    frames128 = torch.from_numpy(
        np.ascontiguousarray(np.broadcast_to(scene, (128, h, w)))
    ).cuda()
    ms = cuda_ms(lambda: detect_and_pose(det, frames128), reps=5)
    log("timing", card=repr(card), batch=128, ms_per_batch=round(ms, 3),
        frames_per_s=round(128 * 1000.0 / ms, 1))
    rows = []
    for name, source, replaces in KERNELS:
        mod, kernel = kernels[name]
        a = args[name]
        k_ms = cuda_ms(lambda: kernel(*a), reps=10)
        p_ms = cuda_ms(lambda: mod.plain(*a), reps=2)
        log(f"timing {name}", card=repr(card), batch=4, kernel_ms=round(k_ms, 4),
            plain_ms=round(p_ms, 4))
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errs[name],
                     "ms": k_ms, "plain_ms": p_ms})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
