#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Five paths, each ``Detector.detect_batch`` + ``pose.solve_normalized_batch``.
Three take the refine route (corner refinement, kernel 4's warp):

* landscape: the 8-marker 1080p bench frame (1080x1920 u8,
  ``ARUCO_MIP_36H12``, ``DetectorConfig()``): ds 10, a 108x192 grid, the
  fused route (kernel 2 in fit mode);
* portrait (A): the same frame turned a quarter (1920x1080): a 192x108
  grid outside the fused envelope, so the label route through kernel 2's
  labels mode and kernel 7;
* dense (B): a 14x9 board of 126 ``APRILTAG_36H11`` tags at 230 px on a
  4K frame (2160x3840) with the ``4k-dense-grid`` preset at 160 lanes:
  ds 20, a 108x192 grid, the label route through kernels 5 and 6.

Two take the tail route (no refinement, or ds 1): kernel 1, kernel 2's
labels mode, kernel 7, window slices in torch and kernel 8:

* noref (C): the landscape frames with ``DetectorConfig(refine_corners=
  False)``;
* small (D): 120x160 frames holding one ``ARUCO_DEFAULT`` marker each,
  ``DetectorConfig()``: ds 1, a 120x160 grid.

Phases, each printing lines of numbers:

1. device: the card (``nvidia-smi`` name and power limit) and versions;
   fails without CUDA;
2. build: compiles the kernels of ``aruco3_tpu_torch/csrc``, one ``nvcc``
   per source, all at once;
3. kernels: each kernel of each path against its plain PyTorch version on
   the card, at the path's shapes (4 frames; 2 for dense), each kernel fed
   the previous kernel's real outputs; raises if a contract is broken.
   Dense checks kernels 5 and 6 on both label planes (the inner one as
   ``rank_roots:inner`` and ``fit_lanes:inner``), after a line with the
   cluster size of kernel 5 and the lane group of kernel 6 per plane.
   Kernel 8 also decodes its samples and those of its plain version into
   the same cell grids;
4. paths: each path driven once, every launch count set to 0 just before
   and read just after: every kernel of the path launched, no other and no
   plain version called.  Landscape and portrait on 16 frames: every
   ground-truth marker within 2 px with a finite pose.  Dense on 4 frames,
   noref and small on 16: frame 0 equal to the port's CPU path (ids,
   codes, rounded corners, stats); noref every marker within 12 px (its
   corners are the coarse fit's, ~ds px), small its marker within 2 px;
5. timing: detect + pose in frames/s (landscape, portrait and noref at
   batch 128, dense at 16, small at 512) with the device time per batch
   by kernel (``torch.profiler``) beside it; each kernel of the path alone
   on that batch (device time, profiler) beside its bound there; each
   kernel against its plain version at its path's phase-3 shapes (CUDA
   events after warm-up, and the kernel's device time alone; kernels 3
   and 4 on each of the three refine paths), on the portrait coarse
   planes at batch 128 the fused kernel 2 against
   labels mode + kernel 7, and on the noref quads at batch 128 kernel 8
   against ``grid_sample`` and the tail route's warp + decode against
   kernel 4's.

Then one JSON line with the kernels, the ``nvidia-smi`` line, and the last
line ``{"ok": true, "device": {...}}``.  Imports no JAX.

Each kernel's ``bound_ms`` is the larger of its bytes over 3.35 TB/s and
its operations over 67 T/s (the H100's non-tensor float32 peak; integer
and boolean work is counted against it too, which only lowers the bound).
Bytes: each input the function needs read once, each output written once;
the window kernels (refine, warp_decode) count only the windows of valid
lanes.  Operations, per element, from this run's data: frontend 31 per
pixel; coarse labelling 12 per cell per flood or CCL round (peel depths
after the first not counted); rank pool 10 per cell; fit chain 40 per
member cell of each fitted lane plus one per cell to find the members;
refine 8 per window pixel; warp 20 per sample plus 2,560 per lane for
Otsu; window evaluation (kernel 8) 20 per sample of every lane, whose
bytes are the windows, both coordinates and the samples.  ``library_ms``
is one PyTorch call that computes the same function where there is one:
``grid_sample`` (bilinear, zero padding, corners aligned) for kernel 8.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

LANDSCAPE_HW = (1080, 1920)
DICT_NAME = "ARUCO_MIP_36H12"
DENSE_HW = (2160, 3840)
SMALL_HW = (120, 160)
# The "single" scene of the twin tests at half size: marker 5 of ARUCO_DEFAULT.
SMALL_QUAD = np.array([[100, 70], [220, 75], [215, 190], [95, 185]], float) * 0.5
MARKER_MM = 40.0
# Noref corners are the coarse fit's, within ~ds px of the truth (the JAX
# package's worst on the landscape frame is 9.46 px).
NOREF_TOL_PX = 12.0
# Phase-3 tag of a kernel's call on the inner label plane (dense: kernels 5, 6).
INNER = ":inner"
# Phase-5 batch of each path.
BATCHES = {"landscape": 128, "portrait": 128, "dense": 16, "noref": 128, "small": 512}
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# The CUDA kernel each wrapper launches (its name in a profile).
CUDA_NAMES = {"frontend": "frontend_kernel", "coarse_fit": "coarse_kernel",
              "coarse_labels": "coarse_kernel", "fused_fit": "fused_fit_kernel",
              "rank_roots": "rank_roots_kernel", "fit_lanes": "fit_lanes_kernel",
              "refine": "refine_kernel", "warp_decode": "warp_decode_kernel",
              "warp_eval": "warp_eval_kernel"}
# name -> (CUDA source, TPU kernel it replaces, path whose shapes its row reports)
KERNELS = {
    "frontend": ("aruco3_tpu_torch/csrc/frontend.cu",
                 "aruco3_tpu/ops/frontend_pallas.py:294", "landscape"),
    "coarse_fit": ("aruco3_tpu_torch/csrc/coarse_fit.cu",
                   "aruco3_tpu/ops/coarse_pallas.py:872", "landscape"),
    "coarse_labels": ("aruco3_tpu_torch/csrc/coarse_fit.cu",
                      "aruco3_tpu/ops/coarse_pallas.py:872", "portrait"),
    "fused_fit": ("aruco3_tpu_torch/csrc/fit.cu",
                  "aruco3_tpu/ops/fit_pallas.py:445", "portrait"),
    "rank_roots": ("aruco3_tpu_torch/csrc/fit.cu",
                   "aruco3_tpu/ops/fit_pallas.py:271", "dense"),
    "fit_lanes": ("aruco3_tpu_torch/csrc/fit.cu",
                  "aruco3_tpu/ops/fit_pallas.py:331", "dense"),
    "refine": ("aruco3_tpu_torch/csrc/refine.cu",
               "aruco3_tpu/ops/refine_pallas.py:47", "landscape"),
    "warp_decode": ("aruco3_tpu_torch/csrc/warp_decode.cu",
                    "aruco3_tpu/ops/warp_gather.py:53", "landscape"),
    "warp_eval": ("aruco3_tpu_torch/csrc/warp_eval.cu",
                  "aruco3_tpu/ops/warp_pallas.py:36", "noref"),
}


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


def device_ms(fn, reps: int, kernel: str | None = None) -> float:
    """Device milliseconds per call of ``fn`` (torch.profiler over ``reps``
    calls after one warm-up): the kernels' time without the host's.  The
    profiler now and then drops events, so a profile counts only if it
    holds at least ``reps`` events of the CUDA kernel named ``kernel``
    (one launch a call), or any device time when ``kernel`` is None; raises
    after five profiles that do not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        total = sum(e.self_device_time_total for e in dev)
        events = sum(e.count for e in dev if kernel is not None and kernel in e.key)
        if total > 0 and (kernel is None or events >= reps):
            return total / 1e3 / reps
    raise RuntimeError(f"torch.profiler dropped device events of {kernel} in five tries")


def mismatches(a, b) -> int:
    return int((a != b).sum())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def nbytes(*objs) -> int:
    """Bytes of the tensors in ``objs`` (tensors, dicts, tuples, lists)."""
    import torch

    total = 0
    for o in objs:
        if torch.is_tensor(o):
            total += o.numel() * o.element_size()
        elif isinstance(o, dict):
            total += nbytes(*o.values())
        elif isinstance(o, (tuple, list)):
            total += nbytes(*o)
    return total


def grid_frame(d, h, w, cell, rng, n_cols, n_rows):
    """ChArUco-style dense grid of markers, each rendered on its own tile
    (the board of the JAX package's ``benches/bench_configs.py``).  Returns
    the frame and [(id, corners (4, 2))]."""
    from aruco3_tpu_torch.render import render_marker

    img = np.full((h, w), 255, dtype=np.uint8)
    side = int(cell * 0.8)
    quad = np.array(
        [[2.0, 2.0], [2.0 + side, 2.0], [2.0 + side, 2.0 + side], [2.0, 2.0 + side]]
    )
    tile = side + 4
    truth = []
    for r in range(n_rows):
        for c in range(n_cols):
            mid = (r * n_cols + c) % len(d)
            x0 = 40 + c * cell
            y0 = 40 + r * cell
            if x0 + tile >= w or y0 + tile >= h:
                continue
            sub = render_marker(d, mid, (tile, tile), quad, noise_sigma=0.0)
            img[y0 : y0 + tile, x0 : x0 + tile] = np.minimum(
                img[y0 : y0 + tile, x0 : x0 + tile], sub
            )
            truth.append((mid, quad + [x0, y0]))
    img = np.clip(
        img.astype(np.float64) + rng.normal(0, 2.0, img.shape), 0, 255
    ).astype(np.uint8)
    return img, truth


def counters():
    """name -> Counter of every kernel wrapper."""
    from aruco3_tpu_torch.ops import coarse_fit, fit, frontend, refine, warp_decode, warp_eval

    return {
        "frontend": frontend.count,
        "coarse_fit": coarse_fit.count,
        "coarse_labels": coarse_fit.labels_count,
        "fused_fit": fit.fused_count,
        "rank_roots": fit.rank_count,
        "fit_lanes": fit.lanes_count,
        "refine": refine.count,
        "warp_decode": warp_decode.count,
        "warp_eval": warp_eval.count,
    }


def wrappers():
    """name -> (kernel wrapper, plain version on the same arguments)."""
    from aruco3_tpu_torch import segment
    from aruco3_tpu_torch.ops import coarse_fit, fit, frontend, refine, warp_decode, warp_eval

    return {
        "frontend": (frontend.threshold_open_pool, frontend.plain),
        "coarse_fit": (coarse_fit.coarse_fit, coarse_fit.plain),
        "coarse_labels": (coarse_fit.coarse_labels, coarse_fit.labels_plain),
        "fused_fit": (fit.fused_fit_batch, fit.fused_fit_plain),
        "rank_roots": (fit.rank_roots, segment.rank_pool),
        "fit_lanes": (fit.fit_lanes, segment.fit_lanes),
        "refine": (refine.refine_corners, refine.plain),
        "warp_decode": (warp_decode.warp_decode, warp_decode.plain),
        "warp_eval": (warp_eval.warp_eval, warp_eval.plain),
    }


def stage_inputs(frames, det):
    """The path's intermediate tensors for ``frames``: (name -> the
    arguments each kernel of the path gets, on the detector's route; the
    tail route's warp inputs, or None on the refine route)."""
    import torch

    from aruco3_tpu_torch import detector, rectify, segment
    from aruco3_tpu_torch.ops import coarse_fit, fit, frontend, refine

    params, min_edge, min_sep, ds = det.geometry(*frames.shape[1:])
    wn = segment.refine_window_size(params, ds)
    args = {"frontend": (frames, det.config.threshold_window, params.open_radius, ds)}
    coarse, near, level1 = frontend.threshold_open_pool(*args["frontend"])
    k1, k2 = params.max_candidates, params.max_inner_candidates
    tail = detector.tail_route(params, ds)
    if not tail and detector.fit_route(coarse.shape[1], coarse.shape[2], k1, k2) == "fused":
        args["coarse_fit"] = (coarse, params, ds)
        fit1, fit2, ic = coarse_fit.coarse_fit(*args["coarse_fit"])
    else:
        args["coarse_labels"] = (coarse, params)
        l1, l2 = coarse_fit.coarse_labels(*args["coarse_labels"])
        if max(k1, k2) > fit.MAX_LANES:
            for tag, lab, k in (("", l1, k1), (INNER, l2, k2)):
                if k <= 0:
                    continue
                kr = segment.rank_pool_size(k, lab.shape[1] * lab.shape[2])
                args["rank_roots" + tag] = (lab, kr, params.min_component_px)
                roots_r, sizes_r, _ = fit.rank_roots(*args["rank_roots" + tag])
                roots, sizes = segment.select_lanes(roots_r, sizes_r, k)
                args["fit_lanes" + tag] = (
                    lab, roots.contiguous(), sizes.clamp(min=0).contiguous(),
                    (sizes >= 0).contiguous(), ds, params.containment_slack,
                )
        else:
            args["fused_fit"] = (l1, l2, ds, params, k1, k2, True)
        fit1, fit2 = fit.fused_fit_batch(l1, l2, ds, params, k1, k2, dup_skip=True)
        ic = segment.inner_footprint(l2) if k2 > 0 else torch.zeros_like(coarse)
    cand = segment.merge_fits(fit1, fit2, params, ds)
    s = det.config.homography_sample_size
    if tail:
        quads, valid, _ = segment.finalize_quads(
            cand["quads"], cand["valid"], cand["sizes"], cand["overflow"], params,
            min_edge, min_sep,
        )
        H, h_valid = rectify.homography_square_to_quad(quads, s)
        windows, ux, uy, bad = rectify.warp_setup(frames, level1, H, quads, s)
        args["warp_eval"] = (windows.reshape(-1, rectify.WARP_WIN, rectify.WARP_WIN),
                             ux.reshape(-1, s * s), uy.reshape(-1, s * s))
        return args, {"grey": frames, "level1": level1, "H": H, "quads": quads,
                      "valid": valid & h_valid, "bad": bad.reshape(-1, s * s),
                      "mark": det.dictionary.get_mark_size()}
    args["refine"] = (
        frames, near, cand["quads"].contiguous(), cand["centroids"].contiguous(), ic,
        cand["is_inner"].contiguous(), cand["valid"].contiguous(), ds, wn,
    )
    quads = refine.refine_corners(*args["refine"])
    quads, valid, _ = segment.finalize_quads(
        quads, cand["valid"], cand["sizes"], cand["overflow"], params, min_edge, min_sep
    )
    H, h_valid = rectify.homography_square_to_quad(quads, s)
    h, w = frames.shape[1:]
    shapes = rectify.pyramid_level_shapes(h, w, rectify.num_levels(h, w))
    lvl, tlx, tly = rectify.warp_windows(quads, shapes)
    args["warp_decode"] = (
        frames, rectify.upper_levels(level1, shapes), H.contiguous(), lvl, tlx, tly,
        valid & h_valid, s, det.dictionary.get_mark_size(),
    )
    return args, None


def kernel_of(name: str) -> str:
    """The kernel a phase-3 entry checks (``fit_lanes:inner`` -> ``fit_lanes``)."""
    return name.split(":")[0]


def log_fit_split(path, args) -> None:
    """Kernel 5's cluster size and kernel 6's lane group, per label plane."""
    import torch

    from aruco3_tpu_torch.ops import _build, fit

    sms = _build.sm_count(torch.cuda.current_device())
    for tag in ("", INNER):
        if "fit_lanes" + tag not in args:
            continue
        lab, roots = args["fit_lanes" + tag][:2]
        b, k = roots.shape
        on_chip = _build.layout("a3_lanes_layout", *lab.shape[1:])[1] == 0
        g = fit.lane_group(k, b, sms, on_chip)
        log("fit split", path=path, plane=tag[1:] or "outer", batch=b, sms=sms, lanes=k,
            kr=args["rank_roots" + tag][1], rank_cluster=fit.rank_cluster(b, sms), lane_group=g,
            lane_blocks=b * -(-k // g), members_on_chip=on_chip)


def fit_counts(g, r, tag=""):
    """Mismatch counts of two fit dicts and their centroid error."""
    from aruco3_tpu_torch.ops import coarse_fit

    counts = {}
    for key in ("roots", "sizes", "qualifying", "valid"):
        counts[f"{tag}{key}"] = mismatches(g[key], r[key].to(g[key].dtype))
    counts[f"{tag}quads_non_tie"] = coarse_fit.quad_mismatches(g, r)
    return counts, float((g["centroids"] - r["centroids"]).abs().max())


def compare(name, args, got, ref, tail=None):
    """(mismatch counts, max abs error) of a kernel's outputs against its
    plain version's, by the kernel's contract (``tail``: the tail route's
    warp inputs from ``stage_inputs``)."""
    import torch

    from aruco3_tpu_torch import rectify
    from aruco3_tpu_torch.ops import coarse_fit

    if name == "frontend":
        counts = {f"{k}_mismatch": mismatches(a, b)
                  for k, a, b in zip(("coarse", "near", "level1"), got, ref)}
        return counts, float((got[2] - ref[2]).abs().max())
    if name in ("coarse_labels", "rank_roots"):
        keys = ("labels1", "labels2") if name == "coarse_labels" else ("roots", "sizes", "n_roots")
        return {f"{k}_mismatch": mismatches(a, b) for k, a, b in zip(keys, got, ref)}, 0.0
    if name in ("coarse_fit", "fused_fit"):
        counts, err = fit_counts(got[0], ref[0], "outer_")
        if got[1] is not None:
            c2, e2 = fit_counts(got[1], ref[1], "inner_")
            counts.update(c2)
            err = max(err, e2)
        if name == "coarse_fit":
            counts["inner_coarse"] = mismatches(got[2], ref[2])
        return counts, err
    if name == "fit_lanes":
        counts = {
            "frac_mismatch": mismatches(got[2], ref[2]),
            "quads_non_tie": coarse_fit.quad_mismatches(
                {"quads": got[0]}, {"quads": ref[0], "centroids": ref[1], "sizes": args[2]}
            ),
        }
        return counts, float((got[1] - ref[1]).abs().max())
    if name == "refine":
        valid = args[6]
        err = float((got[valid] - ref[valid]).abs().max()) if valid.any() else 0.0
        return {"corner_mismatch": mismatches(got[valid], ref[valid])}, err
    if name == "warp_decode":
        valid = args[6]
        counts = {"otsu_mismatch": mismatches(got[1][valid], ref[1][valid]),
                  "grid_mismatch": mismatches(got[2][valid], ref[2][valid])}
        return counts, float((got[0] - ref[0]).abs().max())
    if name == "warp_eval":
        s = int(round(got.shape[1] ** 0.5))
        valid = tail["valid"].reshape(-1)

        def grids(vals):
            patches = torch.where(tail["bad"], 0.0, vals).reshape(-1, s, s)
            return rectify.otsu_cells(patches, tail["mark"])[1][valid]

        return ({"grid_mismatch": mismatches(grids(got), grids(ref))},
                float((got - ref).abs().max()))
    raise KeyError(name)


def compare_kernels(path, args, params, tail=None) -> dict:
    """Phase 3: each kernel of the path against its plain version; returns
    name -> (max abs error, bytes, operations), raising on a broken
    contract.  Where the path takes kernels 5 and 6, also the whole split
    fit (kernel 5, top-k, kernel 6) against ``segment.fit_quads``."""
    import torch

    from aruco3_tpu_torch import segment
    from aruco3_tpu_torch.ops import fit

    out = {}
    log_fit_split(path, args)
    for tag in ("", INNER):
        if "fit_lanes" + tag not in args:
            continue
        lab, _, sizes, _, ds, _ = args["fit_lanes" + tag]
        k = sizes.shape[1]
        counts, err = fit_counts(fit.fit_quads_batch(lab, ds, params, k),
                                 segment.fit_quads(lab, ds, params, k))
        log("kernel fit_quads_batch" + tag, path=path, centroid_max_abs_err=err, **counts)
        require(sum(counts.values()) == 0 and err <= 1e-3,
                f"fit_quads_batch{tag} ({path}): outputs differ from segment.fit_quads")
    table = wrappers()
    for name, a in args.items():
        kernel, plain = table[kernel_of(name)]
        got = kernel(*a)
        ref = plain(*a)
        counts, err = compare(kernel_of(name), a, got, ref, tail)
        counts.pop("valid_lanes_x", None)
        log(f"kernel {name}", path=path, max_abs_err=err, **counts)
        require(sum(counts.values()) == 0, f"{name} ({path}): outputs differ from the plain version")
        limit = 1e-3 if name != "frontend" else 0.0
        require(err <= limit, f"{name} ({path}): max abs error {err} above {limit}")
        out[name] = (err, *work(kernel_of(name), a, got))
    torch.cuda.synchronize()
    return out


def label_rounds(params) -> int:
    """Flood and CCL rounds of the labelling, peel depths after the first
    not counted."""
    outer = params.fill_rounds + params.ccl_rounds
    if params.max_inner_candidates <= 0:
        return outer
    return outer + params.bg_rounds + params.fill_rounds + 2 * params.inner_flood_rounds + params.ccl_rounds


def fit_ops(fit: dict, cells: int) -> int:
    """Rank pool and chain operations of one fitted plane (lanes with a
    nonzero centroid were fitted)."""
    fitted = (fit["centroids"] != 0).any(dim=-1)
    return 11 * cells + 40 * int(fit["sizes"][fitted].sum())


def work(name, args, got):
    """(bytes, operations) the kernel's function needs on these inputs."""
    if name == "frontend":
        return nbytes(args[0], got), 31 * args[0].numel()
    if name in ("coarse_fit", "coarse_labels"):
        coarse, params = args[0], args[1]
        ops = 12 * label_rounds(params) * coarse.numel()
        if name == "coarse_fit":
            ops += sum(fit_ops(f, coarse.numel()) for f in got[:2] if f is not None)
        return nbytes(coarse, got), ops
    if name == "fused_fit":
        planes = [args[0]] + ([args[1]] if got[1] is not None else [])
        return nbytes(planes, got[:2]), sum(fit_ops(f, args[0].numel()) for f in got[:2] if f is not None)
    if name == "rank_roots":
        return nbytes(args[0], got), 10 * args[0].numel()
    if name == "fit_lanes":
        lab, roots, sizes, use = args[:4]
        return nbytes(lab, roots, sizes, use, got), lab.numel() + 40 * int(sizes[use].sum())
    if name == "refine":
        valid, wn = args[6], args[8]
        nv = int(valid.sum())
        return nbytes(args[2:7], got) + nv * 4 * wn * wn * 2, nv * 4 * wn * wn * 8
    if name == "warp_decode":
        valid, s = args[6], args[7]
        nv = int(valid.sum())
        return nbytes(args[2:7], got) + nv * s * s, nv * (20 * s * s + 2560)
    if name == "warp_eval":
        return nbytes(args, got), 20 * got.numel()
    raise KeyError(name)


def bound(bytes_: int, ops: int):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def detect_and_pose(det, frames):
    import torch

    from aruco3_tpu_torch import pose

    out = det.detect_batch(frames)
    h, w = frames.shape[1:]
    scale = torch.tensor([float(w), float(h)], device=frames.device)
    rot, tr, err = pose.solve_normalized_batch(out["marker_corners"] / scale, MARKER_MM)
    return out, rot, tr, err


def check_markers(out, tr, truth, tol=2.0) -> float:
    """Every ground-truth marker in every frame within ``tol`` px
    (cyclic), with a finite pose; returns the worst corner error."""
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
            require(bool(errs) and min(errs) <= tol, f"frame {f}: marker {mid} missed")
            worst = max(worst, min(errs))
        require(bool(np.isfinite(tr[f][valid[f]]).all()), f"frame {f}: non-finite pose")
    return worst


def drive(path, det, frames, kernels_of_path):
    """Phase 4: one run of the path with every count set to 0 just before
    and read just after; returns (out, tr, launches)."""
    import torch

    counts = counters()
    for c in counts.values():
        c.reset()
    out, _, tr, _ = detect_and_pose(det, frames)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counts.items()}
    plains = {name: c.plain_calls for name, c in counts.items()}
    log(f"path {path} counts", **{f"launches_{k}": v for k, v in launches.items()},
        **{f"plain_calls_{k}": v for k, v in plains.items()})
    for name, n in launches.items():
        if name in {kernel_of(k) for k in kernels_of_path}:
            require(n > 0, f"{path}: kernel {name} was not launched")
        else:
            require(n == 0, f"{path}: kernel {name} is not on this path but was launched")
    require(all(v == 0 for v in plains.values()), f"{path}: a plain version ran")
    return out, tr, launches


def equal_to_cpu(path, out, det, frame):
    """Frame 0 of a card run against the port's CPU path on the same frame:
    ids, codes, rounded corners and stats must be equal.  Returns (float
    candidates equal, seconds of the CPU run)."""
    from aruco3_tpu_torch import Detector
    from aruco3_tpu_torch.detector import to_host

    got0 = to_host(out, 0)
    t_cpu = time.perf_counter()
    ref0 = Detector(det.config, det.dictionary, device="cpu").detect(frame)
    cpu_s = time.perf_counter() - t_cpu

    def summary(det_):
        return sorted((m.id, m.code, tuple(m.corners)) for m in det_.markers)

    require(summary(got0) == summary(ref0), f"{path}: frame 0 markers differ from the CPU path")
    require(got0.stats == ref0.stats, f"{path}: frame 0 stats differ from the CPU path")
    return got0.candidates == ref0.candidates, cpu_s


def sample_grid(ux, uy):
    """Kernel 8's window coordinates as a ``grid_sample`` grid (N, 1, S2, 2)
    for ``align_corners=True`` on 64-px windows: x = (g + 1) / 2 * 63."""
    import torch

    return torch.stack([ux * (2.0 / 63.0) - 1.0, uy * (2.0 / 63.0) - 1.0], dim=-1)[:, None]


def grid_sample_eval(windows, grid):
    """Kernel 8's function as one PyTorch call (zero padding)."""
    import torch.nn.functional as F

    return F.grid_sample(windows[:, None], grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)[:, 0, 0]


def tail_timing(det, frames, card, small_args) -> None:
    """On the tail route's quads of ``frames``: kernel 8 against
    ``grid_sample`` and its bound (CUDA events, and device time alone,
    also at the phase-3 arguments ``small_args``), and the route's warp +
    decode (window slices, kernel 8, torch Otsu and resize) against kernel
    4 (warp and decode in one launch, valid lanes only)."""
    from aruco3_tpu_torch import rectify
    from aruco3_tpu_torch.ops import warp_decode, warp_eval

    args, tail = stage_inputs(frames, det)
    win, ux, uy = args["warp_eval"]
    got = warp_eval.warp_eval(win, ux, uy)
    k_ms = cuda_ms(lambda: warp_eval.warp_eval(win, ux, uy), reps=10)
    grid = sample_grid(ux, uy)
    lib_err = float((grid_sample_eval(win, grid) - warp_eval.plain(win, ux, uy)).abs().max())
    lib_ms = cuda_ms(lambda: grid_sample_eval(win, grid), reps=10)
    b_ms, b_by = bound(*work("warp_eval", args["warp_eval"], got))
    dev = {}
    for shape, (a_win, a_ux, a_uy) in (("batch", args["warp_eval"]), ("phase3", small_args)):
        a_grid = sample_grid(a_ux, a_uy)
        dev[f"{shape}_kernel_device_ms"] = round(
            device_ms(lambda: warp_eval.warp_eval(a_win, a_ux, a_uy), reps=10,
                      kernel="warp_eval_kernel"), 4)
        dev[f"{shape}_grid_sample_device_ms"] = round(
            device_ms(lambda: grid_sample_eval(a_win, a_grid), reps=10), 4)
    grey, level1, H, quads, valid = (tail[k] for k in ("grey", "level1", "H", "quads", "valid"))
    s = int(round(ux.shape[1] ** 0.5))
    m = tail["mark"]
    h, w = grey.shape[1:]
    shapes = rectify.pyramid_level_shapes(h, w, rectify.num_levels(h, w))

    def tail_warp():
        patches = rectify.warp_patches_mxu(grey, level1, H, quads, s)
        return rectify.otsu_cells(patches.reshape(-1, s, s), m)

    def kernel4():
        lvl, tlx, tly = rectify.warp_windows(quads, shapes)
        return warp_decode.warp_decode(grey, rectify.upper_levels(level1, shapes),
                                       H.contiguous(), lvl, tlx, tly, valid, s, m)

    tail_ms = cuda_ms(tail_warp, reps=5)
    k4_ms = cuda_ms(kernel4, reps=5)
    log("timing warp_eval at batch", path="noref", card=repr(card), batch=grey.shape[0],
        lanes=ux.shape[0], kernel_ms=round(k_ms, 4), grid_sample_ms=round(lib_ms, 4),
        grid_sample_max_abs_diff=lib_err, bound_ms=round(b_ms, 5), bound_by=b_by,
        phase3_lanes=small_args[1].shape[0], **dev)
    log("timing tail warp", path="noref", card=repr(card), batch=grey.shape[0],
        lanes=ux.shape[0], valid_lanes=int(valid.sum()), slices_kernel8_decode_ms=round(tail_ms, 4),
        kernel4_ms=round(k4_ms, 4))


def profile_path(path, det, frames, ms_per_batch, reps=3) -> None:
    """Device time per batch by kernel (torch.profiler over ``reps``
    batches after warm-up) against the CUDA-event time per batch, and the
    batch's host-to-device copies (each one a CUDA graph cannot capture
    from pageable memory)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    detect_and_pose(det, frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            detect_and_pose(det, frames)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    dev = [e for e in avg if str(e.device_type).endswith("CUDA")]
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3 / reps
    log("profile", path=path, batch=frames.shape[0], device_ms_per_batch=round(device_ms, 3),
        ms_per_batch=round(ms_per_batch, 3),
        device_idle_share=round(1.0 - device_ms / ms_per_batch, 3),
        device_ops_per_batch=round(sum(e.count for e in dev) / reps, 1),
        htod_copies_per_batch=sum(e.count for e in avg if "HtoD" in e.key) / reps)
    by_name = {}
    for e in dev:  # names cut to 60 characters; templated ones share a prefix
        by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + e.self_device_time_total / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:16]
    print(json.dumps({"profile_top": path,
                      "device_ms_per_batch": {k: round(v, 4) for k, v in top}}), flush=True)


def batch_kernel_timing(path, det, frames, card) -> dict:
    """Each kernel of the path alone on the path's phase-5 batch: device ms
    (torch.profiler, the wrapper's host time left out) beside its bound on
    the same inputs.  Returns name -> (device ms, bound ms, bound by)."""
    args, _ = stage_inputs(frames, det)
    log_fit_split(path, args)
    table = wrappers()
    out = {}
    for name, a in args.items():
        kernel = table[kernel_of(name)][0]
        got = kernel(*a)
        ms = device_ms(lambda: kernel(*a), reps=5, kernel=CUDA_NAMES[kernel_of(name)])
        b_ms, b_by = bound(*work(kernel_of(name), a, got))
        log(f"timing {name} at batch", path=path, card=repr(card), batch=frames.shape[0],
            device_ms=round(ms, 4), bound_ms=round(b_ms, 5), bound_by=b_by,
            share_of_bound=round(b_ms / ms, 3))
        out[name] = (ms, b_ms, b_by)
    return out


def route_timing(det, frames, card) -> None:
    """On the portrait coarse planes: the fused kernel 2 (fit mode) against
    the label route's labels mode + kernel 7 (the route is not switched)."""
    from aruco3_tpu_torch.ops import coarse_fit, fit, frontend

    params, _, _, ds = det.geometry(*frames.shape[1:])
    k1, k2 = params.max_candidates, params.max_inner_candidates
    coarse = frontend.threshold_open_pool(frames, det.config.threshold_window,
                                          params.open_radius, ds)[0]
    fused_ms = cuda_ms(lambda: coarse_fit.coarse_fit(coarse, params, ds), reps=10)
    labels = coarse_fit.coarse_labels(coarse, params)
    labels_ms = cuda_ms(lambda: coarse_fit.coarse_labels(coarse, params), reps=10)
    fit_ms = cuda_ms(lambda: fit.fused_fit_batch(*labels, ds, params, k1, k2, dup_skip=True),
                     reps=10)
    route_ms = cuda_ms(lambda: fit.fused_fit_batch(*coarse_fit.coarse_labels(coarse, params),
                                                   ds, params, k1, k2, dup_skip=True), reps=10)
    log("timing route", path="portrait", card=repr(card), batch=coarse.shape[0],
        grid=f"{coarse.shape[1]}x{coarse.shape[2]}", fused_kernel2_ms=round(fused_ms, 4),
        coarse_labels_ms=round(labels_ms, 4), fused_fit_ms=round(fit_ms, 4),
        label_route_ms=round(route_ms, 4))


def kernel_timing(name, path, fns, a, checked, batch, launches, card) -> dict:
    """Phase 5 for one kernel at its path's phase-3 arguments ``a``: CUDA
    events per call over 10 calls (the wrapper's host time included), device time
    alone, the plain version's time and the library call's where there is
    one, beside the bound (``checked``: phase 3's error, bytes and
    operations) and the kernel alone at the phase-5 batch (``batch``).
    Logs them and returns the kernel's row of the JSON line."""
    kernel, plain = fns
    k_ms = cuda_ms(lambda: kernel(*a), reps=10)
    dev_ms = device_ms(lambda: kernel(*a), reps=10, kernel=CUDA_NAMES[name])
    p_ms = cuda_ms(lambda: plain(*a), reps=2)
    err, bytes_, ops = checked
    b_ms, b_by = bound(bytes_, ops)
    lib_ms = None
    if name == "warp_eval":
        grid = sample_grid(a[1], a[2])
        lib_ms = cuda_ms(lambda: grid_sample_eval(a[0], grid), reps=10)
    batch_ms, batch_bound_ms, batch_bound_by = batch
    log(f"timing {name}", path=path, card=repr(card), batch=int(a[0].shape[0]), kernel_ms=round(k_ms, 4),
        device_ms=round(dev_ms, 4), plain_ms=round(p_ms, 4), bound_ms=round(b_ms, 5),
        bound_by=b_by, bytes=bytes_, ops=ops,
        library_ms=lib_ms if lib_ms is None else round(lib_ms, 4),
        phase5_batch=BATCHES[path], batch_device_ms=round(batch_ms, 4),
        batch_bound_ms=round(batch_bound_ms, 5))
    return {"name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "path": path, "device_ms": dev_ms,
            "batch": BATCHES[path], "batch_device_ms": batch_ms,
            "batch_bound_ms": batch_bound_ms, "batch_bound_by": batch_bound_by}


def path_inputs():
    """The five paths' inputs: ({path: (detector on the card, frames (n, H,
    W) u8)}, {path: ground truth [(id, corners)]})."""
    from dataclasses import replace

    from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig, render
    from aruco3_tpu_torch.models import presets

    dictionary = ARDictionary.new_from_named_dict(DICT_NAME)
    det = Detector(DetectorConfig(), dictionary, device="cuda")
    h, w = LANDSCAPE_HW
    scene, truth = render.bench_scene(dictionary, (w, h), seed=0, noise_sigma=2.0)
    extra = [render.bench_scene(dictionary, (w, h), seed=s)[0] for s in (1, 2, 3)]
    portrait = np.ascontiguousarray(np.rot90(scene))
    # np.rot90 turns the frame a quarter counter-clockwise: (x, y) -> (y, W-1-x).
    truth_p = [(mid, np.stack([c[:, 1], (w - 1) - c[:, 0]], axis=-1)) for mid, c in truth]
    pre = presets.get_preset("4k-dense-grid")
    dense_cfg = replace(pre.config, max_candidates=160)
    dense_dict = ARDictionary.new_from_named_dict(pre.dictionary)
    det_dense = Detector(dense_cfg, dense_dict, device="cuda")
    dh, dw = DENSE_HW
    boards = [grid_frame(dense_dict, dh, dw, 230, np.random.default_rng(s), 14, 9)
              for s in range(2)]
    det_noref = Detector(DetectorConfig(refine_corners=False), dictionary, device="cuda")
    small_dict = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    det_small = Detector(DetectorConfig(), small_dict, device="cuda")
    sh, sw = SMALL_HW
    smalls = np.stack([render.render_marker(small_dict, 5, (sw, sh), SMALL_QUAD, noise_sigma=2.0,
                                            rng=np.random.default_rng(s)) for s in range(4)])

    paths = {
        "landscape": (det, np.stack([scene] + extra)),
        "portrait": (det, np.stack([portrait] + [np.ascontiguousarray(np.rot90(e))
                                                 for e in extra])),
        "dense": (det_dense, np.stack([b[0] for b in boards])),
        "noref": (det_noref, np.stack([scene] + extra)),
        "small": (det_small, smalls),
    }
    truths = {"landscape": truth, "portrait": truth_p, "dense": boards[0][1], "noref": truth,
              "small": [(5, SMALL_QUAD)]}
    return paths, truths


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs an NVIDIA card")
    card = smi_line()
    log("device", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        count=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from aruco3_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    log("build", seconds=round(time.perf_counter() - t0, 3), library=_build.library_path().name)

    paths, truths = path_inputs()
    det, det_dense, det_noref, det_small = (
        paths[p][0] for p in ("landscape", "dense", "noref", "small"))
    scene, portrait = paths["landscape"][1][0], paths["portrait"][1][0]
    boards, smalls = paths["dense"][1], paths["small"][1]
    h, w = LANDSCAPE_HW
    phase3 = {}
    args_of = {}
    for path, (d, frames) in paths.items():
        args, tail = stage_inputs(torch.from_numpy(frames).cuda(), d)
        args_of[path] = args
        phase3[path] = compare_kernels(path, args, d.geometry(*frames.shape[1:])[0], tail)

    # Phase 4: each path with its own counts.
    launches_of = {}
    t16 = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(scene, (16, h, w)))).cuda()
    out, tr, launches_of["landscape"] = drive("landscape", det, t16, set(args_of["landscape"]))
    worst = check_markers(out, tr, truths["landscape"])
    log("path landscape", frames=16, markers_per_frame=int(out["marker_valid"][0].sum()),
        worst_corner_err_px=round(worst, 3))
    p16 = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(portrait, (16, w, h)))).cuda()
    out, tr, launches_of["portrait"] = drive("portrait", det, p16, set(args_of["portrait"]))
    worst_p = check_markers(out, tr, truths["portrait"])
    log("path portrait", frames=16, markers_per_frame=int(out["marker_valid"][0].sum()),
        worst_corner_err_px=round(worst_p, 3))
    del p16
    out, tr, launches_of["noref"] = drive("noref", det_noref, t16, set(args_of["noref"]))
    worst_n = check_markers(out, tr, truths["noref"], tol=NOREF_TOL_PX)
    cand_eq, cpu_s = equal_to_cpu("noref", out, det_noref, scene)
    log("path noref", frames=16, markers_per_frame=int(out["marker_valid"][0].sum()),
        worst_corner_err_px=round(worst_n, 3), cpu_reference_s=round(cpu_s, 3),
        candidates_equal_cpu=cand_eq)
    del t16
    d4 = torch.from_numpy(np.concatenate([boards] * 2)).cuda()
    out, tr, launches_of["dense"] = drive("dense", det_dense, d4, set(args_of["dense"]))
    cand_eq, cpu_s = equal_to_cpu("dense", out, det_dense, boards[0])
    found = {int(i) for i, v in zip(out["marker_id"][0].tolist(), out["marker_valid"][0].tolist())
             if v} & {mid for mid, _ in truths["dense"]}
    log("path dense", frames=4, tags_found=len(found), tags_on_board=len(truths["dense"]),
        markers_frame0=int(out["marker_valid"][0].sum()), cpu_reference_s=round(cpu_s, 3),
        candidates_equal_cpu=cand_eq)
    require(bool(torch.isfinite(tr[0][out["marker_valid"][0]]).all()), "dense: non-finite pose")
    del d4
    s16 = torch.from_numpy(np.concatenate([smalls] * 4)).cuda()
    out, tr, launches_of["small"] = drive("small", det_small, s16, set(args_of["small"]))
    worst_s = check_markers(out, tr, truths["small"])
    cand_eq, cpu_s = equal_to_cpu("small", out, det_small, smalls[0])
    log("path small", frames=16, markers_per_frame=int(out["marker_valid"][0].sum()),
        worst_corner_err_px=round(worst_s, 3), cpu_reference_s=round(cpu_s, 3),
        candidates_equal_cpu=cand_eq)
    del s16

    # Phase 5: throughput, kernel against plain version, route comparison.
    at_batch = {}
    for path, batch in BATCHES.items():
        d, frames = paths[path]
        big = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(frames[0], (batch,) + frames.shape[1:])
        )).cuda()
        ms = cuda_ms(lambda: detect_and_pose(d, big), reps=5 if batch > 16 else 3)
        log("timing", path=path, card=repr(card), batch=batch, ms_per_batch=round(ms, 3),
            frames_per_s=round(batch * 1000.0 / ms, 1))
        profile_path(path, d, big, ms)
        at_batch[path] = batch_kernel_timing(path, d, big, card)
        if path == "portrait":
            route_timing(d, big, card)
        if path == "noref":
            tail_timing(d, big, card, args_of["noref"]["warp_eval"])
        del big

    table = wrappers()
    rows = [kernel_timing(name, path, table[name], args_of[path][name], phase3[path][name],
                          at_batch[path][name], launches_of[path][name], card)
            for name, (_, _, path) in KERNELS.items()]
    # Kernels 3 and 4 on the other refine paths (their rows report landscape).
    for path in ("portrait", "dense"):
        for name in ("refine", "warp_decode"):
            kernel_timing(name, path, table[name], args_of[path][name], phase3[path][name],
                          at_batch[path][name], launches_of[path][name], card)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
