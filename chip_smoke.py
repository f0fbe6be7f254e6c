#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Five paths, each ``detect_batch_arrays`` + ``pose.solve_normalized_batch``
captured as one CUDA graph a batch shape (``pose_graph``, in the detector's
graph cache: the counterpart of bench.py's ``jax.jit(batch_fn)``), beside
the same function run eagerly (``pose_step``).  Three take the refine
route (corner refinement, kernel 4's warp):

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
   the same cell grids.  The pose kernel (``ops/ippe.py``, kernel 9; no
   TPU counterpart) poses every lane of the path's detect output, the
   marker corners over the frame's size, invalid lanes as the detector
   leaves them.  Kernels 1, 4, 8 and 9 are held to their plain versions
   bit for bit (max abs error 0.0; for kernel 9 NaN where the plain
   version has NaN), the others to 1e-3.  Kernel 2's labels mode also at
   the dense 4K cell's settings (``dense4k``: the dense boards at
   coarse_factor 10, a 216x384 grid, 16 frames): bit-equal to
   ``labels_plain``, one launch, on clusters of 8 blocks of 512 threads
   (its plan and the layout its wrapper launched; another fails).  Then
   kernels 1 (refine mode: the bfloat16 chain's level 1, and level 2 by
   ``rectify.upper_levels``), 4 (samples and cell grids at pyramid levels
   0-3) and 8 on seeded probes, bit for bit against the JAX TPU kernels'
   outputs (``tests/torch_golden/kernels.npz``: ``build_packed_pyramid``,
   the gather warp ``warp_patches_dma`` and ``warp_eval``, in interpret
   mode);
4. paths: each path's graph captured, then replayed once with every
   launch count set to 0 just before and read just after: every kernel of
   the path launched, no other and no plain version called; the graph's
   outputs equal to the eager path's on the same frames (integers and
   booleans bit-equal, floats with a max abs difference of 0.0, NaN where
   NaN).  Landscape and portrait on 16 frames: every
   ground-truth marker within 2 px with a finite pose.  Dense on 4 frames,
   noref and small on 16: frame 0 equal to the port's CPU path (ids,
   codes, rounded corners, stats); noref every marker within 12 px (its
   corners are the coarse fit's, ~ds px), small its marker within 2 px.
   Then each path's recorded frames (landscape, portrait and noref 4,
   dense 2, small 4) through the path's graph at that batch, held lane by
   lane against the JAX package's results on the same frames
   (``tests/torch_golden/paths.npz``; ``tools/torch_golden.py`` compares:
   integers bit-exact, fit-corner ties accepted and counted, poses within
   ``tests/test_pose.py``'s tolerances), every field a warp decides held
   to the decode of JAX's quads by the Pallas warp of the path's route;
   lanes where JAX's XLA warp decodes otherwise are printed and counted;
5. timing: detect + pose in frames/s (landscape, portrait and noref at
   batch 128, dense at 16, small at 512), eager and graphed in turns
   (eager, graph, graph, eager); the graph's capture ms, kernel nodes,
   pool growth and output clone ms; device ms, idle share and
   host-to-device copies per batch of both (``torch.profiler``), the
   graphed batch's device time by kernel; fails if a graphed batch makes a
   host-to-device copy or is slower than the eager one; each kernel of the path alone
   on that batch (device time, profiler) beside its bound there; each
   kernel against its plain version at its path's phase-3 shapes (CUDA
   events after warm-up, and the kernel's device time alone; kernels 3
   and 4 on each of the three refine paths; the pose kernel also at one
   frame's lanes; kernel 2's labels mode at the ``dense4k`` stage, whose
   16 frames are the batch, its row in the JSON line with its plan), on
   the portrait coarse
   planes at batch 128 the fused kernel 2 against
   labels mode + kernel 7, and on the noref quads at batch 128 kernel 8
   against ``grid_sample`` and the tail route's warp + decode against
   kernel 4's; kernel 1 alone at the benchmark's three batch cells' shapes
   (128 1080p frames at ds 10, 16 4K frames at ds 10, 64 VGA frames at ds
   4; r = 7, open radius 2, level 1 by the chain), its outputs bit-equal to
   its plain version's, its device ms beside its bound, its plain
   version's ms and the layout it launched (``frontend_layout``: rows a
   block walks, chunk rows, blocks).

Phases 6-11 drive the other entry points, each once; phase 12 the
configurations users run, phase 13 the settings they change:

6. parity: ``parity.score`` of the port's detector on the card against
   the reference oracle on 20 seeded 1080p ``ARUCO_MIP_36H12`` scenes
   (seed 5), at least 0.99, and each scene's markers held against the
   JAX package's (``tests/torch_golden/scenes.npz``: lanes, ids, codes,
   distances, rounded corners).  The scenes and the oracle's detections
   (``parity.reference_scenes``, host numpy) are made in a process of
   their own while phases 2-4 run; phase 5 waits for it;
7. stream: ``StreamPipeline`` at BASELINE config 5's shape (4 streams of
   1080x1920, batch 8, rings of 8) on the native ring: 32 frames with
   every lane equal to ``detect_batch``, then three 3-second windows with
   the rings kept full (lanes checked too), frames/s counted from the
   first completed batch, host ms per batch in each hook, beside
   ``detect_batch`` alone at batch 8 (its graph: event and device ms;
   eager: event ms); then BASELINE config 5's two-dictionary stream
   (``golden.stream_frames``: two 1080p streams of 4 frames for each of
   ``ARUCO_MIP_36H12`` and ``APRILTAG_36H11``, one pipeline a dictionary
   as ``benches/bench_configs.py:281-345`` runs them), every lane equal
   to ``detect_batch`` and held to the JAX package's results on the same
   frames (``tests/torch_golden/stream.npz``, ``golden.compare_batch``);
8. sharded: ``detect_sharded`` with pose at NCCL world size 1 (the step's
   own graph), equal to the batch's graph of detect + pose (integers and
   poses);
9. spatial: ``detect_spatial`` at NCCL world size 1 through its band
   and masks graphs, on the 1080p landscape frame and on the 8K frame
   (the noise-free landscape frame with each pixel repeated 4x4, then
   noise drawn per 8K pixel: 4320x7680, ds 40):
   outputs equal to the eager step's (integers bit for bit, floats 0.0),
   ids of ``Detector.detect`` with corners within 1 px, every truth id
   found, on both frames ``Detector.detect`` held lane by lane against
   the JAX record of its route's Pallas warp and the step against that
   of the tail warp (``tests/torch_golden/frame_8k.npz``; a lane the two
   records decode differently is printed and left out of the id
   comparison), kernels 2
   (labels), 7, 3 and 8 launched a replay and not kernel 1; ms per frame
   eager and graphed in turns, device ms, idle
   share, the graphs' capture ms, kernel nodes and pools, and
   ``Detector.detect``'s graph on the same frame.  Then the 1080p frame
   as 4 row bands in this process through ``detect_from_masks`` (held
   to the frame's tail-warp record too), and kernels 3 and 8 on that
   route against their plain versions;
10. detect_arrays: kernel 1's opened mask against its plain version, and
    ``detect_arrays`` against ``Detector.detect``, each held to its
    route's JAX record of the frame (the tail warp's, the refine warp's);
11. examples: ``examples/torch_pose_accuracy_sim.py``'s ``simulate`` for
    its 24 views on the card (translation and normal-axis error: mean,
    p95, max), every pose found finite, every view's ids equal to those
    of the same function on the CPU (run in a process of its own beside
    phases 2-4), and every view held against the JAX package's
    (``tests/torch_golden/orbit.npz``: ids, translation and normal), the
    JAX views' statistics printed beside the card's;
    ``examples/torch_detect_image.py``'s ``detect_image`` on one
    synthesized 800x600 scene, which must find its marker;
12. configs: the configurations users run, each held lane by lane against
    the JAX package's results on the same frames
    (``tests/torch_golden/configs.npz``; ``golden.config_cases`` and
    ``golden.config_frames`` make them, ``tools/torch_golden.py``'s
    docstring says where each comes from):

    - ``config1``: BASELINE config 1, one 640x480 ``ARUCO_DEFAULT`` frame
      (``benches/bench_configs.py:126-148``), ``DetectorConfig()``, batch 1;
    - ``config2``: BASELINE config 2's 64 VGA frames of 1-4 markers
      (``:151-188``), batch 64;
    - ``config2_noise``: its 64 frames of uniform noise, batch 64;
    - ``config4``: BASELINE config 4 (``:230-278``), the ``4k-dense-grid``
      preset (``aruco3_tpu/models/presets.py:47-57``: 96 lanes, its gates)
      on ``_grid_frame`` at cell 330 (a 10x7 ``APRILTAG_36H11`` grid on
      2160x3840, ``:191-217``), the one recorded frame stacked to batch 32
      as config 4 stacks it; also through ``Detector.detect_batch``
      (config 4 times detect only);
    - ``preset/reference-default`` (``aruco3_tpu/models/presets.py:32-38``)
      on config 1's frame, ``preset/low-latency-tracker`` (``:59-65``, 8
      lanes) on a 480x640 board of 12 ``APRILTAG_36H11`` tags,
      ``preset/permissive-decode`` (``:67-73``) on 8 noise frames and a
      marker with a corrupted code (``1080p-mip36h12``, ``:40-45``, is the
      landscape path);
    - ``dict/<NAME>`` for each of the 15 dictionaries (marks 6, 7, 8 and
      10), ``DetectorConfig()`` (the refine route), and
      ``dict/<NAME>:noref`` with ``refine_corners=False`` (the tail
      route): a 480x640 board of 12 tags and its mirror, batch 2;
    - ``rgb``: config 2's first 4 frames as tinted (4, 480, 640, 3) colour;
    - ``clutter``, ``clutter:noref``: 4 VGA frames of noise in 4x4 blocks,
      about a thousand components more than the 32 lanes (config 2's
      noise frames leave none after the opening), on both routes.

    Each case's frames go through its detector's detect + pose graph at
    the case's batch; one replay with every launch count set to 0 just
    before and read just after must launch the kernels of the case's route
    (fused: 1, 2 fit mode, 3, 4; tail: 1, 2 labels mode, 7, 8) and no
    other, and call no plain version; the outputs are held to the record
    as in phase 4 (``golden.compare_batch``).  One line a case: route,
    lanes, markers found, lanes equal, ties, lanes where JAX's XLA warp
    decodes otherwise.  For ``config1``, ``config2``, ``config2_noise``
    and ``config4``: event ms per batch and frames/s of the graph beside
    the eager function, in turns (eager, graph, graph, eager) after the
    capture; config 4's are ``Detector.detect_batch``'s graph (detect
    only) against ``detect_batch_arrays`` eagerly;
13. sweep: the settings users change, each held lane by lane against the
    JAX package's results on the same frames
    (``tests/torch_golden/sweep.npz``; ``golden.sweep_cases`` and
    ``golden.sweep_frames``): every field of ``DetectorConfig`` at values
    no other record takes (``threshold_window`` 3-21, ``ccl_rounds`` 1-6,
    ``coarse_factor`` 2-8, ``max_candidates`` 1-256 with kernels 5 and 6
    above 128 lanes and on a 240x320 grid, ``max_inner_candidates`` 0 and
    40, ``homography_sample_size`` 25-81 on both routes, the gates, the
    gather warp), seven odd frame shapes (97x131 to 1000x250) and four-
    and one-channel frames.  Each case's frames go through its detect +
    pose graph at their count, one replay counted as in phase 12, held as
    in phase 4; one ``[sweep case]`` line a case: route, frame, ds, grid,
    lanes, S, refine window, where kernels 2 and 6 keep their state,
    launches, differences, ties, XLA-warp lanes apart and graphed ms per
    batch.
    Every case runs; a case that fails (a wrapper's refusal included)
    fails the phase after the rest have run.

Then a ``[jax records]`` line a phase (frames, scenes or views compared and
equal, ties accepted, differences, lanes where JAX's XLA warp and the
Pallas warp decode apart), one JSON line with the kernels, the
``nvidia-smi`` line, and the last line ``{"ok": true, "device": {...}}``.
Imports no JAX.  The inputs come from ``tools/torch_golden.py``; the run
stops if a JAX record is missing, if a frame's sha256 differs from the
recorded one (make the records again with ``tools/torch_make_golden.py``
on a machine with JAX), or if any comparison finds a difference.

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
bytes are the windows, both coordinates and the samples; the pose (kernel
9) 662 per lane (its float32 operations, counted in ``csrc/pose.cu``),
whose bytes are the corners and the poses.  ``library_ms``
is one PyTorch call that computes the same function where there is one:
``grid_sample`` (bilinear, zero padding, corners aligned) for kernel 8.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
import torch_golden as golden  # noqa: E402  (the inputs, and the JAX records' comparator)

LANDSCAPE_HW, DICT_NAME, MARKER_MM = golden.LANDSCAPE_HW, golden.DICT_NAME, golden.MARKER_MM
# Noref corners are the coarse fit's, within ~ds px of the truth (the JAX
# package's worst on the landscape frame is 9.46 px).
NOREF_TOL_PX = 12.0
# Phase-3 tag of a kernel's call on the inner label plane (dense: kernels 5, 6).
INNER = ":inner"
# Kernels held to their plain versions (and to the JAX TPU kernels' records,
# ``kernel_records``) bit for bit.
EXACT_KERNELS = ("frontend", "warp_decode", "warp_eval", "ippe")
# Phase-5 batch of each path.
BATCHES = {"landscape": 128, "portrait": 128, "dense": 16, "noref": 128, "small": 512}
# Phase 3's dense 4K stage (the benchmark's apriltag36h11_4k_dense cell):
# the dense boards at coarse_factor 10, a 216x384 grid, 16 frames a batch,
# where kernel 2's labels mode runs on clusters of 8 blocks of 512 threads.
DENSE4K_DS, DENSE4K_BATCH, DENSE4K_PLAN = 10, 16, ["cluster", 8, 512]
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# The CUDA kernel each wrapper launches (its name in a profile).
CUDA_NAMES = {"frontend": "frontend_kernel", "coarse_fit": "coarse_kernel",
              "coarse_labels": "coarse_kernel", "fused_fit": "fused_fit_kernel",
              "rank_roots": "rank_roots_kernel", "fit_lanes": "fit_lanes_kernel",
              "refine": "refine_kernel", "warp_decode": "warp_decode_kernel",
              "warp_eval": "warp_eval_kernel", "ippe": "ippe_kernel"}
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
    "ippe": ("aruco3_tpu_torch/csrc/pose.cu", "none (aruco3_tpu/pose.py is XLA's)", "landscape"),
}
# Float32 operations of the pose kernel a lane (``csrc/pose.cu``).
POSE_OPS_PER_LANE = 662


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


def counters():
    """name -> Counter of every kernel wrapper."""
    from aruco3_tpu_torch.ops import coarse_fit, fit, frontend, ippe, refine, warp_decode, warp_eval

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
        "ippe": ippe.count,
    }


def wrappers():
    """name -> (kernel wrapper, plain version on the same arguments)."""
    from aruco3_tpu_torch import segment
    from aruco3_tpu_torch.ops import coarse_fit, fit, frontend, ippe, refine, warp_decode, warp_eval

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
        "ippe": (ippe.solve, ippe.plain),
    }


def stage_inputs(frames, det):
    """The path's intermediate tensors for ``frames``: (name -> the
    arguments each kernel of the path gets, on the detector's route; the
    tail route's warp inputs, or None on the refine route).  The pose
    kernel's are the path's marker corners over the frame's size, every
    lane, as ``pose_step`` hands them over."""
    import torch

    from aruco3_tpu_torch import detector, rectify, segment
    from aruco3_tpu_torch.ops import coarse_fit, fit, frontend, refine

    params, min_edge, min_sep, ds = det.geometry(*frames.shape[1:])
    h, w = frames.shape[1:3]
    corners = detector.detect_batch_arrays(frames, det.dictionary, det.config,
                                           *det.geometry(h, w))["marker_corners"]
    scale = torch.tensor([float(w), float(h)], device=frames.device)
    pose_args = ((corners / scale).reshape(-1, 4, 2), MARKER_MM)
    wn = segment.refine_window_size(params, ds)
    tail = detector.tail_route(params, ds)
    # Level 1 as the route takes it: the bfloat16 chain on the refine route.
    args = {"frontend": (frames, det.config.threshold_window, params.open_radius, ds, False,
                         not tail)}
    coarse, near, level1 = frontend.threshold_open_pool(*args["frontend"])
    k1, k2 = params.max_candidates, params.max_inner_candidates
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
            args["fused_fit"] = (l1, l2, ds, params, k1, k2)
        fit1, fit2 = fit.fused_fit_batch(l1, l2, ds, params, k1, k2)
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
        args["ippe"] = pose_args
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
    args["ippe"] = pose_args
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
    if name == "ippe":
        counts, err = {}, 0.0
        for key, a, b in zip(("rotations", "translations", "errors"), got, ref):
            nan_a, nan_b = torch.isnan(a), torch.isnan(b)
            counts[f"{key}_nan_mismatch"] = mismatches(nan_a, nan_b)
            diff = torch.where((a == b) | (nan_a & nan_b), 0.0, (a - b).abs())
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
        return counts, err
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
        limit = 0.0 if name in EXACT_KERNELS else 1e-3
        require(err <= limit, f"{name} ({path}): max abs error {err} above {limit}")
        out[name] = (err, *work(kernel_of(name), a, got))
    torch.cuda.synchronize()
    return out


def dense4k_inputs(det_dense, boards):
    """Kernel 2's labels-mode arguments at the dense 4K cell's settings:
    the dense path's boards (2160x3840, 160 lanes) repeated to
    ``DENSE4K_BATCH`` frames, through kernel 1 at coarse_factor
    ``DENSE4K_DS`` (a 216x384 grid) as the detector's route takes it."""
    from dataclasses import replace

    import torch

    from aruco3_tpu_torch import Detector, detector
    from aruco3_tpu_torch.ops import frontend

    det = Detector(replace(det_dense.config, coarse_factor=DENSE4K_DS), det_dense.dictionary,
                   device="cuda")
    frames = torch.from_numpy(np.concatenate([boards] * (DENSE4K_BATCH // len(boards)))).cuda()
    params, _, _, ds = det.geometry(*frames.shape[1:])
    coarse = frontend.threshold_open_pool(frames, det.config.threshold_window, params.open_radius,
                                          ds, False, not detector.tail_route(params, ds))[0]
    return coarse, params


def dense4k_check(args):
    """Phase 3's dense 4K stage: kernel 2's labels mode on ``args``
    (``dense4k_inputs``) against ``labels_plain`` on the same card tensors,
    bit for bit, in the plan ``DENSE4K_PLAN`` (raises on another, or on a
    launch other than one, counted at the launch site); returns phase 3's
    (max abs error, bytes, operations) and the launches."""
    from aruco3_tpu_torch.ops import _build, coarse_fit

    coarse, params = args
    b, hc, wc = coarse.shape
    layout, blocks, threads, _ = coarse_fit.plan(b, hc, wc, 0, _build.sm_count(coarse.device.index))
    count = coarse_fit.labels_count
    count.reset()
    got = coarse_fit.coarse_labels(*args)
    launches, launched = count.launches, count.fields.get("coarse_layout")
    counts, err = compare("coarse_labels", args, got, coarse_fit.labels_plain(*args))
    log("kernel coarse_labels", path="dense4k", batch=b, grid=f"{hc}x{wc}", layout=layout,
        blocks=blocks, threads=threads, launches=launches, max_abs_err=err, **counts)
    require([layout, blocks, threads] == DENSE4K_PLAN and launched == DENSE4K_PLAN[:2],
            f"coarse_labels (dense4k): plan {layout, blocks, threads}, launched {launched}")
    require(launches == 1, f"coarse_labels (dense4k): {launches} launches")
    require(sum(counts.values()) == 0, "coarse_labels (dense4k): outputs differ from the plain version")
    return (err, *work("coarse_labels", args, got)), launches


def kernel_records() -> None:
    """Phase 3 against the JAX TPU kernels (``tests/torch_golden/
    kernels.npz``, made by ``tools/torch_make_golden.py`` on the probes of
    ``golden.kernel_probes``): kernel 1's refine-mode level 1 and the
    chain's level 2 (``rectify.upper_levels``) against
    ``build_packed_pyramid``'s; kernel 4's samples and cell grids at
    levels 0-3 against the gather warp ``warp_patches_dma`` (its fused
    decode), through the recorded homographies: grids at marks 6, 7, 8 and
    10, samples and grids at S = 49 and 64; kernel 8 against
    ``warp_pallas.warp_eval`` (``golden.port_kernel_outputs`` on the
    card).  Each bit for bit; any difference fails."""
    rec = golden.load("kernels")
    got = golden.port_kernel_outputs("cuda")
    log("kernel probes", frame="x".join(map(str, golden.PROBE_HW)),
        lanes=got["levels"].size, levels=sorted(set(got["levels"].ravel().tolist())),
        windows=golden.PROBE_WINDOWS, marks=list(golden.PROBE_MARKS),
        patch_sides=[golden.PROBE_S, golden.PROBE_S_WIDE])
    for key in sorted(k for k in rec if k not in ("hashes", "H", "H_s64")):
        g, want = got[key], rec[key]
        require(g.shape == want.shape, f"{key}: shape {g.shape} against the record's {want.shape}")
        diff = np.abs(g.astype(np.float64) - want.astype(np.float64))
        log(f"kernel {key} vs jax tpu kernel", mismatch=int((diff != 0).sum()), of=diff.size,
            max_abs_err=float(diff.max()))
        require(not diff.any(), f"{key}: differs from the JAX TPU kernel's record")


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
    if name == "ippe":
        return nbytes(args[0], got), POSE_OPS_PER_LANE * args[0].shape[0]
    raise KeyError(name)


def bound(bytes_: int, ops: int):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pose_step(det, h, w):
    """Eager detect + pose of (B, h, w) frames: ``detect_batch_arrays``,
    then ``pose.solve_normalized_batch`` of the corners over the frame's
    size (the JAX bench's ``batch_fn``).  The scale is built here, once."""
    import torch

    from aruco3_tpu_torch import pose
    from aruco3_tpu_torch.detector import detect_batch_arrays

    dictionary, config, geometry = det.dictionary, det.config, det.geometry(h, w)
    scale = torch.tensor([float(w), float(h)], device=det.device)

    def step(frames):  # holds no detector: its graph would make a cycle
        out = detect_batch_arrays(frames, dictionary, config, *geometry)
        rot, tr, err = pose.solve_normalized_batch(out["marker_corners"] / scale, MARKER_MM)
        return out, rot, tr, err

    return step


def pose_graph(det, shape):
    """The CUDA graph of ``pose_step`` for (B, H, W[, C]) uint8 batches of
    ``shape``, in the detector's graph cache: the counterpart of bench.py's
    ``jax.jit(batch_fn)``."""
    import torch

    shape = tuple(shape)
    return det.graphs.get(("detect_and_pose",) + shape, lambda: pose_step(det, *shape[1:3]),
                          [(shape, torch.uint8)], det.device)


def tensors(tree):
    """The tensors of nested dicts and tuples, in a fixed order, by path."""
    import torch

    if torch.is_tensor(tree):
        return [("", tree)]
    if isinstance(tree, dict):
        items = sorted(tree.items())
    else:
        items = list(enumerate(tree))
    return [(f"{k}/{p}".rstrip("/"), t) for k, v in items for p, t in tensors(v)]


def graph_vs_eager(path, got, ref) -> None:
    """Graphed outputs against the eager ones on the same frames: integer
    and boolean tensors bit-equal, float tensors equal (NaN where the other
    has NaN, and a max abs difference of 0.0 elsewhere): the same kernels
    in the same order."""
    import torch

    a, b = tensors(got), tensors(ref)
    require([k for k, _ in a] == [k for k, _ in b], f"{path}: graphed outputs differ in keys")
    mism, worst = 0, 0.0
    for (key, x), (_, y) in zip(a, b):
        require(x.shape == y.shape and x.dtype == y.dtype, f"{path}: {key} differs in shape or type")
        if x.is_floating_point():
            nan_x, nan_y = torch.isnan(x), torch.isnan(y)
            mism += mismatches(nan_x, nan_y)
            ok = ~(nan_x | nan_y)
            if ok.any():
                worst = max(worst, float((x[ok] - y[ok]).abs().max()))
        else:
            mism += mismatches(x, y)
    log(f"path {path} graph vs eager", tensors=len(a), mismatches=mism, float_max_abs_diff=worst)
    require(mism == 0 and worst == 0.0, f"{path}: graphed outputs differ from eager ones")


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
    """Phase 4: one run of the path's graph (captured before) with every
    count set to 0 just before and read just after, then its outputs
    against the eager path's on the same frames; returns (out, tr,
    launches)."""
    import torch

    g = pose_graph(det, frames.shape)
    counts = counters()
    for c in counts.values():
        c.reset()
    got = g(frames)
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
    graph_vs_eager(path, got, pose_step(det, *frames.shape[1:])(frames))
    out, _, tr, _ = got
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

    def kernel4():  # on the refine route's chain levels
        lvl, tlx, tly = rectify.warp_windows(quads, shapes)
        uppers = rectify.upper_levels(rectify.level1_plane(grey, chain=True), shapes)
        return warp_decode.warp_decode(grey, uppers, H.contiguous(), lvl, tlx, tly, valid, s, m)

    tail_ms = cuda_ms(tail_warp, reps=5)
    k4_ms = cuda_ms(kernel4, reps=5)
    log("timing warp_eval at batch", path="noref", card=repr(card), batch=grey.shape[0],
        lanes=ux.shape[0], kernel_ms=round(k_ms, 4), grid_sample_ms=round(lib_ms, 4),
        grid_sample_max_abs_diff=lib_err, bound_ms=round(b_ms, 5), bound_by=b_by,
        phase3_lanes=small_args[1].shape[0], **dev)
    log("timing tail warp", path="noref", card=repr(card), batch=grey.shape[0],
        lanes=ux.shape[0], valid_lanes=int(valid.sum()), slices_kernel8_decode_ms=round(tail_ms, 4),
        kernel4_ms=round(k4_ms, 4))


def profile_run(fn, reps=3) -> dict:
    """torch.profiler over ``reps`` calls of ``fn`` after a warm-up: device
    ms, device operations and host-to-device copies per call (each such
    copy from pageable memory is one a CUDA graph cannot capture), and the
    16 largest kernel names by device ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    dev = [e for e in avg if str(e.device_type).endswith("CUDA")]
    by_name = {}
    for e in dev:  # names cut to 60 characters; templated ones share a prefix
        by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + e.self_device_time_total / 1e3 / reps
    return {"device_ms": sum(e.self_device_time_total for e in dev) / 1e3 / reps,
            "device_ops": sum(e.count for e in dev) / reps,
            "htod": sum(e.count for e in avg if "HtoD" in e.key) / reps,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:16]}


def path_timing(path, det, big, card) -> None:
    """Phase 5 for one path: detect + pose at its batch, eager and through
    its graph, CUDA-event ms per batch in turns (eager, graph, graph,
    eager); the graph's capture ms, kernel nodes and pool growth; the
    clone of its outputs alone; device ms, idle share, device operations
    and host-to-device copies per batch of each (torch.profiler).  Fails
    if the graph is slower than the eager path."""
    reps = 5 if big.shape[0] > 16 else 3
    eager = pose_step(det, *big.shape[1:])
    g = pose_graph(det, big.shape)
    e1 = cuda_ms(lambda: eager(big), reps)
    g1 = cuda_ms(lambda: g(big), reps)
    g2 = cuda_ms(lambda: g(big), reps)
    e2 = cuda_ms(lambda: eager(big), reps)
    ms, eager_ms = (g1 + g2) / 2, (e1 + e2) / 2
    batch = big.shape[0]
    log("timing", path=path, card=repr(card), batch=batch, ms_per_batch=round(ms, 3),
        frames_per_s=round(batch * 1000.0 / ms, 1), eager_ms_per_batch=round(eager_ms, 3),
        eager_frames_per_s=round(batch * 1000.0 / eager_ms, 1),
        graph_ms_runs=[round(g1, 3), round(g2, 3)], eager_ms_runs=[round(e1, 3), round(e2, 3)])
    clone_ms = cuda_ms(g.fresh, reps)
    gp = profile_run(lambda: g(big))
    ep = profile_run(lambda: eager(big))
    log("graph", path=path, card=repr(card), batch=batch, eager_event_ms=round(eager_ms, 3),
        capture_ms=round(g.capture_ms, 1), kernel_nodes=g.kernel_nodes,
        pool_mb=round(g.pool_bytes / 2**20, 1), replay_event_ms=round(ms, 3),
        device_ms=round(gp["device_ms"], 3), idle_share=round(1.0 - gp["device_ms"] / ms, 3),
        device_ops_per_batch=round(gp["device_ops"], 1), htod_copies_per_batch=gp["htod"],
        clone_ms=round(clone_ms, 4), output_mb=round(nbytes(g.outputs) / 2**20, 1),
        eager_device_ms=round(ep["device_ms"], 3),
        eager_idle_share=round(1.0 - ep["device_ms"] / eager_ms, 3),
        eager_device_ops_per_batch=round(ep["device_ops"], 1),
        eager_htod_copies_per_batch=ep["htod"])
    print(json.dumps({"profile_top": path, "device_ms_per_batch": {
        k: round(v, 4) for k, v in gp["top"]}}), flush=True)
    require(gp["htod"] == 0, f"{path}: {gp['htod']} host-to-device copies a graphed batch")
    require(ms <= eager_ms, f"{path}: the graph ({ms:.3f} ms) is slower than eager ({eager_ms:.3f} ms)")


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


# Kernel 1 at the benchmark's batch cells: (frames, height, width, ds).
FRONTEND_CELLS = {"mip36h12_1080p.batch128": (128, 1080, 1920, 10),
                  "apriltag36h11_4k_dense.batch16": (16, 2160, 3840, 10),
                  "aruco_default_vga.batch64": (64, 480, 640, 4)}


def frontend_cells_timing(det, frames, card) -> None:
    """Kernel 1 alone at each batch cell's shape (frames of that size cut
    from the 1080p ``frames``, tiled where the cell's are larger, each
    frame turned by its own offset; the refine route's mode): outputs
    bit-equal to the plain version's, device ms (profiler) beside the
    bound, the plain version's ms (CUDA events) and the layout launched."""
    import torch

    from aruco3_tpu_torch.ops import frontend

    params = det.geometry(*frames.shape[1:])[0]
    src = torch.from_numpy(np.ascontiguousarray(frames)).cuda()
    for cell, (b, h, w, ds) in FRONTEND_CELLS.items():
        tiled = src.repeat(1, -(-h // src.shape[1]), -(-w // src.shape[2]))[:, :h, :w]
        grey = torch.stack([torch.roll(tiled[i % len(tiled)], (7 * i, 13 * i), (0, 1))
                            for i in range(b)]).contiguous()
        args = (grey, det.config.threshold_window, params.open_radius, ds, False, True)
        got = frontend.threshold_open_pool(*args)
        layout = frontend.count.fields["frontend_layout"]
        ref = frontend.plain(*args)
        require(all(torch.equal(a, r) for a, r in zip(got, ref, strict=True)),
                f"frontend at {cell}: differs from its plain version")
        ms = device_ms(lambda: frontend.threshold_open_pool(*args), reps=5,
                       kernel=CUDA_NAMES["frontend"])
        p_ms = cuda_ms(lambda: frontend.plain(*args), reps=2)
        b_ms, b_by = bound(*work("frontend", args, got))
        log("timing frontend at cell", cell=cell, card=repr(card), batch=b,
            frontend_layout=layout, device_ms=round(ms, 4), plain_ms=round(p_ms, 4),
            bound_ms=round(b_ms, 5), bound_by=b_by, share_of_bound=round(b_ms / ms, 3))
        del grey, got, ref


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
    fit_ms = cuda_ms(lambda: fit.fused_fit_batch(*labels, ds, params, k1, k2),
                     reps=10)
    route_ms = cuda_ms(lambda: fit.fused_fit_batch(*coarse_fit.coarse_labels(coarse, params),
                                                   ds, params, k1, k2), reps=10)
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
    Logs them and returns the kernel's row of the JSON line.  ``batch``
    None: ``a`` is the phase-5 batch itself (the dense 4K stage)."""
    kernel, plain = fns
    k_ms = cuda_ms(lambda: kernel(*a), reps=10)
    dev_ms = device_ms(lambda: kernel(*a), reps=10, kernel=CUDA_NAMES[name])
    p_ms = cuda_ms(lambda: plain(*a), reps=2)
    err, bytes_, ops = checked
    b_ms, b_by = bound(bytes_, ops)
    phase5_batch = BATCHES.get(path, int(a[0].shape[0]))
    lib_ms = None
    if name == "warp_eval":
        grid = sample_grid(a[1], a[2])
        lib_ms = cuda_ms(lambda: grid_sample_eval(a[0], grid), reps=10)
    batch_ms, batch_bound_ms, batch_bound_by = batch or (dev_ms, b_ms, b_by)
    log(f"timing {name}", path=path, card=repr(card), batch=int(a[0].shape[0]), kernel_ms=round(k_ms, 4),
        device_ms=round(dev_ms, 4), plain_ms=round(p_ms, 4), bound_ms=round(b_ms, 5),
        bound_by=b_by, bytes=bytes_, ops=ops,
        library_ms=lib_ms if lib_ms is None else round(lib_ms, 4),
        phase5_batch=phase5_batch, batch_device_ms=round(batch_ms, 4),
        batch_bound_ms=round(batch_bound_ms, 5))
    return {"name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "path": path, "device_ms": dev_ms,
            "batch": phase5_batch, "batch_device_ms": batch_ms,
            "batch_bound_ms": batch_bound_ms, "batch_bound_by": batch_bound_by}


def path_inputs():
    """The five paths' inputs (``golden.path_frames``): ({path: (detector on
    the card, frames (n, H, W) u8)}, {path: ground truth [(id, corners)] of
    frame 0}).  Fails if a frame differs from the one the JAX records were
    made from."""
    from aruco3_tpu_torch import ARDictionary, Detector

    specs = golden.path_specs()
    frames = golden.path_frames()
    records = golden.load("paths")
    paths, truths, dets = {}, {}, {}
    for path in golden.PATHS:
        name, cfg = specs[path]
        golden.check_hashes(path, golden.subset(records, path)["hashes"], frames[path][0])
        key = (name, cfg)
        if key not in dets:
            dets[key] = Detector(cfg, ARDictionary.new_from_named_dict(name), device="cuda")
        paths[path] = (dets[key], frames[path][0])
        truths[path] = frames[path][1]
    return paths, truths, records


def jax_report(phase: str, rep, totals: dict) -> None:
    """Logs a comparison with the JAX records (counts, each accepted tie
    and each lane where JAX's XLA warp decodes otherwise than the Pallas
    warp the port is held to on a line of its own, the first differences)
    and adds its counts to ``totals``; fails on any difference."""
    log(f"{phase} vs jax", **rep.counts())
    for item, lane, fields in rep.ties:
        log(f"{phase} vs jax tie accepted", item=item, lane=lane, fields=",".join(fields))
    for item, lane in rep.warp_split:
        log(f"{phase} vs jax xla warp apart", item=item, lane=lane)
    for d in rep.differences[:20]:
        print(f"[{phase} vs jax difference] {d}", flush=True)
    t = totals.setdefault(phase.split()[0], {"compared": 0, "equal": 0, "ties_accepted": 0,
                                             "differences": 0, "xla_warp_lanes_apart": 0})
    for k in t:
        t[k] += rep.counts()[k]
    require(not rep.differences, f"{phase}: {len(rep.differences)} differences from the JAX records")


def held_to_jax(path, det, frames, records, totals) -> None:
    """Phase 4 against the JAX package: the path's recorded frames through
    the path's graph (detect + pose), every lane of every frame held
    against the record (``golden.compare_batch``)."""
    import torch

    out, rot, tr, err = pose_graph(det, frames.shape)(torch.from_numpy(frames).cuda())
    rep = golden.compare_batch(path, golden.subset(records, path), frames, out, (rot, tr, err),
                               lambda: golden.port_fits(det, frames))
    jax_report(f"path {path}", rep, totals)


# Phases 6-10: the entry points beside ``detect_batch``.
PARITY_SCENES, PARITY_SEED, PARITY_GATE = 20, 5, 0.99  # tests/test_parity.py's 1080p gate
STREAMS, STREAM_BATCH, STREAM_RING, STREAM_FRAMES = 4, 8, 8, 32  # BASELINE config 5
STREAM_WINDOW_S, STREAM_REPEATS = 3.0, 3  # the rate windows of phase 7
BANDS = 4  # row bands of the in-process spatial run
MASKS_KERNELS = ("coarse_labels", "fused_fit", "refine", "warp_eval")
SPATIAL_REPS = 5  # frames a phase-9 timing
POSE_VIEWS = 24  # the pose-accuracy example's orbit
DETECT_IMAGE_SEED = 3  # the detect-image example's synthesized scene


def parity_reference(workers: int):
    """Phase 6's reference side: the 20 seeded 1080p scenes and the
    oracle's detections (host numpy; run in a process of its own beside
    phases 2-4)."""
    from aruco3_tpu_torch import parity

    t0 = time.perf_counter()
    scenes = parity.reference_scenes(DICT_NAME, PARITY_SCENES, (LANDSCAPE_HW[1], LANDSCAPE_HW[0]),
                                     PARITY_SEED, workers)
    return scenes, time.perf_counter() - t0


def parity_phase(card, scenes, reference_s, scene_records, totals) -> None:
    """Phase 6: the port's detector on the card against the oracle on the
    reference scenes (``parity.score``, as ``parity.run_parity``), and
    scene by scene against the JAX records (``golden.compare_scenes``)."""
    from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig, parity

    t0 = time.perf_counter()
    det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict(DICT_NAME), device="cuda")
    outs = []
    res = parity.score(det, scenes, outputs=outs)
    images = [img for _, img, _, _ in scenes]
    jax_report("parity", golden.compare_scenes(
        "phase6", golden.subset(scene_records, "phase6"), images, outs,
        lambda k: golden.port_fits(det, images[k][None])), totals)
    s = res.summary()
    log("parity", card=repr(card), dictionary=DICT_NAME, scenes=res.n_scenes,
        markers=res.n_markers, oracle_found=res.oracle_found, port_found=res.tpu_found,
        both_found=res.both_found, parity=res.parity, missed=res.missed,
        port_only=res.port_only, port_corner_mean_px=s["tpu_corner_mean_px"],
        reference_seconds=round(reference_s, 1), detect_seconds=round(time.perf_counter() - t0, 1))
    require(res.oracle_found >= 0.7 * res.n_markers, "parity: the oracle found too few markers")
    require(res.parity >= PARITY_GATE, f"parity {res.parity} below {PARITY_GATE}")


def lane_markers(out, lane, ref, f) -> None:
    """Lane ``lane`` of ``out`` against frame ``f`` of ``ref``: the same
    valid lanes, ids and corners."""
    import torch

    valid = ref["marker_valid"][f]
    require(torch.equal(out["marker_valid"][lane], valid), "stream: valid lanes differ")
    for key in ("marker_id", "marker_corners"):
        require(torch.equal(out[key][lane][valid], ref[key][f][valid]), f"stream: {key} differs")


def timed_pipeline(det):
    """A ``StreamPipeline`` at BASELINE config 5's shape that records the
    host seconds of each hook, per batch, and when each batch completed."""
    from aruco3_tpu_torch.runtime import stream as rt

    class Timed(rt.StreamPipeline):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.hook_s = {"assemble": [], "dispatch": [], "sync": []}
            self.completed = []  # (perf_counter after the batch's sync, real frames)

        def _assemble(self):
            t0 = time.perf_counter()
            out = super()._assemble()
            if out[3]:
                self.hook_s["assemble"].append(time.perf_counter() - t0)
            return out

        def _dispatch(self, batch):
            t0 = time.perf_counter()
            out = super()._dispatch(batch)
            self.hook_s["dispatch"].append(time.perf_counter() - t0)
            return out

        def _sync(self, out):
            t0 = time.perf_counter()
            super()._sync(out)
            self.hook_s["sync"].append(time.perf_counter() - t0)

        def _complete(self, pending):
            super()._complete(pending)
            self.completed.append((time.perf_counter(), pending[-1]))

    h, w = LANDSCAPE_HW
    pipe = Timed(det, (h, w), n_streams=STREAMS, batch=STREAM_BATCH, ring_capacity=STREAM_RING)
    require(all(r.native for r in pipe.rings), "stream: the native ring did not build")
    return pipe


def check_lanes(items, ref, n) -> int:
    """Every real lane of the drained ``items`` against ``ref``
    (``detect_batch`` of the ``n`` frames; stream s's k-th push is frame
    (s + k) % n, and with no ring drops its seq is k).  Returns the lanes
    checked."""
    lanes = 0
    for item in items:
        require(item["outputs"]["done"].query(), "stream: a result came before its batch ended")
        for lane, (s, seq) in enumerate(zip(item["stream_ids"], item["seqs"])):
            if s >= 0:
                lane_markers(item["outputs"], lane, ref, (int(s) + int(seq)) % n)
                lanes += 1
    return lanes


def collect(pipe, items, until, deadline, whole=False) -> None:
    """Blocking drains of ``pipe.results`` into ``items`` (only the keys
    the lane check reads, unless ``whole``) until ``until()`` or the
    deadline."""
    import queue

    keep = ("marker_valid", "marker_id", "marker_corners", "done")
    while not until() and time.perf_counter() < deadline:
        try:
            item = pipe.results.get(timeout=0.05)
        except queue.Empty:
            continue
        if not whole:
            item["outputs"] = {k: item["outputs"][k] for k in keep}
        items.append(item)


def stream_check(det, frames, ref) -> int:
    """32 frames pushed before the start, every lane against ``ref``."""
    pipe = timed_pipeline(det)
    n = len(frames)
    for i in range(STREAM_FRAMES // STREAMS):
        for s in range(STREAMS):
            pipe.push(s, frames[(s + i) % n])
    items = []
    pipe.start()
    collect(pipe, items, lambda: pipe.stats.frames >= STREAM_FRAMES, time.perf_counter() + 120)
    pipe.stop()
    items += pipe.drain()
    require(pipe.stats.frames == STREAM_FRAMES, f"stream: {pipe.stats.frames} frames came out")
    lanes = check_lanes(items, ref, n)
    require(lanes == STREAM_FRAMES, f"stream: {lanes} lanes checked")
    return lanes


def stream_window(det, frames, ref) -> dict:
    """One rate window: a producer thread keeps every ring topped up (it
    pushes only into a ring that has room, so nothing is dropped) while
    the pipeline runs for STREAM_WINDOW_S seconds after its first batch
    completed.  Frames/s counts the frames of the batches completed after
    the first over the time between the first completion and the last, so
    the worker's start and the first dispatch stay outside.  Every lane
    drained is checked against ``ref``."""
    import threading

    pipe = timed_pipeline(det)
    n = len(frames)
    pushed = [0] * STREAMS
    stop = threading.Event()

    def produce():
        while not stop.is_set():
            room = False
            for s, ring in enumerate(pipe.rings):
                if len(ring) < ring.capacity:
                    pipe.push(s, frames[(s + pushed[s]) % n])
                    pushed[s] += 1
                    room = True
            if not room:
                time.sleep(0.0002)

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    items = []
    pipe.start()
    done = pipe.completed
    try:
        collect(pipe, items, lambda: len(done) > 1 and done[-1][0] - done[0][0] >= STREAM_WINDOW_S,
                time.perf_counter() + 60)
    finally:
        stop.set()
        producer.join(timeout=10)
        pipe.stop()
    items += pipe.drain()
    require(len(done) > 1 and done[-1][0] - done[0][0] >= STREAM_WINDOW_S,
            f"stream: {len(done)} batches in the 60 s limit")
    require(sum(r.dropped for r in pipe.rings) == 0, "stream: a ring dropped a frame")
    lanes = check_lanes(items, ref, n)
    t_first, t_last = done[0][0], done[-1][0]
    frames_after = sum(k for _, k in done[1:])
    return {
        "frames_per_s": frames_after / (t_last - t_first),
        "batches": len(done),
        "window_s": t_last - t_first,
        "lanes": lanes,
        "results_dropped": pipe.stats.results_dropped,
        # hook ms per batch, the first batch (pinned allocation) left out
        **{f"{k}_ms_per_batch": 1e3 * sum(v[1:]) / max(1, len(v) - 1)
           for k, v in pipe.hook_s.items()},
    }


def stream_lanes(det, frames, ref) -> dict:
    """BASELINE config 5's half for one dictionary: a ``StreamPipeline`` of
    ``golden.STREAM_PER_DICT`` streams (batch 8, rings of 8) fed stream s's
    ``golden.STREAM_DEPTH`` frames (``frames`` stream after stream), every
    lane held to ``ref`` (``detect_batch`` of the frames); returns the
    lanes' outputs in frame order, as one batch."""
    import torch

    from aruco3_tpu_torch.runtime.stream import StreamPipeline

    n, depth = len(frames), golden.STREAM_DEPTH
    pipe = StreamPipeline(det, frames.shape[1:], n_streams=golden.STREAM_PER_DICT,
                          batch=STREAM_BATCH, ring_capacity=STREAM_RING)
    require(all(r.native for r in pipe.rings), "stream: the native ring did not build")
    for k in range(depth):
        for s in range(golden.STREAM_PER_DICT):
            pipe.push(s, frames[s * depth + k])
    items = []
    pipe.start()
    collect(pipe, items, lambda: pipe.stats.frames >= n, time.perf_counter() + 120, whole=True)
    pipe.stop()
    items += pipe.drain()
    require(pipe.stats.frames == n, f"stream: {pipe.stats.frames} of {n} frames came out")
    rows = [None] * n
    for item in items:
        require(item["outputs"]["done"].query(), "stream: a result came before its batch ended")
        for lane, (s, seq) in enumerate(zip(item["stream_ids"], item["seqs"])):
            if s >= 0:
                f = int(s) * depth + int(seq)
                lane_markers(item["outputs"], lane, ref, f)
                rows[f] = (item["outputs"], lane)
    require(all(r is not None for r in rows), "stream: a frame's lane is missing")
    out = {k: torch.stack([o[k][lane] for o, lane in rows])
           for k in ("quads", "quad_valid", "marker_valid") + golden.MARKER_FIELDS}
    out["stats"] = {k: torch.stack([o["stats"][k][lane] for o, lane in rows])
                    for k in rows[0][0]["stats"]}
    return out


def stream_config5(frames_by_dict, records, totals) -> None:
    """Phase 7's check of BASELINE config 5's stream (four 1080p streams
    over two dictionaries, one pipeline a dictionary as
    ``benches/bench_configs.py:281-345`` runs them; ``golden.stream_frames``):
    each lane equal to ``detect_batch`` of its frame and held to the JAX
    record of the frames (``tests/torch_golden/stream.npz``)."""
    import torch

    from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig

    for name, frames in frames_by_dict.items():
        rec = golden.subset(records, name)
        golden.check_hashes(f"stream {name}", rec["hashes"], frames)
        det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict(name), device="cuda")
        ref = det.detect_batch(torch.from_numpy(frames).cuda())
        out = stream_lanes(det, frames, ref)
        rep = golden.compare_batch(f"stream {name}", rec, frames, out, None,
                                   lambda: golden.port_fits(det, frames))
        log("stream config5", dictionary=name, streams=golden.STREAM_PER_DICT,
            frames=len(frames), lanes_equal_detect_batch=len(frames),
            markers=int(out["marker_valid"].sum()), lanes_equal_jax=rep.lanes)
        jax_report(f"stream {name}", rep, totals)


def stream_phase(det, frames, card, config5_frames, records, totals) -> None:
    """Phase 7: ``StreamPipeline`` at BASELINE config 5's shape (4 streams
    of 1080x1920, batch 8, rings of 8) on the native ring.  A check run of
    32 frames, every lane against ``detect_batch``; then STREAM_REPEATS
    rate windows of STREAM_WINDOW_S seconds each with the rings kept full
    (their lanes checked too), beside ``detect_batch`` alone at batch 8
    on frames already on the card: its event time (the graph's copy,
    replay and clones) and its device time, and the eager
    ``detect_batch_arrays``'s event time (host launch loop included).
    Then BASELINE config 5's two-dictionary stream against ``detect_batch``
    and the JAX records (``stream_config5``)."""
    import statistics

    import torch

    from aruco3_tpu_torch.detector import detect_batch_arrays

    ref = det.detect_batch(torch.from_numpy(frames).cuda())
    b8 = torch.from_numpy(np.concatenate([frames, frames])).cuda()
    batch_ms = cuda_ms(lambda: det.detect_batch(b8), reps=10)
    batch_device_ms = device_ms(lambda: det.detect_batch(b8), reps=10)
    geometry = det.geometry(*b8.shape[1:])
    eager_ms = cuda_ms(lambda: detect_batch_arrays(b8, det.dictionary, det.config, *geometry),
                       reps=10)
    del b8
    lanes = stream_check(det, frames, ref)
    log("stream check", streams=STREAMS, batch=STREAM_BATCH, frames=STREAM_FRAMES,
        native_ring=True, lanes_equal_detect_batch=lanes)
    rates = []
    for run in range(STREAM_REPEATS):
        r = stream_window(det, frames, ref)
        rates.append(r["frames_per_s"])
        log("stream window", run=run, card=repr(card),
            **{k: (round(v, 3) if isinstance(v, float) else v) for k, v in r.items()})
    med = statistics.median(rates)
    log("stream", card=repr(card), streams=STREAMS, batch=STREAM_BATCH, windows=STREAM_REPEATS,
        window_s=STREAM_WINDOW_S, frames_per_s_median=round(med, 1),
        frames_per_s_min=round(min(rates), 1), frames_per_s_max=round(max(rates), 1),
        spread=round((max(rates) - min(rates)) / med, 3),
        ms_per_batch_median=round(1e3 * STREAM_BATCH / med, 3),
        detect_batch_event_ms=round(batch_ms, 3), detect_batch_device_ms=round(batch_device_ms, 3),
        detect_batch_eager_event_ms=round(eager_ms, 3))
    stream_config5(config5_frames, records, totals)


def sharded_phase(det, frames) -> None:
    """Phase 8: ``detect_sharded`` with pose at NCCL world size 1 (its own
    graph of detect + pose) against the batch's ``pose_graph``."""
    import torch

    from aruco3_tpu_torch.parallel import sharding

    batch = torch.from_numpy(frames).cuda()
    got = sharding.detect_sharded(det, batch, with_pose=True)
    out, rot, tr, err = pose_graph(det, batch.shape)(batch)
    ref = dict(out, pose_rotations=rot, pose_translations=tr, pose_errors=err)
    valid = ref["marker_valid"]
    mism = {k: mismatches(got[k], ref[k]) for k in ("marker_valid", "marker_id", "marker_dist",
                                                    "marker_code")}
    mism["marker_corners"] = mismatches(got["marker_corners"][valid], ref["marker_corners"][valid])
    pose_diff = max(float((got[k][valid] - ref[k][valid]).abs().max()) for k in sharding.POSE_KEYS)
    log("sharded", backend="nccl", world=1, frames=len(frames), markers=int(valid.sum()),
        pose_max_abs_diff=pose_diff, **{f"{k}_mismatch": v for k, v in mism.items()})
    require(sum(mism.values()) == 0, "sharded: outputs differ from detect_batch")
    require(pose_diff == 0.0, f"sharded: poses differ by {pose_diff}")


def masks_stage_inputs(grey, black, coarse, det):
    """Kernels 3 and 8's arguments on the masks route (``detect_from_masks``)
    of (B, H, W) grey frames and their masks, and the tail route's warp
    inputs for ``compare``."""
    import torch

    from aruco3_tpu_torch import rectify, segment
    from aruco3_tpu_torch.ops import coarse_fit, fit, refine
    from aruco3_tpu_torch.parallel import sharding

    params, min_edge, min_sep, ds = sharding.parallel_geometry(det.config, *grey.shape[1:])
    k1, k2 = params.max_candidates, params.max_inner_candidates
    l1, l2 = coarse_fit.coarse_labels(coarse, params)
    fit1, fit2 = fit.fused_fit_batch(l1, l2, ds, params, k1, k2)
    cand = segment.merge_fits(fit1, fit2, params, ds)
    ic = segment.inner_footprint(l2) if k2 > 0 else torch.zeros_like(coarse)
    args = {"refine": (grey, segment.near_mask(black), cand["quads"].contiguous(),
                       cand["centroids"].contiguous(), ic, cand["is_inner"].contiguous(),
                       cand["valid"].contiguous(), ds, segment.refine_window_size(params, ds))}
    quads, valid, _ = segment.finalize_quads(refine.refine_corners(*args["refine"]), cand["valid"],
                                             cand["sizes"], cand["overflow"], params, min_edge,
                                             min_sep)
    s = det.config.homography_sample_size
    H, h_valid = rectify.homography_square_to_quad(quads, s)
    windows, ux, uy, bad = rectify.warp_setup(grey, rectify.level1_plane(grey), H, quads, s)
    args["warp_eval"] = (windows.reshape(-1, rectify.WARP_WIN, rectify.WARP_WIN),
                         ux.reshape(-1, s * s), uy.reshape(-1, s * s))
    return args, params, {"valid": valid & h_valid, "bad": bad.reshape(-1, s * s),
                          "mark": det.dictionary.get_mark_size()}


def counted(path, fn, kernels):
    """``fn()`` with every launch count set to 0 just before and read just
    after: the kernels named launched, no other and no plain version."""
    import torch

    counts = counters()
    for c in counts.values():
        c.reset()
    out = fn()
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counts.items()}
    log(f"path {path} counts", **{f"launches_{k}": v for k, v in launches.items()})
    for name, c in counts.items():
        require((c.launches > 0) == (name in kernels),
                f"{path}: kernel {name} launched {c.launches} times")
        require(c.plain_calls == 0, f"{path}: the plain version of {name} ran")
    return out


def same_markers(path, out, ref, apart=()) -> float:
    """The valid ids of a single-frame output against those of
    ``Detector.detect``'s (``ref``, a frame of ``detect_batch``), corners
    within 1 px; returns the worst corner difference.  Lanes in ``apart``,
    where the JAX records of the two routes' Pallas warps decode
    differently (the spatial step decodes through kernel 8, the detector
    through kernel 4; each side is held to its own record beforehand), are
    printed and left out."""
    if apart:
        log(f"{path} lanes apart", lanes=list(apart))

    def markers(o):
        return sorted((int(i), c.tolist()) for k, (i, c, v) in enumerate(zip(
            o["marker_id"].cpu().numpy(), o["marker_corners"].cpu().numpy(),
            o["marker_valid"].cpu().numpy())) if v and k not in apart)

    got, ref = markers(out), markers(ref)
    require([i for i, _ in got] == [i for i, _ in ref],
            f"{path}: ids {[i for i, _ in got]} against {[i for i, _ in ref]}")
    worst = max((float(np.abs(np.array(a) - np.array(b)).max()) for (_, a), (_, b) in zip(got, ref)),
                default=0.0)
    require(worst <= 1.0, f"{path}: corners {worst} px from Detector.detect")
    return worst


def batched(frame_out: dict) -> dict:
    """A single-frame output with a batch axis of 1 (for the comparator)."""
    return {k: v[None] for k, v in frame_out.items() if hasattr(v, "shape")}


def spatial_records(label, det, frame, rec, outs, totals) -> tuple:
    """``Detector.detect``'s lanes on ``frame`` held to the JAX record of
    the frame's refine-route Pallas warp, and each single-frame output of
    the tail warp's route in ``outs`` (name -> output) to its tail-warp
    record (``golden.compare_scenes``); returns the lanes where the two
    records decode differently."""
    import torch

    grey = torch.from_numpy(frame).cuda()
    fits = lambda k: golden.port_fits(det, frame[None])  # noqa: E731
    jax_report(f"spatial {label} detect", golden.compare_scenes(
        label, rec, [frame], [det.detect_batch(grey[None])], fits), totals)
    for name, out in outs.items():
        jax_report(f"spatial {label} {name}", golden.compare_scenes(
            label, rec, [frame], [batched(out)], fits, decode="tail"), totals)
    return tuple(golden.scene_lanes_apart(rec, 0, "pallas/", "tail/"))


def spatial_size(label, det, frame, truth_ids, card, record, totals) -> None:
    """Phase 9 at one frame size: ``detect_spatial`` at NCCL world size 1
    through its band and masks graphs (captured first), one replay with
    the counts set to 0 just before and read just after, its outputs
    against the eager step's (``graphs=False``) and its ids and corners
    against ``Detector.detect``'s, every truth id found, and both held to
    the JAX record of the frame (``spatial_records``: ``Detector.detect``
    to its refine-route Pallas warp's decode, the step to the tail
    warp's); then ms per frame,
    eager and graphed in turns (eager, graph, graph, eager; CUDA events),
    device ms, idle share and device operations per frame of each
    (torch.profiler), the two graphs' capture ms, kernel nodes and pool
    growth, and ``Detector.detect``'s graph on the same frame."""
    import torch

    from aruco3_tpu_torch.detector import frame_of
    from aruco3_tpu_torch.parallel import spatial

    grey = torch.from_numpy(frame).cuda()
    h, w = frame.shape
    eager_step = spatial.build_spatial_detect(det, h, w, graphs=False)

    def graphed():
        return spatial.detect_spatial(det, grey)

    def eager():
        return eager_step(grey)

    graphed()  # captures the band and masks graphs
    out = counted(f"spatial {label}", graphed, MASKS_KERNELS)
    launches = sum(c.launches for c in counters().values())
    graph_vs_eager(f"spatial {label}", out, eager())
    single = det.detect(frame)
    apart = spatial_records(label, det, frame, record, {"step": out}, totals)
    worst = same_markers(f"spatial {label}", out, frame_of(det.detect_batch(grey[None]), 0),
                         apart)
    ids = {m.id for m in single.markers}
    require(truth_ids <= ids, f"spatial {label}: truth ids {sorted(truth_ids - ids)} missed")
    e1 = cuda_ms(eager, SPATIAL_REPS)
    g1 = cuda_ms(graphed, SPATIAL_REPS)
    g2 = cuda_ms(graphed, SPATIAL_REPS)
    e2 = cuda_ms(eager, SPATIAL_REPS)
    ms, eager_ms = (g1 + g2) / 2, (e1 + e2) / 2
    gp = profile_run(graphed)
    ep = profile_run(eager)
    detect_ms = cuda_ms(lambda: det.detect_batch(grey[None]), SPATIAL_REPS)
    detect_dev = profile_run(lambda: det.detect_batch(grey[None]))
    graphs = {k[0]: g for k, g in det.graphs.graphs.items()
              if k[0] in ("spatial_band", "spatial_masks") and k[1:3] == (h, w)}
    band, masks = graphs["spatial_band"], graphs["spatial_masks"]
    log("spatial", size=label, card=repr(card), frame=f"{h}x{w}",
        ds=det.geometry(h, w)[3], ids=sorted(ids), truth_ids_found=len(truth_ids),
        worst_corner_diff_px=worst, event_ms=round(ms, 4), eager_event_ms=round(eager_ms, 4),
        graph_ms_runs=[round(g1, 4), round(g2, 4)], eager_ms_runs=[round(e1, 4), round(e2, 4)],
        device_ms=round(gp["device_ms"], 4), eager_device_ms=round(ep["device_ms"], 4),
        idle_share=round(1.0 - gp["device_ms"] / ms, 3),
        eager_idle_share=round(1.0 - ep["device_ms"] / eager_ms, 3),
        kernel_launches_per_frame=launches, device_ops_per_frame=round(gp["device_ops"], 1),
        eager_device_ops_per_frame=round(ep["device_ops"], 1),
        htod_copies_per_frame=gp["htod"],
        band_capture_ms=round(band.capture_ms, 1), band_kernel_nodes=band.kernel_nodes,
        band_pool_mb=round(band.pool_bytes / 2**20, 1),
        masks_capture_ms=round(masks.capture_ms, 1), masks_kernel_nodes=masks.kernel_nodes,
        masks_pool_mb=round(masks.pool_bytes / 2**20, 1),
        detect_event_ms=round(detect_ms, 4), detect_device_ms=round(detect_dev["device_ms"], 4))
    print(json.dumps({"profile_top": f"spatial {label}", "device_ms_per_frame": {
        k: round(v, 4) for k, v in gp["top"]}}), flush=True)


def spatial_phase(det, scene, truth, card, record_8k, totals) -> None:
    """Phase 9: ``spatial_size`` on the 1080p landscape frame and on the
    8K frame (``golden.frame_8k``: 4320x7680, ds 40), each held to its
    JAX record in ``record_8k``; then the 1080p frame as 4 row bands in
    this process (each band's halo cut from the frame, as the exchange
    delivers it) through ``detect_from_masks`` eagerly, against
    ``Detector.detect`` and the frame's tail-warp record, with the masks
    route's launches; kernels 3 and 8 on that route against their plain
    versions."""
    import torch

    from aruco3_tpu_torch import segment
    from aruco3_tpu_torch.detector import detect_from_masks, frame_of
    from aruco3_tpu_torch.parallel import sharding, spatial

    truth_ids = {mid for mid, _ in truth}
    rec_1080p = golden.subset(record_8k, "1080p")
    spatial_size("1080p", det, scene, truth_ids, card, rec_1080p, totals)
    spatial_size("8K", det, golden.frame_8k(det.dictionary), truth_ids, card,
                 golden.subset(record_8k, "8k"), totals)
    h, w = scene.shape
    grey = torch.from_numpy(scene).cuda()
    params, min_edge, min_sep, ds = sharding.parallel_geometry(det.config, h, w)
    require(h % (BANDS * ds) == 0, f"spatial: {h} rows in {BANDS} bands of whole cells")
    window = det.config.threshold_window
    halo = window + 2 * spatial.OPEN_RADIUS
    hs = h // BANDS
    zeros = torch.zeros((halo, w), dtype=torch.uint8, device=grey.device)
    padded = torch.cat([zeros, grey, zeros])
    black = torch.cat([spatial._threshold_open_tile(padded[r * hs : r * hs + hs + 2 * halo],
                                                    r * hs, h, w, window, spatial.OPEN_RADIUS,
                                                    halo) for r in range(BANDS)])
    coarse = segment.pool_black(black.reshape(BANDS, hs, w), ds).reshape(-1, (w + ds - 1) // ds)
    bands = counted("spatial bands", lambda: frame_of(detect_from_masks(
        grey[None], black[None], coarse[None], det.dictionary, det.config, params, min_edge,
        min_sep, ds), 0), MASKS_KERNELS)
    apart = spatial_records("1080p", det, scene, rec_1080p, {"bands": bands}, totals)
    worst_b = same_markers("spatial bands", bands, frame_of(det.detect_batch(grey[None]), 0),
                           apart)
    log("spatial bands", backend="nccl", world=1, bands=BANDS, halo=halo,
        bands_worst_corner_diff_px=worst_b)
    args, params, tail = masks_stage_inputs(grey[None], black[None], coarse[None], det)
    compare_kernels("spatial", args, params, tail)


def detect_arrays_phase(det, scene, record, totals) -> None:
    """Phase 10: kernel 1's opened black mask (and its other outputs)
    against the plain version on the landscape frame, and
    ``detector.detect_arrays`` (the masks route: the tail warp) against
    ``Detector.detect``, each held to its route's JAX record of the frame
    (``spatial_records``)."""
    import torch

    from aruco3_tpu_torch.detector import detect_arrays, frame_of
    from aruco3_tpu_torch.ops import frontend

    h, w = scene.shape
    grey = torch.from_numpy(scene).cuda()
    params, min_edge, min_sep, ds = det.geometry(h, w)
    a = (grey[None], det.config.threshold_window, params.open_radius, ds)
    got = frontend.threshold_open_pool(*a, opened=True)
    ref = frontend.plain(*a, opened=True)
    mism = {f"{k}_mismatch": mismatches(x, y)
            for k, x, y in zip(("coarse", "near", "level1", "opened"), got, ref)}
    require(sum(mism.values()) == 0, "detect_arrays: kernel 1 differs from its plain version")
    out = counted("detect_arrays", lambda: detect_arrays(
        grey, det.dictionary, det.config, params, min_edge, min_sep, ds),
        ("frontend",) + MASKS_KERNELS)
    apart = spatial_records("1080p", det, scene, record, {"detect_arrays": out}, totals)
    worst = same_markers("detect_arrays", out, frame_of(det.detect_batch(grey[None]), 0), apart)
    log("detect_arrays", opened_pixels=int(got[3].sum()), worst_corner_diff_px=worst, **mism)


def examples():
    """The port's example scripts (``examples/torch_*.py``) as modules."""
    path = str(Path(__file__).resolve().parent / "examples")
    if path not in sys.path:
        sys.path.insert(0, path)
    import torch_detect_image
    import torch_pose_accuracy_sim

    return torch_pose_accuracy_sim, torch_detect_image


def pose_sim_cpu():
    """Phase 11's CPU side: the pose-accuracy example's orbit detected on
    the CPU (run in a process of its own beside phases 2-4)."""
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    return examples()[0].simulate(POSE_VIEWS, device="cpu"), time.perf_counter() - t0


def stats_of(errs) -> dict:
    """Mean, 95th percentile and max of an error array (None if empty)."""
    if not len(errs):
        return {"mean": None, "p95": None, "max": None}
    return {"mean": round(float(errs.mean()), 4), "p95": round(float(np.percentile(errs, 95)), 4),
            "max": round(float(errs.max()), 4)}


def examples_phase(cpu, cpu_s, orbit_records, totals) -> None:
    """Phase 11: the pose-accuracy example (``simulate``: render, detect,
    IPPE through the camera, compare) for its 24 views on the card: every
    pose found finite, each view's ids equal to the CPU run's of the same
    function, and each view held against the JAX records (ids, translation
    and normal: ``golden.compare_views``), the JAX views' error statistics
    beside the card's; then the detect-image example on one synthesized
    800x600 scene, whose marker it must find."""
    sim, detect_image = examples()
    t0 = time.perf_counter()
    res = sim.simulate(POSE_VIEWS, device="cuda")
    card_s = time.perf_counter() - t0
    for i, v in enumerate(res["views"]):
        if v["translation"] is not None:
            require(bool(np.isfinite(v["translation"]).all() and np.isfinite(v["normal"]).all()),
                    f"pose sim: view {i} has a non-finite pose")
    same_ids = sum(a["ids"] == b["ids"] for a, b in zip(res["views"], cpu["views"]))
    t, r = stats_of(res["t_errs"]), stats_of(res["r_errs"])
    rec = golden.subset(orbit_records, "orbit")
    jax = golden.view_stats(rec)
    log("pose sim", views=len(res["views"]), detected=res["detected"],
        cpu_detected=cpu["detected"], jax_detected=jax["detected"], views_ids_equal_cpu=same_ids,
        **{f"t_err_mm_{k}": v for k, v in t.items()},
        **{f"jax_t_err_mm_{k}": jax[f"t_err_{k}"] for k in t},
        **{f"normal_err_deg_{k}": v for k, v in r.items()},
        **{f"jax_normal_err_deg_{k}": jax[f"r_err_{k}"] for k in r},
        card_seconds=round(card_s, 2), cpu_seconds=round(cpu_s, 2))
    require(same_ids == len(cpu["views"]) == len(res["views"]),
            f"pose sim: ids of {same_ids} of {len(res['views'])} views equal to the CPU run's")
    for i, (v, t_err, r_err) in enumerate(zip(res["views"], rec["t_err"], rec["r_err"])):
        log("pose sim view", view=i, ids=v["ids"], t_err_mm=v["t_err_mm"], jax_t_err_mm=float(t_err),
            normal_err_deg=v["r_err_deg"], jax_normal_err_deg=float(r_err))
    frames = [v["image"] for v in res["views"]]
    jax_report("pose sim", golden.compare_views("orbit", rec, frames, res["views"]), totals)
    out = Path(__file__).resolve().parent / "build" / "smoke_detected.ppm"
    out.parent.mkdir(exist_ok=True)
    got = detect_image.detect_image(device="cuda", rng=np.random.default_rng(DETECT_IMAGE_SEED),
                                    out=str(out))
    mid = got["truth"][0]
    ids = [m.id for m in got["detection"].markers]
    log("detect image", truth_id=mid, ids=ids, candidates=len(got["detection"].candidates))
    require(mid in ids, f"detect image: marker {mid} not found ({ids})")


CONFIG_TIMED = ("config1", "config2", "config2_noise", "config4")  # phase 12's timed cases


def case_kernels(det, shape):
    """(route, kernels) of a (B, H, W[, C]) batch through the detector's
    detect + pose graph: "tail" (kernel 1, kernel 2's labels mode, kernel 7
    or kernels 5 and 6, kernel 8; not 8 with ``warp_impl="gather"``),
    "fused" (kernels 1, 2 in fit mode, 3 and 4) or "labels" (kernels 1, 2
    in labels mode, 7 or 5 and 6, 3 and 4); the pose kernel on every
    route."""
    from aruco3_tpu_torch.ops.fit import MAX_LANES

    h, w = shape[1:3]
    params = det.geometry(h, w)[0]
    k1, k2 = params.max_candidates, params.max_inner_candidates
    fits = {"fused_fit"} if max(k1, k2) <= MAX_LANES else {"rank_roots", "fit_lanes"}
    route = det.route(h, w)
    if route == "tail":
        warp = set() if det.config.warp_impl == "gather" else {"warp_eval"}
        return "tail", {"frontend", "coarse_labels", "ippe"} | warp | fits
    if route == "fused":
        return "fused", {"frontend", "coarse_fit", "refine", "warp_decode", "ippe"}
    return "labels", {"frontend", "coarse_labels", "refine", "warp_decode", "ippe"} | fits


def config_timing(name, eager, graphed, frames, card) -> None:
    """Phase 12's timing of one case: CUDA-event ms per batch of the graph
    and of the eager function in turns (eager, graph, graph, eager; 5
    calls a timing after a warm-up), and frames/s."""
    e1 = cuda_ms(lambda: eager(frames), 5)
    g1 = cuda_ms(lambda: graphed(frames), 5)
    g2 = cuda_ms(lambda: graphed(frames), 5)
    e2 = cuda_ms(lambda: eager(frames), 5)
    ms, eager_ms = (g1 + g2) / 2, (e1 + e2) / 2
    batch = frames.shape[0]
    log("configs timing", case=name, card=repr(card), batch=batch, ms_per_batch=round(ms, 4),
        frames_per_s=round(batch * 1000.0 / ms, 1), eager_ms_per_batch=round(eager_ms, 4),
        eager_frames_per_s=round(batch * 1000.0 / eager_ms, 1),
        graph_ms_runs=[round(g1, 4), round(g2, 4)], eager_ms_runs=[round(e1, 4), round(e2, 4)])


def configs_phase(card, totals) -> None:
    """Phase 12: each case of ``golden.config_cases`` through its
    detector's detect + pose graph at the case's batch, one counted replay,
    held to ``configs.npz``; config 4 also through ``Detector.detect_batch``;
    the timed cases' graphs against their eager functions."""
    import torch

    from aruco3_tpu_torch import ARDictionary, Detector
    from aruco3_tpu_torch.detector import detect_batch_arrays

    records = golden.load("configs")
    for name, case in golden.config_cases().items():
        t0 = time.perf_counter()
        frames = golden.config_frames(name)
        rec = golden.subset(records, name)
        golden.check_hashes(name, rec["hashes"], frames)
        recorded = len(frames)
        if case.batch != recorded:
            rec = golden.stacked(rec, case.batch)
            frames = np.broadcast_to(frames, (case.batch,) + frames.shape[1:])
        det = Detector(case.config, ARDictionary.new_from_named_dict(case.dictionary),
                       device="cuda")
        batch = torch.from_numpy(np.ascontiguousarray(frames)).cuda()
        route, kernels = case_kernels(det, batch.shape)
        g = pose_graph(det, batch.shape)  # warm-up and capture
        out, rot, tr, err = counted(f"configs {name}", lambda: g(batch), kernels)

        def fits():
            return golden.port_fits(det, frames)

        rep = golden.compare_batch(name, rec, frames, out, (rot, tr, err), fits)
        jax_report(f"configs {name}", rep, totals)
        if case.detect_only:
            det.detect_batch(batch)  # its graph's warm-up and capture, then a replay
            got = counted(f"configs {name} detect_batch", lambda: det.detect_batch(batch),
                          kernels - {"ippe"})
            jax_report(f"configs {name} detect_batch",
                       golden.compare_batch(name, rec, frames, got, None, fits), totals)
        log("configs case", case=name, dictionary=case.dictionary, route=route,
            mark=det.dictionary.get_mark_size(), frames_recorded=recorded, batch=case.batch,
            lanes=int(out["quad_valid"].shape[1]), quads=int(out["quad_valid"].sum()),
            markers=int(out["marker_valid"].sum()), lanes_equal=rep.lanes, ties=len(rep.ties),
            xla_warp_lanes_apart=len(rep.warp_split), seconds=round(time.perf_counter() - t0, 2))
        if name in CONFIG_TIMED:
            if case.detect_only:
                dictionary, config, geometry = det.dictionary, det.config, det.geometry(
                    *batch.shape[1:3])
                config_timing(name, lambda f: detect_batch_arrays(f, dictionary, config, *geometry),
                              det.detect_batch, batch, card)
            else:
                config_timing(name, pose_step(det, *batch.shape[1:3]), g, batch, card)
        del det, g, batch, out, rot, tr, err
        torch.cuda.empty_cache()


def layouts(route, kernels, params, b, hc, wc) -> dict:
    """Where kernel 2 (and kernel 6, where it runs) keeps the state of b
    frames of the case's grid: kernel 2's plan (its layout, "smem",
    "cluster" or "scratch", blocks a frame and device scratch in ints a
    frame), kernel 6's on chip (shared memory) or not and its device
    scratch in ints a block, as the library's layouts say."""
    from aruco3_tpu_torch.ops import _build, coarse_fit

    kr = coarse_fit.fit_pool(params, hc * wc) if route == "fused" else 0
    layout, blocks, _, ints = coarse_fit.plan(b, hc, wc, kr, _build.sm_count(0))
    out = {"coarse_layout": layout, "coarse_blocks": blocks, "coarse_scratch_ints": ints}
    if "fit_lanes" in kernels:
        smem, ints = _build.layout("a3_lanes_layout", hc, wc)
        out.update(fit_lanes_on_chip=smem > 0, fit_lanes_scratch_ints=ints)
    return out


def sweep_case(name, case, records, card, totals) -> None:
    """Phase 13 for one case of ``golden.sweep_cases``: its recorded
    frames through the detector's detect + pose graph at their count, one
    replay counted (the route's kernels, no other, no plain version), held
    to ``sweep.npz`` (``golden.compare_batch``), then the graph's event ms
    per batch."""
    import torch

    from aruco3_tpu_torch import ARDictionary, Detector, segment

    t0 = time.perf_counter()
    frames = golden.sweep_frames(name)
    rec = golden.subset(records, name)
    golden.check_hashes(name, rec["hashes"], frames)
    det = Detector(case.config, ARDictionary.new_from_named_dict(case.dictionary), device="cuda")
    batch = torch.from_numpy(frames).cuda()
    route, kernels = case_kernels(det, batch.shape)
    h, w = frames.shape[1:3]
    params, _, _, ds = det.geometry(h, w)
    hc, wc = -(-h // ds), -(-w // ds)
    g = pose_graph(det, batch.shape)  # warm-up and capture
    out, rot, tr, err = counted(f"sweep {name}", lambda: g(batch), kernels)
    launches = {k: c.launches for k, c in counters().items() if c.launches}
    rep = golden.compare_batch(name, rec, frames, out, (rot, tr, err),
                               lambda: golden.port_fits(det, frames))
    ms = cuda_ms(lambda: g(batch), 5)
    log("sweep case", case=name, card=repr(card), route=route, frames=len(frames),
        frame="x".join(str(v) for v in frames.shape[1:]), ds=ds, grid=f"{hc}x{wc}",
        grid_cells=hc * wc, lanes=int(out["quad_valid"].shape[1]),
        inner_lanes=params.max_inner_candidates, sample_size=det.config.homography_sample_size,
        threshold_window=det.config.threshold_window, ccl_rounds=params.ccl_rounds,
        refine_window=segment.refine_window_size(params, ds) if "refine" in launches else None,
        **layouts(route, kernels, params, len(frames), hc, wc),
        **{f"launches_{k}": v for k, v in launches.items()},
        quads=int(out["quad_valid"].sum()), markers=int(out["marker_valid"].sum()),
        lanes_equal=rep.lanes, differences=len(rep.differences), ties=len(rep.ties),
        xla_warp_lanes_apart=len(rep.warp_split), graph_ms_per_batch=round(ms, 4),
        seconds=round(time.perf_counter() - t0, 2))
    jax_report(f"sweep {name}", rep, totals)


def sweep_phase(card, records, totals) -> None:
    """Phase 13: every case of ``golden.sweep_cases`` (``sweep_case``)
    against ``records`` (``sweep.npz``), each in turn whatever the one
    before it did; fails at the end if any case failed, a wrapper's
    refusal included."""
    import torch

    failed = []
    for name, case in golden.sweep_cases().items():
        try:
            sweep_case(name, case, records, card, totals)
        except (AssertionError, ValueError, RuntimeError) as e:
            failed.append(name)
            print(f"[sweep failed] case={name} {type(e).__name__}: {e}", flush=True)
        torch.cuda.empty_cache()
    log("sweep", cases=len(golden.sweep_cases()), failed=len(failed))
    require(not failed, f"sweep: {len(failed)} cases failed: {failed}")


def main() -> int:
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs an NVIDIA card")
    import aruco3_tpu_torch  # noqa: F401  (fails at once outside a checkout)

    # Phase 6's reference side renders and runs the oracle on the host
    # beside phases 2-4, and so does phase 11's CPU run; phase 5 starts
    # after both have ended, so that its timings have the host to
    # themselves.
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as bg:
        reference = bg.submit(parity_reference, max(1, (os.cpu_count() or 3) - 2))
        pose_cpu = bg.submit(pose_sim_cpu)
        return run(reference, pose_cpu, bg.submit(golden.stream_frames))


def run(reference, pose_cpu, stream_frames) -> int:
    import torch

    card = smi_line()
    log("device", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        count=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from aruco3_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    log("build", seconds=round(time.perf_counter() - t0, 3), library=_build.library_path().name)

    paths, truths, records = path_inputs()
    scene_records, orbit_records, record_8k, stream_records, sweep_records = (
        golden.load(n) for n in ("scenes", "orbit", "frame_8k", "stream", "sweep"))
    totals = {}  # phase -> counts of the comparisons with the JAX records
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
    dense4k = dense4k_inputs(det_dense, boards)
    dense4k_checked, dense4k_launches = dense4k_check(dense4k)
    kernel_records()

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
    for path in golden.PATHS:
        held_to_jax(path, paths[path][0], paths[path][1], records, totals)

    t_wait = time.perf_counter()
    parity_scenes, reference_s = reference.result()
    log("parity reference", scenes=len(parity_scenes), seconds=round(reference_s, 1),
        waited_s=round(time.perf_counter() - t_wait, 1))
    t_wait = time.perf_counter()
    pose_cpu, pose_cpu_s = pose_cpu.result()
    log("pose sim cpu", views=len(pose_cpu["views"]), detected=pose_cpu["detected"],
        seconds=round(pose_cpu_s, 1), waited_s=round(time.perf_counter() - t_wait, 1))

    # Phase 5: throughput, kernel against plain version, route comparison.
    at_batch = {}
    for path, batch in BATCHES.items():
        d, frames = paths[path]
        big = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(frames[0], (batch,) + frames.shape[1:])
        )).cuda()
        path_timing(path, d, big, card)
        at_batch[path] = batch_kernel_timing(path, d, big, card)
        if path == "portrait":
            route_timing(d, big, card)
        if path == "noref":
            tail_timing(d, big, card, args_of["noref"]["warp_eval"])
        del big
    frontend_cells_timing(det, paths["landscape"][1], card)

    table = wrappers()
    rows = [kernel_timing(name, path, table[name], args_of[path][name], phase3[path][name],
                          at_batch[path][name], launches_of[path][name], card)
            for name, (_, _, path) in KERNELS.items()]
    # Kernels 3 and 4 on the other refine paths (their rows report landscape).
    for path in ("portrait", "dense"):
        for name in ("refine", "warp_decode"):
            kernel_timing(name, path, table[name], args_of[path][name], phase3[path][name],
                          at_batch[path][name], launches_of[path][name], card)
    # The pose kernel at one frame's lanes: a live camera's call.
    pts = args_of["landscape"]["ippe"][0]
    one = (pts[: pts.shape[0] // len(paths["landscape"][1])], MARKER_MM)
    got = table["ippe"][0](*one)
    counts, err = compare("ippe", one, got, table["ippe"][1](*one))
    require(sum(counts.values()) == 0 and err == 0.0, "ippe at one frame's lanes: differs")
    kernel_timing("ippe", "landscape", table["ippe"], one, (err, *work("ippe", one, got)),
                  at_batch["landscape"]["ippe"], launches_of["landscape"]["ippe"], card)
    # Kernel 2's labels mode at the dense 4K cell's batch, on clusters.
    row = kernel_timing("coarse_labels", "dense4k", table["coarse_labels"], dense4k,
                        dense4k_checked, None, dense4k_launches, card)
    rows.append({**row, "plan": DENSE4K_PLAN})
    del dense4k
    # Phases 6-12: parity, stream, sharded, spatial, detect_arrays, examples, configs.
    import torch.distributed as dist

    phase_s = {}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        phase(*args)
        phase_s[f"{name}_s"] = round(time.perf_counter() - t0, 1)

    timed("parity", parity_phase, card, parity_scenes, reference_s, scene_records, totals)
    timed("stream", stream_phase, det, paths["landscape"][1], card, stream_frames.result(),
          stream_records, totals)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        timed("sharded", sharded_phase, det, paths["landscape"][1])
        timed("spatial", spatial_phase, det, scene, truths["landscape"], card, record_8k, totals)
    finally:
        dist.destroy_process_group()
    timed("detect_arrays", detect_arrays_phase, det, scene, golden.subset(record_8k, "1080p"),
          totals)
    timed("examples", examples_phase, pose_cpu, pose_cpu_s, orbit_records, totals)
    timed("configs", configs_phase, card, totals)
    timed("sweep", sweep_phase, card, sweep_records, totals)
    log("phases 6-13", **phase_s)
    for phase, counts in totals.items():
        log("jax records", of=phase, **counts)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
