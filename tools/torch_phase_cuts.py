"""Kernels 2, 7, 6, 3 and 4 cut after each phase: device ms per batch on
one card.

    cd <checkout> && python <repo>/tools/torch_phase_cuts.py current|parent [k2 k7 k6 k3 k4]

Run from the root of a checkout whose kernel sources the anchors below
name: ``current`` this tree's, ``parent`` those of the commit before the
kernel's redesign (kernels 2 and 7: 6b92655; kernels 3 and 4: 0bce09b).
Each cut is a copy of the checkout's ``aruco3_tpu_torch`` under
``build/cuts/`` with a statement put before one anchor, in
``csrc/coarse_fit.cu`` (kernel 2), ``csrc/fit_common.cuh`` (kernel 7's
fit), ``csrc/fit.cu`` (kernel 6), ``csrc/refine.cu`` (kernel 3) or
``csrc/warp_decode.cu`` (kernel 4): a ``return``, after a sink where
nothing else would read the work before the anchor (it would be
optimised away).
All copies build at once, each through its own ``_build``; then each is
timed in a process of its own that imports it: the landscape (fit mode),
small (labels mode, batch 512) and portrait (labels mode) coarse planes of
``chip_smoke.py``'s paths through kernel 2, the portrait and small label
planes through kernel 7, the dense path's lanes of both label planes
(batch 16) through kernel 6, and kernels 3 and 4 on the inputs the
landscape, portrait and dense paths give them at their phase-5 batches,
by ``chip_smoke.device_ms``.  The uncut checkout is the last row of each
table.  The kernels default to all the tree has cuts for.  An anchor that
is not found once fails the run.  Needs the card.
"""

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

RET = "if (threadIdx.x >= 0) return;\n"
# Sinks: read what the phases before the cut wrote only on chip.
HIST_SINK = "if (threadIdx.x >= 0) {\n    if (hist[threadIdx.x & 255] < 0) levels[n] = -1;\n    return;\n  }\n"
WIN_SINK = ("if (threadIdx.x >= 0) {\n    __syncthreads();\n"
            "    if (win[(threadIdx.x * 17) & 4095] < 0.0f) levels[n] = -1;\n    return;\n  }\n")
MEAN_SINK = "if (threadIdx.x >= 0) {\n    if (mean < 0.0f) out[q * 2] = 0.0f;\n    return;\n  }\n"
# Kernel 3's cuts end score_rows; the kernel's arg-max and store follow.
ROWS_SINK = ("if (threadIdx.x >= 0) {\n    uint32_t x = 0;\n"
             "    for (int ri = 0; ri < ROWS; ++ri) {\n"
             "      x ^= static_cast<uint32_t>(rows[ri].near);\n"
             "      for (int j = 0; j < CH * 4; ++j) x ^= rows[ri].g[j];\n    }\n"
             "    if (x == 0x9e3779b9u) bs = 1.0f;\n    return;\n  }\n")
SUM_SINK = ("if (threadIdx.x >= 0) {\n"
            "    if (mean < 0.0f && (rows[0].near ^ rows[ROWS - 1].near) == 1ull) bs = 1.0f;\n"
            "    return;\n  }\n")
TOOL = Path(__file__).resolve()
# kernel -> [(name, file, anchor[, statement])]: the statement (RET unless
# given) goes before the anchor.
CUTS = {
    "parent": dict(
        k2=[
            ("outer fill", "coarse_fit.cu",
             "  for (int p = threadIdx.x; p < P; p += blockDim.x) {\n    const int q = qof(p, g);\n    F1[q]"),
            ("+outer CCL", "coarse_fit.cu",
             "  const a3fit::Twins none = {nullptr, nullptr, nullptr, 0};\n  if (labels_only)"),
            ("+outer fit", "coarse_fit.cu", "  // Inner pass (segment.label_planes)"),
            ("+inner depth 0", "coarse_fit.cu", "  uint8_t* NOTLEV = OK;"),
            ("+peel depths", "coarse_fit.cu", "  if (labels_only) return;\n  a3fit::fit_plane(LAB2"),
        ],
        k7=[
            ("rank pool", "fit_common.cuh", "  topk_pick(s.roots_r"),
            ("+top-k", "fit_common.cuh", "  if (threadIdx.x == 0) *o.qual = n_roots;"),
        ],
        k3=[
            ("setup", "refine.cu", "  int sum = 0;"),
            ("+sum", "refine.cu", "  float bs = -INFINITY;", MEAN_SINK),
        ],
        k4=[
            ("setup", "warp_decode.cu",
             "  for (int i = threadIdx.x; i < S2; i += blockDim.x) {\n    const float x"),
            ("+taps", "warp_decode.cu",
             "  for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;"),
            ("+histogram", "warp_decode.cu", "  if (threadIdx.x == 0) {\n    int w = 0, mm = 0;",
             HIST_SINK),
            ("+Otsu", "warp_decode.cu", "  const float lv = static_cast<float>(s_level);"),
        ],
    ),
    "current": dict(
        k2=[
            ("outer fill", "coarse_fit.cu",
             "  each_word(g, band, [&](int q, int, int) { F1[q] = M2[q] | (WHITE[q] & ~R[q]); });"),
            ("+outer CCL", "coarse_fit.cu", "  if (labels_only) {\n    int* L1"),
            ("+outer fit", "coarse_fit.cu", "  // Inner pass (segment.label_planes)"),
            ("+inner depth 0", "coarse_fit.cu", "  uint32_t* NOTLEV = OK;"),
            ("+peel depths", "coarse_fit.cu",
             "  if (labels_only) return;\n  // The inner plane back on chip"),
        ],
        k7=[
            ("rank pool", "fit_common.cuh", "  topk_select(s.sizes_r, kr, k, s.sel, s.topk);"),
            ("+top-k", "fit_common.cuh", "  if (threadIdx.x == 0) *o.qual = n_roots;"),
            ("+members", "fit_common.cuh", "  for (int l = warp; l < k; l += nwarps) {"),
        ],
        k6=[
            ("setup, staged plane", "fit.cu", "  // Members of each root, counted, then listed root after root."),
            ("+member counts", "fit.cu",
             "  if (warp == 0) {\n    for (int i = lane; i < g; i += 32) off[i] = cnt[i];"),
            ("+member lists", "fit.cu", "  // A warp a lane: its root's members, its own size."),
        ],
        k3=[
            ("setup", "refine.cu", "  // Every load of the thread's rows issued"),
            ("+staging", "refine.cu", "  int sum = 0;", ROWS_SINK),
            ("+sum", "refine.cu", "  // For an integer g, g < mean exactly", SUM_SINK),
        ],
        k4=[
            ("setup, staged window", "warp_decode.cu",
             "  // Sample i = threadIdx.x + j * THREADS", WIN_SINK),
            ("+taps", "warp_decode.cu", "  // Histogram of the rounded samples"),
            ("+histogram", "warp_decode.cu", "  // Otsu: one warp", HIST_SINK),
            ("+Otsu", "warp_decode.cu", "  const float lv = static_cast<float>(s_level);"),
        ],
    ),
}


def smoke():
    """chip_smoke.py beside this tool (the port it drives is the cwd's)."""
    spec = importlib.util.spec_from_file_location("smoke", TOOL.parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_variant(kernels: str, name: str) -> None:
    """In a process of its own, from the root of a (cut) copy: device ms per
    batch of the comma-separated kernels ("k2", "k7", "k6", "k3", "k4")."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from aruco3_tpu_torch import segment
    from aruco3_tpu_torch.ops import coarse_fit as k2
    from aruco3_tpu_torch.ops import fit as kfit
    from aruco3_tpu_torch.ops import frontend as k1

    cs = smoke()
    paths, _ = cs.path_inputs()
    kernels = kernels.split(",")
    for kernel, wrapper, cuda in (("k3", "refine", "refine_kernel"),
                                  ("k4", "warp_decode", "warp_decode_kernel")):
        if kernel not in kernels:
            continue
        fn = cs.wrappers()[wrapper][0]
        for path in ("landscape", "portrait", "dense"):
            det, frames = paths[path]
            big = torch.from_numpy(np.ascontiguousarray(
                np.broadcast_to(frames[0], (cs.BATCHES[path],) + frames.shape[1:]))).cuda()
            a = cs.stage_inputs(big, det)[0][wrapper]
            del big
            ms = cs.device_ms(lambda: fn(*a), reps=5, kernel=cuda)
            print(f"{kernel} cut {path} batch {cs.BATCHES[path]} {name}: device_ms {ms:.4f}",
                  flush=True)
    if "k6" in kernels:  # the dense path's label planes and lanes, as detect_batch makes them
        det, frames = paths["dense"]
        params, _, _, ds = det.geometry(*frames.shape[1:])
        big = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(frames[0], (cs.BATCHES["dense"],) + frames.shape[1:]))).cuda()
        c = k1.threshold_open_pool(big, det.config.threshold_window, params.open_radius, ds)[0]
        del big
        planes = k2.coarse_labels(c, params)
        for plane, lab, k in (("outer", planes[0], params.max_candidates),
                              ("inner", planes[1], params.max_inner_candidates)):
            kr = segment.rank_pool_size(k, lab.shape[1] * lab.shape[2])
            roots, sizes = segment.select_lanes(*kfit.rank_roots(lab, kr, params.min_component_px)[:2], k)
            a = (lab, roots.contiguous(), sizes.clamp(min=0).contiguous(),
                 (sizes >= 0).contiguous(), ds, params.containment_slack)
            ms = cs.device_ms(lambda: kfit.fit_lanes(*a), reps=5, kernel="fit_lanes_kernel")
            print(f"k6 cut dense {plane} batch {lab.shape[0]} lanes {k} {name}: device_ms {ms:.4f}",
                  flush=True)
    if not {"k2", "k7"} & set(kernels):
        return
    P = segment.QuadParams()
    coarse = {}
    for path, ds in (("landscape", 10), ("small", 1), ("portrait", 10)):
        frames = paths[path][1]
        g = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(frames[0], (cs.BATCHES[path],) + frames.shape[1:]))).cuda()
        coarse[path] = (k1.threshold_open_pool(g, 7, 2, ds)[0], ds)
        del g
    if "k2" in kernels:
        for path, mode in (("landscape", "fit"), ("small", "labels"), ("portrait", "labels")):
            c, ds = coarse[path]
            call = (lambda: k2.coarse_fit(c, P, ds)) if mode == "fit" else (lambda: k2.coarse_labels(c, P))
            ms = cs.device_ms(call, reps=5)
            print(f"k2 cut {path} {mode} batch {c.shape[0]} {name}: device_ms {ms:.4f}", flush=True)
    if "k7" in kernels:
        for path in ("portrait", "small"):
            c, ds = coarse[path]
            l1, l2 = k2.coarse_labels(c, P)
            ms = cs.device_ms(lambda: kfit.fused_fit_batch(l1, l2, ds, P, 32, 12), reps=5)
            print(f"k7 cut {path} batch {c.shape[0]} {name}: device_ms {ms:.4f}", flush=True)


def main(which: str, kernels: list[str]) -> None:
    kernels = kernels or list(CUTS[which])
    root = Path("build/cuts")
    shutil.rmtree(root, ignore_errors=True)
    variants = []  # (directory, kernel, name)
    for kernel in kernels:
        for i, (name, fname, anchor, *stmt) in enumerate(CUTS[which][kernel]):
            d = root / f"{kernel}_{i}"
            shutil.copytree("aruco3_tpu_torch", d / "aruco3_tpu_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            src = d / "aruco3_tpu_torch" / "csrc" / fname
            text = src.read_text()
            assert text.count(anchor) == 1, (which, name, anchor)
            src.write_text(text.replace(anchor, (stmt[0] if stmt else RET) + anchor))
            variants.append((d, kernel, name))
    variants.append((Path("."), ",".join(kernels), "all"))
    build = [sys.executable, "-c", "from aruco3_tpu_torch.ops import _build; _build.build()"]
    procs = [subprocess.Popen(build, cwd=d) for d, _, _ in variants]
    assert all(p.wait() == 0 for p in procs), "a cut did not build"
    print("card", smoke().smi_line(), flush=True)
    for d, kernel, name in variants:
        subprocess.run([sys.executable, str(TOOL), "--time", kernel, name], cwd=d, check=True)


if __name__ == "__main__":
    if sys.argv[1] == "--time":
        time_variant(sys.argv[2], sys.argv[3])
    else:
        main(sys.argv[1], sys.argv[2:])
