#!/usr/bin/env python
"""Writes the JAX package's results on the inputs of ``chip_smoke.py``
into ``tests/torch_golden/`` (the records ``tools/torch_golden.py``
compares the PyTorch/CUDA port with).  Needs JAX; runs on the CPU.

    python tools/torch_make_golden.py [part ...] [--check]

Parts (all by default):

* ``paths``: the five paths' frames (``torch_golden.path_frames``) through
  the program ``bench.py`` times, ``detector.detect_batch_arrays`` then
  ``pose.solve_normalized_batch`` of the corners over (W, H) with a 40 mm
  marker, at the path's batch and config (its poses as ``bench_pose_*``);
  the same solve of the same corners op by op (``pose_*``, the poses the
  comparator holds the port to); and the fit lanes before refinement
  (``segment.extract_candidates``) for the tie rule;
* ``scenes``: the 700 scenes of ``tools/torch_parity_report.py --suite
  400`` and phase 6's 20, each through ``Detector.detect``'s program (one
  frame, the detector's params): its markers by lane (id, code, distance,
  rounded corners) and its fit lanes;
* ``orbit``: the pose example's 24 views through ``Detector.detect`` and
  ``pose.solve_with_intrinsics``, as ``examples/pose_accuracy_sim.py``
  computes them: markers, the translation and normal of marker 17, and
  their errors against the rendered pose;
* ``8k``: phase 9's 4320x7680 frame through ``Detector.detect``.

Each frame is stored as its sha256, never as pixels.  ``--check`` makes
the parts again and compares them with the stored records instead of
writing (exit 1 if any array differs).

    python tools/torch_make_golden.py --warps SCENE_SET K

decodes every valid lane of scene K of a scene set (``suite/...``,
``phase6``) with JAX's two warps, the XLA pyramid warp of its CPU route
(``warp_patches_mxu``) and the gather warp of its TPU refine route
(``warp_patches_dma``, its Pallas kernel in interpret mode), and with the
port's refine-route warp (kernel 4's plain version), on JAX's quads, and
prints each lane's pyramid level and decoded id under each.

The whole run takes about 20 minutes on a CPU (most of it the 300 1080p
scenes; the 8K frame about 25 s).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import asdict

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_golden as golden  # noqa: E402
from aruco3_tpu import (  # noqa: E402
    ARDictionary, CameraIntrinsics, Detector, DetectorConfig, frontend, pose, segment,
)
from aruco3_tpu.detector import detect_batch_arrays  # noqa: E402

PARTS = ("paths", "scenes", "orbit", "8k")


def jax_config(cfg) -> DetectorConfig:
    """The JAX ``DetectorConfig`` of a port config (same fields)."""
    return DetectorConfig(**asdict(cfg))


def geometry(cfg: DetectorConfig, h: int, w: int):
    """(params, min_edge, min_sep, ds) as ``aruco3_tpu.Detector._compiled``
    derives them."""
    ds = cfg.coarse_factor or segment.choose_coarse_factor(h, w)
    eps_scale = cfg.contour_simplification_epsilon / 0.05
    base = segment.QuadParams()
    params = segment.QuadParams(
        max_candidates=cfg.max_candidates,
        max_inner_candidates=cfg.max_inner_candidates,
        coarse_factor=ds,
        ccl_rounds=cfg.ccl_rounds,
        refine=cfg.refine_corners,
        containment_slack=base.containment_slack * eps_scale,
        min_containment=min(0.999, base.min_containment / max(eps_scale, 1e-6)),
    )
    side = min(w, h)
    return (params, side * cfg.min_side_length_factor, side * cfg.min_corner_separation_factor,
            ds)


def program(cfg: DetectorConfig, dictionary, h: int, w: int, with_pose: bool):
    """One jitted program: ``detect_batch_arrays`` of (B, h, w) frames, the
    fit lanes of their coarse masks, and (``with_pose``) the poses of the
    corners over (w, h) as ``bench.py`` solves them."""
    params, min_edge, min_sep, ds = geometry(cfg, h, w)

    def fits(g):
        white = frontend.adaptive_threshold(g, cfg.threshold_window)
        coarse = segment.pool_black(segment.open_mask(~white, params.open_radius), ds)
        cand = segment.extract_candidates(coarse, params, ds)
        return cand["quads"], cand["centroids"], cand["sizes"]

    def fn(frames):
        out = detect_batch_arrays(frames, dictionary, cfg, params, min_edge, min_sep, ds)
        res = {k: out[k] for k in ("quads", "quad_valid", "marker_valid", "stats")
               + golden.MARKER_FIELDS}
        res["fit_quads"], res["fit_centroids"], res["fit_sizes"] = jax.vmap(fits)(out["grey"])
        if with_pose:
            norm = out["marker_corners"] / jnp.array([float(w), float(h)], jnp.float32)
            res["poses"] = pose.solve_normalized_batch(norm, golden.MARKER_MM)
        return res

    return jax.jit(fn)


def eager_poses(corners, h: int, w: int):
    """``pose.solve_normalized_batch`` of the corners over (w, h), op by op
    (``jax.disable_jit``): one rounding an operation, as the port rounds.
    XLA's programs contract multiply-adds as their fusions fall, and the
    poses of far markers move with them (ROADMAP §3, known differences)."""
    with jax.disable_jit():
        norm = jnp.asarray(corners) / jnp.array([float(w), float(h)], jnp.float32)
        return jax.device_get(pose.solve_normalized_batch(norm, golden.MARKER_MM))


def path_record(path: str, frames) -> dict:
    """The record of one path's frames (keys without the path prefix):
    the bench program's outputs, its poses as ``bench_pose_*`` and the
    op-by-op poses of its corners as ``pose_*``."""
    dict_name, cfg = golden.path_specs()[path]
    n, h, w = frames.shape
    fn = program(jax_config(cfg), ARDictionary.new_from_named_dict(dict_name), h, w, True)
    res = jax.device_get(fn(jnp.asarray(frames)))
    rec = golden.batch_record(res, eager_poses(res["marker_corners"], h, w))
    for k, v in zip(golden.POSE_KEYS, res["poses"]):
        rec[f"bench_{k}"] = np.asarray(v)
    for k in ("fit_quads", "fit_centroids", "fit_sizes"):
        rec[k] = np.asarray(res[k])
    rec["hashes"] = np.array([golden.frame_hash(f) for f in frames])
    return rec


class SceneRecorder:
    """Records frames of one shape through ``Detector.detect``'s program
    (one frame a call; the detector's params for ``cfg``)."""

    def __init__(self, dict_name: str, cfg: DetectorConfig | None = None):
        self.cfg = cfg or DetectorConfig()
        self.dictionary = ARDictionary.new_from_named_dict(dict_name)
        self.fns = {}
        self.markers, self.fits, self.hashes = [], [], []

    def add(self, img) -> dict:
        h, w = img.shape
        if (h, w) not in self.fns:
            self.fns[h, w] = program(self.cfg, self.dictionary, h, w, False)
        res = jax.device_get(self.fns[h, w](jnp.asarray(img)[None]))
        self.markers.append(golden.markers_of(res, 0))
        self.fits.append(golden.fit_lanes(res["fit_quads"][0], res["fit_centroids"][0],
                                          res["fit_sizes"][0]))
        self.hashes.append(golden.frame_hash(img))
        self.lanes = res["marker_valid"].shape[1]
        return res

    def record(self) -> dict:
        rec = golden.pack(self.markers)
        rec.update({f"fit/{k}": v for k, v in golden.pack(self.fits).items()})
        rec["hashes"] = np.array(self.hashes)
        rec["lanes"] = np.array(self.lanes)
        return rec


def scene_record(name: str, n: int | None = None, verify: bool = False) -> dict:
    """The record of scene set ``name`` (its first ``n`` scenes if given).
    ``verify``: first hold scene 0's markers against ``Detector.detect``
    itself (one more compile)."""
    dict_name = golden.SCENE_SETS[name][0]
    rec = SceneRecorder(dict_name)
    for k, (_, img, _) in enumerate(golden.scene_images(name, n)):
        res = rec.add(img)
        if verify and k == 0:
            det = Detector(rec.cfg, rec.dictionary).detect(img)
            got = golden.markers_of(res, 0)
            want = [(m.id, m.code, m.hamming_distance, [list(c) for c in m.corners])
                    for m in det.markers]
            have = [(int(i), int(c[0]) | (int(c[1]) << 32), int(d), cr.tolist())
                    for i, c, d, cr in zip(got["id"], got["code"], got["dist"], got["corners"])]
            if want != have:
                raise AssertionError(f"{name}: the program differs from Detector.detect")
    return rec.record()


def orbit_record() -> dict:
    """The pose example's views through the JAX package."""
    sim = golden.pose_example()
    intr = sim.camera()
    jintr = CameraIntrinsics.new(intr.image_width, intr.image_height, intr.focal_x, intr.focal_y)
    rec = SceneRecorder("ARUCO_DEFAULT")
    found, trans, normal, t_err, r_err = [], [], [], [], []
    for img, rot, t_true in golden.orbit_images():
        m = rec.add(img)
        mk = golden.markers_of(m, 0)
        hit = np.nonzero(mk["id"] == sim.MARKER_ID)[0]
        found.append(bool(len(hit)))
        if not len(hit):
            for a in (trans, normal):
                a.append(np.full(3, np.nan, np.float32))
            t_err.append(np.nan)
            r_err.append(np.nan)
            continue
        corners = [tuple(int(v) for v in c) for c in mk["corners"][hit[0]]]
        best, _alt = pose.solve_with_intrinsics(corners, sim.MARKER_MM, jintr)
        t_est = np.asarray(best.translation, np.float32)
        z_est = np.asarray(best.rotation, np.float32)[:, 2]
        trans.append(t_est)
        normal.append(z_est)
        t_err.append(float(np.linalg.norm(t_est.astype(np.float64) - t_true)))
        r_err.append(float(np.degrees(np.arccos(np.clip(np.dot(rot[:, 2], z_est.astype(np.float64)),
                                                        -1, 1)))))
    out = rec.record()
    out.update(found=np.array(found), translation=np.stack(trans), normal=np.stack(normal),
               t_err=np.array(t_err), r_err=np.array(r_err))
    return out


def record_8k() -> dict:
    rec = SceneRecorder(golden.DICT_NAME)
    rec.add(golden.frame_8k(ARDictionary.new_from_named_dict(golden.DICT_NAME)))
    return rec.record()


def make(part: str) -> dict:
    """The arrays of one record file, keys prefixed by path or scene set."""
    if part == "paths":
        frames = golden.path_frames()
        out = {}
        for p in golden.PATHS:
            rec = path_record(p, frames[p][0])
            out.update({f"{p}/{k}": v for k, v in rec.items()})
            v = rec["marker_valid"]
            print(f"  {p}: bench program's poses against op by op, max abs: " + ", ".join(
                f"{k} {float(np.abs(rec[k][v] - rec['bench_' + k][v]).max()):.6g}"
                for k in golden.POSE_KEYS[:2]), flush=True)
        return out
    if part == "scenes":
        out = {}
        for name in golden.SCENE_SETS:
            t0 = time.perf_counter()
            out.update({f"{name}/{k}": v for k, v in scene_record(name, verify=True).items()})
            print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out
    if part == "orbit":
        return {f"orbit/{k}": v for k, v in orbit_record().items()}
    if part == "8k":
        return {f"8k/{k}": v for k, v in record_8k().items()}
    raise ValueError(part)


def same(a: dict, b: dict) -> list:
    """Keys whose arrays differ (NaN equal to NaN)."""
    keys = sorted(set(a) | set(b))
    return [k for k in keys if k not in a or k not in b
            or not np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f")]


def warps(name: str, k: int) -> None:
    """``--warps``: scene ``k`` of ``name`` decoded by JAX's two warps and
    the port's, lane by lane."""
    import math

    import torch

    from aruco3_tpu import rectify
    from aruco3_tpu_torch import rectify as prect
    from aruco3_tpu_torch.ops import frontend as pfront
    from aruco3_tpu_torch.ops import warp_decode

    img = list(golden.scene_images(name, k + 1))[k][1]
    h, w = img.shape
    cfg = DetectorConfig()
    d = ARDictionary.new_from_named_dict(golden.SCENE_SETS[name][0])
    m, s = d.get_mark_size(), cfg.homography_sample_size
    params, min_edge, min_sep, ds = geometry(cfg, h, w)
    grey = jnp.asarray(img)
    black = segment.open_mask(~frontend.adaptive_threshold(grey, cfg.threshold_window),
                              params.open_radius)
    found = segment.find_quads_from_masks(black, segment.pool_black(black, ds), params, min_edge,
                                          min_sep, ds, grey=grey)
    quads = found["quads"]
    H, _ = rectify.homography_square_to_quad(quads, s)
    levels = max(1, int(math.ceil(math.log2(max(h, w) / 60.0))) + 1)
    xla, _ = rectify.decode_patches(
        rectify.warp_patches_mxu(rectify.build_pyramid(grey, levels), H, quads, s), m)
    canvas, offsets, shapes = rectify.build_packed_pyramid(grey[None], levels)
    gather = jax.jit(lambda c, hh, q: rectify.warp_patches_dma(
        c, offsets, shapes, hh, q, s, interpret=True, fuse_decode_mark=m)[1])(canvas, H[None],
                                                                          quads[None])
    gather, _ = rectify.decode_grids(gather[0], m)
    tq = torch.from_numpy(np.array(quads))[None]
    tg = torch.from_numpy(img)[None]
    pshapes = prect.pyramid_level_shapes(h, w, prect.num_levels(h, w))
    lvl, tlx, tly = prect.warp_windows(tq, pshapes)
    level1 = pfront.threshold_open_pool(tg, cfg.threshold_window, params.open_radius, ds)[2]
    grids = warp_decode.plain(tg, prect.upper_levels(level1, pshapes),
                              torch.from_numpy(np.array(H))[None], lvl, tlx, tly,
                              torch.ones_like(lvl, dtype=torch.bool), s, m)[2]
    port = prect.decode_grids(grids.reshape(-1, grids.shape[-1]), m)[0].numpy()

    def ids(bits):
        i, dist = d.find_nearest_bits(np.asarray(bits))
        r = int(np.argmin(np.asarray(dist)))
        return int(np.asarray(i)[r]), int(np.asarray(dist)[r])

    for lane in np.nonzero(np.asarray(found["valid"]))[0]:
        print(f"{name} scene {k} lane {lane} level {int(lvl[0, lane])}: (id, distance) "
              f"xla warp {ids(xla[lane])}, gather warp {ids(gather[lane])}, "
              f"port {ids(port[lane])}", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--warps"]:
        warps(sys.argv[2], int(sys.argv[3]))
        return 0
    check = "--check" in sys.argv[1:]
    parts = [a for a in sys.argv[1:] if a != "--check"] or list(PARTS)
    bad = []
    for part in parts:
        t0 = time.perf_counter()
        arrays = make(part)
        name = "frame_8k" if part == "8k" else part
        if check:
            diff = same(arrays, golden.load(name))
            bad += [f"{name}: {k}" for k in diff]
            print(f"{part}: {len(arrays)} arrays, {len(diff)} differ, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        else:
            golden.RECORDS.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(golden.RECORDS / f"{name}.npz", **arrays)
            size = (golden.RECORDS / f"{name}.npz").stat().st_size
            print(f"{part}: {len(arrays)} arrays, {size} bytes, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in bad:
        print("differs:", line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
