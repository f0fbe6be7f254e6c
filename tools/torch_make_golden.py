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
* ``8k``: phase 9's frames, the 4320x7680 frame and the landscape
  path's frame 0, through ``Detector.detect``;
* ``kernels``: the JAX TPU kernels that kernels 1, 4 and 8 of the port
  reproduce, on the seeded probes of ``torch_golden.kernel_probes``:
  ``build_packed_pyramid``'s levels 1 and 2 (the chain the frontend
  kernel's ``emit_level1`` starts), ``warp_patches_dma``'s samples and
  cell grids at levels 0-3 (the gather warp, interpret mode) and
  ``warp_pallas.warp_eval``'s samples (interpret mode);
* ``configs``: the cases of ``torch_golden.config_cases`` (``configs.npz``);
* ``sweep``: the cases of ``torch_golden.sweep_cases`` (``sweep.npz``):
  each setting of ``DetectorConfig`` users change, odd frame shapes and
  four- and one-channel frames, each refused unless the route's
  Pallas-warp decode finds a marker on every frame (but where the case's
  point is lane overflow);
* ``stream``: BASELINE config 5's stream (``torch_golden.stream_frames``,
  ``stream.npz``): each dictionary's 8 frames at batch 8, the batch of
  ``chip_smoke.py``'s phase 7.

Besides JAX's results (its CPU route, whose warp is the XLA pyramid warp
``warp_patches_mxu``), every input's record holds under ``pallas/`` the
decode of JAX's recorded quads by the Pallas warp of the port's route
(``pallas_decoder``): on the refine route (corner refinement and ds > 1)
``build_packed_pyramid`` and the gather warp ``warp_patches_dma`` with
its fused decode, on the tail route ``_warp_setup`` and ``warp_eval``,
both in interpret mode, then JAX's ``_match_tail``: marker validity, id,
code, distance, rotation, rotated corners, the decode's stats, and the
poses (or the pose example's view poses) of those corners.  Phase 9's
frames, which the spatial step decodes through the tail warp, hold that
decode under ``tail/`` too.

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

The whole run takes about 25 minutes on a CPU (most of it the 300 1080p
scenes; the 8K frame about 40 s).
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
from aruco3_tpu import rectify  # noqa: E402
from aruco3_tpu.detector import _match_tail, _num_levels, detect_batch_arrays  # noqa: E402
from aruco3_tpu.ops.warp_pallas import warp_eval  # noqa: E402

PARTS = ("paths", "scenes", "orbit", "8k", "kernels", "configs", "sweep", "stream")


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


def program(cfg: DetectorConfig, dictionary, h: int, w: int, with_pose: bool,
            with_grey: bool = False):
    """One jitted program: ``detect_batch_arrays`` of (B, h, w[, C]) frames,
    the fit lanes of their coarse masks, (``with_pose``) the poses of the
    corners over (w, h) as ``bench.py`` solves them, and (``with_grey``) the
    frames' luma."""
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
        if with_grey:
            res["grey"] = out["grey"]
        return res

    return jax.jit(fn)


def route_of(cfg: DetectorConfig, h: int, w: int) -> str:
    """The port's route for (h, w) frames (``detector.tail_route``): "refine"
    (corner refinement and ds > 1, the JAX TPU route), or "tail", whose
    warp is "gather" with ``warp_impl="gather"``."""
    params, _, _, ds = geometry(cfg, h, w)
    if params.refine and ds > 1:
        return "refine"
    return "gather" if cfg.warp_impl == "gather" else "tail"


def pallas_decoder(cfg: DetectorConfig, dictionary, h: int, w: int, route: str):
    """fn(frames (B, h, w) u8, quads, quad_valid, stats) -> ``_match_tail``'s
    outputs of JAX's quads decoded by the Pallas warp of ``route``, in
    interpret mode: "refine", the chain pyramid (``build_packed_pyramid``)
    through the gather warp ``warp_patches_dma`` and its fused decode;
    "tail", ``_warp_setup`` on the exact pyramid (``build_pyramid``) and
    ``warp_eval``; "gather" (the tail route with ``warp_impl="gather"``,
    which no Pallas kernel warps), ``rectify.warp_patches``.  The
    homographies are computed op by op, as the port computes them; the rest
    is one jitted program."""
    s = cfg.homography_sample_size
    m = dictionary.get_mark_size()
    levels = _num_levels(h, w)
    assert m * m <= 128, "the JAX refine route fuses the decode of these marks only"

    def refine(grey, H, hv, quads, qv, stats):
        canvas, offsets, shapes = rectify.build_packed_pyramid(grey, levels)
        patches, grids = rectify.warp_patches_dma(canvas, offsets, shapes, H, quads, s,
                                                  interpret=True, fuse_decode_mark=m)
        return jax.vmap(lambda q, v, hh, p, st, g: _match_tail(
            q, v, hh, p, st, dictionary, cfg, grids=g))(quads, qv, hv, patches, stats, grids)

    def tail(grey, H, hv, quads, qv, stats):
        def one(g, hh, hvv, q, v, st):
            windows, ux, uy, bad = rectify._warp_setup(rectify.build_pyramid(g, levels), hh, q, s)
            vals = jnp.where(bad, 0.0, warp_eval(windows, ux, uy, interpret=True))
            return _match_tail(q, v, hvv, vals.reshape(-1, s, s), st, dictionary, cfg)

        return jax.vmap(one)(grey, H, hv, quads, qv, stats)

    def gather(grey, H, hv, quads, qv, stats):
        return jax.vmap(lambda g, hh, hvv, q, v, st: _match_tail(
            q, v, hvv, rectify.warp_patches(g, hh, s), st, dictionary, cfg))(
                grey, H, hv, quads, qv, stats)

    fn = jax.jit({"refine": refine, "tail": tail, "gather": gather}[route])

    def decode(frames, quads, quad_valid, stats):
        H, hv = rectify.homography_square_to_quad(jnp.asarray(quads), s)
        return jax.device_get(fn(jnp.asarray(frames), H, hv, jnp.asarray(quads),
                                 jnp.asarray(quad_valid), stats))

    return decode


def eager_poses(corners, h: int, w: int):
    """``pose.solve_normalized_batch`` of the corners over (w, h), op by op
    (``jax.disable_jit``): one rounding an operation, as the port rounds.
    XLA's programs contract multiply-adds as their fusions fall, and the
    poses of far markers move with them (ROADMAP §3, known differences)."""
    with jax.disable_jit():
        norm = jnp.asarray(corners) / jnp.array([float(w), float(h)], jnp.float32)
        return jax.device_get(pose.solve_normalized_batch(norm, golden.MARKER_MM))


def batch_with_decode(fn, decoder, frames) -> tuple[dict, dict]:
    """(``fn``'s outputs, the record) of a batch of (n, h, w[, C]) frames
    through ``fn`` (a ``program`` with pose; with grey for colour frames):
    its outputs, the op-by-op poses of its corners as ``pose_*``, its fit
    lanes, the frames' hashes, and under ``pallas/`` ``decoder``'s decode
    of its quads (a ``pallas_decoder``)."""
    h, w = frames.shape[1:3]
    res = jax.device_get(fn(jnp.asarray(frames)))
    rec = golden.batch_record(res, eager_poses(res["marker_corners"], h, w))
    for k in ("fit_quads", "fit_centroids", "fit_sizes"):
        rec[k] = np.asarray(res[k])
    rec["hashes"] = np.array([golden.frame_hash(f) for f in frames])
    dec = decoder(res["grey"] if frames.ndim == 4 else frames, res["quads"], res["quad_valid"],
                  res["stats"])
    dec = golden.batch_record(dec, eager_poses(dec["marker_corners"], h, w))
    rec.update({f"pallas/{k}": v for k, v in dec.items() if k not in ("quads", "quad_valid")})
    return res, rec


def path_record(path: str, frames) -> dict:
    """The record of one path's frames (keys without the path prefix):
    the bench program's outputs, its poses as ``bench_pose_*`` and the
    op-by-op poses of its corners as ``pose_*``; under ``pallas/`` the
    decode of its quads by the Pallas warp of the port's route."""
    dict_name, cfg = golden.path_specs()[path]
    n, h, w = frames.shape
    jcfg, dictionary = jax_config(cfg), ARDictionary.new_from_named_dict(dict_name)
    res, rec = batch_with_decode(program(jcfg, dictionary, h, w, True),
                                 pallas_decoder(jcfg, dictionary, h, w, route_of(jcfg, h, w)),
                                 frames)
    for k, v in zip(golden.POSE_KEYS, res["poses"]):
        rec[f"bench_{k}"] = np.asarray(v)
    return rec


def case_record(dict_name: str, config, frames, programs: dict) -> dict:
    """The record of ``frames`` through the JAX package at the port config
    ``config`` (keys without a prefix; ``batch_with_decode``, the route's
    Pallas warp under ``pallas/``).  ``programs`` keeps the last call's
    program and decoder by (dictionary, config, shape), for the next call
    of the same key; a new key drops them and JAX's caches, since the
    compiled programs of many cases at once exhaust the process's memory
    maps."""
    h, w = frames.shape[1:3]
    cfg = jax_config(config)
    key = (dict_name, cfg, frames.shape)
    if key not in programs:
        programs.clear()
        jax.clear_caches()
        dictionary = ARDictionary.new_from_named_dict(dict_name)
        programs[key] = (program(cfg, dictionary, h, w, True, with_grey=frames.ndim == 4),
                         pallas_decoder(cfg, dictionary, h, w, route_of(cfg, h, w)))
    return batch_with_decode(*programs[key], frames)[1]


def config_record(name: str, programs: dict) -> dict:
    """The record of case ``name`` of ``torch_golden.config_cases``
    (``case_record``)."""
    case = golden.config_cases()[name]
    return case_record(case.dictionary, case.config, golden.config_frames(name), programs)


def masked(rec: dict) -> dict:
    """``rec`` with the float lanes that no comparison reads set to 0, so
    that they compress to nothing: poses and corners of lanes without a
    marker, quads of lanes without a quad, fits of lanes without a
    component.  ``torch_golden.compare_batch`` reads them only where the
    record's mask holds."""
    out = dict(rec)
    masks = {"": "marker_valid", "pallas/": "pallas/marker_valid"}
    for prefix, mask in masks.items():
        for key in golden.POSE_KEYS + ("marker_corners",):
            if prefix + key in out:
                out[prefix + key] = np.where(
                    _lanes(out[mask], out[prefix + key]), out[prefix + key], 0)
    out["quads"] = np.where(_lanes(out["quad_valid"], out["quads"]), out["quads"], 0)
    used = out["fit_sizes"] > 0
    for key in ("fit_quads", "fit_centroids"):
        out[key] = np.where(_lanes(used, out[key]), out[key], 0)
    return {k: np.asarray(v, rec[k].dtype) for k, v in out.items()}


def _lanes(mask, a):
    """A (B, K) lane mask broadcast against (B, K, ...) ``a``."""
    return mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim))


def sweep_record(name: str, programs: dict) -> dict:
    """The record of case ``name`` of ``torch_golden.sweep_cases``
    (``case_record``, ``masked``); raises unless the route's Pallas-warp decode finds a
    marker on every frame, where the case's point is not lane overflow."""
    case = golden.sweep_cases()[name]
    rec = masked(case_record(case.dictionary, case.config, golden.sweep_frames(name), programs))
    found = rec["pallas/marker_valid"].sum(axis=1)
    if not case.overflow and (found == 0).any():
        raise AssertionError(f"{name}: no marker found on frames {np.nonzero(found == 0)[0]}")
    return rec


def case_line(name: str, rec: dict, cfg, shape, seconds: float) -> str:
    """One case's line of the maker's log."""
    route = route_of(jax_config(cfg), *shape[1:3])
    return (f"  {name}: {len(rec['hashes'])} frames, {route} route, "
            f"{int(rec['quad_valid'].sum())} quads, {int(rec['pallas/marker_valid'].sum())} "
            f"markers (XLA warp {int(rec['marker_valid'].sum())}), {seconds:.1f} s")


def check_config_inputs() -> None:
    """Holds ``torch_golden``'s config inputs to the JAX package's own
    renders of them: config 1's frame (``aruco3_tpu.render``), config 2's
    first frames (the loop of ``benches/bench_configs.py:157-179``) and
    config 4's frame (that file's ``_grid_frame``)."""
    import importlib.util

    from aruco3_tpu import render

    spec = importlib.util.spec_from_file_location(
        "bench_configs", golden.ROOT / "benches" / "bench_configs.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    h, w = golden.CONFIG_HW
    img = render.random_marker_scene(d, 5, (w, h), rng=np.random.default_rng(0))[0]
    assert np.array_equal(img, golden.config1_frame()), "config 1's frame"
    rng = np.random.default_rng(1)
    for f in golden.config2_frames(False)[:4]:
        img = np.full((h, w), 255, dtype=np.uint8)
        for j in range(int(rng.integers(1, 5))):
            mid = int(rng.integers(0, len(d)))
            sub = render.random_marker_scene(d, mid, (320, 240), rng=rng, min_scale=0.4,
                                             max_scale=0.7)[0]
            y0, x0 = (j // 2) * 240, (j % 2) * 320
            img[y0 : y0 + 240, x0 : x0 + 320] = np.minimum(img[y0 : y0 + 240, x0 : x0 + 320], sub)
        assert np.array_equal(img, f), "config 2's frames"
    img = bench._grid_frame(ARDictionary.new_from_named_dict("APRILTAG_36H11"), *golden.DENSE_HW,
                            cell=golden.CONFIG4_CELL,
                            rng=np.random.default_rng(golden.CONFIG4_SEED))[0]
    assert np.array_equal(img, golden.config_frames("config4")[0]), "config 4's frame"


class SceneRecorder:
    """Records frames of one shape through ``Detector.detect``'s program
    (one frame a call; the detector's params for ``cfg``), and the decode
    of its quads by the Pallas warp of the port's route (``pallas/``; with
    ``tail_too`` also by the tail warp, ``tail/``)."""

    def __init__(self, dict_name: str, cfg: DetectorConfig | None = None, tail_too=False):
        self.cfg = cfg or DetectorConfig()
        self.dictionary = ARDictionary.new_from_named_dict(dict_name)
        self.fns = {}
        self.decoders = {}
        self.routes = ("pallas", "tail") if tail_too else ("pallas",)
        self.markers, self.fits, self.hashes = [], [], []
        self.decoded = {prefix: [] for prefix in self.routes}

    def add(self, img) -> tuple[dict, dict]:
        """(the program's outputs, prefix -> the Pallas-warp decode) of one frame."""
        h, w = img.shape
        if (h, w) not in self.fns:
            self.fns[h, w] = program(self.cfg, self.dictionary, h, w, False)
            for prefix in self.routes:
                route = route_of(self.cfg, h, w) if prefix == "pallas" else "tail"
                self.decoders[prefix, h, w] = pallas_decoder(self.cfg, self.dictionary, h, w,
                                                             route)
        res = jax.device_get(self.fns[h, w](jnp.asarray(img)[None]))
        self.markers.append(golden.markers_of(res, 0))
        self.fits.append(golden.fit_lanes(res["fit_quads"][0], res["fit_centroids"][0],
                                          res["fit_sizes"][0]))
        self.hashes.append(golden.frame_hash(img))
        self.lanes = res["marker_valid"].shape[1]
        decs = {}
        for prefix in self.routes:
            decs[prefix] = self.decoders[prefix, h, w](img[None], res["quads"], res["quad_valid"],
                                                       res["stats"])
            self.decoded[prefix].append(golden.markers_of(decs[prefix], 0))
        return res, decs

    def record(self) -> dict:
        rec = golden.pack(self.markers)
        rec.update({f"fit/{k}": v for k, v in golden.pack(self.fits).items()})
        for prefix, items in self.decoded.items():
            rec.update({f"{prefix}/{k}": v for k, v in golden.pack(items).items()})
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
        res, _ = rec.add(img)
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
    """The pose example's views through the JAX package: under ``pallas/``
    the same from the Pallas-warp decode."""
    sim = golden.pose_example()
    intr = sim.camera()
    jintr = CameraIntrinsics.new(intr.image_width, intr.image_height, intr.focal_x, intr.focal_y)
    rec = SceneRecorder("ARUCO_DEFAULT")
    views = {"": [], "pallas/": []}

    def view(mk, rot, t_true):
        """(found, translation, normal, t_err, r_err) of the marker in ``mk``."""
        hit = np.nonzero(mk["id"] == sim.MARKER_ID)[0]
        if not len(hit):
            return False, np.full(3, np.nan, np.float32), np.full(3, np.nan, np.float32), \
                np.nan, np.nan
        corners = [tuple(int(v) for v in c) for c in mk["corners"][hit[0]]]
        best, _alt = pose.solve_with_intrinsics(corners, sim.MARKER_MM, jintr)
        t_est = np.asarray(best.translation, np.float32)
        z_est = np.asarray(best.rotation, np.float32)[:, 2]
        return (True, t_est, z_est, float(np.linalg.norm(t_est.astype(np.float64) - t_true)),
                float(np.degrees(np.arccos(np.clip(np.dot(rot[:, 2], z_est.astype(np.float64)),
                                                   -1, 1)))))

    for img, rot, t_true in golden.orbit_images():
        m, decs = rec.add(img)
        views[""].append(view(golden.markers_of(m, 0), rot, t_true))
        views["pallas/"].append(view(golden.markers_of(decs["pallas"], 0), rot, t_true))
    out = rec.record()
    for prefix, rows in views.items():
        found, trans, normal, t_err, r_err = zip(*rows)
        out.update({prefix + "found": np.array(found), prefix + "translation": np.stack(trans),
                    prefix + "normal": np.stack(normal), prefix + "t_err": np.array(t_err),
                    prefix + "r_err": np.array(r_err)})
    return out


def record_8k() -> dict:
    """Phase 9's frames, the 8K frame and the landscape path's frame 0,
    each also decoded by the tail warp (the spatial step's)."""
    d = ARDictionary.new_from_named_dict(golden.DICT_NAME)
    out = {}
    for label, frame in (("8k", golden.frame_8k(d)),
                         ("1080p", golden.path_frames(("landscape",))["landscape"][0][0])):
        rec = SceneRecorder(golden.DICT_NAME, tail_too=True)
        rec.add(frame)
        out.update({f"{label}/{k}": v for k, v in rec.record().items()})
    return out


def kernels_record() -> dict:
    """The JAX TPU kernels of the port's kernels 1, 4 and 8 on the probes
    of ``torch_golden.kernel_probes``, in interpret mode: the gather warp's
    samples at S = 49, its cell grids at each mark of
    ``torch_golden.PROBE_MARKS``, and its samples and grids (mark 7) at S =
    ``torch_golden.PROBE_S_WIDE``."""
    pr = golden.kernel_probes()
    grey, quads = jnp.asarray(pr["grey"]), jnp.asarray(pr["quads"])
    h, w = pr["grey"].shape[1:]
    levels = _num_levels(h, w)

    def chain_and_gather(g, hh, q, s, m):
        canvas, offsets, shapes = rectify.build_packed_pyramid(g, levels)
        planes = [canvas[:, offsets[lv] : offsets[lv] + shapes[lv][0], : shapes[lv][1]]
                  for lv in (1, 2)]
        samples, grids = rectify.warp_patches_dma(canvas, offsets, shapes, hh, q, s,
                                                  interpret=True, fuse_decode_mark=m)
        return planes, samples, grids[..., : m * m] > 0.5

    gather = jax.jit(chain_and_gather, static_argnums=(3, 4))
    out = {"hashes": np.array([golden.frame_hash(pr[k]) for k in golden.PROBE_KEYS])}
    for s, key in ((golden.PROBE_S, "H"), (golden.PROBE_S_WIDE, "H_s64")):
        out[key] = np.asarray(rectify.homography_square_to_quad(quads, s)[0])
    for m in golden.PROBE_MARKS:
        (l1, l2), samples, grids = gather(grey, jnp.asarray(out["H"]), quads, golden.PROBE_S, m)
        out[golden.probe_grid_key(m)] = np.asarray(grids)
    samples64, grids64 = gather(grey, jnp.asarray(out["H_s64"]), quads, golden.PROBE_S_WIDE,
                                golden.PROBE_MARK)[1:]
    evals = jax.jit(lambda a, x, y: warp_eval(a, x, y, interpret=True))(
        jnp.asarray(pr["windows"]), jnp.asarray(pr["ux"]), jnp.asarray(pr["uy"]))
    out.update({
        # bfloat16 levels as their float32 values (exact).
        "level1": np.asarray(l1.astype(jnp.float32)), "level2": np.asarray(l2.astype(jnp.float32)),
        "warp_samples": np.asarray(samples).reshape(samples.shape[0], samples.shape[1], -1),
        "warp_samples_s64": np.asarray(samples64).reshape(samples64.shape[0],
                                                          samples64.shape[1], -1),
        "warp_grids_s64": np.asarray(grids64),
        "warp_eval": np.asarray(evals),
    })
    return out


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
        return record_8k()
    if part == "kernels":
        return kernels_record()
    if part == "configs":
        check_config_inputs()
        out, programs = {}, {}
        for name, case in golden.config_cases().items():
            t0 = time.perf_counter()
            rec = config_record(name, programs)
            out.update({f"{name}/{k}": v for k, v in rec.items()})
            print(case_line(name, rec, case.config, golden.config_frames(name).shape,
                            time.perf_counter() - t0), flush=True)
        return out
    if part == "sweep":
        out, programs = {}, {}
        for name, case in golden.sweep_cases().items():
            t0 = time.perf_counter()
            rec = sweep_record(name, programs)
            out.update({f"{name}/{k}": v for k, v in rec.items()})
            print(case_line(name, rec, case.config, golden.sweep_frames(name).shape,
                            time.perf_counter() - t0), flush=True)
        return out
    if part == "stream":
        out, programs = {}, {}
        for name, frames in golden.stream_frames().items():
            t0 = time.perf_counter()
            rec = masked(case_record(name, DetectorConfig(), frames, programs))
            out.update({f"{name}/{k}": v for k, v in rec.items()})
            print(case_line(name, rec, DetectorConfig(), frames.shape,
                            time.perf_counter() - t0), flush=True)
        return out
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
    level1 = pfront.threshold_open_pool(tg, cfg.threshold_window, params.open_radius, ds,
                                        chain=True)[2]
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
