"""The JAX package's results on the inputs of ``chip_smoke.py``, and the
comparator that holds the PyTorch/CUDA port to them.  Imports no JAX.

The records (``tests/torch_golden/*.npz``) are written on the CPU by
``tools/torch_make_golden.py``, which runs the JAX package on the frames
this module makes.  They hold no frame: each frame's sha256 stands beside
its results, and a caller that renders the frames again (``chip_smoke.py``
on the card, ``tools/torch_parity_report.py --golden``, the tests) hands
them to the comparator, which refuses to compare when a hash differs.

Inputs (numpy, the port's renderer):

* ``path_frames``: the five paths of ``chip_smoke.py`` (landscape,
  portrait and noref 4 frames, dense 2, small 4) with ``path_specs``;
* ``scene_images``: the parity suite of ``tools/torch_parity_report.py
  --suite 400`` (seed 1234: 400 ``ARUCO_DEFAULT`` 320x240 scenes, 150
  ``ARUCO_MIP_36H12`` and 150 ``APRILTAG_36H11`` at 1920x1080) and the 20
  1080p ``ARUCO_MIP_36H12`` scenes of ``chip_smoke.py``'s phase 6 (seed 5);
* ``orbit_images``: the 24 views of ``examples/torch_pose_accuracy_sim.py``;
* ``frame_8k``: phase 9's 4320x7680 frame.

Comparison rules (ROADMAP's parity contract):

* integers bit-exact: valid masks, ids, codes, distances, rotations,
  corners (the refined pixel corners, and the rounded corners of a
  ``Detection``), candidate quads and stats;
* a lane whose outputs differ is accepted only as a fit-corner tie: its
  fit quads (before refinement) differ, and corner A of both is equally
  far from the component's centroid (``tie_lanes``, the rule of
  ``tests/torch_twin.py``'s ``assert_quads_tie_equivalent``, which calls
  it).  Each accepted tie is counted and listed; a frame with a tie may
  differ in its stats;
* poses within ``tests/test_pose.py``'s tolerances (max abs): the batched
  solve of the main path, rotations ``POSE_ROT_TOL`` and translations
  ``POSE_TRANS_TOL`` (``:227-230``, the batched float32 solve against the
  scalar one), against the JAX solve of the same corners op by op (one
  rounding an operation, as torch rounds; the bench program's own poses,
  whose multiply-adds XLA contracts as its fusions fall, are reported
  beside them, not held); the pose example's normal ``VIEW_ROT_TOL`` and
  translation ``VIEW_TRANS_TOL`` in mm (``:187-190``, the golden pose, as
  ``tests/test_torch_examples.py`` holds the example; the JAX example
  solves op by op too).

Any other difference is a fault, returned with its path or scene set,
frame, scene or view, lane and field.
"""

from __future__ import annotations

import hashlib
import sys
from dataclasses import dataclass, field, replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
RECORDS = ROOT / "tests" / "torch_golden"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tests/test_pose.py:227-230 (max abs): rotation, translation.
POSE_ROT_TOL, POSE_TRANS_TOL = 2e-5, 1e-2
# tests/test_pose.py:187-190 (max abs): rotation (the normal), translation (mm).
VIEW_ROT_TOL, VIEW_TRANS_TOL = 1e-5, 1e-3
# tests/torch_twin.py: corner A's squared distances from the centroid.
TIE_TOL = 1e-2

# The paths of chip_smoke.py.
LANDSCAPE_HW = (1080, 1920)
DICT_NAME = "ARUCO_MIP_36H12"
DENSE_HW = (2160, 3840)
SMALL_HW = (120, 160)
# The "single" scene of the twin tests at half size: marker 5 of ARUCO_DEFAULT.
SMALL_QUAD = np.array([[100, 70], [220, 75], [215, 190], [95, 185]], float) * 0.5
MARKER_MM = 40.0
PATHS = ("landscape", "portrait", "dense", "noref", "small")
# Scene sets: name -> (dictionary, scenes, (width, height), seed).
SUITE_SEED = 1234
SCENE_SETS = {
    "suite/ARUCO_DEFAULT": ("ARUCO_DEFAULT", 400, (320, 240), SUITE_SEED),
    "suite/ARUCO_MIP_36H12": ("ARUCO_MIP_36H12", 150, (1920, 1080), SUITE_SEED),
    "suite/APRILTAG_36H11": ("APRILTAG_36H11", 150, (1920, 1080), SUITE_SEED),
    "phase6": (DICT_NAME, 20, (1920, 1080), 5),
}
ORBIT_VIEWS = 24
SPATIAL_8K_SCALE, SPATIAL_8K_SEED = 4, 8  # the 8K frame's pixel repetition and noise seed
# The integer fields of a batch's outputs, compared on valid lanes.
MARKER_FIELDS = ("marker_id", "marker_dist", "marker_code", "marker_rot", "marker_corners")
POSE_KEYS = ("pose_rotations", "pose_translations", "pose_errors")


class StaleRecord(ValueError):
    """A record is missing, or was made from other frames."""


# ---------------------------------------------------------------------- inputs
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


def frame_8k(dictionary) -> np.ndarray:
    """Phase 9's 8K frame: the landscape frame without its noise
    (``render.bench_scene``, seed 0: the same 8 markers), each pixel
    repeated 4x4 (4320x7680), then Gaussian noise of sigma 2 drawn for
    each 8K pixel, as an 8K sensor's.  The noisy 1080p frame repeated
    instead carries its noise in 4x4-pixel blocks, which the opening's 5x5
    element no longer removes: the black mask fills with specks and no
    marker is found, by the port or by the JAX package."""
    from aruco3_tpu_torch import render

    h, w = LANDSCAPE_HW
    clean, _ = render.bench_scene(dictionary, (w, h), seed=0, noise_sigma=0.0)
    big = np.repeat(np.repeat(clean, SPATIAL_8K_SCALE, axis=0), SPATIAL_8K_SCALE, axis=1)
    noise = np.random.default_rng(SPATIAL_8K_SEED).standard_normal(big.shape, np.float32)
    return np.clip(big + 2.0 * noise, 0, 255).astype(np.uint8)


def path_specs() -> dict:
    """path -> (dictionary name, the port's ``DetectorConfig``)."""
    from aruco3_tpu_torch import DetectorConfig
    from aruco3_tpu_torch.models import presets

    pre = presets.get_preset("4k-dense-grid")
    return {
        "landscape": (DICT_NAME, DetectorConfig()),
        "portrait": (DICT_NAME, DetectorConfig()),
        "dense": (pre.dictionary, replace(pre.config, max_candidates=160)),
        "noref": (DICT_NAME, DetectorConfig(refine_corners=False)),
        "small": ("ARUCO_DEFAULT", DetectorConfig()),
    }


def path_frames(paths=PATHS) -> dict:
    """path -> (frames (n, H, W) u8, ground truth [(id, corners)] of frame
    0) for each of ``paths``: landscape, the 1080p bench frame
    (``render.bench_scene`` seed 0, noise 2) and seeds 1-3; portrait, the
    same turned a quarter; dense, two 14x9 boards of 230 px tags on 4K;
    noref, landscape's frames; small, four 120x160 frames of one marker
    (noise seeds 0-3)."""
    from aruco3_tpu_torch import ARDictionary, render

    specs = path_specs()
    out = {}
    if {"landscape", "portrait", "noref"} & set(paths):
        dictionary = ARDictionary.new_from_named_dict(DICT_NAME)
        h, w = LANDSCAPE_HW
        scene, truth = render.bench_scene(dictionary, (w, h), seed=0, noise_sigma=2.0)
        frames = np.stack([scene] + [render.bench_scene(dictionary, (w, h), seed=s)[0]
                                     for s in (1, 2, 3)])
        # np.rot90 turns a frame a quarter counter-clockwise: (x, y) -> (y, W-1-x).
        truth_p = [(mid, np.stack([c[:, 1], (w - 1) - c[:, 0]], axis=-1)) for mid, c in truth]
        out["landscape"] = out["noref"] = (frames, truth)
        out["portrait"] = (np.ascontiguousarray(np.rot90(frames, axes=(1, 2))), truth_p)
    if "dense" in paths:
        dense_dict = ARDictionary.new_from_named_dict(specs["dense"][0])
        dh, dw = DENSE_HW
        boards = [grid_frame(dense_dict, dh, dw, 230, np.random.default_rng(s), 14, 9)
                  for s in range(2)]
        out["dense"] = (np.stack([b[0] for b in boards]), boards[0][1])
    if "small" in paths:
        small_dict = ARDictionary.new_from_named_dict(specs["small"][0])
        sh, sw = SMALL_HW
        smalls = [render.render_marker(small_dict, 5, (sw, sh), SMALL_QUAD, noise_sigma=2.0,
                                       rng=np.random.default_rng(s)) for s in range(4)]
        out["small"] = (np.stack(smalls), [(5, SMALL_QUAD)])
    return {p: out[p] for p in paths}


def scene_images(name: str, n: int | None = None):
    """Yields (kind, image, truth) of the first ``n`` scenes (all if None)
    of scene set ``name``, drawn as ``parity.reference_scenes`` draws them
    (one generator in order)."""
    from aruco3_tpu_torch import ARDictionary, parity

    dict_name, count, size, seed = SCENE_SETS[name]
    d = ARDictionary.new_from_named_dict(dict_name)
    rng = np.random.default_rng(seed)
    for k in range(count if n is None else min(n, count)):
        kind = parity.SCENE_KINDS[k % len(parity.SCENE_KINDS)]
        img, truths = parity.generate_scene(d, rng, size, kind)
        yield kind, img, truths


def pose_example():
    """``examples/torch_pose_accuracy_sim.py`` as a module."""
    path = str(ROOT / "examples")
    if path not in sys.path:
        sys.path.insert(0, path)
    import torch_pose_accuracy_sim

    return torch_pose_accuracy_sim


def orbit_images(n: int = ORBIT_VIEWS):
    """[(image, rotation, translation)] of the pose example's first ``n`` views."""
    sim = pose_example()
    d = sim.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    return list(sim.orbit_views(n, d, sim.camera()))


def frame_hash(img) -> str:
    """sha256 of a frame's dtype, shape and bytes."""
    a = np.ascontiguousarray(img)
    h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


# --------------------------------------------------------------------- records
def load(name: str) -> dict:
    """``tests/torch_golden/<name>.npz`` as a dict of arrays."""
    path = RECORDS / f"{name}.npz"
    if not path.exists():
        raise StaleRecord(f"no record {path}: make it with tools/torch_make_golden.py")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def subset(rec: dict, prefix: str) -> dict:
    """The entries of ``rec`` under ``prefix/``, the prefix taken off."""
    p = prefix + "/"
    out = {k[len(p):]: v for k, v in rec.items() if k.startswith(p)}
    if not out:
        raise StaleRecord(f"the record holds nothing for {prefix}")
    return out


def check_hashes(where: str, hashes, frames) -> None:
    """Raises ``StaleRecord`` unless ``frames`` are the recorded ones."""
    if len(hashes) != len(frames):
        raise StaleRecord(f"{where}: {len(hashes)} frames recorded, {len(frames)} given")
    bad = [i for i, (h, f) in enumerate(zip(hashes, frames)) if str(h) != frame_hash(f)]
    if bad:
        raise StaleRecord(f"{where}: frames {bad} differ from the recorded ones (sha256)")


def host(tree):
    """Tensors (any device) of nested dicts and tuples as numpy arrays."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(host(v) for v in tree)
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return tree


def batch_record(out, poses=None) -> dict:
    """A detect batch's outputs (``detect_batch_arrays``, either package)
    and its poses (rotations, translations, errors) in the record's layout."""
    o = host(out)
    rec = {k: np.asarray(o[k]) for k in ("quads", "quad_valid", "marker_valid") + MARKER_FIELDS}
    rec["marker_code"] = rec["marker_code"].astype(np.int64)
    for k, v in o["stats"].items():
        rec[f"stats/{k}"] = np.asarray(v).astype(np.int64)
    if poses is not None:
        for k, v in zip(POSE_KEYS, host(poses)):
            rec[k] = np.asarray(v)
    return rec


def markers_of(out, f: int) -> dict:
    """The valid lanes of frame ``f`` of a detect batch as
    ``Detector.detect`` lists them: lane, id, code (lo, hi), distance and
    corners rounded half to even, as ``to_host`` rounds them."""
    o = host({k: out[k] for k in ("marker_valid",) + MARKER_FIELDS})
    lanes = np.nonzero(o["marker_valid"][f])[0]
    return {
        "lane": lanes.astype(np.int64),
        "id": o["marker_id"][f][lanes].astype(np.int64),
        "code": o["marker_code"][f][lanes].astype(np.int64),
        "dist": o["marker_dist"][f][lanes].astype(np.int64),
        "corners": np.rint(o["marker_corners"][f][lanes].astype(np.float64)).astype(np.int64),
    }


def fit_lanes(quads, centroids, sizes) -> dict:
    """The used fit lanes (size > 0) of one frame's candidates."""
    q, c, s = (np.asarray(a) for a in (quads, centroids, sizes))
    lanes = np.nonzero(s > 0)[0]
    return {"lane": lanes.astype(np.int64), "quads": q[lanes].astype(np.float32),
            "centroids": c[lanes].astype(np.float32), "sizes": s[lanes].astype(np.int64)}


def pack(items: list[dict]) -> dict:
    """Per-item dicts of equal keys -> concatenated arrays with ``offsets``."""
    keys = items[0].keys()
    out = {k: np.concatenate([it[k] for it in items]) for k in keys}
    out["offsets"] = np.cumsum([0] + [len(it["lane"]) for it in items]).astype(np.int64)
    return out


MARKER_KEYS = ("lane", "id", "code", "dist", "corners")
FIT_KEYS = ("lane", "quads", "centroids", "sizes")


def unpack(rec: dict, prefix: str, k: int, keys=MARKER_KEYS) -> dict:
    """Item ``k`` of ``pack``'s arrays ``keys`` stored under ``prefix``."""
    lo, hi = rec[f"{prefix}offsets"][k], rec[f"{prefix}offsets"][k + 1]
    return {key: rec[prefix + key][lo:hi] for key in keys}


def head(rec: dict, n: int) -> dict:
    """A scene set's record cut to its first ``n`` scenes."""
    out = {"hashes": rec["hashes"][:n], "lanes": rec["lanes"]}
    for prefix, keys in (("", MARKER_KEYS), ("fit/", FIT_KEYS)):
        offsets = rec[f"{prefix}offsets"][: n + 1]
        out[f"{prefix}offsets"] = offsets
        out.update({prefix + k: rec[prefix + k][: offsets[-1]] for k in keys})
    return out


def dense_fits(fits: dict, k_lanes: int):
    """Used fit lanes back in lane order: (quads (K, 4, 2), centroids (K, 2), sizes (K,))."""
    q = np.zeros((k_lanes, 4, 2), np.float32)
    c = np.zeros((k_lanes, 2), np.float32)
    s = np.zeros((k_lanes,), np.int64)
    lanes = fits["lane"]
    q[lanes], c[lanes], s[lanes] = fits["quads"], fits["centroids"], fits["sizes"]
    return q, c, s


def port_fits(det, frames):
    """The port's fit quads of ``frames`` (before refinement) on the
    detector's route: (n, K, 4, 2) numpy."""
    import torch

    from aruco3_tpu_torch import detector, frontend
    from aruco3_tpu_torch.ops.frontend import threshold_open_pool

    images = torch.as_tensor(np.ascontiguousarray(frames)).to(det.device)
    grey = frontend.rgb_to_luma_u8(images).contiguous()
    params, _, _, ds = det.geometry(*grey.shape[1:])
    coarse = threshold_open_pool(grey, det.config.threshold_window, params.open_radius, ds)[0]
    fused = not detector.tail_route(params, ds) and detector.fit_route(
        coarse.shape[1], coarse.shape[2], params.max_candidates, params.max_inner_candidates
    ) == "fused"
    cand = detector.fit_candidates(coarse, params, ds, fused)[0]
    return host(cand["quads"])


# ------------------------------------------------------------------ comparator
@dataclass
class Difference:
    where: str
    item: int  # frame, scene or view
    lane: int | None
    field: str
    jax: object
    port: object

    def __str__(self) -> str:
        lane = "" if self.lane is None else f" lane {self.lane}"
        return f"{self.where} #{self.item}{lane} {self.field}: jax {self.jax} port {self.port}"


@dataclass
class Report:
    """What one comparison found: items compared and equal, marker lanes
    compared, accepted ties [(item, lane, fields)], differences, and the
    largest pose differences (rotation, translation)."""

    where: str
    compared: int = 0
    equal: int = 0
    lanes: int = 0
    ties: list = field(default_factory=list)
    differences: list = field(default_factory=list)
    rot_max: float = 0.0
    trans_max: float = 0.0
    bench_rot_max: float = 0.0
    bench_trans_max: float = 0.0

    def counts(self) -> dict:
        return {"compared": self.compared, "equal": self.equal, "lanes": self.lanes,
                "ties_accepted": len(self.ties), "differences": len(self.differences),
                "pose_rot_max_abs": self.rot_max, "pose_trans_max_abs": self.trans_max,
                "bench_pose_rot_max_abs": self.bench_rot_max,
                "bench_pose_trans_max_abs": self.bench_trans_max}


def tie_lanes(qa, qb, centroids, sizes):
    """(differs, accepted) over lanes: used lanes (size > 0) whose fitted
    quads differ, and of those the ones where corner A of both quads lies
    equally far (squared distance within ``TIE_TOL``) from the component's
    centroid: an extreme-point tie, after which the other corners
    legitimately follow the other choice."""
    qa, qb = np.asarray(qa, np.float64), np.asarray(qb, np.float64)
    cen = np.asarray(centroids, np.float64)
    used = np.asarray(sizes) > 0
    differs = (qa != qb).reshape(qa.shape[:-2] + (-1,)).any(-1) & used
    da = ((qa[..., 0, :] - cen) ** 2).sum(-1)
    db = ((qb[..., 0, :] - cen) ** 2).sum(-1)
    return differs, differs & (np.abs(da - db) < TIE_TOL)


def _settle(rep: Report, item: int, diffs: list, fits) -> None:
    """Files one item's differences: lanes whose fit quads are a tie
    (``fits()`` -> (port quads, jax quads, jax centroids, jax sizes), asked
    only when something differs) are accepted and counted; every other
    difference, and a fit difference that is no tie, is a fault."""
    if not diffs:
        rep.equal += 1
        return
    lanes = {d.lane for d in diffs if d.lane is not None}
    accepted = set()
    if fits is not None and lanes:
        pq, jq, jc, js = fits()
        differs, ok = tie_lanes(pq, jq, jc, js)
        accepted = {int(k) for k in np.nonzero(ok)[0]} & lanes
        for k in np.nonzero(differs & ~ok)[0]:
            if int(k) in lanes:
                diffs.append(Difference(rep.where, item, int(k), "fit_quads",
                                        jq[k].tolist(), pq[k].tolist()))
    for k in sorted(accepted):
        rep.ties.append((item, k, sorted({d.field for d in diffs if d.lane == k})))
    rep.differences += [d for d in diffs if d.lane not in accepted
                        and not (d.lane is None and accepted and d.field.startswith("stats/"))]


def compare_batch(where: str, rec: dict, frames, out, poses=None, fits_of=None) -> Report:
    """A detect batch of ``frames`` (outputs ``out``, poses (rotations,
    translations, errors) or None) against its record ``rec``
    (``subset(load("paths"), path)``), frame by frame and lane by lane.
    ``fits_of()`` -> the port's fit quads of the frames (``port_fits``),
    asked only when a lane differs."""
    check_hashes(where, rec["hashes"], frames)
    got = batch_record(out, poses)
    rep = Report(where)
    port_fit = []

    def fits(f):
        def get():
            if not port_fit:
                port_fit.append(fits_of())
            return port_fit[0][f], rec["fit_quads"][f], rec["fit_centroids"][f], rec["fit_sizes"][f]
        return get if fits_of is not None else None

    for f in range(len(frames)):
        rep.compared += 1
        diffs = []
        for key in ("quad_valid", "marker_valid"):
            for k in np.nonzero(got[key][f] != rec[key][f])[0]:
                diffs.append(Difference(where, f, int(k), key, bool(rec[key][f][k]),
                                        bool(got[key][f][k])))
        both_q = got["quad_valid"][f] & rec["quad_valid"][f]
        for k in np.nonzero(both_q)[0]:
            if not np.array_equal(got["quads"][f][k], rec["quads"][f][k]):
                diffs.append(Difference(where, f, int(k), "quads", rec["quads"][f][k].tolist(),
                                        got["quads"][f][k].tolist()))
        both = got["marker_valid"][f] & rec["marker_valid"][f]
        rep.lanes += int(both.sum())
        for key in MARKER_FIELDS:
            for k in np.nonzero(both)[0]:
                a, b = rec[key][f][k], got[key][f][k]
                if not np.array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64)):
                    diffs.append(Difference(where, f, int(k), key, np.asarray(a).tolist(),
                                            np.asarray(b).tolist()))
        for key in sorted(k for k in rec if k.startswith("stats/")):
            if key not in got or int(got[key][f]) != int(rec[key][f]):
                diffs.append(Difference(where, f, None, key, int(rec[key][f]),
                                        None if key not in got else int(got[key][f])))
        if poses is not None:
            for k in np.nonzero(both)[0]:
                for key, tol, attr in (("pose_rotations", POSE_ROT_TOL, "rot_max"),
                                       ("pose_translations", POSE_TRANS_TOL, "trans_max")):
                    d = float(np.abs(got[key][f][k].astype(np.float64)
                                     - rec[key][f][k].astype(np.float64)).max())
                    if not np.isfinite(d) or d > tol:
                        diffs.append(Difference(where, f, int(k), key, rec[key][f][k].tolist(),
                                                got[key][f][k].tolist()))
                    elif d > getattr(rep, attr):
                        setattr(rep, attr, d)
                    if "bench_" + key in rec:  # reported, not held
                        d = float(np.abs(got[key][f][k].astype(np.float64)
                                         - rec["bench_" + key][f][k].astype(np.float64)).max())
                        setattr(rep, "bench_" + attr, max(getattr(rep, "bench_" + attr), d))
        _settle(rep, f, diffs, fits(f))
    return rep


def compare_scenes(where: str, rec: dict, frames, outs, fits_of=None) -> Report:
    """Detections of scenes (one ``detect_batch`` output of one frame
    each, ``outs``) against the records of the scene set (``subset(load(
    "scenes"), name)``): per scene the same marker lanes, and on each its
    id, code, distance and rounded corners.  ``fits_of(k)`` -> the port's
    fit quads of scene ``k`` (1, K, 4, 2), asked only when a lane
    differs."""
    check_hashes(where, rec["hashes"], frames)
    rep = Report(where)
    k_lanes = int(rec["lanes"])
    for k, out in enumerate(outs):
        rep.compared += 1
        want = unpack(rec, "", k)
        got = markers_of(out, 0)
        diffs = marker_diffs(where, k, want, got)
        rep.lanes += len(set(want["lane"].tolist()) & set(got["lane"].tolist()))

        def fits(k=k):
            jq, jc, js = dense_fits(unpack(rec, "fit/", k, FIT_KEYS), k_lanes)
            return fits_of(k)[0], jq, jc, js

        _settle(rep, k, diffs, fits if fits_of is not None else None)
    return rep


def marker_diffs(where: str, item: int, want: dict, got: dict) -> list:
    """Differences between two ``markers_of`` lists, lane by lane."""
    diffs = []
    wl, gl = want["lane"].tolist(), got["lane"].tolist()
    for lane in sorted(set(wl) ^ set(gl)):
        diffs.append(Difference(where, item, lane, "marker_valid", lane in wl, lane in gl))
    for lane in sorted(set(wl) & set(gl)):
        i, j = wl.index(lane), gl.index(lane)
        for key in ("id", "code", "dist", "corners"):
            if not np.array_equal(want[key][i], got[key][j]):
                diffs.append(Difference(where, item, lane, key, want[key][i].tolist(),
                                        got[key][j].tolist()))
    return diffs


def compare_views(where: str, rec: dict, frames, views) -> Report:
    """The pose example's views (``simulate(...)["views"]``) against the
    record: the same ids in order, and the marker's translation (mm) and
    normal within ``VIEW_TRANS_TOL`` and ``VIEW_ROT_TOL``, or missed in both."""
    check_hashes(where, rec["hashes"], frames)
    rep = Report(where)
    for v, view in enumerate(views):
        rep.compared += 1
        diffs = []
        ids = unpack(rec, "", v)["id"].tolist()
        if view["ids"] != ids:
            diffs.append(Difference(where, v, None, "ids", ids, view["ids"]))
        found = bool(rec["found"][v])
        if (view["translation"] is not None) != found:
            diffs.append(Difference(where, v, None, "found", found,
                                    view["translation"] is not None))
        elif found:
            for key, tol, attr in (("normal", VIEW_ROT_TOL, "rot_max"),
                                   ("translation", VIEW_TRANS_TOL, "trans_max")):
                d = float(np.abs(np.asarray(view[key], np.float64)
                                 - rec[key][v].astype(np.float64)).max())
                if not np.isfinite(d) or d > tol:
                    diffs.append(Difference(where, v, None, key, rec[key][v].tolist(),
                                            np.asarray(view[key]).tolist()))
                elif d > getattr(rep, attr):
                    setattr(rep, attr, d)
        _settle(rep, v, diffs, None)
    return rep


def view_stats(rec: dict) -> dict:
    """The recorded views' errors as the pose example reports them: views
    detected, translation (mm) and normal-axis (degrees) mean, p95, max."""
    found = rec["found"].astype(bool)
    out = {"detected": int(found.sum())}
    for key in ("t_err", "r_err"):
        e = rec[key][found].astype(np.float64)
        out.update({f"{key}_mean": round(float(e.mean()), 4),
                    f"{key}_p95": round(float(np.percentile(e, 95)), 4),
                    f"{key}_max": round(float(e.max()), 4)} if len(e) else {})
    return out
