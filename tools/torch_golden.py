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
* ``frame_8k``: phase 9's 4320x7680 frame;
* ``kernel_probes``: seeded probes of kernels 1, 4 and 8 (a frame, quads
  at pyramid levels 0-3, windows and window coordinates), whose record
  (``kernels.npz``) holds the JAX TPU kernels' outputs on them (kernel
  4's cell grids at marks 6, 7, 8 and 10, and its samples and grids at
  S = 64 too);
* ``config_frames``: the configurations users run, ``config_cases``
  (``configs.npz``; ``chip_smoke.py``'s phase 12), in this order:

  - ``config1``: BASELINE config 1 (``benches/bench_configs.py:126-148``),
    one 640x480 ``ARUCO_DEFAULT`` frame, ``random_marker_scene(d, 5,
    rng=default_rng(0))``, ``DetectorConfig()``: the refine route at ds 4;
  - ``config2``: BASELINE config 2 (``:151-188``), 64 VGA frames of 1-4
    markers (``default_rng(1)``), at batch 64;
  - ``config2_noise``: its noise frames (``noise=True``): 64 VGA frames
    of uniform noise, which fill every candidate lane, at batch 64;
  - ``config4``: BASELINE config 4 (``:191-217``, ``:230-278``): the
    ``4k-dense-grid`` preset (``models/presets.py:47-57``: 96 lanes, its
    gates) on ``_grid_frame`` at cell 330, a 10x7 ``APRILTAG_36H11`` grid
    on 2160x3840 (noise ``default_rng(2)``), one frame recorded, stacked
    to batch 32 on the card, detect only as config 4 times it (also
    through ``Detector.detect_batch``);
  - ``preset/reference-default`` (``models/presets.py:32-38``) on config
    1's frame; ``preset/low-latency-tracker`` (``:59-65``, 8 lanes) on a
    480x640 board of 12 ``APRILTAG_36H11`` tags, more than its lanes;
    ``preset/permissive-decode`` (``:67-73``) on ``config2_noise``'s first
    8 frames and marker 5 with a corrupted code (``tests/
    test_torch_configs.py:29``'s construction at 480x640).  The fifth
    preset, ``1080p-mip36h12``, is the landscape path of ``paths``;
  - ``dict/<NAME>`` for each of the 15 dictionaries (the alias
    ``ARUCO_DEFAULT`` too), ``DetectorConfig()``, and ``dict/<NAME>:noref``
    with ``refine_corners=False`` (the tail route): a 480x640 board of 12
    tags of 104 px (``grid_frame``, noise sigma 2) and its left-right
    mirror;
  - ``rgb``: ``config2``'s first 4 frames as (4, 480, 640, 3), each
    channel tinted by a seeded gain and offset, so that luma is not the
    grey;
  - ``clutter`` and ``clutter:noref`` (``DetectorConfig()`` and without
    refinement, ``ARUCO_DEFAULT``): 4 VGA frames of uniform noise in 4x4
    blocks.  Config 2's noise frames leave no component after the 5x5
    opening; these leave about a thousand more than the 32 lanes hold, so
    the lane selection and kernel 2's round limits run full;
* ``sweep_frames``: the settings users change, ``sweep_cases``
  (``sweep.npz``; ``chip_smoke.py``'s phase 13): each field of
  ``DetectorConfig`` at values no other record takes, odd frame shapes
  and four- and one-channel frames (``sweep_cases`` says which);
* ``stream_frames``: BASELINE config 5's stream (``stream.npz``; phase 7).

Each record holds JAX's CPU route (its warp is the XLA pyramid warp) and,
under ``pallas/``, the decode of JAX's quads by the Pallas warp of the
port's route (``held``): the gather warp on the bfloat16 chain pyramid on
the refine route, ``warp_eval`` on the tail route.  The port is held to
the latter in every field a warp decides (marker validity, id, code,
distance, rotation, rotated corners, the decode's stats, poses); quads,
fits and candidate stats to both, which agree.  The lanes where JAX's two
warps decode differently are counted and listed (``Report.warp_split``)
and fail nothing.  Phase 9's frames also hold the tail warp's decode
(``tail/``), the spatial step's.

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

import functools
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
# The "single" scene of the twin tests (marker 5 of ARUCO_DEFAULT on 320x240),
# and at half size.
SINGLE_QUAD = np.array([[100, 70], [220, 75], [215, 190], [95, 185]], float)
SMALL_QUAD = SINGLE_QUAD * 0.5
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
# The kernel probes: frame, patch side and mark size, lanes a level (0-3),
# windows, seed.
PROBE_HW, PROBE_S, PROBE_MARK = (240, 320), 49, 7
PROBE_LANES, PROBE_WINDOWS, PROBE_SEED = 4, 8, 12
PROBE_KEYS = ("grey", "quads", "windows", "ux", "uy")
# Quad sides (px) that land on pyramid levels 0-3 of a PROBE_HW frame.
PROBE_SIDES = ((12, 36), (62, 76), (122, 150), (250, 300))
# Kernel 4's marks in the probes (the 15 dictionaries' 6, 7, 8 and 10), and
# the patch side of its second probe.
PROBE_MARKS, PROBE_S_WIDE = (6, 7, 8, 10), 64
# The configurations of ``configs.npz``: VGA frames; config 4's grid
# (cell, columns x rows, noise seed) on 4K and its batch; the boards of the
# dict/ and tracker cases (4x3 tags of 104 px, above ``DetectorConfig()``'s
# edge gate of 0.2 * 480 = 96 px), their noise seed (plus the dictionary's
# index); seeds of the tracker's board, the corrupted frame and the tints.
CONFIG_HW, CONFIG2_FRAMES = (480, 640), 64
CONFIG4_CELL, CONFIG4_GRID, CONFIG4_SEED, CONFIG4_BATCH = 330, (10, 7), 2, 32
BOARD_CELL, BOARD_GRID, BOARD_SEED = 130, (4, 3), 20
TRACKER_SEED, CORRUPT_SEED, RGB_SEED, CLUTTER_SEED = 13, 14, 15, 16
PERMISSIVE_NOISE_FRAMES, RGB_FRAMES, CLUTTER_FRAMES, CLUTTER_BLOCK = 8, 4, 4, 4
# The sweep (``sweep.npz``): its board's dictionary and seed, the shapes'
# dictionary, frames a shape and their seed, the seeds of the colour frames'
# tints and alpha.
SWEEP_DICT, SWEEP_SEED, SHAPE_DICT, SHAPE_FRAMES, SHAPE_SEED = (
    "ARUCO_DEFAULT", 30, "ARUCO_MIP_36H12", 3, 31)
CHANNEL_SEED = 32
SMALL_TAGS_CELL, SMALL_TAGS_GRID = 52, (11, 8)
SWEEP_SHAPES = ((241, 323), (479, 641), (555, 777), (250, 1000), (1000, 250), (190, 190),
                (97, 131))
SWEEP_S = (25, 36, 64, 81)
# BASELINE config 5's stream (``stream.npz``): its dictionaries, streams a
# dictionary, frames a stream, and the seed of stream 0's scene.
STREAM_DICTS, STREAM_PER_DICT, STREAM_DEPTH, STREAM_SEED = (
    ("ARUCO_MIP_36H12", "APRILTAG_36H11"), 2, 4, 50)
CONFIG_DICTS =("APRILTAG_16H5", "APRILTAG_25H7", "APRILTAG_25H9", "APRILTAG_36H10",
                "APRILTAG_36H11", "APRILTAG_36H9", "ARTAG", "ARTOOLKITPLUS", "ARTOOLKITPLUSBCH",
                "ARUCO", "ARUCO_DEFAULT", "ARUCO_MIP_16H3", "ARUCO_MIP_25H7", "ARUCO_MIP_36H12",
                "CHILITAGS")
NOREF = ":noref"  # suffix of a dict/ case on the tail route
# Record prefixes of the Pallas warps' decodes: the route's own, the tail warp's.
DECODES = ("pallas", "tail")
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


def kernel_probes() -> dict:
    """The inputs of ``kernels.npz`` (numpy, from ``PROBE_SEED``): grey
    (1, 240, 320) u8, dark blocks and noise; quads (1, 4 * PROBE_LANES, 4,
    2) f32, squares turned and perturbed, PROBE_LANES of each side range
    of ``PROBE_SIDES`` (pyramid levels 0-3), centred anywhere in the frame;
    windows (PROBE_WINDOWS, 64, 64) f32 grey values that are not bfloat16
    values; ux, uy (PROBE_WINDOWS, PROBE_S^2) f32 window coordinates
    inside, in the edge bands (-1, 0) and (63, 64), on the edges and far
    outside."""
    rng = np.random.default_rng(PROBE_SEED)
    h, w = PROBE_HW
    img = np.full((h, w), 200.0)
    for _ in range(12):
        y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y0 : y0 + rng.integers(4, h // 3), x0 : x0 + rng.integers(4, w // 3)] = rng.uniform(0, 90)
    grey = np.clip(np.round(img + rng.normal(0, 12, img.shape)), 0, 255).astype(np.uint8)[None]
    base = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]])
    quads = []
    for lo, hi in PROBE_SIDES:
        for _ in range(PROBE_LANES):
            side, ang = rng.uniform(lo, hi), rng.uniform(0, 2 * np.pi)
            rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
            # At most 45 degrees off the axes' bounding box, so the side
            # range keeps its level.
            rot = rot if abs(np.sin(2 * ang)) < 0.5 else np.eye(2)
            q = base @ rot.T * side + rng.uniform(-0.02, 0.02, (4, 2)) * side
            quads.append(q + rng.uniform([0, 0], [w, h]))
    n = PROBE_WINDOWS * PROBE_S * PROBE_S

    def coords():
        u = rng.uniform(0.0, 63.0, n)
        band = rng.integers(0, 6, n)
        u = np.where(band == 1, rng.uniform(-1.0, 0.0, n), u)
        u = np.where(band == 2, rng.uniform(63.0, 64.0, n), u)
        u = np.where(band == 3, rng.choice([-1.0, 0.0, 63.0, 64.0, 62.5], n), u)
        u = np.where(band == 4, rng.choice([-7.5, 70.25, -1e6, 1e6], n), u)
        return u.reshape(PROBE_WINDOWS, -1).astype(np.float32)

    return {"grey": grey, "quads": np.array(quads, np.float32)[None],
            "windows": rng.uniform(0, 255, (PROBE_WINDOWS, 64, 64)).astype(np.float32),
            "ux": coords(), "uy": coords()}


def probe_grid_key(m: int) -> str:
    """The key of kernel 4's cell grids at mark ``m`` in ``kernels.npz``."""
    return "warp_grids" if m == PROBE_MARK else f"warp_grids_m{m}"


def port_kernel_outputs(device) -> dict:
    """The port's kernels 1, 4 and 8 on ``kernel_probes`` (their plain
    versions on the CPU), as ``kernels.npz`` holds the JAX TPU kernels'
    outputs: kernel 1's refine-mode level 1 and the chain's level 2
    (``rectify.upper_levels``), kernel 4's samples and its cell grids at
    each of ``PROBE_MARKS`` through the recorded homographies, and its
    samples and grids (mark 7) at S = ``PROBE_S_WIDE`` through that side's;
    kernel 8's samples; numpy, bfloat16 levels as float32.  Also "levels":
    the pyramid level of each probe lane."""
    import torch

    from aruco3_tpu_torch import rectify
    from aruco3_tpu_torch.ops import frontend, warp_decode, warp_eval

    rec = load("kernels")
    pr = kernel_probes()
    check_hashes("kernels", rec["hashes"], [pr[k] for k in PROBE_KEYS])
    t = {k: torch.from_numpy(v).to(device) for k, v in pr.items()}
    shapes = rectify.pyramid_level_shapes(*PROBE_HW, rectify.num_levels(*PROBE_HW))
    uppers = rectify.upper_levels(frontend.threshold_open_pool(t["grey"], 7, 2, 2, chain=True)[2],
                                  shapes)
    lvl, tlx, tly = rectify.warp_windows(t["quads"], shapes)

    def warp(key_h, s, m):
        return warp_decode.warp_decode(
            t["grey"], uppers, torch.from_numpy(rec[key_h]).to(device), lvl, tlx, tly,
            torch.ones_like(lvl, dtype=torch.bool), s, m)

    samples = warp("H", PROBE_S, PROBE_MARK)[0]
    wide, _, wide_grids = warp("H_s64", PROBE_S_WIDE, PROBE_MARK)
    out = {"level1": uppers[0].float(), "level2": uppers[1].float(),
           "warp_samples": samples.reshape(rec["warp_samples"].shape),
           "warp_samples_s64": wide.reshape(rec["warp_samples_s64"].shape),
           "warp_grids_s64": wide_grids,
           "warp_eval": warp_eval.warp_eval(t["windows"], t["ux"], t["uy"]), "levels": lvl}
    for m in PROBE_MARKS:
        out[probe_grid_key(m)] = warp("H", PROBE_S, m)[2]
    return {k: v.cpu().numpy() for k, v in out.items()}


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


@dataclass(frozen=True)
class ConfigCase:
    """A case of ``configs.npz``: dictionary name, the port's
    ``DetectorConfig``, the batch it is driven at on the card (its recorded
    frames, or its one recorded frame stacked) and whether it runs detect
    only (config 4)."""

    dictionary: str
    config: object
    batch: int
    detect_only: bool = False


def config_cases() -> dict:
    """name -> ``ConfigCase``, in the record's order (the module docstring
    says where each comes from)."""
    from aruco3_tpu_torch import DetectorConfig
    from aruco3_tpu_torch.models import presets

    default = DetectorConfig()
    cases = {
        "config1": ConfigCase("ARUCO_DEFAULT", default, 1),
        "config2": ConfigCase("ARUCO_DEFAULT", default, CONFIG2_FRAMES),
        "config2_noise": ConfigCase("ARUCO_DEFAULT", default, CONFIG2_FRAMES),
    }
    dense = presets.get_preset("4k-dense-grid")
    cases["config4"] = ConfigCase(dense.dictionary, dense.config, CONFIG4_BATCH, True)
    batches = {"reference-default": 1, "low-latency-tracker": 1,
               "permissive-decode": PERMISSIVE_NOISE_FRAMES + 1}
    for name, batch in batches.items():
        pre = presets.get_preset(name)
        cases[f"preset/{name}"] = ConfigCase(pre.dictionary, pre.config, batch)
    for name in CONFIG_DICTS:
        cases[f"dict/{name}"] = ConfigCase(name, default, 2)
        cases[f"dict/{name}{NOREF}"] = ConfigCase(name, replace(default, refine_corners=False), 2)
    cases["rgb"] = ConfigCase("ARUCO_DEFAULT", default, RGB_FRAMES)
    cases["clutter"] = ConfigCase("ARUCO_DEFAULT", default, CLUTTER_FRAMES)
    cases["clutter" + NOREF] = ConfigCase("ARUCO_DEFAULT", replace(default, refine_corners=False),
                                          CLUTTER_FRAMES)
    return cases


def _dictionary(name: str):
    from aruco3_tpu_torch import ARDictionary

    return ARDictionary.new_from_named_dict(name)


@functools.lru_cache(maxsize=None)
def config1_frame() -> np.ndarray:
    """BASELINE config 1's frame (``benches/bench_configs.py:134-135``)."""
    from aruco3_tpu_torch import render

    h, w = CONFIG_HW
    return render.random_marker_scene(_dictionary("ARUCO_DEFAULT"), 5, (w, h),
                                      rng=np.random.default_rng(0))[0]


@functools.lru_cache(maxsize=None)
def config2_frames(noise: bool, n: int = CONFIG2_FRAMES) -> np.ndarray:
    """The first ``n`` of BASELINE config 2's 64 frames
    (``benches/bench_configs.py:157-179``): 1-4 markers each, every one a
    320x240 ``random_marker_scene`` in its quadrant; with ``noise``,
    uniform noise."""
    from aruco3_tpu_torch import render

    d = _dictionary("ARUCO_DEFAULT")
    h, w = CONFIG_HW
    rng = np.random.default_rng(1)
    frames = []
    for _ in range(n):
        if noise:
            frames.append(rng.integers(0, 256, size=(h, w), dtype=np.uint8))
            continue
        img = np.full((h, w), 255, dtype=np.uint8)
        for j in range(int(rng.integers(1, 5))):
            mid = int(rng.integers(0, len(d)))
            sub, _, _ = render.random_marker_scene(d, mid, (w // 2, h // 2), rng=rng,
                                                   min_scale=0.4, max_scale=0.7)
            y0, x0 = (j // 2) * (h // 2), (j % 2) * (w // 2)
            img[y0 : y0 + h // 2, x0 : x0 + w // 2] = np.minimum(
                img[y0 : y0 + h // 2, x0 : x0 + w // 2], sub)
        frames.append(img)
    return np.stack(frames)


def board(dict_name: str, seed: int) -> np.ndarray:
    """A 480x640 ``grid_frame`` board of 12 tags of ``dict_name`` (ids 0-11)."""
    h, w = CONFIG_HW
    return grid_frame(_dictionary(dict_name), h, w, BOARD_CELL, np.random.default_rng(seed),
                      *BOARD_GRID)[0]


def corrupted_frame() -> np.ndarray:
    """Marker 5 of ``ARUCO_DEFAULT`` on 480x640 (the twin tests' "single"
    quad doubled) with a patch of its code cells painted near-white: a
    decode more than tau from any code (``tests/test_torch_configs.py:29``)."""
    from aruco3_tpu_torch import render

    h, w = CONFIG_HW
    img = render.render_marker(_dictionary("ARUCO_DEFAULT"), 5, (w, h), SINGLE_QUAD * 2,
                               noise_sigma=2.0, rng=np.random.default_rng(CORRUPT_SEED))
    img[210:300, 280:370] = 235
    return img


def tinted(frames: np.ndarray, seed: int) -> np.ndarray:
    """(n, H, W) grey -> (n, H, W, 3): each channel of each frame scaled by
    a gain in [0.6, 1) and lifted by an offset in [0, 40)."""
    rng = np.random.default_rng(seed)
    gain = rng.uniform(0.6, 1.0, (len(frames), 1, 1, 3))
    offset = rng.integers(0, 40, (len(frames), 1, 1, 3))
    return np.clip(np.round(frames[..., None] * gain + offset), 0, 255).astype(np.uint8)


def config_frames(name: str) -> np.ndarray:
    """The recorded frames of case ``name`` of ``config_cases``: (n, H, W)
    u8, or (n, H, W, 3) for ``rgb``."""
    if name in ("config1", "preset/reference-default"):
        return config1_frame()[None]
    if name == "config2":
        return config2_frames(False)
    if name == "config2_noise":
        return config2_frames(True)
    if name == "config4":
        (h, w), (cols, rows) = DENSE_HW, CONFIG4_GRID
        return grid_frame(_dictionary("APRILTAG_36H11"), h, w, CONFIG4_CELL,
                          np.random.default_rng(CONFIG4_SEED), cols, rows)[0][None]
    if name == "preset/low-latency-tracker":
        return board("APRILTAG_36H11", TRACKER_SEED)[None]
    if name == "preset/permissive-decode":
        return np.concatenate([config2_frames(True, PERMISSIVE_NOISE_FRAMES),
                               corrupted_frame()[None]])
    if name.startswith("dict/"):
        dict_name = name[len("dict/"):].removesuffix(NOREF)
        img = board(dict_name, BOARD_SEED + CONFIG_DICTS.index(dict_name))
        return np.stack([img, np.ascontiguousarray(img[:, ::-1])])
    if name == "rgb":
        return tinted(config2_frames(False, RGB_FRAMES), RGB_SEED)
    if name.startswith("clutter"):
        (h, w), k = CONFIG_HW, CLUTTER_BLOCK
        small = np.random.default_rng(CLUTTER_SEED).integers(
            0, 256, (CLUTTER_FRAMES, h // k, w // k), dtype=np.uint8)
        return np.ascontiguousarray(np.repeat(np.repeat(small, k, axis=1), k, axis=2))
    raise KeyError(name)


@dataclass(frozen=True)
class SweepCase:
    """A case of ``sweep.npz``: dictionary name, the port's
    ``DetectorConfig``, its frames (a source of ``sweep_source``), driven
    on the card at their count, and whether its point is lane overflow
    (its frames may decode nothing)."""

    dictionary: str
    config: object
    frames: str
    overflow: bool = False


def sweep_cases() -> dict:
    """name -> ``SweepCase``, in the record's order: each field of
    ``DetectorConfig`` users set, at values no other record takes (the
    default is 7, 3, auto, 32, 12, 49, 0.2, 0.1, 0.05, True, "mxu"), and
    odd frame shapes and channel counts.  A name is the settings, then
    ``:noref`` (``refine_corners=False``, the tail route) and the frames'
    source where it is not "mixed" (``sweep_source``).

    - ``threshold_window`` 3 (on "small_tags", with the edge gate at 0.05),
      5, 11, 21, and 11 on the tail route: kernel 1's tile plans at other
      halos;
    - ``ccl_rounds`` 1 (on "board"), 2, 6, and each on ``clutter``: kernel
      2's round limits, components cut short;
    - ``coarse_factor`` 2, 3, 5, 8: kernel 3's windows of 12-24 px; at 2
      a 240x320 grid (76,800 cells), the label route with kernel 2 off
      chip;
    - ``max_candidates`` 1, 128, 129, 256 on ``clutter`` (1 and 128 on
      both routes: kernel 2's fit mode and kernel 7 at their edges; 129
      and 256: kernels 5 and 6), 256 on the mixed frames too, and 160 at
      ``coarse_factor`` 2 on both (kernels 5 and 6 on the 240x320 grid,
      kernel 6 off chip); ``max_inner_candidates`` 0 and 40;
    - ``homography_sample_size`` 25, 36, 64, 81 on both routes: kernel
      4's three templates, kernel 8's window sizes;
    - the gates: ``min_side_length_factor`` 0.05,
      ``min_corner_separation_factor`` 0.02 and 0.3,
      ``contour_simplification_epsilon`` 0.02 (on "board") and 0.2,
      ``filter_high_bit_errors=False``, ``warp_impl="gather"`` (tail);
    - ``shape/HxW``: ``SWEEP_SHAPES`` at their automatic coarse factors
      (2, 4, 5, 6, 6, 1, 1), 3 frames each;
    - ``channels/4`` and ``channels/1``: the mixed frames as (4, 480, 640,
      4) tinted colour with a random alpha, and as (4, 480, 640, 1).
    """
    from aruco3_tpu_torch import DetectorConfig

    base = DetectorConfig()
    cases = {}

    def add(name, frames="mixed", overflow=False, dictionary=SWEEP_DICT, **fields):
        cases[name] = SweepCase(dictionary, replace(base, **fields), frames, overflow)

    # A 7x7 box (radius 3) leaves a cell black only within 3 px of its
    # edge, which the 5x5 opening keeps only for cells of about 7 px: tags
    # of 41 px, under the default edge gate of 96 px on VGA.
    add("threshold_window=3,min_side_length_factor=0.05", "small_tags", threshold_window=3,
        min_side_length_factor=0.05)
    for v in (5, 11, 21):
        add(f"threshold_window={v}", threshold_window=v)
    add("threshold_window=11" + NOREF, threshold_window=11, refine_corners=False)
    # One round leaves the turned markers of config 2's frames in pieces.
    add("ccl_rounds=1", "board", ccl_rounds=1)
    for v in (2, 6):
        add(f"ccl_rounds={v}", ccl_rounds=v)
    for v in (1, 2, 6):
        add(f"ccl_rounds={v}:clutter", "clutter", True, ccl_rounds=v)
    for v in (2, 3, 5, 8):
        add(f"coarse_factor={v}", coarse_factor=v)
    for v in (1, 128, 129, 256):
        add(f"max_candidates={v}:clutter", "clutter", True, max_candidates=v)
    for v in (1, 128):
        add(f"max_candidates={v}{NOREF}:clutter", "clutter", True, max_candidates=v,
            refine_corners=False)
    add("max_candidates=256", max_candidates=256)
    add("coarse_factor=2,max_candidates=160", coarse_factor=2, max_candidates=160)
    add("coarse_factor=2,max_candidates=160:clutter", "clutter", True, coarse_factor=2,
        max_candidates=160)
    for v in (0, 40):
        add(f"max_inner_candidates={v}", max_inner_candidates=v)
    for v in SWEEP_S:
        add(f"homography_sample_size={v}", homography_sample_size=v)
        add(f"homography_sample_size={v}{NOREF}", homography_sample_size=v,
            refine_corners=False)
    add("min_side_length_factor=0.05", min_side_length_factor=0.05)
    for v in (0.02, 0.3):
        add(f"min_corner_separation_factor={v}", min_corner_separation_factor=v)
    # At 0.02 the containment gate drops config 2's turned markers.
    add("contour_simplification_epsilon=0.02", "board", contour_simplification_epsilon=0.02)
    add("contour_simplification_epsilon=0.2", contour_simplification_epsilon=0.2)
    add("filter_high_bit_errors=False", filter_high_bit_errors=False)
    add("warp_impl=gather" + NOREF, warp_impl="gather", refine_corners=False)
    for h, w in SWEEP_SHAPES:
        add(f"shape/{h}x{w}", f"shape/{h}x{w}", dictionary=SHAPE_DICT)
    for c in (4, 1):
        add(f"channels/{c}", f"channels/{c}")
    return cases


def shape_frames(h: int, w: int) -> np.ndarray:
    """``SHAPE_FRAMES`` (h, w) frames of ``SHAPE_DICT`` markers: the frame
    cut into a grid of about 240-px tiles (at least one), one
    ``random_marker_scene`` a tile (0.5-0.68 of its short side, corners
    moved by up to 6% of it, noise 2)."""
    from aruco3_tpu_torch import render

    d = _dictionary(SHAPE_DICT)
    rows, cols = max(1, h // 240), max(1, w // 240)
    th, tw = h // rows, w // cols
    rng = np.random.default_rng([SHAPE_SEED, h, w])
    frames = []
    for _ in range(SHAPE_FRAMES):
        img = np.full((h, w), 255, dtype=np.uint8)
        for r in range(rows):
            for c in range(cols):
                sub = render.random_marker_scene(d, int(rng.integers(0, len(d))), (tw, th),
                                                 rng=rng, min_scale=0.5, max_scale=0.68,
                                                 max_persp=0.06)[0]
                img[r * th : (r + 1) * th, c * tw : (c + 1) * tw] = sub
        frames.append(img)
    return np.stack(frames)


@functools.lru_cache(maxsize=None)
def sweep_source(source: str) -> np.ndarray:
    """The frames of a ``SweepCase``: "board", a 480x640 board of 12
    ``SWEEP_DICT`` tags (``board``) and the same turned half a turn;
    "mixed", those and the first two of config 2's frames (1-4 markers
    turned and tilted); "small_tags", a 480x640 board of 11x8 tags of 41
    px (cell 52) and its half turn; "clutter", ``config_frames("clutter")``;
    "shape/HxW", ``shape_frames``; "channels/4", the mixed frames tinted
    (``tinted``) with a random alpha channel; "channels/1", the mixed
    frames with a channel axis."""
    if source == "board":
        img = board(SWEEP_DICT, SWEEP_SEED)
        return np.stack([img, np.ascontiguousarray(img[::-1, ::-1])])
    if source == "mixed":
        return np.concatenate([sweep_source("board"), config2_frames(False, 2)])
    if source == "small_tags":
        (h, w), (cols, rows) = CONFIG_HW, SMALL_TAGS_GRID
        img = grid_frame(_dictionary(SWEEP_DICT), h, w, SMALL_TAGS_CELL,
                         np.random.default_rng(SWEEP_SEED), cols, rows)[0]
        return np.stack([img, np.ascontiguousarray(img[::-1, ::-1])])
    if source == "clutter":
        return config_frames("clutter")
    if source.startswith("shape/"):
        h, w = (int(v) for v in source[len("shape/"):].split("x"))
        return shape_frames(h, w)
    if source == "channels/4":
        grey = sweep_source("mixed")
        alpha = np.random.default_rng(CHANNEL_SEED).integers(0, 256, grey.shape + (1,), np.uint8)
        return np.concatenate([tinted(grey, CHANNEL_SEED), alpha], axis=-1)
    if source == "channels/1":
        return np.ascontiguousarray(sweep_source("mixed")[..., None])
    raise KeyError(source)


def sweep_frames(name: str) -> np.ndarray:
    """The recorded frames of case ``name`` of ``sweep_cases``."""
    return sweep_source(sweep_cases()[name].frames)


def stream_frames() -> dict:
    """BASELINE config 5's stream (``benches/bench_configs.py:281-345``):
    dictionary -> its ``STREAM_PER_DICT`` streams' frames, stream after
    stream, ``STREAM_DEPTH`` each, (8, 1080, 1920) u8.  Each stream's scene
    is ``render.bench_scene`` (8 markers; seed ``STREAM_SEED`` plus the
    stream's index over both dictionaries); its frame k is that scene
    rolled by 7k px along the rows and brightened by (3k) % 5 grey levels,
    the per-tick change of ``config5_device`` (``:390-398``)."""
    from aruco3_tpu_torch import render

    h, w = LANDSCAPE_HW
    out = {}
    for j, name in enumerate(STREAM_DICTS):
        frames = []
        for s in range(STREAM_PER_DICT):
            scene = render.bench_scene(_dictionary(name), (w, h),
                                       seed=STREAM_SEED + j * STREAM_PER_DICT + s)[0]
            for k in range(STREAM_DEPTH):
                f = np.roll(scene, 7 * k, axis=1).astype(np.int32) + (3 * k) % 5
                frames.append(np.clip(f, 0, 255).astype(np.uint8))
        out[name] = np.stack(frames)
    return out


def stacked(rec: dict, n: int) -> dict:
    """A batch record of one frame repeated to ``n`` frames (config 4's
    frame as its batch stacks it)."""
    return {k: np.repeat(v, n // len(rec["hashes"]), axis=0) for k, v in rec.items()}


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


def held(rec: dict, decode: str = "pallas") -> dict:
    """``rec`` as the port is held to it: every field a warp decides taken
    from the decode of JAX's quads by the Pallas warp of the port's route
    (``decode="pallas"``) or by the tail warp (``"tail"``, phase 9's
    frames).  Raises ``StaleRecord`` if the record holds no such decode."""
    p = decode + "/"
    over = {k[len(p):]: v for k, v in rec.items() if k.startswith(p)}
    if not over:
        raise StaleRecord(f"the record holds no {decode} decode: make it with "
                          "tools/torch_make_golden.py")
    out = {k: v for k, v in rec.items() if k.split("/")[0] not in DECODES}
    out.update(over)
    return out


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
    parts = [("", MARKER_KEYS), ("fit/", FIT_KEYS)]
    parts += [(d + "/", MARKER_KEYS) for d in DECODES if f"{d}/offsets" in rec]
    for prefix, keys in parts:
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
    compared, accepted ties [(item, lane, fields)], differences, the
    lanes where JAX's XLA warp and the held Pallas warp decode differently
    [(item, lane)] (reported, not held), and the largest pose differences
    (rotation, translation)."""

    where: str
    compared: int = 0
    equal: int = 0
    lanes: int = 0
    ties: list = field(default_factory=list)
    differences: list = field(default_factory=list)
    warp_split: list = field(default_factory=list)
    rot_max: float = 0.0
    trans_max: float = 0.0
    bench_rot_max: float = 0.0
    bench_trans_max: float = 0.0

    def counts(self) -> dict:
        return {"compared": self.compared, "equal": self.equal, "lanes": self.lanes,
                "ties_accepted": len(self.ties), "differences": len(self.differences),
                "xla_warp_lanes_apart": len(self.warp_split),
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


def batch_lanes_apart(a: dict, b: dict, f: int) -> list:
    """Lanes of frame ``f`` whose decoded fields differ between two batch
    records."""
    lanes = set(np.nonzero(a["marker_valid"][f] != b["marker_valid"][f])[0].tolist())
    both = a["marker_valid"][f] & b["marker_valid"][f]
    for key in MARKER_FIELDS:
        for k in np.nonzero(both)[0]:
            if not np.array_equal(a[key][f][k], b[key][f][k]):
                lanes.add(int(k))
    return sorted(int(k) for k in lanes)


def compare_batch(where: str, rec: dict, frames, out, poses=None, fits_of=None) -> Report:
    """A detect batch of ``frames`` (outputs ``out``, poses (rotations,
    translations, errors) or None) against its record ``rec``
    (``subset(load("paths"), path)``; held to its Pallas-warp decode,
    ``held``), frame by frame and lane by lane.  ``fits_of()`` -> the
    port's fit quads of the frames (``port_fits``), asked only when a lane
    differs."""
    check_hashes(where, rec["hashes"], frames)
    xla, rec = rec, held(rec)
    got = batch_record(out, poses)
    rep = Report(where)
    for f in range(len(frames)):
        rep.warp_split += [(f, k) for k in batch_lanes_apart(xla, rec, f)]
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
                    if "bench_" + key in rec and (f, int(k)) not in rep.warp_split:
                        # Reported, not held; the bench program decodes
                        # with the XLA warp.
                        d = float(np.abs(got[key][f][k].astype(np.float64)
                                         - rec["bench_" + key][f][k].astype(np.float64)).max())
                        setattr(rep, "bench_" + attr, max(getattr(rep, "bench_" + attr), d))
        _settle(rep, f, diffs, fits(f))
    return rep


def scene_lanes_apart(rec: dict, k: int, a: str = "", b: str = "pallas/") -> list:
    """Lanes of scene ``k`` whose markers differ between two decodes of a
    scene record (prefixes ``a`` and ``b``; "" is JAX's XLA warp)."""
    return sorted({d.lane for d in marker_diffs("", k, unpack(rec, a, k), unpack(rec, b, k))})


def compare_scenes(where: str, rec: dict, frames, outs, fits_of=None,
                   decode: str = "pallas") -> Report:
    """Detections of scenes (one ``detect_batch`` output of one frame
    each, ``outs``) against the records of the scene set (``subset(load(
    "scenes"), name)``; held to its ``decode``, ``held``): per scene the
    same marker lanes, and on each its id, code, distance and rounded
    corners.  ``fits_of(k)`` -> the port's fit quads of scene ``k`` (1, K,
    4, 2), asked only when a lane differs."""
    check_hashes(where, rec["hashes"], frames)
    xla, rec = rec, held(rec, decode)
    rep = Report(where)
    k_lanes = int(rec["lanes"])
    for k, out in enumerate(outs):
        rep.compared += 1
        rep.warp_split += [(k, lane) for lane in scene_lanes_apart(xla, k, "", decode + "/")]
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
    record (held to its Pallas-warp decode, ``held``): the same ids in
    order, and the marker's translation (mm) and normal within
    ``VIEW_TRANS_TOL`` and ``VIEW_ROT_TOL``, or missed in both."""
    check_hashes(where, rec["hashes"], frames)
    xla, rec = rec, held(rec)
    rep = Report(where)
    for v, view in enumerate(views):
        rep.compared += 1
        rep.warp_split += [(v, lane) for lane in scene_lanes_apart(xla, v)]
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
    """The recorded views' errors (of the Pallas-warp decode, ``held``) as
    the pose example reports them: views detected, translation (mm) and
    normal-axis (degrees) mean, p95, max."""
    rec = held(rec)
    found = rec["found"].astype(bool)
    out = {"detected": int(found.sum())}
    for key in ("t_err", "r_err"):
        e = rec[key][found].astype(np.float64)
        out.update({f"{key}_mean": round(float(e.mean()), 4),
                    f"{key}_p95": round(float(np.percentile(e, 95)), 4),
                    f"{key}_max": round(float(e.max()), 4)} if len(e) else {})
    return out
