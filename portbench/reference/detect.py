"""Benchmark reference: the detector and pose step of ``aruco3_tpu_torch``
in plain PyTorch, every kernel by its plain version.

A frozen copy of ``aruco3_tpu_torch/detector.py``'s ``DetectorConfig``,
route rules, ``detect_batch_arrays`` and ``match_tail``, where each kernel
call is the plain function its wrapper runs on the CPU:

* kernel 1: ``frontend.adaptive_threshold``, ``segment.open_mask``,
  ``segment.pool_black``, ``segment.near_mask``, ``rectify.level1_plane``;
* kernel 2 (fit mode): ``segment.fit_planes``; (labels mode)
  ``segment.label_planes``;
* kernels 5-7: ``segment.fit_quads`` (twins of valid outer lanes skipped
  up to 128 lanes, as kernel 7 skips them);
* kernel 3: ``segment.refine_windows`` on the valid lanes;
* kernel 4: ``rectify.warp_samples`` + ``rectify.otsu_cells``;
* kernel 8: ``rectify.warp_eval``.

It runs on any device and imports nothing of the program.  ``lowp`` makes
the precision control: the refined corners and the pose solve's inputs and
outputs are rounded to bfloat16, the step below the float32 the
configuration states.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import frontend, pose, rectify, segment
from .dictionaries import ARDictionary

# Lanes a fit kernel takes in one launch (``ops.fit.MAX_LANES``).
MAX_LANES = 128


@dataclass(frozen=True)
class DetectorConfig:
    """Detection tunables, as the program's ``DetectorConfig``."""

    threshold_window: int = 7
    contour_simplification_epsilon: float = 0.05
    min_side_length_factor: float = 0.2
    min_corner_separation_factor: float = 0.1
    homography_sample_size: int = 49
    filter_high_bit_errors: bool = True
    max_candidates: int = 32
    max_inner_candidates: int = 12
    coarse_factor: int | None = None
    ccl_rounds: int = 3
    refine_corners: bool = True
    warp_impl: str = "mxu"


def quad_params(cfg: DetectorConfig, ds: int) -> segment.QuadParams:
    eps_scale = cfg.contour_simplification_epsilon / 0.05
    base = segment.QuadParams()
    return segment.QuadParams(
        max_candidates=cfg.max_candidates,
        max_inner_candidates=cfg.max_inner_candidates,
        coarse_factor=ds,
        ccl_rounds=cfg.ccl_rounds,
        refine=cfg.refine_corners,
        containment_slack=base.containment_slack * eps_scale,
        min_containment=min(0.999, base.min_containment / max(eps_scale, 1e-6)),
    )


def geometry(cfg: DetectorConfig, height: int, width: int):
    """(params, min_edge, min_sep, ds) of an (height, width) frame."""
    ds = cfg.coarse_factor or segment.choose_coarse_factor(height, width)
    min_edge = min(width, height) * cfg.min_side_length_factor
    min_sep = min(width, height) * cfg.min_corner_separation_factor
    return quad_params(cfg, ds), min_edge, min_sep, ds


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _chain_levels(rp: int, cp: int) -> int:
    lv = 0
    s = 1
    while s < cp:
        lv += 2
        s *= 2
    s = 1
    while s < rp:
        lv += 2
        s *= 2
    return lv


def fit_route(hc: int, wc: int, k1: int, k2: int) -> str:
    """"fused" (kernel 2 in fit mode) or "labels" (kernel 2 in labels mode,
    then kernel 7 or kernels 5 and 6) for an (hc, wc) coarse grid."""
    rp = max(_round_up(hc, 8), 8)
    cp = max(256, _round_up(wc + 1, 128))
    exact = wc <= 255 and rp <= 256 and rp * cp <= 128 * 256
    fits_vmem = rp <= 512 and rp * cp * 4 * (12 + _chain_levels(rp, cp)) <= 48 * 1024 * 1024
    return "fused" if exact and fits_vmem and k1 <= 128 and k2 <= 128 else "labels"


def tail_route(params: segment.QuadParams, ds: int) -> bool:
    """True where the detector decodes without kernels 3 and 4."""
    return not (params.refine and ds > 1)


def route(cfg: DetectorConfig, height: int, width: int) -> str:
    """"tail", "fused" or "labels": the route an (height, width) frame takes."""
    params, _, _, ds = geometry(cfg, height, width)
    if tail_route(params, ds):
        return "tail"
    hc, wc = -(-height // ds), -(-width // ds)
    return fit_route(hc, wc, params.max_candidates, params.max_inner_candidates)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _fits(coarse, params, ds, fused):
    k1, k2 = params.max_candidates, params.max_inner_candidates
    if fused:
        _, fit1, fit2, inner = segment.fit_planes(coarse, params, ds)
        return segment.merge_fits(fit1, fit2, params, ds), inner, None
    labels1, labels2 = segment.label_planes(coarse, params)
    fit1 = segment.fit_quads(labels1, ds, params, k=k1)
    fit2 = None
    if k2 > 0:
        skip = fit1 if k1 <= MAX_LANES and k2 <= MAX_LANES else None
        fit2 = segment.fit_quads(labels2, ds, params, k=k2, skip_twins_of=skip)
    return segment.merge_fits(fit1, fit2, params, ds), None, labels2


def detect_batch(images: torch.Tensor, dictionary: ARDictionary, cfg: DetectorConfig,
                 lowp: bool = False) -> dict:
    """(B, H, W) uint8 frames -> the fields the benchmark compares:
    marker_valid, marker_id, marker_dist, marker_code, marker_corners."""
    grey = frontend.rgb_to_luma_u8(images).contiguous()
    _, h, w = grey.shape
    params, min_edge, min_sep, ds = geometry(cfg, h, w)
    tail = tail_route(params, ds)
    black = segment.open_mask(~frontend.adaptive_threshold(grey, cfg.threshold_window),
                              params.open_radius)
    coarse = segment.pool_black(black, ds)
    level1 = rectify.level1_plane(grey, not tail)
    fused = not tail and fit_route(
        coarse.shape[1], coarse.shape[2], params.max_candidates, params.max_inner_candidates
    ) == "fused"
    cand, inner_coarse, labels2 = _fits(coarse, params, ds, fused)
    quads, valid = cand["quads"], cand["valid"]
    if params.refine and ds > 1:
        if inner_coarse is None:
            inner_coarse = (segment.inner_footprint(labels2) if params.max_inner_candidates > 0
                            else torch.zeros_like(coarse))
        refined = segment.refine_windows(
            segment.near_mask(black), quads, cand["centroids"], ds,
            segment.refine_window_size(params, ds), grey, inner_coarse, cand["is_inner"],
        )
        quads = torch.where(valid[..., None, None], refined, quads)
        if lowp:
            quads = _bf16(quads)
    quads, valid, _ = segment.finalize_quads(
        quads, valid, cand["sizes"], cand["overflow"], params, min_edge, min_sep
    )
    s = cfg.homography_sample_size
    m = dictionary.get_mark_size()
    b, k = valid.shape
    H, h_valid = rectify.homography_square_to_quad(quads, s)
    if tail:
        if cfg.warp_impl == "gather":
            patches = rectify.warp_patches(grey, H, s)
        else:
            patches = rectify.warp_patches_mxu(grey, level1, H, quads, s)
        _, grids = rectify.otsu_cells(patches.reshape(b * k, s, s), m)
    else:
        shapes = rectify.pyramid_level_shapes(h, w, rectify.num_levels(h, w))
        uppers = rectify.upper_levels(level1, shapes)
        lvl, tlx, tly = rectify.warp_windows(quads, shapes)
        samples = rectify.warp_samples(grey, uppers, H, lvl, tlx, tly, s)
        _, grids = rectify.otsu_cells(samples.reshape(b * k, s, s), m)
        grids = grids.reshape(b, k, -1) & (valid & h_valid)[..., None]
    return match(quads, valid, h_valid, grids, dictionary, cfg)


def match(quads, quad_valid, h_valid, grids, dictionary, cfg) -> dict:
    """Grid tail, 4-rotation dictionary match and corner rotation."""
    b, k = quad_valid.shape
    bits, border_valid = rectify.decode_grids(grids.reshape(b * k, -1), dictionary.get_mark_size())
    ids_r, dists_r = dictionary.find_nearest_bits(bits)
    rot = torch.argmin(dists_r.to(torch.int64) * 4 + torch.arange(4, device=bits.device), dim=-1)
    best_id = ids_r.gather(1, rot[:, None])[:, 0].reshape(b, k)
    best_dist = dists_r.gather(1, rot[:, None])[:, 0].reshape(b, k)
    codes = rectify.bits_to_u32_pairs(bits)
    best_code = codes.gather(1, rot[:, None, None].expand(-1, 1, 2))[:, 0].reshape(b, k, 2)
    rot = rot.reshape(b, k)
    accept = quad_valid & h_valid & border_valid.reshape(b, k)
    if cfg.filter_high_bit_errors:
        accept = accept & (best_dist < dictionary.tau)
    idx = (torch.arange(4, device=quads.device) + rot[..., None]) % 4
    corners = quads.gather(2, idx[..., None].expand(-1, -1, -1, 2))
    return {
        "marker_valid": accept,
        "marker_id": best_id,
        "marker_dist": best_dist,
        "marker_code": best_code,
        "marker_corners": corners,
    }


def solve_pose(corners: torch.Tensor, width: int, height: int, marker_mm: float,
               lowp: bool = False):
    """(rotations, translations, errors) of (..., 4, 2) pixel corners over
    the frame's size, lower-error pose first (``pose.solve_normalized_batch``)."""
    scale = torch.tensor([float(width), float(height)], device=corners.device)
    pts = corners / scale
    if lowp:
        pts = _bf16(pts)
    rot, tr, err = pose.solve_normalized_batch(pts, marker_mm)
    if lowp:
        rot, tr, err = _bf16(rot), _bf16(tr), _bf16(err)
    return rot, tr, err
