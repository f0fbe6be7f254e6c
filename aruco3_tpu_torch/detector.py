"""Detector — the end-to-end ArUco/AprilTag pipeline; counterpart of
``aruco3_tpu/detector.py``.

``detect_batch_arrays`` runs the stages of the JAX package's batched
detector on a (B, H, W[, C]) uint8 tensor, on one of its two routes
(``tail_route`` picks):

Refine route (corner refinement on and ds > 1; the JAX Pallas route):

1. luma (torch)
2. kernel 1 ``ops.frontend``: threshold, opening, pooling, near mask,
   pyramid level 1
3. the fit of both label planes, by the route ``fit_route`` picks:
   * "fused": kernel 2 ``ops.coarse_fit`` (fit mode) labels and fits in
     one launch and emits the inner footprint;
   * "labels": kernel 2 ``ops.coarse_fit.coarse_labels`` (labels mode)
     writes the planes, ``ops.fit.fused_fit_batch`` fits them (kernel 7,
     or kernels 5 and 6 above 128 lanes), and the inner footprint is
     ``segment.inner_footprint`` of the inner plane (torch)
4. ``segment.merge_fits`` (torch)
5. kernel 3 ``ops.refine``: full-resolution corner refinement
6. ``segment.finalize_quads`` (torch)
7. homography (torch)
8. pyramid levels >= 2 as 2x2 means of level 1 (torch)
9. kernel 4 ``ops.warp_decode``: warp, Otsu, Triangle resize, cell grid
10. grid tail and dictionary match (torch)

Tail route (no refinement, or ds == 1; the JAX ``_detect_tail``):

1. luma, kernel 1 as above
2. kernel 2 in labels mode, then ``ops.fit.fused_fit_batch`` (kernel 7,
   or kernels 5 and 6), ``segment.merge_fits``, ``segment.finalize_quads``
3. ``decode_tail``: homography; the pyramid warp (window slices in torch,
   kernel 8 ``ops.warp_eval``), or the gather warp where
   ``warp_impl="gather"``; Otsu, Triangle resize and cell grid (torch);
   grid tail and dictionary match

Masks route (``detect_from_masks``, the JAX ``_detect_tail``: from the
opened black mask and its pooling, as the row-sharded detector
``parallel.spatial`` and the single-frame ``detect_arrays`` give them):
kernel 2 in labels mode and kernel 7 (or kernels 5 and 6), merge, kernel 3
on ``segment.near_mask(black)`` where refinement is on and ds > 1,
finalize, then ``decode_tail``.

On a CUDA tensor every kernel stage launches its hand-written kernel; on a
CPU tensor the same function runs each kernel's plain PyTorch version.
``Detector.detect_batch`` on the card replays one captured CUDA graph of
``detect_batch_arrays`` per batch shape (``Detector._compiled``, the JAX
detector's one compiled program per shape); on the CPU it runs
``detect_batch_arrays`` eagerly.
The refine route's warp (kernel 4) rounds its column weights to bfloat16
as the JAX warps do; the tail route's warp (kernel 8) samples with float32
weights where the JAX XLA warp rounds them to bfloat16.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import frontend, rectify, segment
from .dictionaries import ARDictionary
from .runtime import graph
from .ops.coarse_fit import coarse_fit, coarse_labels
from .ops.fit import fused_fit_batch
from .ops.frontend import threshold_open_pool
from .ops.refine import refine_corners
from .ops.warp_decode import warp_decode


@dataclass(frozen=True)
class DetectorConfig:
    """Detection tunables; defaults and meaning as in the JAX package."""

    threshold_window: int = 7
    contour_simplification_epsilon: float = 0.05
    min_side_length_factor: float = 0.2
    min_corner_separation_factor: float = 0.1
    homography_sample_size: int = 49
    filter_high_bit_errors: bool = True
    max_candidates: int = 32
    max_inner_candidates: int = 12
    coarse_factor: int | None = None  # None = auto from image size
    ccl_rounds: int = 3
    refine_corners: bool = True
    # Warp of the tail route: "mxu" (pyramid windows + kernel 8) or
    # "gather" (the oracle).  The refine route always warps with kernel 4.
    warp_impl: str = "mxu"


@dataclass
class Marker:
    """Decoded marker: ``id`` indexes the dictionary, ``code`` is the raw
    read, corners are clockwise pixel coords from the marker's top-left."""

    id: int
    code: int
    corners: list[tuple[int, int]]
    hamming_distance: int


@dataclass
class Detection:
    """Host-side output of one frame, with the debug intermediates."""

    grey: np.ndarray | None = None
    candidates: list = field(default_factory=list)
    homographies: list = field(default_factory=list)
    markers: list[Marker] = field(default_factory=list)
    stats: dict = field(default_factory=dict)


def quad_params(cfg: DetectorConfig, ds: int) -> segment.QuadParams:
    """QuadParams the detector derives from its config: the reference's
    contour epsilon scales the containment gate (ratio 1 at 0.05)."""
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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _chain_levels(rp: int, cp: int) -> int:
    """Doubling levels (two planes each) of the TPU coarse kernel's scans."""
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
    """"fused" or "labels": the route the JAX detector takes from an
    (hc, wc) coarse grid with k1 outer and k2 inner lanes to the fits.

    The rule is the JAX package's (``detector.py:355-360``), kept here as a
    copy of its arithmetic: the fused coarse+fit kernel only where its
    grid fits the TPU kernel's VMEM budget (``coarse_fits_vmem``), its
    bf16 matrix-unit reductions stay exact (``fused_fit_exact``), and both
    lane counts are at most 128.  These are limits of the TPU's memory and
    bf16 arithmetic, not of the card; the port follows them because the
    two routes agree only up to exact extreme-point ties, so the same
    route on the same frame and config keeps the port's answers equal to
    the JAX package's.
    """
    rp = max(_round_up(hc, 8), 8)
    cp = max(256, _round_up(wc + 1, 128))
    exact = wc <= 255 and rp <= 256 and rp * cp <= 128 * 256
    fits_vmem = rp <= 512 and rp * cp * 4 * (12 + _chain_levels(rp, cp)) <= 48 * 1024 * 1024
    return "fused" if exact and fits_vmem and k1 <= 128 and k2 <= 128 else "labels"


def tail_route(params: segment.QuadParams, ds: int) -> bool:
    """True where the JAX detector decodes through ``_detect_tail``: its
    Pallas route needs corner refinement and a coarse factor above 1
    (``pallas_refine``, ``detector.py:252``).  Without refinement, or at
    ds 1 (frames whose long side is at most 192 px), it fits through the
    label planes and warps with ``warp_patches_mxu``."""
    return not (params.refine and ds > 1)


# Graphs a Detector keeps (the JAX detector's ``lru_cache(maxsize=32)``).
GRAPH_CACHE_SIZE = 32


class Detector:
    """Runs ``detect_batch_arrays`` on ``device`` (the card unless the
    caller asks for the CPU); on the card through a captured CUDA graph a
    batch shape (``_compiled``), all of a detector's graphs in one memory
    pool."""

    def __init__(
        self,
        config: DetectorConfig | None = None,
        dictionary: ARDictionary | None = None,
        device: str | torch.device = "cuda",
    ):
        self.config = config or DetectorConfig()
        self.dictionary = dictionary or ARDictionary.new_from_named_dict(
            "ARUCO_DEFAULT"
        )
        self.device = torch.device(device)
        self._graphs: graph.GraphCache | None = None

    @property
    def graphs(self) -> graph.GraphCache:
        """This detector's graphs on its card (made at first use)."""
        if self._graphs is None:
            self._graphs = graph.GraphCache(GRAPH_CACHE_SIZE)
        return self._graphs

    def _compiled(self, b: int, h: int, w: int, c: int | None = None) -> graph.Graph:
        """The CUDA graph of ``detect_batch_arrays`` for (b, h, w[, c]) uint8
        batches on the detector's card, captured at its first use and kept
        among the ``GRAPH_CACHE_SIZE`` most recently used (the JAX
        detector's ``_compiled``)."""
        shape = (b, h, w) if c is None else (b, h, w, c)
        # The graph keeps its function: a function that held the detector
        # would make a reference cycle, and the cyclic collector could
        # then destroy the detector's graphs while another is captured.
        dictionary, config, geometry = self.dictionary, self.config, self.geometry(h, w)

        def pipeline(images):
            return detect_batch_arrays(images, dictionary, config, *geometry)

        return self.graphs.get(shape, lambda: pipeline, shape, torch.uint8, self.device)

    def geometry(self, height: int, width: int):
        """(params, min_edge, min_sep, ds) for an (height, width) frame."""
        cfg = self.config
        ds = cfg.coarse_factor or segment.choose_coarse_factor(height, width)
        min_edge = min(width, height) * cfg.min_side_length_factor
        min_sep = min(width, height) * cfg.min_corner_separation_factor
        return quad_params(cfg, ds), min_edge, min_sep, ds

    def detect_batch(self, images) -> dict:
        """(B, H, W[, C]) uint8 frames -> dict of batched tensors on the
        detector's device (see ``detect_batch_arrays``).  On the card the
        frames (host or device) are copied into the shape's graph, which is
        replayed on the current stream; the outputs are fresh tensors and
        the call does not wait for them."""
        images = torch.as_tensor(images)
        if self.device.type == "cuda":
            if images.dtype != torch.uint8 or images.ndim not in (3, 4):
                raise ValueError(
                    f"expected (B, H, W[, C]) uint8 frames, got {tuple(images.shape)} {images.dtype}"
                )
            return self._compiled(*images.shape)(images)
        images = images.to(self.device)
        params, min_edge, min_sep, ds = self.geometry(images.shape[1], images.shape[2])
        return detect_batch_arrays(
            images, self.dictionary, self.config, params, min_edge, min_sep, ds
        )

    def detect(self, image) -> Detection:
        """One (H, W), (H, W, 3) or (H, W, 4) image -> ``Detection``."""
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        out = self.detect_batch(torch.from_numpy(np.ascontiguousarray(arr))[None])
        return to_host(out, 0)


def to_host(out: dict, index: int) -> Detection:
    """Frame ``index`` of a ``detect_batch`` result as a ``Detection``."""
    frame = {
        k: (v[index].cpu().numpy() if torch.is_tensor(v) else v)
        for k, v in out.items()
        if k != "stats"
    }
    det = Detection(
        grey=frame["grey"],
        stats={k: int(v[index]) for k, v in out["stats"].items()},
    )
    for k in range(frame["quads"].shape[0]):
        if not frame["quad_valid"][k]:
            continue
        det.candidates.append([(float(x), float(y)) for x, y in frame["quads"][k]])
        det.homographies.append(
            np.clip(np.round(frame["patches"][k]), 0, 255).astype(np.uint8)
        )
        if frame["marker_valid"][k]:
            lo, hi = (int(v) for v in frame["marker_code"][k])
            det.markers.append(
                Marker(
                    id=int(frame["marker_id"][k]),
                    code=lo | (hi << 32),
                    corners=[
                        (int(round(float(x))), int(round(float(y))))
                        for x, y in frame["marker_corners"][k]
                    ],
                    hamming_distance=int(frame["marker_dist"][k]),
                )
            )
    return det


def detect_batch_arrays(
    images: torch.Tensor,
    dictionary: ARDictionary,
    cfg: DetectorConfig,
    params: segment.QuadParams,
    min_edge: float,
    min_sep: float,
    ds: int,
) -> dict:
    """(B, H, W[, C]) uint8 -> batched outputs with fixed capacity K:
    grey (B, H, W) u8; quads (B, K, 4, 2) f32; quad_valid (B, K);
    patches (B, K, S, S) f32; marker_valid (B, K); marker_id / marker_dist /
    marker_rot (B, K) int; marker_code (B, K, 2) int64 (lo, hi) words;
    marker_corners (B, K, 4, 2) f32 (corner 0 = marker top-left); stats, a
    dict of (B,) int32 counters."""
    grey = frontend.rgb_to_luma_u8(images).contiguous()
    _, h, w = grey.shape
    coarse, near, level1 = threshold_open_pool(
        grey, cfg.threshold_window, params.open_radius, ds
    )
    tail = tail_route(params, ds)
    fused = not tail and fit_route(
        coarse.shape[1], coarse.shape[2], params.max_candidates, params.max_inner_candidates
    ) == "fused"
    quads, valid, stats = candidates(grey, near, coarse, params, min_edge, min_sep, ds, fused)
    if tail:
        out = decode_tail(grey, level1, quads, valid, stats, dictionary, cfg)
        out["grey"] = grey
        return out

    s = cfg.homography_sample_size
    H, h_valid = rectify.homography_square_to_quad(quads, s)
    shapes = rectify.pyramid_level_shapes(h, w, rectify.num_levels(h, w))
    uppers = rectify.upper_levels(level1, shapes)
    lvl, tlx, tly = rectify.warp_windows(quads, shapes)
    m = dictionary.get_mark_size()
    patches, _, grids = warp_decode(
        grey, uppers, H.contiguous(), lvl, tlx, tly, valid & h_valid, s, m
    )
    out = match_tail(quads, valid, h_valid, grids, stats, dictionary, cfg)
    out["patches"] = patches
    out["grey"] = grey
    return out


def fit_candidates(coarse, params, ds, fused):
    """Both label planes of (B, Hc, Wc) coarse masks fitted and merged
    into K lanes (``segment.merge_fits``: quads, centroids, sizes, ...)
    before refinement: ``fused``, kernel 2 in fit mode; else kernel 2's
    labels mode, then kernel 7, or kernels 5 and 6 above 128 lanes.
    Returns (cand, the inner footprint at coarse resolution from kernel 2's
    fit mode or None, the inner label plane or None)."""
    k1, k2 = params.max_candidates, params.max_inner_candidates
    if fused:
        fit1, fit2, inner_coarse = coarse_fit(coarse, params, ds)
        return segment.merge_fits(fit1, fit2, params, ds), inner_coarse, None
    labels1, labels2 = coarse_labels(coarse, params)
    fit1, fit2 = fused_fit_batch(labels1, labels2, ds, params, k1, k2, dup_skip=True)
    return segment.merge_fits(fit1, fit2, params, ds), None, labels2


def candidates(grey, near, coarse, params, min_edge, min_sep, ds, fused):
    """Finalized candidate quads (quads, valid, stats) of (B, H, W) frames
    from their coarse masks: ``fit_candidates``, kernel 3's corner
    refinement on ``near`` where ``params.refine`` and ds > 1, and
    ``segment.finalize_quads``."""
    cand, inner_coarse, labels2 = fit_candidates(coarse, params, ds, fused)
    quads = cand["quads"]
    if params.refine and ds > 1:
        if inner_coarse is None:  # label route: only refinement reads it
            inner_coarse = (
                segment.inner_footprint(labels2)
                if params.max_inner_candidates > 0
                else torch.zeros_like(coarse)
            )
        quads = refine_corners(
            grey,
            near,
            quads.contiguous(),
            cand["centroids"].contiguous(),
            inner_coarse,
            cand["is_inner"].contiguous(),
            cand["valid"].contiguous(),
            ds,
            segment.refine_window_size(params, ds),
        )
    return segment.finalize_quads(
        quads, cand["valid"], cand["sizes"], cand["overflow"], params, min_edge, min_sep
    )


def detect_from_masks(grey, black, coarse, dictionary, cfg, params, min_edge, min_sep, ds):
    """Detection from masks (``_detect_tail`` of the JAX package), batched:
    grey (B, H, W) u8, black (B, H, W) bool (the opened black mask), coarse
    (B, Hc, Wc) bool (its pooling) -> the outputs of
    ``detect_batch_arrays``.  The fit takes kernel 2's labels mode and
    kernel 7 (or kernels 5 and 6); where ``params.refine`` and ds > 1,
    kernel 3 refines on ``segment.near_mask(black)``; ``decode_tail``
    decodes with kernel 8 on the pyramid of ``rectify.level1_plane(grey)``."""
    near = segment.near_mask(black) if params.refine and ds > 1 else None
    quads, valid, stats = candidates(grey, near, coarse, params, min_edge, min_sep, ds, False)
    out = decode_tail(grey, rectify.level1_plane(grey), quads, valid, stats, dictionary, cfg)
    out["grey"] = grey
    return out


def detect_arrays(image, dictionary, cfg, params, min_edge, min_sep, ds) -> dict:
    """The single-frame pipeline (``detect_arrays`` of the JAX package):
    one (H, W[, C]) uint8 frame -> the outputs of ``detect_batch_arrays``
    for that frame, without the batch axis (stats as 0-d tensors).  Kernel
    1 gives the opened black mask and its pooling (``opened=True``), then
    ``detect_from_masks``."""
    grey = frontend.rgb_to_luma_u8(image[None]).contiguous()
    coarse, _, _, black = threshold_open_pool(
        grey, cfg.threshold_window, params.open_radius, ds, opened=True
    )
    out = detect_from_masks(grey, black, coarse, dictionary, cfg, params, min_edge, min_sep, ds)
    return frame_of(out, 0)


def frame_of(out: dict, index: int) -> dict:
    """Frame ``index`` of a batched output dict (stats included)."""
    frame = {k: v[index] for k, v in out.items() if torch.is_tensor(v)}
    frame["stats"] = {k: v[index] for k, v in out["stats"].items()}
    return frame


def decode_tail(grey, level1, quads, quad_valid, stats, dictionary, cfg):
    """Homography, warp, cell grids and match of every lane (``_decode_tail``
    of the JAX package), batched: the pyramid warp
    (``rectify.warp_patches_mxu``, kernel 8) or, with ``warp_impl="gather"``,
    the gather warp; then ``rectify.otsu_cells`` and ``match_tail``."""
    s = cfg.homography_sample_size
    b, k = quad_valid.shape
    H, h_valid = rectify.homography_square_to_quad(quads, s)
    if cfg.warp_impl == "gather":
        patches = rectify.warp_patches(grey, H, s)
    else:
        patches = rectify.warp_patches_mxu(grey, level1, H, quads, s)
    _, grids = rectify.otsu_cells(patches.reshape(b * k, s, s), dictionary.get_mark_size())
    out = match_tail(quads, quad_valid, h_valid, grids, stats, dictionary, cfg)
    out["patches"] = patches
    return out


def match_tail(quads, quad_valid, h_valid, grids, stats, dictionary, cfg):
    """Grid tail, 4-rotation dictionary match, corner rotation and the
    rejection counters (``_match_tail`` of the JAX package), batched."""
    b, k = quad_valid.shape
    m = dictionary.get_mark_size()
    bits, border_valid = rectify.decode_grids(grids.reshape(b * k, -1), m)
    ids_r, dists_r = dictionary.find_nearest_bits(bits)  # (B*K, 4)
    # First minimum over the rotations: the key folds the rotation index in.
    rot = torch.argmin(dists_r.to(torch.int64) * 4 + torch.arange(4, device=bits.device), dim=-1)
    best_id = ids_r.gather(1, rot[:, None])[:, 0].reshape(b, k)
    best_dist = dists_r.gather(1, rot[:, None])[:, 0].reshape(b, k)
    codes = rectify.bits_to_u32_pairs(bits)  # (B*K, 4, 2)
    best_code = codes.gather(1, rot[:, None, None].expand(-1, 1, 2))[:, 0].reshape(b, k, 2)
    rot = rot.reshape(b, k)
    border_valid = border_valid.reshape(b, k)

    accept = quad_valid & h_valid & border_valid
    tau_ok = best_dist < dictionary.tau
    if cfg.filter_high_bit_errors:
        accept = accept & tau_ok

    def count(mask):
        return mask.sum(dim=-1, dtype=torch.int32)

    stats = dict(stats)
    stats["reject_homography"] = count(quad_valid & ~h_valid)
    stats["reject_border"] = count(quad_valid & h_valid & ~border_valid)
    stats["reject_tau"] = count(quad_valid & h_valid & border_valid & ~tau_ok)
    stats["markers"] = count(accept)

    # corners.rotate_left(rot): corner i of the result is corner (i + rot) % 4.
    idx = (torch.arange(4, device=quads.device) + rot[..., None]) % 4
    corners_rot = quads.gather(2, idx[..., None].expand(-1, -1, -1, 2))
    return {
        "quads": quads,
        "quad_valid": quad_valid,
        "marker_valid": accept,
        "marker_id": best_id,
        "marker_dist": best_dist,
        "marker_rot": rot.to(torch.int32),
        "marker_code": best_code,
        "marker_corners": corners_rot,
        "stats": stats,
    }
