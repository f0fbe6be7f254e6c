"""Recall/corner parity harness: the port's detector against the
reference-pipeline oracle (``oracle.py``) over randomized scenes; the
counterpart of ``aruco3_tpu/parity.py``, with the same scene families,
seeds and counts.

``generate_scene`` makes seeded scene families (rotation/scale/perspective/
noise sweeps, dark backgrounds, nested and multi-marker layouts);
``run_parity`` runs both detectors and reports:

  * oracle_recall / tpu_recall: fraction of planted markers found (the
    names of the JAX package's report; ``tpu_*`` is the port's detector);
  * parity: fraction of oracle-found (scene, id) pairs the port's detector
    also finds, the headline number (>=0.99 required);
  * corner error stats of each detector vs ground truth.

Used by tests/test_torch_parity.py, ``chip_smoke.py`` and
tools/torch_parity_report.py.
"""

from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
import multiprocessing

import numpy as np
import torch

from .detector import Detector, DetectorConfig, to_host
from .dictionaries import ARDictionary
from .oracle import OracleDetector
from .render import render_marker


def _corner_err(found, truth) -> float:
    found = np.asarray(found, dtype=np.float64)
    best = np.inf
    for r in range(4):
        err = np.linalg.norm(
            np.roll(found, r, axis=0) - truth, axis=-1
        ).mean()
        best = min(best, err)
    return best


def _rot_quad(rng, side, cx, cy, max_persp):
    ang = rng.uniform(0, 2 * np.pi)
    base = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]])
    rot = np.array(
        [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
    )
    quad = base @ rot.T * side
    quad += rng.uniform(-max_persp, max_persp, size=(4, 2)) * side
    quad += np.array([cx, cy])
    return quad


def generate_scene(
    dictionary: ARDictionary,
    rng: np.random.Generator,
    image_size: tuple[int, int],
    kind: str,
):
    """One randomized scene -> (image u8, [(marker_id, truth_corners)])."""
    w, h = image_size
    noise = rng.uniform(0.5, 3.0)
    if kind == "plain":
        side = rng.uniform(0.28, 0.6) * min(w, h)
        cx = rng.uniform(side * 0.75, w - side * 0.75)
        cy = rng.uniform(side * 0.75, h - side * 0.75)
        mid = int(rng.integers(0, len(dictionary)))
        quad = _rot_quad(rng, side, cx, cy, 0.10)
        img = render_marker(
            dictionary, mid, image_size, quad, noise_sigma=noise, rng=rng
        )
        return img, [(mid, quad)]
    if kind == "dark":
        side = rng.uniform(0.35, 0.6) * min(w, h)
        cx = rng.uniform(side * 0.8, w - side * 0.8)
        cy = rng.uniform(side * 0.8, h - side * 0.8)
        mid = int(rng.integers(0, len(dictionary)))
        quad = _rot_quad(rng, side, cx, cy, 0.08)
        img = render_marker(
            dictionary, mid, image_size, quad, background=0,
            quiet_zone_cells=2, noise_sigma=noise, rng=rng,
        )
        return img, [(mid, quad)]
    if kind == "multi":
        img = np.full((h, w), 255, np.uint8)
        truths = []
        side = rng.uniform(0.26, 0.34) * min(w, h)
        for gx in (0.27, 0.73):
            mid = int(rng.integers(0, len(dictionary)))
            cx = gx * w + rng.uniform(-0.03, 0.03) * w
            cy = rng.uniform(0.4, 0.6) * h
            quad = _rot_quad(rng, side, cx, cy, 0.06)
            sub = render_marker(
                dictionary, mid, image_size, quad, noise_sigma=0.0
            )
            img = np.minimum(img, sub)
            truths.append((mid, quad))
        img = np.clip(
            img.astype(np.float64) + rng.normal(0, noise, img.shape), 0, 255
        ).astype(np.uint8)
        return img, truths
    if kind == "nested":
        side = rng.uniform(0.3, 0.42) * min(w, h)
        cx = rng.uniform(0.4, 0.6) * w
        cy = rng.uniform(0.4, 0.6) * h
        mid = int(rng.integers(0, len(dictionary)))
        quad = _rot_quad(rng, side, cx, cy, 0.05)
        mimg = render_marker(
            dictionary, mid, image_size, quad, background=0,
            quiet_zone_cells=2, noise_sigma=0.0,
        )
        scene = np.full((h, w), 255, np.uint8)
        pad = side * 0.55
        y0 = max(0, int(cy - pad - side * 0.5))
        y1 = min(h, int(cy + pad + side * 0.5))
        x0 = max(0, int(cx - pad - side * 0.5))
        x1 = min(w, int(cx + pad + side * 0.5))
        scene[y0:y1, x0:x1] = mimg[y0:y1, x0:x1]
        scene = np.clip(
            scene.astype(np.float64) + rng.normal(0, noise, scene.shape),
            0,
            255,
        ).astype(np.uint8)
        return scene, [(mid, quad)]
    raise ValueError(f"unknown scene kind {kind!r}")


SCENE_KINDS = ("plain", "plain", "plain", "dark", "multi", "nested")


@dataclass
class ParityResult:
    n_scenes: int = 0
    n_markers: int = 0
    oracle_found: int = 0
    tpu_found: int = 0
    both_found: int = 0
    tpu_errs: list = field(default_factory=list)
    oracle_errs: list = field(default_factory=list)
    # per scene-family counts: kind -> [n_markers, oracle, tpu, both]
    families: dict = field(default_factory=dict)
    # (scene index, marker id) found by the oracle only / by the port only
    missed: list = field(default_factory=list)
    port_only: list = field(default_factory=list)

    @property
    def parity(self) -> float:
        return self.both_found / max(self.oracle_found, 1)

    @property
    def oracle_recall(self) -> float:
        return self.oracle_found / max(self.n_markers, 1)

    @property
    def tpu_recall(self) -> float:
        return self.tpu_found / max(self.n_markers, 1)

    def summary(self) -> dict:
        te = np.array(self.tpu_errs) if self.tpu_errs else np.zeros(1)
        oe = np.array(self.oracle_errs) if self.oracle_errs else np.zeros(1)
        per_family = {
            kind: {
                "n_markers": int(n),
                "oracle_found": int(o),
                "tpu_found": int(t),
                "parity": round(b / max(o, 1), 4),
            }
            for kind, (n, o, t, b) in sorted(self.families.items())
        }
        return {
            "n_scenes": self.n_scenes,
            "n_markers": self.n_markers,
            "oracle_recall": round(self.oracle_recall, 4),
            "tpu_recall": round(self.tpu_recall, 4),
            "parity": round(self.parity, 4),
            "tpu_corner_mean_px": round(float(te.mean()), 3),
            "tpu_corner_p99_px": round(float(np.percentile(te, 99)), 3),
            "oracle_corner_mean_px": round(float(oe.mean()), 3),
            "per_family": per_family,
            "missed": [list(p) for p in self.missed],
            "port_only": [list(p) for p in self.port_only],
        }


def _oracle_detect(dictionary_name: str, img: np.ndarray):
    return OracleDetector(ARDictionary.new_from_named_dict(dictionary_name)).detect(img)


def reference_scenes(
    dictionary_name: str = "ARUCO_DEFAULT",
    n_scenes: int = 120,
    image_size: tuple[int, int] = (320, 240),
    seed: int = 0,
    workers: int = 0,
) -> list:
    """The seeded scenes of ``run_parity`` with the reference oracle's
    detections: [(kind, image, [(marker_id, truth_corners)], oracle
    markers)].  The scenes come from one generator in order, as in the JAX
    package; with ``workers`` > 0 the oracle (serial numpy, about twice a
    scene's rendering at 1080p) runs in that many processes while this one
    renders the next scenes."""
    d = ARDictionary.new_from_named_dict(dictionary_name)
    rng = np.random.default_rng(seed)
    pool = None
    if workers > 0:
        pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        scenes = []
        for k in range(n_scenes):
            kind = SCENE_KINDS[k % len(SCENE_KINDS)]
            img, truths = generate_scene(d, rng, image_size, kind)
            orc = (pool.submit(_oracle_detect, dictionary_name, img) if pool is not None
                   else _oracle_detect(dictionary_name, img))
            scenes.append((kind, img, truths, orc))
        if pool is not None:
            scenes = [(kind, img, truths, orc.result()) for kind, img, truths, orc in scenes]
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    return scenes


def score(
    detector: Detector, scenes, match_px: float = 6.0, outputs: list | None = None
) -> ParityResult:
    """``detector`` on ``reference_scenes`` output, scored against the
    ground truth and the oracle's detections.  ``outputs``, where given,
    receives each scene's ``detect_batch`` output (one frame), of which
    ``Detector.detect`` is the host copy."""
    res = ParityResult()
    for k, (kind, img, truths, orc) in enumerate(scenes):
        out = detector.detect_batch(torch.from_numpy(np.ascontiguousarray(img))[None])
        if outputs is not None:
            outputs.append(out)
        _score(res, k, kind, truths, to_host(out, 0).markers, orc, match_px)
    return res


def run_parity(
    dictionary_name: str = "ARUCO_DEFAULT",
    n_scenes: int = 120,
    image_size: tuple[int, int] = (320, 240),
    seed: int = 0,
    match_px: float = 6.0,
    detector_config: DetectorConfig | None = None,
    device: str = "cuda",
    workers: int = 0,
) -> ParityResult:
    """A/B the port's detector (on ``device``) against the reference oracle
    (``workers``: see ``reference_scenes``)."""
    d = ARDictionary.new_from_named_dict(dictionary_name)
    det = Detector(detector_config or DetectorConfig(), d, device=device)
    scenes = reference_scenes(dictionary_name, n_scenes, image_size, seed, workers)
    return score(det, scenes, match_px)


def matching(markers, mid: int, truth, match_px: float = 6.0) -> list:
    """The markers (anything with ``id`` and ``corners``) of id ``mid``
    whose corners lie within ``match_px`` of ``truth`` (mean corner
    distance at the best cyclic shift): the markers that find it."""
    return [m for m in markers if m.id == mid and _corner_err(m.corners, truth) < match_px]


def _score(res: ParityResult, k: int, kind: str, truths, tpu, orc, match_px: float) -> None:
    res.n_scenes += 1
    fam = res.families.setdefault(kind, np.zeros(4, np.int64))
    for mid, truth in truths:
        res.n_markers += 1
        fam[0] += 1
        t = matching(tpu, mid, truth, match_px)
        o = matching(orc, mid, truth, match_px)
        if t:
            res.tpu_found += 1
            fam[2] += 1
            res.tpu_errs.append(_corner_err(t[0].corners, truth))
        if o:
            res.oracle_found += 1
            fam[1] += 1
            res.oracle_errs.append(_corner_err(o[0].corners, truth))
        if t and o:
            res.both_found += 1
            fam[3] += 1
        elif o:
            res.missed.append((k, mid))
        elif t:
            res.port_only.append((k, mid))
