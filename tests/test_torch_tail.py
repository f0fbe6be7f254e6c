"""Twin tests of the detector's tail route: the port's Detector (CPU, plain
versions) against the JAX Detector (XLA path) where the JAX detector
decodes through ``_detect_tail``: corner refinement off on the 320x240
scenes, a 160x120 frame (coarse factor 1) with refinement on, and the
gather warp (``warp_impl="gather"``).  Markers, candidates and stats must
be equal.  Also the route rule, the kernels the route runs, and the
conversion of ``warp_impl``.
"""

import dataclasses

import numpy as np
import pytest

from aruco3_tpu import Detector as JDetector
from aruco3_tpu import DetectorConfig as JDetectorConfig
from aruco3_tpu import dictionaries as jdictionaries
from aruco3_tpu_torch import Detector, DetectorConfig, convert, dictionaries, segment
from aruco3_tpu_torch.detector import tail_route
from aruco3_tpu_torch.ops import coarse_fit, fit, frontend, refine, warp_decode, warp_eval
from torch_twin import make_scene

COUNTS = {
    "frontend": frontend.count,
    "coarse_fit": coarse_fit.count,
    "coarse_labels": coarse_fit.labels_count,
    "rank_roots": fit.rank_count,
    "fit_lanes": fit.lanes_count,
    "fused_fit": fit.fused_count,
    "refine": refine.count,
    "warp_decode": warp_decode.count,
    "warp_eval": warp_eval.count,
}
TAIL = {"frontend", "coarse_labels", "fused_fit", "warp_eval"}


def _twins(cfg):
    jd = jdictionaries.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    d = dictionaries.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    jcfg = JDetectorConfig(**dataclasses.asdict(cfg), use_pallas="never")
    return JDetector(jcfg, jd), Detector(cfg, d, device="cpu")


@pytest.fixture(scope="module")
def noref_detectors():
    """Refinement off (one JAX compile at 320x240)."""
    return _twins(DetectorConfig(refine_corners=False))


@pytest.fixture(scope="module")
def small_detectors():
    """The default config, which at 160x120 pools by 1 (one JAX compile)."""
    return _twins(DetectorConfig())


@pytest.fixture(scope="module")
def gather_detectors():
    """Refinement off with the gather warp (one JAX compile)."""
    return _twins(DetectorConfig(refine_corners=False, warp_impl="gather"))


def summary(det):
    return sorted((m.id, m.code, m.hamming_distance, tuple(m.corners)) for m in det.markers)


def _detect_twin(jdet, det, img, ids):
    """Detect on both; returns the plain calls of each wrapper in the
    port's run."""
    for c in COUNTS.values():
        c.reset()
    got = det.detect(img)
    ran = {name: c.plain_calls for name, c in COUNTS.items()}
    assert all(c.launches == 0 for c in COUNTS.values())
    ref = jdet.detect(img)
    assert ids <= {m.id for m in ref.markers}
    assert summary(got) == summary(ref)
    assert got.candidates == ref.candidates
    assert got.stats == ref.stats
    return ran


@pytest.mark.parametrize("kind", ["single", "multi", "dark", "nested"])
def test_noref_detect_matches_jax(noref_detectors, kind):
    jdet, det = noref_detectors
    img, ids = make_scene(kind)
    ran = _detect_twin(jdet, det, img, ids)
    assert ran == {name: int(name in TAIL) for name in COUNTS}


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_small_frame_detect_matches_jax(small_detectors, kind):
    """The scene at half size on a 160x120 frame: coarse factor 1 takes
    the tail route although refinement is on."""
    jdet, det = small_detectors
    img, ids = make_scene(kind, 160, 120, scale=0.5)
    assert det.geometry(120, 160)[3] == 1
    ran = _detect_twin(jdet, det, img, ids)
    assert ran == {name: int(name in TAIL) for name in COUNTS}


def test_gather_warp_detect_matches_jax(gather_detectors):
    """``warp_impl="gather"``: the same route without kernel 8."""
    jdet, det = gather_detectors
    img, ids = make_scene("multi")
    ran = _detect_twin(jdet, det, img, ids)
    assert ran == {name: int(name in TAIL - {"warp_eval"}) for name in COUNTS}


@pytest.mark.parametrize("refine,ds,tail", [
    (True, 2, False), (True, 10, False), (True, 1, True), (False, 10, True), (False, 1, True),
])
def test_tail_route_rule(refine, ds, tail):
    assert tail_route(segment.QuadParams(refine=refine, coarse_factor=ds), ds) is tail


def test_convert_carries_warp_impl():
    jcfg = JDetectorConfig(refine_corners=False, warp_impl="gather", use_pallas="never")
    jd = jdictionaries.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    state = {
        "name": jd.name, "num_bits": jd.num_bits, "tau": jd.tau,
        "code_list": np.asarray(jd.code_list), "config": dataclasses.asdict(jcfg),
        "params": dataclasses.asdict(segment.QuadParams()),
    }
    _, cfg, _ = convert.from_jax_state(state)
    assert (cfg.warp_impl, cfg.refine_corners) == ("gather", False)
    port_fields = {f.name for f in dataclasses.fields(DetectorConfig)}
    assert {f.name for f in dataclasses.fields(JDetectorConfig)} - port_fields == {"use_pallas"}
