"""Twin tests of the detector's route choice and of its label route: the
port's ``fit_route`` against the JAX package's rule, and the port's
Detector on the label route (CPU, plain versions) against the JAX Detector
(XLA path), on a portrait grid outside the fused envelope and above 128
lanes.  Also the port's presets against the JAX package's."""

import dataclasses

import numpy as np
import pytest

from aruco3_tpu import Detector as JDetector
from aruco3_tpu import DetectorConfig as JDetectorConfig
from aruco3_tpu import dictionaries as jdictionaries
from aruco3_tpu.models import presets as jpresets
from aruco3_tpu.ops.coarse_pallas import coarse_fits_vmem, fused_fit_exact
from aruco3_tpu_torch import Detector, DetectorConfig, dictionaries
from aruco3_tpu_torch.detector import fit_route
from aruco3_tpu_torch.models import presets
from aruco3_tpu_torch.ops import coarse_fit, fit
from torch_twin import make_scene

COUNTS = {
    "coarse_fit": coarse_fit.count,
    "coarse_labels": coarse_fit.labels_count,
    "rank_roots": fit.rank_count,
    "fit_lanes": fit.lanes_count,
    "fused_fit": fit.fused_count,
}


@pytest.mark.parametrize(
    "hc,wc,k1,k2",
    [
        (108, 192, 32, 12),  # landscape 1080p
        (192, 108, 32, 12),  # portrait 1080p
        (64, 300, 32, 12),  # wide
        (270, 480, 32, 12),  # 1080p at coarse factor 4
        (540, 960, 32, 12),  # beyond the VMEM budget
        (108, 192, 160, 12),  # dense board above 128 lanes
        (108, 192, 32, 129),
    ],
)
def test_fit_route_matches_jax_rule(hc, wc, k1, k2):
    jax_fused = coarse_fits_vmem(hc, wc) and fused_fit_exact(hc, wc) and k1 <= 128 and k2 <= 128
    assert fit_route(hc, wc, k1, k2) == ("fused" if jax_fused else "labels")


def _twins(cfg):
    jd = jdictionaries.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    d = dictionaries.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    jcfg = JDetectorConfig(**dataclasses.asdict(cfg), use_pallas="never")
    return JDetector(jcfg, jd), Detector(cfg, d, device="cpu")


@pytest.fixture(scope="module")
def portrait_detectors():
    """Coarse factor 2 on a 240x320 portrait frame: a 160x120 grid, whose
    rp*cp = 160*256 leaves the fused envelope (one JAX compile)."""
    return _twins(DetectorConfig(coarse_factor=2))


@pytest.fixture(scope="module")
def wide_detectors():
    """160 outer lanes on the 320x240 frame (one JAX compile)."""
    return _twins(DetectorConfig(max_candidates=160))


def summary(det):
    return sorted((m.id, m.code, m.hamming_distance, tuple(m.corners)) for m in det.markers)


def _detect_twin(jdet, det, img, ids):
    for c in COUNTS.values():
        c.reset()
    got = det.detect(img)
    ran = {name: c.plain_calls for name, c in COUNTS.items()}
    ref = jdet.detect(img)
    assert ids <= {m.id for m in ref.markers}
    assert summary(got) == summary(ref)
    assert got.candidates == ref.candidates
    assert got.stats == ref.stats
    return ran


@pytest.mark.parametrize("kind", ["multi", "dark", "nested"])
def test_portrait_detect_matches_jax(portrait_detectors, kind):
    """The 320x240 scene turned a quarter (rot90, not a mirror): labels
    mode, then kernel 7's plain version."""
    jdet, det = portrait_detectors
    img, ids = make_scene(kind)
    img = np.ascontiguousarray(np.rot90(img))
    assert img.shape == (320, 240)
    ran = _detect_twin(jdet, det, img, ids)
    assert ran == {"coarse_fit": 0, "coarse_labels": 1, "rank_roots": 0, "fit_lanes": 0,
                   "fused_fit": 1}


def test_detect_above_128_lanes_matches_jax(wide_detectors):
    """The two-marker scene with 160 lanes: labels mode, then kernels 5 and
    6's plain versions on each plane."""
    jdet, det = wide_detectors
    img, ids = make_scene("multi")
    ran = _detect_twin(jdet, det, img, ids)
    assert ran == {"coarse_fit": 0, "coarse_labels": 1, "rank_roots": 2, "fit_lanes": 2,
                   "fused_fit": 0}


def test_presets_match_jax():
    assert list(presets.PRESETS) == list(jpresets.PRESETS)
    for name, pre in presets.PRESETS.items():
        jpre = jpresets.get_preset(name)
        assert (pre.dictionary, pre.description) == (jpre.dictionary, jpre.description)
        port_cfg = dataclasses.asdict(pre.config)
        assert port_cfg == {k: v for k, v in dataclasses.asdict(jpre.config).items() if k in port_cfg}
        det = presets.build_detector(name, device="cpu")
        assert det.dictionary.name == jpre.dictionary
        assert str(det.device) == "cpu"
    assert str(presets.get_preset("4k-dense-grid").build().device) == "cuda"
    with pytest.raises(KeyError):
        presets.get_preset("nope")
