"""Reference parity of the port on the CPU: the port's oracle and scene
generator (``aruco3_tpu_torch.oracle``, ``.parity``) against the JAX
package's (both numpy: nothing here compiles a JAX program), the oracle's
unit tests on the port's copy, and ``run_parity`` of the port's detector
against its oracle on seeded 320x240 scenes."""

import numpy as np
import pytest

from aruco3_tpu import ARDictionary as JARDictionary
from aruco3_tpu import oracle as joracle
from aruco3_tpu import parity as jparity
from aruco3_tpu_torch import ARDictionary, frontend, parity
from aruco3_tpu_torch.oracle import (
    OracleDetector,
    adaptive_threshold_np,
    approximate_polygon_dp,
    convex_hull,
    find_contours_np,
)
from aruco3_tpu_torch.render import render_marker
from torch_twin import t


def _markers(ms):
    return [(m.id, m.code, list(m.corners), m.hamming_distance) for m in ms]


@pytest.mark.parametrize("name", ["ARUCO_DEFAULT", "APRILTAG_36H11"])
def test_scenes_and_oracle_match_jax(name):
    """One cycle of the scene kinds at 320x240: the port's scenes and
    truths bit-equal to the JAX package's, and the port's oracle's
    detections equal to ``aruco3_tpu.oracle.OracleDetector``'s."""
    d, jd = ARDictionary.new_from_named_dict(name), JARDictionary.new_from_named_dict(name)
    od, jod = OracleDetector(d), joracle.OracleDetector(jd)
    rng, jrng = np.random.default_rng(1234), np.random.default_rng(1234)
    assert parity.SCENE_KINDS == jparity.SCENE_KINDS
    found = 0
    for kind in parity.SCENE_KINDS:
        img, truths = parity.generate_scene(d, rng, (320, 240), kind)
        jimg, jtruths = jparity.generate_scene(jd, jrng, (320, 240), kind)
        np.testing.assert_array_equal(img, jimg)
        assert [m for m, _ in truths] == [m for m, _ in jtruths]
        for (_, q), (_, jq) in zip(truths, jtruths):
            np.testing.assert_array_equal(q, jq)
        got = _markers(od.detect(img))
        assert got == _markers(jod.detect(jimg)), kind
        found += len(got)
    assert found >= 6


def test_run_parity_on_the_cpu():
    res = parity.run_parity(n_scenes=12, image_size=(320, 240), seed=11, device="cpu")
    s = res.summary()
    assert res.n_scenes == 12 and res.oracle_found >= 0.7 * res.n_markers, s
    assert res.parity == 1.0, s
    assert res.missed == [] and s["tpu_corner_mean_px"] < 2.0, s
    assert set(s["per_family"]) == {"plain", "dark", "multi", "nested"}


# ---------------------------------------------------------------- units
def test_adaptive_threshold_matches_frontend():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(64, 80), dtype=np.uint8)
    a = adaptive_threshold_np(img, 7)
    b = frontend.adaptive_threshold(t(img), 7).numpy()
    np.testing.assert_array_equal(a, b)


def test_find_contours_rectangle():
    m = np.zeros((20, 30), dtype=bool)
    m[4:12, 5:20] = True
    cs = find_contours_np(m)
    assert len(cs) == 1  # one outer border, no holes
    c = cs[0]
    assert c[:, 0].min() == 5 and c[:, 0].max() == 19
    assert c[:, 1].min() == 4 and c[:, 1].max() == 11
    assert len(c) == 2 * (15 + 8) - 4


def test_find_contours_ring_has_hole_border():
    m = np.zeros((24, 24), dtype=bool)
    m[4:20, 4:20] = True
    m[8:16, 8:16] = False  # hole
    cs = find_contours_np(m)
    assert len(cs) == 2  # outer border + hole border
    sizes = sorted(len(c) for c in cs)
    assert sizes[0] < sizes[1]


def test_rdp_square():
    pts = []
    for x in range(20):
        pts.append((x, 0))
    for y in range(20):
        pts.append((20, y))
    for x in range(20, 0, -1):
        pts.append((x, 20))
    for y in range(20, 0, -1):
        pts.append((0, y))
    out = approximate_polygon_dp(np.array(pts), len(pts) * 0.05)
    assert len(out) == 4


def test_convex_hull_drops_concave():
    pts = np.array([[0, 0], [10, 0], [10, 10], [5, 5]])
    assert len(convex_hull(pts)) == 3


def test_oracle_detects_rendered_marker():
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    od = OracleDetector(d)
    corners = np.array([[60, 40], [200, 45], [195, 180], [55, 175]], float)
    img = render_marker(d, 33, (320, 240), corners, noise_sigma=1.5)
    ms = od.detect(img)
    assert any(m.id == 33 and m.hamming_distance == 0 for m in ms)


def test_oracle_detects_dark_background():
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    od = OracleDetector(d)
    corners = np.array([[70, 50], [210, 55], [205, 190], [65, 185]], float)
    img = render_marker(
        d, 7, (320, 240), corners, background=0, quiet_zone_cells=2,
        noise_sigma=1.5,
    )
    assert any(m.id == 7 for m in od.detect(img))
