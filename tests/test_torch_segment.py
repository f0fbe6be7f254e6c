"""Twin tests of the port's segmentation: label planes, quad fit, merge,
corner refinement and the finalize gates, through the plain versions of
kernels 2 and 3."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco3_tpu import frontend as jfrontend
from aruco3_tpu import render as jrender
from aruco3_tpu import segment as jsegment
from aruco3_tpu.dictionaries import ARDictionary as JDictionary
from aruco3_tpu_torch import segment
from aruco3_tpu_torch.ops import coarse_fit as k2
from aruco3_tpu_torch.ops import frontend as k1
from aruco3_tpu_torch.ops import refine as k3
from torch_twin import assert_quads_tie_equivalent, coarse_masks, n, t

P = segment.QuadParams()
JP = jsegment.QuadParams()
DS = 6
CASES = [
    ((40, 54), 0.35, 32, 12),  # sparse
    ((40, 54), 0.6, 32, 12),  # dense: few merged components
    ((30, 40), 0.3, 12, 8),  # inner-pass lanes
]


@functools.lru_cache(maxsize=None)
def _jax_coarse_fit_fn(k1_, k2_):
    """label_planes + fit_quads on both planes + inner footprint (XLA),
    compiled once per lane counts."""

    def one(m):
        l1, l2 = jsegment.label_planes(m, JP)
        f1 = jsegment.fit_quads(l1, DS, JP, k=k1_)
        f2 = jsegment.fit_quads(l2, DS, JP, k=k2_)
        ic = jsegment._dilate3(l2 < l2.size)
        return l1, l2, f1, f2, ic

    return jax.jit(jax.vmap(one))


def _jax_coarse_fit(c, k1_, k2_):
    return _jax_coarse_fit_fn(k1_, k2_)(jnp.asarray(c))


@pytest.mark.parametrize("shape,density,kk1,kk2", CASES)
def test_coarse_fit_plain_matches_jax(shape, density, kk1, kk2):
    """Labels, roots, sizes, qualifying, valid and the inner footprint are
    bit-exact; quads are tie-equivalent; centroids agree."""
    rng = np.random.default_rng(11)
    c = rng.random((3,) + shape) < density
    jl1, jl2, jf1, jf2, jic = _jax_coarse_fit(c, kk1, kk2)
    l1, l2 = segment.label_planes(t(c), P)
    np.testing.assert_array_equal(n(l1), np.asarray(jl1))
    np.testing.assert_array_equal(n(l2), np.asarray(jl2))
    params = segment.QuadParams(max_candidates=kk1, max_inner_candidates=kk2)
    f1, f2, ic = k2.plain(t(c), params, DS)
    np.testing.assert_array_equal(n(ic), np.asarray(jic))
    for got, ref in ((f1, jf1), (f2, jf2)):
        for key in ("valid", "sizes", "qualifying", "roots"):
            np.testing.assert_array_equal(n(got[key]), np.asarray(ref[key]), err_msg=key)
        np.testing.assert_allclose(n(got["centroids"]), np.asarray(ref["centroids"]), atol=1e-4)
        assert_quads_tie_equivalent(got["quads"], ref["quads"], ref["centroids"], ref["sizes"])


def test_label_planes_serpentine_matches_jax():
    """A serpentine longer than the round limits close: the plain label
    planes equal the JAX package's, and the outer plane holds more than one
    label (a labelling run to convergence would give one)."""
    c = n(coarse_masks("serpentine", 3, (40, 54)))
    jl1, jl2 = _jax_coarse_fit(c, 32, 12)[:2]
    l1, l2 = segment.label_planes(t(c), P)
    np.testing.assert_array_equal(n(l1), np.asarray(jl1))
    np.testing.assert_array_equal(n(l2), np.asarray(jl2))
    outer = n(l1)[0]
    assert len(np.unique(outer[outer < outer.size])) > 1


def test_merge_fits_matches_jax():
    rng = np.random.default_rng(12)
    c = rng.random((3, 40, 54)) < 0.35
    params = segment.QuadParams()
    _, _, jf1, jf2, jic = _jax_coarse_fit(c, params.max_candidates, params.max_inner_candidates)
    ref = jax.vmap(
        lambda a, b, icb: jsegment.merge_fits(None, None, a, b, JP, DS, inner_coarse=icb)
    )(jf1, jf2, jic)
    tf = lambda f: {k: t(v) for k, v in f.items()}  # noqa: E731
    got = segment.merge_fits(tf(jf1), tf(jf2), params, DS)
    for key in ("quads", "valid", "sizes", "centroids", "is_inner", "overflow"):
        np.testing.assert_array_equal(n(got[key]), np.asarray(ref[key]), err_msg=key)


def _scene(kind):
    d = JDictionary.new_from_named_dict("ARUCO_DEFAULT")
    corners = np.array([[100, 70], [220, 75], [215, 190], [95, 185]], float)
    if kind == "dark":
        return jrender.render_marker(
            d, 5, (320, 240), corners, background=0, quiet_zone_cells=2, noise_sigma=2.0
        )
    return jrender.render_marker(d, 5, (320, 240), corners, noise_sigma=2.0)


@functools.lru_cache(maxsize=None)
def _jax_refine_fn(ds):
    """XLA frontend, candidates and refine_corners of one frame."""

    def run(g):
        black = jsegment.open_mask(~jfrontend.adaptive_threshold(g, 7), 2)
        cand = jsegment.extract_candidates(jsegment.pool_black(black, ds), JP, ds)
        ref = jsegment.refine_corners(
            black, cand["quads"], cand["centroids"], ds,
            jsegment.refine_window_size(JP, ds), grey=g,
            inner_coarse=cand["inner_coarse"], is_inner=cand["is_inner"],
        )
        found = jsegment.find_quads_from_masks(
            black, jsegment.pool_black(black, ds), JP, 48.0, 24.0, ds, grey=g
        )
        return black, cand, ref, found

    return jax.jit(run)


@pytest.mark.parametrize("kind,ds", [("light", 2), ("dark", 2), ("light", 6)])
def test_refine_plain_matches_jax(kind, ds):
    """Kernel 3's plain version gives the XLA refine_corners' corners on
    every valid lane, outer and inner."""
    img = _scene(kind)
    black, cand, ref, found = _jax_refine_fn(ds)(jnp.asarray(img))
    _, near, _ = k1.plain(t(img[None]), 7, 2, ds)
    got = k3.plain(
        t(img[None]), near, t(cand["quads"])[None], t(cand["centroids"])[None],
        t(cand["inner_coarse"])[None], t(cand["is_inner"])[None],
        t(cand["valid"])[None], ds, segment.refine_window_size(P, ds),
    )[0]
    v = np.asarray(cand["valid"])
    assert v.any()
    np.testing.assert_array_equal(n(got)[v], np.asarray(ref)[v])
    # The port's single-call path: candidates, refine_corners, finalize.
    port = segment.find_quads_from_masks(
        t(black)[None], k1.plain(t(img[None]), 7, 2, ds)[0], P, 48.0, 24.0, ds,
        grey=t(img[None]),
    )
    np.testing.assert_array_equal(n(port["valid"][0]), np.asarray(found["valid"]))
    fv = np.asarray(found["valid"])
    np.testing.assert_array_equal(n(port["quads"][0])[fv], np.asarray(found["quads"])[fv])


def test_finalize_quads_matches_jax():
    rng = np.random.default_rng(13)
    base = rng.uniform(20, 300, size=(10, 1, 2)) + np.array(
        [[0, 0], [40, 2], [42, 44], [-3, 40]], float
    )
    base[3] = base[2] + 1.5  # a near duplicate
    base[5] = base[5][[0, 3, 2, 1]]  # counter-clockwise
    quads = base.astype(np.float32)
    valid = rng.random(10) < 0.8
    sizes = rng.integers(0, 40, size=10).astype(np.int32)
    ref = jsegment.finalize_quads(
        jnp.asarray(quads), jnp.asarray(valid), jnp.asarray(sizes), jnp.int32(3), JP, 40.0, 24.0
    )
    got = segment.finalize_quads(
        t(quads)[None], t(valid)[None], t(sizes)[None], torch.tensor([3]), P, 40.0, 24.0
    )
    np.testing.assert_array_equal(n(got[0][0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(n(got[1][0]), np.asarray(ref[1]))
    for key, val in ref[2].items():
        assert int(got[2][key][0]) == int(val), key


def test_refine_plain_matches_pallas_on_a_frame_smaller_than_the_window():
    """On a 40x30 frame at a 48-px window (ds 20), kernel 3's plain version
    gives the corners of the JAX refine kernel (``refine_corners_batch``,
    interpreted), which zero-pads the frame: pixels past the image count 0
    in the window mean and are never ink."""
    from aruco3_tpu.ops.refine_pallas import refine_corners_batch

    rng = np.random.default_rng(48)
    b, k, h, w, ds, wn = 1, 6, 30, 40, 20, 48
    grey = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    near = rng.random((b, h, w)) < 0.6
    ic = rng.random((b, -(-h // ds), -(-w // ds))) < 0.6
    quads = np.stack([rng.uniform(-2, w + 1, (b, k, 4)), rng.uniform(-2, h + 1, (b, k, 4))],
                     -1).astype(np.float32)
    cents = np.stack([rng.uniform(0, w, (b, k)), rng.uniform(0, h, (b, k))], -1).astype(np.float32)
    is_inner = rng.random((b, k)) < 0.5
    valid = np.ones((b, k), bool)
    up = ic.repeat(ds, 1).repeat(ds, 2)[:, :h, :w]
    packed = grey.astype(np.int32) | near.astype(np.int32) << 8 | up.astype(np.int32) << 9
    ref = refine_corners_batch(
        jnp.asarray(packed), jnp.asarray(quads), jnp.asarray(cents), jnp.asarray(is_inner),
        ds, wn, inner_coarse=jnp.asarray(ic), valid=jnp.asarray(valid), interpret=True,
    )
    got = k3.plain(t(grey), t(near), t(quads), t(cents), t(ic), t(is_inner), t(valid), ds, wn)
    assert (n(got) != quads).any()  # some corners moved
    np.testing.assert_array_equal(n(got), np.asarray(ref))
