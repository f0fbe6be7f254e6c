"""Twin tests of the port's rectification: homography, pyramid, warp,
Otsu, Triangle resize and the bit read.

The port's refine-route warp (kernel 4's plain version) samples the
bfloat16 chain pyramid of ``build_packed_pyramid`` with its column
weights rounded to bfloat16 and its row weights float32, as the gather
warp (``ops/warp_gather.py``, through ``warp_patches_dma``) does: the two
are equal bit for bit at every level, and so are the chain's levels.
Against the XLA pyramid warp (``warp_patches_mxu``), which samples the
exact float32 pyramid and rounds its row contraction to bfloat16, it
agrees to 2 grey.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco3_tpu import rectify as jrectify
from aruco3_tpu import render as jrender
from aruco3_tpu.dictionaries import ARDictionary as JDictionary
from aruco3_tpu_torch import rectify
from torch_twin import n, random_quads, t

S = 49
SHAPE = (240, 320)


def _random_quads(rng, count, lo, hi):
    return random_quads(rng, count, lo, hi, *SHAPE)


def _scene(rng):
    d = JDictionary.new_from_named_dict("ARUCO_DEFAULT")
    img = np.full(SHAPE, 255, np.uint8)
    for mid, q in enumerate(_random_quads(rng, 3, 40, 110)):
        img = np.minimum(img, jrender.render_marker(d, mid, SHAPE[::-1], q))
    return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)


def test_homography_matches_jax(rng):
    quads = _random_quads(rng, 16, 10, 190)
    quads[3] = quads[3][[0, 0, 2, 3]]  # degenerate
    H, valid = rectify.homography_square_to_quad(t(quads), S)
    jH, jvalid = jrectify.homography_square_to_quad(jnp.asarray(quads), S)
    np.testing.assert_array_equal(n(valid), np.asarray(jvalid))
    np.testing.assert_allclose(n(H), np.asarray(jH), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("shape", [SHAPE, (90, 161)])
def test_pyramid_matches_jax(rng, shape):
    grey = rng.integers(0, 256, size=shape, dtype=np.uint8)
    levels = rectify.num_levels(*shape)
    got = rectify.build_pyramid(t(grey), levels)
    ref = jrectify.build_pyramid(jnp.asarray(grey), levels)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    # Kernel 4's levels >= 1 come from level 1 alone.
    shapes = rectify.pyramid_level_shapes(*shape, levels)
    uppers = rectify.upper_levels(rectify.level1_plane(t(grey[None])), shapes)
    for a, b in zip(uppers, ref[1:]):
        np.testing.assert_array_equal(n(a[0]), np.asarray(b))


@pytest.mark.parametrize("shape", [SHAPE, (90, 161), (720, 1280)])
def test_chain_pyramid_matches_packed_pyramid(rng, shape):
    """The refine route's levels 1.. (``level1_plane(chain=True)``, then
    ``upper_levels``) are ``build_packed_pyramid``'s bfloat16 levels bit
    for bit, padding included (720p: odd level sizes down the chain)."""
    grey = rng.integers(0, 256, size=(1,) + shape, dtype=np.uint8)
    levels = rectify.num_levels(*shape)
    shapes = rectify.pyramid_level_shapes(*shape, levels)
    uppers = rectify.upper_levels(rectify.level1_plane(t(grey), chain=True), shapes)
    canvas, offsets, jshapes = jrectify.build_packed_pyramid(jnp.asarray(grey), levels)
    assert [tuple(x) for x in jshapes] == list(shapes)
    canvas = np.asarray(canvas.astype(jnp.float32))
    for level, u in enumerate(uppers, 1):
        assert u.dtype == torch.bfloat16
        ph, pw = shapes[level]
        ref = canvas[0, offsets[level] : offsets[level] + ph, :pw]
        np.testing.assert_array_equal(n(u[0].to(torch.float32)), ref)


def _port_samples(grey, quads):
    """The port's refine-route warp of (K, 4, 2) quads of one (H, W) frame."""
    h, w = grey.shape
    q = t(quads)[None]
    H, _ = rectify.homography_square_to_quad(q, S)
    shapes = rectify.pyramid_level_shapes(h, w, rectify.num_levels(h, w))
    uppers = rectify.upper_levels(rectify.level1_plane(t(grey[None]), chain=True), shapes)
    lvl, tlx, tly = rectify.warp_windows(q, shapes)
    return rectify.warp_samples(t(grey[None]), uppers, H, lvl, tlx, tly, S)[0], lvl[0]


GATHER_LANES = 8  # lanes a call of the gather warp: one compile for the module


@functools.lru_cache(maxsize=None)
def _gather_fn():
    """The JAX gather warp (its Pallas kernel in interpret mode) on the
    chain pyramid of a SHAPE frame, under jit as the detector runs it: XLA
    then rounds each homography row as ``rectify.sample_coords`` does."""
    levels = rectify.num_levels(*SHAPE)

    def run(grey, H, quads):
        canvas, offsets, shapes = jrectify.build_packed_pyramid(grey, levels)
        return jrectify.warp_patches_dma(canvas, offsets, shapes, H, quads, S, interpret=True)

    return jax.jit(run)


def _quads_at_level(rng, level):
    """GATHER_LANES quads of a SHAPE frame that ``warp_windows`` sends to
    ``level`` (level 3: wider than the frame's short side)."""
    shapes = rectify.pyramid_level_shapes(*SHAPE, rectify.num_levels(*SHAPE))
    lo, hi = {0: (12, 36), 1: (50, 80), 2: (100, 160), 3: (200, 300)}[level]
    picked = []
    while len(picked) < GATHER_LANES:
        # Centred anywhere in the frame; the big ones hang over its edges.
        q = random_quads(rng, 16, lo, hi, 2 * hi, 2 * hi)
        q += rng.uniform([0, 0], SHAPE[::-1], (16, 1, 2)) - q.mean(axis=1, keepdims=True)
        q = q.astype(np.float32)
        lvl = n(rectify.warp_windows(t(q), shapes)[0])
        picked += list(q[lvl == level])
    return np.stack(picked[:GATHER_LANES])


def _assert_matches_gather_warp(rng, level):
    grey = _scene(rng)
    quads = _quads_at_level(rng, level)
    got, lvl = _port_samples(grey, quads)
    assert (n(lvl) == level).all()
    jq = jnp.asarray(quads)[None]
    jH, _ = jrectify.homography_square_to_quad(jq, S)
    ref = np.asarray(_gather_fn()(jnp.asarray(grey)[None], jH, jq))
    np.testing.assert_array_equal(n(got).reshape(-1, S, S), ref[0])


def test_warp_level0_matches_gather_warp(rng):
    """Level 0 equals the JAX gather warp (the Pallas kernel in interpret
    mode) bit for bit: float32 column weights instead of its bfloat16 ones
    move samples by up to half a grey level, which flips cells that sit at
    their Otsu level (1080p suite scenes ARUCO_MIP_36H12 22 and
    APRILTAG_36H11 59 decoded other codes)."""
    _assert_matches_gather_warp(rng, 0)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_warp_upper_levels_match_gather_warp(rng, level):
    """Levels 1-3 equal the gather warp bit for bit too: both sample the
    bfloat16 chain pyramid (exact float32 levels move samples by up to
    1.2 grey)."""
    _assert_matches_gather_warp(rng, level)


@functools.lru_cache(maxsize=None)
def _jax_mxu_fn(levels):
    def run(grey, quads):
        H, _ = jrectify.homography_square_to_quad(quads, S)
        return jrectify.warp_patches_mxu(jrectify.build_pyramid(grey, levels), H, quads, S)

    return jax.jit(run)


def test_warp_matches_mxu_warp(rng):
    grey = _scene(rng)
    quads = _random_quads(rng, 16, 12, 190)  # levels 0 to 2
    got, lvl = _port_samples(grey, quads)
    assert len(set(n(lvl).tolist())) >= 2
    ref = _jax_mxu_fn(rectify.num_levels(*SHAPE))(jnp.asarray(grey), jnp.asarray(quads))
    np.testing.assert_allclose(n(got).reshape(-1, S, S), np.asarray(ref), atol=2.0)


def test_decode_matches_jax(rng):
    """Otsu levels, bits and border validity are bit-exact, on marker
    patches and on noise."""
    grey = _scene(rng)
    quads = _random_quads(rng, 8, 30, 160)
    jH, _ = jrectify.homography_square_to_quad(jnp.asarray(quads), S)
    marker = np.asarray(jrectify.warp_patches(jnp.asarray(grey), jH, S))
    noise = rng.uniform(0, 255, size=(8, S, S)).astype(np.float32)
    patches = np.concatenate([marker, noise])
    np.testing.assert_array_equal(
        n(rectify.otsu_level(t(patches))), np.asarray(jrectify.otsu_level(jnp.asarray(patches)))
    )
    for m in (6, 8, 9):
        bits, valid = rectify.decode_patches(t(patches), m)
        jbits, jvalid = jrectify.decode_patches(jnp.asarray(patches), m)
        np.testing.assert_array_equal(n(bits), np.asarray(jbits))
        np.testing.assert_array_equal(n(valid), np.asarray(jvalid))
        np.testing.assert_array_equal(
            n(rectify.bits_to_u32_pairs(bits)), np.asarray(jrectify.bits_to_u32_pairs(jbits))
        )


def test_triangle_resize_matches_jax(rng):
    for src, dst in ((49, 8), (49, 6), (20, 9)):
        np.testing.assert_array_equal(
            rectify.triangle_resize_matrix(src, dst), jrectify._triangle_resize_matrix(src, dst)
        )
    x = rng.uniform(0, 255, size=(3, 49, 49)).astype(np.float32)
    np.testing.assert_allclose(
        n(rectify.resize_triangle(t(x), 8)),
        np.asarray(jrectify.resize_triangle(jnp.asarray(x), 8)),
        rtol=1e-5, atol=1e-3,
    )
