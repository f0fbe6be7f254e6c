"""Twin tests of the port's rectification: homography, pyramid, warp,
Otsu, Triangle resize and the bit read.

The port's warp (kernel 4's plain version) rounds its column weights to
bfloat16 as the JAX warps do and keeps its row weights float32, as the
gather warp (``ops/warp_gather.py``, through ``warp_patches_dma``) does.
At level 0, where that warp reads the frame itself, the two are equal bit
for bit.  Against the XLA pyramid warp (``warp_patches_mxu``), which also
rounds its row weights and row contraction to bfloat16, it agrees to 2
grey.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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


def _port_samples(grey, quads):
    """The port's warp of (K, 4, 2) quads of one (H, W) frame."""
    h, w = grey.shape
    q = t(quads)[None]
    H, _ = rectify.homography_square_to_quad(q, S)
    shapes = rectify.pyramid_level_shapes(h, w, rectify.num_levels(h, w))
    uppers = rectify.upper_levels(rectify.level1_plane(t(grey[None])), shapes)
    lvl, tlx, tly = rectify.warp_windows(q, shapes)
    return rectify.warp_samples(t(grey[None]), uppers, H, lvl, tlx, tly, S)[0], lvl[0]


def test_warp_level0_matches_gather_warp(rng):
    """Level 0 equals the JAX gather warp (the Pallas kernel in interpret
    mode) bit for bit: float32 column weights instead of its bfloat16 ones
    move samples by up to half a grey level, which flips cells that sit at
    their Otsu level (1080p suite scenes ARUCO_MIP_36H12 22 and
    APRILTAG_36H11 59 decoded other codes)."""
    grey = _scene(rng)
    quads = _random_quads(rng, 12, 12, 36)  # small: level 0
    got, lvl = _port_samples(grey, quads)
    assert (n(lvl) == 0).all()
    jq = jnp.asarray(quads)[None]
    jH, _ = jrectify.homography_square_to_quad(jq, S)
    levels = rectify.num_levels(*SHAPE)
    canvas, offsets, shapes = jrectify.build_packed_pyramid(jnp.asarray(grey)[None], levels)
    # Under jit, as the detector runs it: XLA then rounds each homography
    # row as rectify.sample_coords does.
    warp = jax.jit(lambda c, h, q: jrectify.warp_patches_dma(c, offsets, shapes, h, q, S,
                                                             interpret=True))
    ref = np.asarray(warp(canvas, jH, jq))
    np.testing.assert_array_equal(n(got).reshape(-1, S, S), ref[0])


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
