"""Twin tests of kernel 8 and the warp of the detector's tail route: the
plain version of ``ops.warp_eval`` against the JAX Pallas kernel
``warp_eval`` (interpret mode) and a float64 numpy reference; the port's
``rectify.warp_setup`` against the JAX ``_warp_setup``; the port's
``warp_patches_mxu`` and gather warp ``warp_patches`` against the JAX
package's.

Kernel 8 rounds its x weights and the windows to bfloat16 as the JAX
kernel does, so it equals the JAX kernel bit for bit, the tail route's
warp equals ``_warp_setup`` plus the JAX kernel bit for bit, and kernel 8
agrees to 1e-3 grey with float64 on the same bfloat16-rounded inputs.
The XLA warp (``warp_patches_mxu``) also rounds its row contraction to
bfloat16: the pyramid warps agree to 2.5 grey with equal decoded bits.
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
from aruco3_tpu.ops.warp_pallas import warp_eval as jwarp_eval
from aruco3_tpu_torch import rectify
from aruco3_tpu_torch.ops import warp_eval as k8
from torch_twin import n, noisy_blocks, random_quads, t

S = 49
WIN = 64


def _coords(rng, count):
    """(count, S*S) window coordinates: inside, in the partial edge bands
    (-1, 0) and (63, 64), just beyond them, and far outside."""
    u = rng.uniform(0.0, 63.0, size=(count, S * S))
    band = rng.integers(0, 6, size=u.shape)
    u = np.where(band == 1, rng.uniform(-1.0, 0.0, u.shape), u)
    u = np.where(band == 2, rng.uniform(63.0, 64.0, u.shape), u)
    u = np.where(band == 3, rng.choice([-1.0, 0.0, 63.0, 64.0, 62.5], u.shape), u)
    u = np.where(band == 4, rng.choice([-7.5, 70.25, -1e6, 1e6], u.shape), u)
    return u.astype(np.float32)


def _bf16(x):
    """float32 numpy values rounded to bfloat16 (half to even), as float64."""
    return n(t(np.asarray(x, np.float32)).to(torch.bfloat16).to(torch.float64))


def _bilinear64(windows, ux, uy):
    """float64 reference: the dense separable form, on the bfloat16-rounded
    windows and x weights the kernel evaluates."""
    j = np.arange(WIN, dtype=np.float64)
    wx = _bf16(np.maximum(0.0, 1.0 - np.abs(ux.astype(np.float64)[..., None] - j)))
    wy = np.maximum(0.0, 1.0 - np.abs(uy.astype(np.float64)[..., None] - j))
    t_ = wx @ np.swapaxes(_bf16(windows), 1, 2)
    return (wy * t_).sum(-1)


@functools.lru_cache(maxsize=None)
def _jax_kernel_fn():
    """The JAX Pallas kernel in interpret mode (one compile per shape)."""
    return jax.jit(lambda w, x, y: jwarp_eval(w, x, y, interpret=True))


def test_warp_eval_plain_matches_jax_kernel():
    """Bit for bit, on windows that are not bfloat16-exact and coordinates
    inside, in the edge bands, on the edges and far outside the window."""
    rng = np.random.default_rng(8)
    windows = rng.uniform(0, 255, size=(16, WIN, WIN)).astype(np.float32)
    ux, uy = _coords(rng, 16), _coords(rng, 16)
    k8.count.reset()
    got = n(k8.warp_eval(t(windows), t(ux), t(uy)))
    assert (k8.count.launches, k8.count.plain_calls) == (0, 1)
    assert got.shape == (16, S * S) and got.dtype == np.float32
    ref = np.asarray(_jax_kernel_fn()(jnp.asarray(windows), jnp.asarray(ux), jnp.asarray(uy)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, _bilinear64(windows, ux, uy), rtol=0, atol=1e-3)
    # Far outside the window every weight is 0.
    far = (np.abs(ux) > 100) | (np.abs(uy) > 100)
    assert (got[far] == 0).all()


def _frame_and_quads(rng, h, w):
    """Two noisy frames and (2, K, 4, 2) quads from level 0 up to the top
    level, some hanging over the image edge."""
    grey = noisy_blocks(rng, 2, h, w)
    quads = np.stack([random_quads(rng, 12, 8, min(h, w) / 1.3, h, w) for _ in range(2)])
    quads[0, 3] += [0.3 * w, 0.0]  # over the right edge
    quads[1, 4] -= [0.0, 0.25 * h]  # over the top edge
    big = np.array([[-20, -10], [w - 10, -5], [w - 15, h - 5], [-15, h - 10]], np.float32)
    quads[:, 5] = big  # the whole frame: level 2
    return grey, quads


@functools.lru_cache(maxsize=None)
def _jax_setup_fn(levels):
    return jax.jit(lambda g, H, q: jrectify._warp_setup(jrectify.build_pyramid(g, levels), H, q, S))


@pytest.mark.parametrize("shape", [(100, 161), (240, 320)])
def test_warp_setup_matches_jax(shape):
    """Windows, coordinates and the bad mask are equal bit for bit, for
    the same homographies (one with a w row that vanishes on a sample)."""
    rng = np.random.default_rng(9)
    h, w = shape
    grey, quads = _frame_and_quads(rng, h, w)
    H, _ = rectify.homography_square_to_quad(t(quads), S)
    H[1, 0] = torch.tensor([[1.0, 0.0, 5.0], [0.0, 1.0, 5.0], [1.0, 0.0, -10.0]])
    level1 = rectify.level1_plane(t(grey))
    windows, ux, uy, bad = rectify.warp_setup(t(grey), level1, H, t(quads), S)
    assert bool(bad[1, 0].any()) and not bool(bad[0].any())
    levels = rectify.num_levels(h, w)
    fn = _jax_setup_fn(levels)
    for b in range(2):
        ref = fn(jnp.asarray(grey[b]), jnp.asarray(n(H[b])), jnp.asarray(quads[b]))
        for got, want in zip((windows[b], ux[b], uy[b], bad[b]), ref):
            np.testing.assert_array_equal(n(got), np.asarray(want))
    lvl = rectify.warp_windows(t(quads), rectify.pyramid_level_shapes(h, w, levels))[0]
    assert len(set(n(lvl).ravel().tolist())) >= 3


@functools.lru_cache(maxsize=None)
def _jax_tail_warp_fn(levels):
    """The tail route's warp as the JAX TPU kernel computes it:
    ``_warp_setup`` on the exact pyramid, then the Pallas ``warp_eval``
    (interpret mode), degenerate samples 0."""
    def run(g, H, q):
        windows, ux, uy, bad = jrectify._warp_setup(jrectify.build_pyramid(g, levels), H, q, S)
        return jnp.where(bad, 0.0, jwarp_eval(windows, ux, uy, interpret=True))

    return jax.jit(run)


def test_tail_warp_matches_pallas_warp():
    """The tail route's samples (``rectify.warp_patches_mxu``: window slices,
    then kernel 8's plain version) equal ``_warp_setup`` plus the JAX
    kernel bit for bit, levels 0 to 2, quads over the image's edges and a
    homography whose w row vanishes on a sample."""
    rng = np.random.default_rng(9)
    h, w = 240, 320
    grey, quads = _frame_and_quads(rng, h, w)
    H, _ = rectify.homography_square_to_quad(t(quads), S)
    H[1, 0] = torch.tensor([[1.0, 0.0, 5.0], [0.0, 1.0, 5.0], [1.0, 0.0, -10.0]])
    got = rectify.warp_patches_mxu(t(grey), rectify.level1_plane(t(grey)), H, t(quads), S)
    fn = _jax_tail_warp_fn(rectify.num_levels(h, w))
    for b in range(2):
        ref = fn(jnp.asarray(grey[b]), jnp.asarray(n(H[b])), jnp.asarray(quads[b]))
        np.testing.assert_array_equal(n(got[b]).reshape(-1, S * S), np.asarray(ref))


def _marker_scene(rng, h, w):
    """One frame with three rendered markers; returns it and their quads."""
    d = JDictionary.new_from_named_dict("ARUCO_DEFAULT")
    img = np.full((h, w), 255, np.uint8)
    quads = random_quads(rng, 3, 24, 110, h, w)
    for mid, q in enumerate(quads):
        img = np.minimum(img, jrender.render_marker(d, mid, (w, h), q))
    img = np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)
    return img, quads


@functools.lru_cache(maxsize=None)
def _jax_warps_fn(levels):
    def run(grey, H, quads):
        mxu = jrectify.warp_patches_mxu(jrectify.build_pyramid(grey, levels), H, quads, S)
        return mxu, jrectify.warp_patches(grey, H, S)

    return jax.jit(run)


def test_warp_patches_match_jax():
    """Both warps of the port against the JAX package's on marker quads,
    levels 0 to 1, and on noise quads up to level 2, through the same
    homographies (computed inside ``jit``, XLA contracts the homography's
    multiply-adds, which moves samples by up to ~0.01 grey)."""
    rng = np.random.default_rng(10)
    h, w = 240, 320
    img, marker_quads = _marker_scene(rng, h, w)
    quads = np.concatenate([marker_quads, random_quads(rng, 9, 10, 200, h, w)])
    H, _ = rectify.homography_square_to_quad(t(quads[None]), S)
    mxu = rectify.warp_patches_mxu(t(img[None]), rectify.level1_plane(t(img[None])), H,
                                   t(quads[None]), S)[0]
    gather = rectify.warp_patches(t(img[None]), H, S)[0]
    jmxu, jgather = _jax_warps_fn(rectify.num_levels(h, w))(
        jnp.asarray(img), jnp.asarray(n(H[0])), jnp.asarray(quads)
    )
    assert np.abs(n(mxu) - np.asarray(jmxu)).max() <= 2.5
    np.testing.assert_allclose(n(gather), np.asarray(jgather), rtol=0, atol=1e-3)
    m = JDictionary.new_from_named_dict("ARUCO_DEFAULT").get_mark_size()
    bits, valid = rectify.decode_patches(mxu[:3], m)
    jbits, jvalid = jrectify.decode_patches(jmxu[:3], m)
    np.testing.assert_array_equal(n(bits), np.asarray(jbits))
    np.testing.assert_array_equal(n(valid), np.asarray(jvalid))
    assert n(valid).all()
