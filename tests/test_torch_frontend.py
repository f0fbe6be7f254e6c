"""Twin tests of the port's frontend (luma, adaptive threshold, opening,
pooling, near mask, pyramid level 1 in both modes), through kernel 1's
plain version."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco3_tpu import frontend as jfrontend
from aruco3_tpu import rectify as jrectify
from aruco3_tpu import segment as jsegment
from aruco3_tpu_torch import frontend, rectify
from aruco3_tpu_torch.ops import frontend as k1
from torch_twin import n, noisy_blocks, t


def test_luma_matches_jax(rng):
    for c in (3, 4):
        img = rng.integers(0, 256, size=(2, 24, 40, c), dtype=np.uint8)
        np.testing.assert_array_equal(
            n(frontend.rgb_to_luma_u8(t(img))),
            np.asarray(jfrontend.rgb_to_luma_u8(jnp.asarray(img))),
        )
    grey = rng.integers(0, 256, size=(2, 24, 40, 1), dtype=np.uint8)
    np.testing.assert_array_equal(n(frontend.rgb_to_luma_u8(t(grey))), grey[..., 0])


@pytest.mark.parametrize("shape,radius", [((240, 320), 7), ((37, 53), 3), ((9, 11), 7)])
def test_adaptive_threshold_matches_jax(rng, shape, radius):
    grey = rng.integers(0, 256, size=shape, dtype=np.uint8)
    sums, areas = frontend.box_sum_and_area(t(grey), radius)
    jsums, jareas = jfrontend.box_sum_and_area(jnp.asarray(grey), radius)
    np.testing.assert_array_equal(n(sums), np.asarray(jsums))
    np.testing.assert_array_equal(n(areas), np.asarray(jareas))
    np.testing.assert_array_equal(
        n(frontend.adaptive_threshold(t(grey), radius)),
        np.asarray(jfrontend.adaptive_threshold(jnp.asarray(grey), radius)),
    )
    np.testing.assert_array_equal(
        n(frontend.threshold_u8(t(grey), radius)),
        np.asarray(jfrontend.threshold_u8(jnp.asarray(grey), radius)),
    )


def test_adaptive_threshold_golden():
    path = os.path.join(os.path.dirname(__file__), "golden", "adaptive_threshold.json")
    with open(path) as f:
        cases = json.load(f)["cases"]
    for c in cases:
        img = np.array(c["input"], np.uint8).reshape(c["height"], c["width"])
        out = frontend.adaptive_threshold(t(img), c["radius"])
        np.testing.assert_array_equal(n(out).astype(int).ravel(), np.array(c["white"]))


@pytest.mark.parametrize("ds", [2, 6, 10])
def test_frontend_plain_matches_jax(rng, ds):
    """Kernel 1's plain version equals the XLA frontend bit for bit, the
    optional opened mask included."""
    grey = noisy_blocks(rng, 2, 240, 320)
    coarse, near, level1, opened = k1.plain(t(grey), 7, 2, ds, opened=True)
    for b in range(grey.shape[0]):
        g = jnp.asarray(grey[b])
        black = jsegment.open_mask(~jfrontend.adaptive_threshold(g, 7), 2)
        np.testing.assert_array_equal(n(opened[b]), np.asarray(black))
        np.testing.assert_array_equal(n(coarse[b]), np.asarray(jsegment.pool_black(black, ds)))
        np.testing.assert_array_equal(
            n(near[b]), np.asarray(jsegment._dilate3(jsegment._dilate3(black)))
        )
        lvl1 = np.asarray(jrectify.build_pyramid(g, 2)[1])
        h1, w1 = level1.shape[1:]
        np.testing.assert_array_equal(n(level1[b]), lvl1[:h1, :w1])


@pytest.mark.parametrize("shape", [(240, 320), (37, 53)])
def test_frontend_plain_chain_level1_matches_packed_pyramid(rng, shape):
    """The refine route's level 1 (``chain=True``) is bfloat16 and equals
    level 1 of ``build_packed_pyramid`` bit for bit, which the JAX
    frontend kernel's ``emit_level1`` reproduces (``tests/
    test_pallas_kernels.py``); the other outputs are those of the exact
    mode."""
    grey = noisy_blocks(rng, 2, *shape)
    exact = k1.plain(t(grey), 7, 2, 6)
    coarse, near, level1 = k1.plain(t(grey), 7, 2, 6, chain=True)
    assert level1.dtype == torch.bfloat16 and level1.shape == exact[2].shape
    np.testing.assert_array_equal(n(coarse), n(exact[0]))
    np.testing.assert_array_equal(n(near), n(exact[1]))
    levels = max(2, rectify.num_levels(*shape))
    canvas, offsets, shapes = jrectify.build_packed_pyramid(jnp.asarray(grey), levels)
    (ph, pw), h1, w1 = shapes[1], *level1.shape[1:]
    ref = np.asarray(canvas.astype(jnp.float32))[:, offsets[1] : offsets[1] + ph, :pw]
    np.testing.assert_array_equal(n(level1.to(torch.float32)), ref[:, :h1, :w1])
