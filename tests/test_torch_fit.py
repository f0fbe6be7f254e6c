"""Twin tests of kernels 5, 6 and 7 through their plain versions
(``aruco3_tpu_torch.ops.fit`` on CPU tensors) against the JAX fit kernels
of ``aruco3_tpu/ops/fit_pallas.py`` in interpret mode.

The label planes are the port's ``segment.label_planes`` of seeded random
masks (``tests/test_torch_segment.py`` holds them bit-equal to the JAX
planes); both sides fit the same planes.  Integer fields are bit-exact,
quads tie-equivalent, centroids within 1e-4 px (float32 sums of
multiples of 0.5, exact in any order at these sizes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco3_tpu import segment as jsegment
from aruco3_tpu.ops import fit_pallas
from aruco3_tpu_torch import segment
from aruco3_tpu_torch.ops import fit
from torch_twin import assert_quads_tie_equivalent, coarse_layout_model, n

P = segment.QuadParams()
JP = jsegment.QuadParams()
DS = 6


def planes(shape, density, seed=41):
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.random((3,) + shape) < density)
    return segment.label_planes(c, P)


def assert_fit_matches(got, ref):
    for key in ("valid", "sizes", "qualifying", "roots"):
        np.testing.assert_array_equal(n(got[key]), np.asarray(ref[key]), err_msg=key)
    np.testing.assert_allclose(n(got["centroids"]), np.asarray(ref["centroids"]), atol=1e-4)
    assert_quads_tie_equivalent(got["quads"], ref["quads"], ref["centroids"], ref["sizes"])


@pytest.mark.parametrize(
    "shape,density,k",
    [
        ((40, 54), 0.35, 32),
        ((60, 80), 0.45, 96),  # pool above 128 entries
        ((40, 54), 0.35, 160),  # more than 128 lanes
        ((40, 300), 0.35, 300),  # wide plane, pool of 1,200
    ],
)
def test_split_fit_plain_matches_jax(shape, density, k):
    """Kernel 5's plain version against rank_roots_kernel, kernel 6's
    against fit_lanes_kernel, and fit_quads_batch against the JAX one."""
    lab, _ = planes(shape, density)
    jlab = jnp.asarray(n(lab))
    kr = segment.rank_pool_size(k, shape[0] * shape[1])
    got = fit.rank_roots(lab, kr, P.min_component_px)
    ref = fit_pallas.rank_roots_kernel(jlab, kr, JP.min_component_px, interpret=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(n(a), np.asarray(b))

    roots, sizes = segment.select_lanes(got[0], got[1], k)
    use = sizes >= 0
    sizes_pos = torch.clamp(sizes, min=0)
    gq, gc, gf = fit.fit_lanes(lab, roots, sizes_pos, use, DS, P.containment_slack)
    rq, rc, rf = fit_pallas.fit_lanes_kernel(
        jlab, jnp.asarray(n(roots)), jnp.asarray(n(sizes_pos)), jnp.asarray(n(use)),
        DS, JP.containment_slack, interpret=True,
    )
    np.testing.assert_array_equal(n(gf), np.asarray(rf))
    np.testing.assert_allclose(n(gc), np.asarray(rc), atol=1e-4)
    assert_quads_tie_equivalent(gq, rq, rc, sizes_pos)

    assert_fit_matches(
        fit.fit_quads_batch(lab, DS, P, k),
        fit_pallas.fit_quads_batch(jlab, DS, JP, k, interpret=True),
    )


@pytest.mark.parametrize(
    "shape,density,k1,k2",
    [
        ((40, 54), 0.35, 32, 12),
        ((40, 54), 0.6, 32, 12),  # dense: many equal sizes
        ((80, 54), 0.45, 32, 0),  # outer plane only
        ((40, 300), 0.35, 16, 8),  # wide plane
        ((40, 54), 0.35, 160, 12),  # above 128 lanes: kernels 5 and 6
    ],
)
def test_fused_fit_plain_matches_jax(shape, density, k1, k2):
    """Kernel 7's plain version (or the split route above 128 lanes)
    against fused_fit_batch with its twin skip, the JAX detector's
    setting."""
    l1, l2 = planes(shape, density)
    got = fit.fused_fit_batch(l1, l2, DS, P, k1, k2)
    ref = fit_pallas.fused_fit_batch(
        jnp.asarray(n(l1)), jnp.asarray(n(l2)) if k2 else None, DS, JP, k1, k2,
        dup_skip=True, interpret=True,
    )
    assert (got[1] is None) == (ref[1] is None) == (k2 == 0)
    assert_fit_matches(got[0], ref[0])
    if k2:
        assert_fit_matches(got[1], ref[1])
    if k2 and max(k1, k2) <= fit.MAX_LANES:
        # Twin lanes were selected but not fitted: zero centroids.
        skipped = (got[1]["sizes"] > 0) & (got[1]["centroids"] == 0).all(-1)
        assert bool(skipped.any())


@pytest.mark.parametrize("k", [1, 12, 31, 160, 300])
def test_lane_group_covers_each_lane_once(k):
    """Kernel 6's blocks (x, frame) fit lanes [x * G, (x + 1) * G): every
    lane once, at most LANE_GROUP_MAX a block, about one block an SM (the
    fewest blocks where member lists take device scratch)."""
    for b in (1, 2, 5, 16, 132, 140, 512):
        for on_chip in (True, False):
            g = fit.lane_group(k, b, 132, on_chip)
            assert 1 <= g <= fit.LANE_GROUP_MAX
            hits = np.zeros(k, np.int32)
            for x in range(-(-k // g)):  # blockIdx.x
                hits[x * g : min(k, (x + 1) * g)] += 1
            assert (hits == 1).all()
            assert -(-k // g) <= max(1, 132 // b) or g == fit.LANE_GROUP_MAX
        assert fit.lane_group(k, b, 132, False) == min(k, fit.LANE_GROUP_MAX)


@pytest.mark.parametrize("b", [1, 2, 16, 17, 33, 66, 67, 132, 133, 600])
def test_rank_cluster(b):
    """Kernel 5's cluster a frame: the largest power of two in [1, 8] whose
    clusters fit the SMs when the batch does."""
    c = fit.rank_cluster(b, 132)
    assert c in (1, 2, 4, 8)
    assert c * b <= 132 or c == 1
    assert c == fit.RANK_CLUSTER_MAX or 2 * c * b > 132


# (frames, grid, fit mode, kernel 2's [layout, blocks a frame, threads]):
# the five benchmark cells (dense 4K at ds 10; 1080p and VGA, batch and
# live), the portrait 1080p label route, the card tests' off-chip grids,
# the dense grid at batches from 1 to 256, 1080x1920 (ds 1) in both modes;
# other off-chip grids: 4K at ds 1, 5, 6 and 8 and 1080p at ds 2, a grid of
# fewer than 65,536 cells past one block's memory (255x256), one too
# shallow for bands of 8 (9x7300) and one whose band of 8 does not fit
# (200x6000); fit mode past one block at 256x330 and at batches of 300
# and 512 on chip.
CLUSTER, SCRATCH = ["cluster", 8, 512], ["scratch", 1, 1024]
COARSE_PLANS = [
    (16, (216, 384), False, CLUSTER), (128, (108, 192), True, ["smem", 1, 1024]),
    (64, (120, 160), True, ["smem", 1, 1024]), (1, (120, 160), True, ["smem", 1, 1024]),
    (1, (108, 192), True, ["smem", 1, 1024]), (2, (192, 108), False, ["smem", 1, 1024]),
    (2, (256, 330), False, CLUSTER), (2, (217, 385), False, CLUSTER),
    (15, (216, 384), False, CLUSTER), (30, (216, 384), False, CLUSTER),
    (128, (216, 384), False, CLUSTER), (16, (216, 384), True, SCRATCH),
    (1, (1080, 1920), False, SCRATCH), (1, (1080, 1920), True, SCRATCH),
    (1, (216, 384), False, CLUSTER), (256, (216, 384), False, CLUSTER),
    (16, (256, 330), False, CLUSTER), (2, (256, 330), True, SCRATCH),
    (1, (9, 7300), False, SCRATCH), (1, (64, 1100), False, CLUSTER),
    (1, (200, 6000), False, SCRATCH), (1, (255, 256), False, CLUSTER),
    (300, (108, 192), True, ["smem", 1, 1024]), (4, (192, 108), False, ["smem", 1, 1024]),
    (1, (2160, 3840), False, SCRATCH), (512, (120, 160), True, ["smem", 1, 1024]),
    (1, (540, 960), False, SCRATCH), (1, (432, 768), False, SCRATCH),
    (16, (270, 480), False, CLUSTER), (16, (360, 640), False, SCRATCH),
]


@pytest.mark.parametrize("b,grid,fit_mode,want", COARSE_PLANS)
def test_coarse_plan(b, grid, fit_mode, want):
    """Kernel 2's layout on one H100 (the library's layouts through
    ``coarse_layout_model``): one block a frame on chip where it fits, a
    cluster of 8 blocks of 512 threads in labels mode where a band of 8
    fits, else device scratch."""
    from aruco3_tpu_torch.ops import coarse_fit as k2

    hc, wc = grid
    kr = k2.fit_pool(segment.QuadParams(), hc * wc) if fit_mode else 0
    layout, c, threads, per_frame = k2.plan(b, hc, wc, kr, 132, coarse_layout_model)
    assert [layout, c, threads] == want
    if layout == "cluster":
        smem = coarse_layout_model("a3_coarse_cluster_layout", hc, wc, c)[0]
        assert 0 < smem <= 232_448 and per_frame == 0
    else:
        smem, ints = coarse_layout_model("a3_coarse_layout", hc, wc, kr)
        assert (smem > 0) == (layout == "smem") and per_frame == ints
        assert threads == fit.threads_per_block(b, smem, 132)


def test_fit_lanes_plain_matches_jax_on_edited_lanes():
    """Kernel 6's plain version against fit_lanes_kernel where the lanes
    are not a top-k: duplicate roots with equal and other sizes, and a used
    lane whose root no cell holds (corners at cell 0, centroid and
    fraction 0)."""
    lab, _ = planes((40, 54), 0.35)
    k = 32
    kr = segment.rank_pool_size(k, 40 * 54)
    roots, sizes = segment.select_lanes(*segment.rank_pool(lab, kr, P.min_component_px)[:2], k)
    use = sizes >= 0
    sizes = sizes.clamp(min=0)
    use[:, 1] = False
    roots[:, 4], sizes[:, 4] = roots[:, 3], sizes[:, 3]
    roots[:, 6], sizes[:, 6] = roots[:, 5], sizes[:, 5] + 3
    roots[:, 9], sizes[:, 9] = roots[:, 0], sizes[:, 0] - 1
    flat = lab.reshape(lab.shape[0], -1)
    roots[:, 2] = (flat != torch.arange(40 * 54)).int().argmax(dim=1)
    sizes[:, 2] = 4
    use[:, [2, 4, 6, 9]] = True
    assert not bool((flat == roots[:, 2:3]).any())
    gq, gc, gf = fit.fit_lanes(lab, roots, sizes, use, DS, P.containment_slack)
    rq, rc, rf = fit_pallas.fit_lanes_kernel(
        jnp.asarray(n(lab)), jnp.asarray(n(roots)), jnp.asarray(n(sizes)), jnp.asarray(n(use)),
        DS, JP.containment_slack, interpret=True,
    )
    np.testing.assert_array_equal(n(gf), np.asarray(rf))
    np.testing.assert_array_equal(n(gc), np.asarray(rc))
    np.testing.assert_array_equal(n(gq), np.asarray(rq))
    cell0 = (DS - 1) * 0.5
    assert (n(gq)[:, 2] == cell0).all() and (n(gc)[:, 2] == 0).all() and (n(gf)[:, 2] == 0).all()
