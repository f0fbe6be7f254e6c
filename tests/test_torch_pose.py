"""Twin tests of the port's IPPE pose solve and camera model: the golden
C++ IPPE vectors of tests/test_pose.py at their tolerances, and the batched
solve against the JAX package's."""

import jax.numpy as jnp
import numpy as np

from aruco3_tpu import camera as jcamera
from aruco3_tpu import pose as jpose
from aruco3_tpu_torch import camera, pose
from torch_twin import n, t


def test_golden_homographies():
    target = t(np.array([[0.1, 0.1], [0.3, 0.1], [0.3, 0.3], [0.1, 0.3]], np.float32))
    expected = np.array([[0.01818181818181819, 0.0, 0.2], [0.0, -0.01818181818181819, 0.2],
                         [0.0, 0.0, 1.0]])
    h = n(pose.compute_homography_from_marker_square(11.0, target))
    assert np.abs(h - expected).sum() < 1e-5
    pts = t(np.array([[-0.090, -0.089], [-0.095, -0.150], [-0.080, -0.170],
                      [-0.075, -0.090]], np.float32))
    expected = np.array([
        [0.0001197249881460392, -0.00193812233285917, -0.08585585585585585],
        [-0.003084400189663352, -0.00115457562825984, -0.1225675675675677],
        [-0.004504504504504568, 0.01351351351351346, 1.0],
    ])
    h = n(pose.compute_homography_from_marker_square(19.0, pts))
    assert np.abs(h - expected).max() < 1e-5


def test_golden_canonical_solve():
    target = t(np.array([[0.1, 0.1], [0.3, 0.1], [0.3, 0.3], [0.1, 0.3]], np.float32))
    sq = pose.make_marker_square(11.0)
    h = pose.compute_homography_from_marker_square(11.0, target)
    rot, tr, _ = (n(x) for x in pose.solve_canonical_form(sq, target, h))
    rot_b = np.array([
        [0.9259259259259256, 0.07407407407407443, -0.3703703703703712],
        [-0.0740740740740744, -0.9259259259259256, -0.3703703703703713],
        [-0.3703703703703712, 0.3703703703703713, -0.8518518518518512],
    ])
    assert np.abs(rot[0] - np.diag([1.0, -1.0, -1.0])).sum() < 1e-5
    assert np.abs(rot[1] - rot_b).sum() < 1e-5
    assert np.abs(tr[0] - [11.0, 11.0, 55.0]).sum() < 1e-4
    assert np.abs(tr[1] - [10.79629629629629, 10.79629629629629, 55.0]).sum() < 1e-4


def test_golden_e2e_poses():
    target = [(90, 89), (95, 150), (80, 170), (75, 90)]
    pa, pb = pose.solve_with_undistorted_points(target, 17.0, (1000, 1000))
    pa_r = np.array([[0.07313995850727262, 0.2953796077825095, 0.9525762089070907],
                     [0.9973210134149258, -0.02055233410014844, -0.07020254813082821],
                     [-0.001158736630905738, 0.9551588814795613, -0.2960914866390682]])
    pb_r = np.array([[0.05174977302896467, 0.1311239186581316, -0.9900143832021767],
                     [0.9667844474723887, -0.2550432732960733, 0.01675592050389792],
                     [-0.2502994069448807, -0.957997623536802, -0.1399669967559523]])
    assert np.abs(n(pa.rotation) - pa_r).sum() < 2e-5
    assert np.abs(n(pb.rotation) - pb_r).sum() < 2e-5
    assert np.abs(n(pa.translation) - [20.32196265994096, 29.69316666108512,
                                       238.3658341694123]).sum() < 5e-4
    assert np.abs(n(pb.translation) - [19.85146615649354, 29.20013946746331,
                                       234.3277337340188]).sum() < 5e-4
    assert float(pa.error) <= float(pb.error)

    pts = [(-0.090, -0.089), (-0.095, -0.150), (-0.080, -0.170), (-0.075, -0.090)]
    pa, pb = pose.solve_with_normalized_points(pts, 19.0)
    assert np.abs(n(pa.rotation) + pa_r * [[1], [1], [-1]]).max() < 1e-5
    assert np.abs(n(pb.rotation) + pb_r * [[1], [1], [-1]]).max() < 1e-5
    assert np.abs(n(pa.translation) - [-22.712781796404, -33.18648038591866,
                                       266.408873483460]).max() < 1e-3
    assert np.abs(n(pb.translation) - [-22.18693276313984, -32.6354499930472,
                                       261.8957024086092]).max() < 1e-3


def test_batched_solve_matches_jax():
    rng = np.random.default_rng(7)
    batch = []
    for _ in range(32):
        c = rng.uniform(-0.3, 0.3, size=2)
        r = rng.uniform(0.05, 0.15)
        ang = rng.uniform(0, 2 * np.pi)
        quad = [c + r * np.array([np.cos(a), np.sin(a)])
                for a in ang + np.arange(4) * np.pi / 2 + rng.uniform(-0.2, 0.2, 4)]
        batch.append(quad)
    batch = np.array(batch, np.float32).reshape(4, 8, 4, 2)
    rot, tr, err = pose.solve_normalized_batch(t(batch), 20.0)
    jrot, jtr, jerr = jpose.solve_normalized_batch(jnp.asarray(batch), 20.0)
    np.testing.assert_allclose(n(rot), np.asarray(jrot), atol=2e-5)
    np.testing.assert_allclose(n(tr), np.asarray(jtr), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(n(err), np.asarray(jerr), rtol=1e-3, atol=1e-6)


def test_scalar_api_and_transforms_match_jax():
    intr = camera.CameraIntrinsics.new(640, 480, 500.0, 500.0)
    jintr = jcamera.CameraIntrinsics.new(640, 480, 500.0, 500.0)
    corners = [(300, 200), (340, 202), (338, 242), (298, 240)]
    pa, pb = pose.solve_with_intrinsics(corners, 50.0, intr)
    ja, jb = jpose.solve_with_intrinsics(corners, 50.0, jintr)
    for got, ref in ((pa, ja), (pb, jb)):
        np.testing.assert_allclose(n(got.rotation), np.asarray(ref.rotation), atol=2e-5)
        np.testing.assert_allclose(n(got.translation), np.asarray(ref.translation),
                                   rtol=1e-4, atol=1e-3)
    pts = np.array([[0.0, 0.0, 0.0], [7.0, 11.0, 13.0]], np.float32)
    np.testing.assert_allclose(
        n(pa.apply_inverse_transform_to_points(pa.apply_transform_to_points(pts))), pts,
        atol=1e-4,
    )
    e = pose.estimate_pose([(90, 89), (95, 150), (80, 170), (75, 90)], 17.0, (1000, 1000))
    assert float(e[0].error) <= float(e[1].error)


def test_camera_matches_jax():
    for ctor in (lambda m: m.CameraIntrinsics.new(640, 480, 700.0, 690.0),
                 lambda m: m.CameraIntrinsics.new_from_fov_horizontal(1.2, 36.0, 1920, 1080)):
        intr, jintr = ctor(camera), ctor(jcamera)
        np.testing.assert_allclose(np.asarray(intr.k_matrix()), np.asarray(jintr.k_matrix()))
        np.testing.assert_allclose(intr.k_matrix_3x4(), np.asarray(jintr.k_matrix_3x4()))
        x = np.array([-1.0, 0.5, 2.0], np.float32)
        y = np.array([0.3, -0.7, 1.0], np.float32)
        z = np.array([2.0, 3.0, -1.0], np.float32)
        for a, b in zip(intr.project_culled(t(x), t(y), t(z)),
                        jintr.project_culled(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))):
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-6)
        for a, b in zip(intr.unproject(t(x), t(y)), jintr.unproject(jnp.asarray(x), jnp.asarray(y))):
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-6)
        for a, b in zip(intr.project(t(x), t(y), t(z)),
                        jintr.project(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))):
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-6)


def test_reference_helpers_match_jax():
    """The 3x3-matrix IPPE helpers of the reference-shaped API."""
    rng = np.random.default_rng(3)
    jac = rng.uniform(-1, 1, size=(6, 2, 2)).astype(np.float32)
    t2 = rng.uniform(-0.3, 0.3, size=(6, 2)).astype(np.float32)
    for a, b in zip(pose.compute_rotations(jac, t2), jpose.compute_rotations(jac, t2)):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5)
    r1 = n(pose.compute_rotations(jac, t2)[0])
    obj = n(pose.make_marker_square(20.0))[None].repeat(6, 0)
    img = rng.uniform(-0.2, 0.2, size=(6, 4, 2)).astype(np.float32)
    tr = n(pose.compute_translation(obj, img, r1))
    np.testing.assert_allclose(
        tr, np.asarray(jpose.compute_translation(obj, img, r1)), rtol=1e-4, atol=1e-3
    )
    np.testing.assert_allclose(
        n(pose.compute_reprojection_error(r1, tr, obj, img)),
        np.asarray(jpose.compute_reprojection_error(r1, tr, obj, img)), rtol=1e-4,
    )
    v = np.array([[0.1, -0.2, 1.0], [0.0, 0.0, -1.0]], np.float32)
    np.testing.assert_allclose(
        n(pose.find_rotation_to_z(v)), np.asarray(jpose.find_rotation_to_z(v)), atol=1e-6
    )
    p0, j0 = pose.MarkerPose.default(), jpose.MarkerPose.default()
    assert float(p0.error) == float(j0.error)
    np.testing.assert_array_equal(n(p0.apply_transform_to_vectors(v)), v)
    np.testing.assert_array_equal(n(p0.apply_inverse_transform_to_vectors(v)), v)
