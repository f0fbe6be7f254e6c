"""The device renderer: determined by the seed, and drawn as the port's
``render.random_marker_scene`` draws a marker."""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import runner, scenes  # noqa: E402
from portbench.reference import detect as ref  # noqa: E402
from portbench.reference.dictionaries import ARDictionary  # noqa: E402

SMALL = dict(height=240, width=320, tile=[240, 320], origin=[0, 0], pitch=[240, 320],
             columns=1, markers=[1, 1], interior_margin=8, tries=20)


def small_scene(config):
    return dict(runner.load_config(config)["scene"], **SMALL)


def test_same_seed_same_frames_other_seed_other_frames():
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    scene = small_scene("aruco_default_vga")
    seed = 2**31 + 12345
    a, ta = scenes.render_frames(scene, d, 3, seed, "cpu")
    b, tb = scenes.render_frames(scene, d, 3, seed, "cpu")
    c, _ = scenes.render_frames(scene, d, 3, seed + 1, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.uint8 and a.shape == (3, 240, 320)
    assert all(i == j and np.array_equal(p, q) for fa, fb in zip(ta, tb)
               for (i, p), (j, q) in zip(fa, fb))
    assert not torch.equal(a, c)


def test_geometry_is_random_marker_scenes():
    from aruco3_tpu_torch import ARDictionary as PortDictionary
    from aruco3_tpu_torch.render import random_marker_scene

    d = PortDictionary.new_from_named_dict("ARUCO_DEFAULT")
    for seed in (0, 7, 2**31 + 5):
        _, want, _ = random_marker_scene(d, 3, (320, 240), rng=np.random.default_rng(seed),
                                         min_scale=0.4, max_scale=0.7, noise_sigma=0.0)
        got = scenes.marker_quad(np.random.default_rng(seed), 320, 240, (0.4, 0.7), 0.12)
        np.testing.assert_array_equal(got, want)


def test_layouts_keep_markers_in_their_tiles():
    # With an interior margin every corner lies that far inside its tile;
    # without one (config 2's draws) a corner may leave its tile by the
    # turn and the perspective, up to 0.12 + 0.71 - 0.7 sides.
    for config in ("mip36h12_1080p", "aruco_default_vga"):
        c = runner.load_config(config)
        scene = c["scene"]
        d = ARDictionary.new_from_named_dict(c["dictionary"])
        placed, truth = scenes.draw_layout(scene, len(d), 32, 99)
        lo, hi = scene["markers"]
        assert all(lo <= len(t) <= hi for t in truth)
        th, tw = scene["tile"]
        slack = scene.get("interior_margin")
        slack = -slack if slack is not None else 0.13 * scene["scale"][1] * min(th, tw)
        for _, _, _, quad in placed:
            assert (quad[:, 0] >= -slack).all() and (quad[:, 0] <= tw + slack).all()
            assert (quad[:, 1] >= -slack).all() and (quad[:, 1] <= th + slack).all()


def test_rendered_markers_are_found_where_drawn():
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    frames, truth = scenes.render_frames(small_scene("aruco_default_vga"), d, 2, 4242, "cpu")
    out = ref.detect_batch(frames, d, ref.DetectorConfig())
    for b, markers in enumerate(truth):
        for mid, corners in markers:
            hits = (out["marker_valid"][b] & (out["marker_id"][b] == mid)).nonzero()
            assert len(hits) == 1
            got = out["marker_corners"][b, hits[0, 0]].numpy()
            # The corners in order, from whichever the detector calls first.
            assert min(np.abs(np.roll(got, r, axis=0) - corners).max() for r in range(4)) <= 2.0
