"""The port's batch pipeline is fit for CUDA graph capture, on the CPU.

A captured graph cannot hold a host sync (``.item()``, ``bool()`` or
``int()`` of a tensor, a boolean mask index, ``nonzero``) nor a tensor
built from host data during the call (a host-to-device copy on the card).
Each route of ``detect_batch_arrays`` (and the masks route of
``detect_arrays``) runs twice with ``pose.solve_normalized_batch`` under a
``TorchDispatchMode``, and so does the spatial step's band stage
(``parallel.spatial.band_stage``): the first run fills the per-device
caches, the second must dispatch none of those operations.  Only the kernels' plain
versions run outside the mode: on the card the kernels run in their place.

Beside it, the constants hoisted out of the batch (code-word weights,
marker square, flip, the clockwise swap) against their JAX counterparts,
and the graph module's CPU-side pieces.
"""

from contextlib import ExitStack
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from aruco3_tpu import pose as jpose
from aruco3_tpu import rectify as jrectify
from aruco3_tpu import segment as jsegment
from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig, ops, pose, rectify, segment
from aruco3_tpu_torch.detector import detect_arrays, detect_batch_arrays
from aruco3_tpu_torch.ops import coarse_fit, fit, frontend, refine, warp_decode, warp_eval
from aruco3_tpu_torch.parallel import spatial
from aruco3_tpu_torch.runtime import graph
from torch_twin import make_scene, n, t

# The kernels' plain versions, which run where the card runs the kernels.
PLAINS = [
    (frontend, "plain"),
    (coarse_fit, "plain"),
    (coarse_fit, "labels_plain"),
    (fit, "fused_fit_plain"),
    (segment, "rank_pool"),
    (segment, "fit_lanes"),
    (refine, "plain"),
    (warp_decode, "plain"),
    (warp_eval, "plain"),
]
# Operations a capture refuses, or that copy host data to the card.
HOST_SYNCS = ("aten._local_scalar_dense", "aten.nonzero.", "aten.masked_select",
              "aten.unique", "aten._unique")
HOST_DATA = ("aten.lift_fresh",)

# (config, frame (w, h), transpose, stage: "batch" (``detect_batch_arrays``),
# "masks" (``detect_arrays``) or "band" (the spatial band stage of rank 1 of 2))
ROUTES = {
    "fused": (DetectorConfig(), (320, 240), False, "batch"),
    "labels_k7": (DetectorConfig(), (320, 240), True, "batch"),  # portrait 240x320
    "labels_k5_k6": (DetectorConfig(max_candidates=160), (320, 240), False, "batch"),
    "tail": (DetectorConfig(refine_corners=False), (320, 240), False, "batch"),
    "tail_gather": (DetectorConfig(refine_corners=False, warp_impl="gather"), (160, 120),
                    False, "batch"),
    "masks": (DetectorConfig(), (320, 240), False, "masks"),
    "band": (DetectorConfig(), (320, 240), False, "band"),
}


class Recorder(TorchDispatchMode):
    """Records the forbidden operations dispatched, with their callers."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        index = args[1] if name.startswith("aten.index.") and len(args) > 1 else ()
        bool_index = any(torch.is_tensor(i) and i.dtype == torch.bool for i in index)
        if name.startswith(HOST_SYNCS + HOST_DATA) or bool_index:
            import traceback

            site = [ln for ln in traceback.format_stack() if "aruco3_tpu_torch" in ln]
            self.found.append((name, site[-1].strip() if site else "?"))
        return func(*args, **(kwargs or {}))


def _outside(fn):
    def run(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)

    return run


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_is_capture_safe(route):
    cfg, (w, h), transpose, stage = ROUTES[route]
    det = Detector(cfg, ARDictionary.new_from_named_dict("ARUCO_DEFAULT"), device="cpu")
    imgs = [make_scene(k, w, h, w / 320)[0] for k in ("single", "multi")]
    if transpose:
        imgs = [np.ascontiguousarray(i.T) for i in imgs]
    frames = torch.from_numpy(np.stack(imgs))
    geometry = det.geometry(*frames.shape[1:])
    scale = torch.tensor([float(frames.shape[2]), float(frames.shape[1])])

    def step():
        if stage == "band":
            return band(band_ext), None
        if stage == "masks":
            out = detect_arrays(frames[0], det.dictionary, cfg, *geometry)
        else:
            out = detect_batch_arrays(frames, det.dictionary, cfg, *geometry)
        return out, pose.solve_normalized_batch(out["marker_corners"] / scale, 40.0)

    if stage == "band":  # rank 1's rows of frame 0 with the halos it receives
        halo = cfg.threshold_window + 2 * spatial.OPEN_RADIUS
        hs = h // 2
        band = spatial.band_stage(hs, h, w, cfg.threshold_window, halo, geometry[3])
        band_ext = torch.cat([frames[0, hs - halo :], torch.zeros((halo, w), dtype=torch.uint8)])

    with ExitStack() as stack:
        for module, name in PLAINS:
            stack.enter_context(mock.patch.object(module, name, _outside(getattr(module, name))))
        runs = []
        for _ in range(2):
            with Recorder() as rec:
                out, _ = step()
            runs.append(rec.found)
    assert runs[1] == [], sorted(set(runs[1]))
    if stage == "band":
        black, coarse = out
        assert black.shape == (hs, w) and bool(black.any()) and bool(coarse.any())
    else:
        assert int(out["stats"]["markers"].sum()) > 0


def test_hoisted_constants_match_jax():
    rng = np.random.default_rng(5)
    for nb in (16, 25, 36):
        bits = (rng.random((7, 4, nb)) < 0.5).astype(np.int32)
        got = rectify.bits_to_u32_pairs(t(bits))
        np.testing.assert_array_equal(n(got), np.asarray(jrectify.bits_to_u32_pairs(jnp.asarray(bits))))
        assert rectify.code_word_weights(nb, got.device) is rectify.code_word_weights(nb, got.device)
    # The batched pose solve's twin inputs (tests/test_torch_pose.py).
    rng = np.random.default_rng(7)
    quads = []
    for _ in range(32):
        c, r, ang = rng.uniform(-0.3, 0.3, size=2), rng.uniform(0.05, 0.15), rng.uniform(0, 2 * np.pi)
        quads.append([c + r * np.array([np.cos(a), np.sin(a)])
                      for a in ang + np.arange(4) * np.pi / 2 + rng.uniform(-0.2, 0.2, 4)])
    quads = np.array(quads, np.float32).reshape(4, 8, 4, 2)
    for size in (11.0, 20.0, 40.0):
        hom = pose.compute_homography_from_marker_square(size, t(quads))
        np.testing.assert_array_equal(
            n(hom), np.asarray(jpose.compute_homography_from_marker_square(size, jnp.asarray(quads))))
        # A number stays on the host; a tensor takes the device path: the same bits.
        np.testing.assert_array_equal(
            n(hom), n(pose.compute_homography_from_marker_square(torch.tensor(size), t(quads))))
        for a, b in zip(pose.solve_normalized_batch(t(quads), size),
                        pose.solve_normalized_batch(t(quads), torch.tensor(size))):
            np.testing.assert_array_equal(n(a), n(b))
        np.testing.assert_array_equal(n(pose.marker_square_on(size, torch.device("cpu"))),
                                      np.asarray(jpose.make_marker_square(size)))
    v = rng.normal(size=(9, 3)).astype(np.float32)
    v[0] = [0.0, 0.0, -1.0]  # the degenerate flip
    np.testing.assert_array_equal(n(pose.find_rotation_to_z(t(v))),
                                  np.asarray(jpose.find_rotation_to_z(jnp.asarray(v))))
    q = rng.uniform(0, 100, size=(3, 5, 4, 2)).astype(np.float32)
    np.testing.assert_array_equal(n(segment.enforce_clockwise(t(q))),
                                  np.asarray(jsegment.enforce_clockwise(jnp.asarray(q))))


def test_cpu_detector_runs_eagerly():
    """On the CPU ``detect_batch`` is ``detect_batch_arrays`` and makes no
    graph; ``Graph`` refuses a device other than a card."""
    det = Detector(DetectorConfig(), ARDictionary.new_from_named_dict("ARUCO_DEFAULT"),
                   device="cpu")
    frames = torch.from_numpy(np.stack([make_scene("single", 160, 120, 0.5)[0]] * 2))
    got = det.detect_batch(frames)
    ref = detect_batch_arrays(frames, det.dictionary, det.config, *det.geometry(120, 160))
    for key in ("marker_valid", "marker_id", "marker_code", "marker_corners", "quads"):
        assert torch.equal(got[key], ref[key]), key
    assert det._graphs is None
    with pytest.raises(ValueError, match="CUDA device"):
        graph.Graph(lambda x: x, [((2, 4), torch.uint8)], "cpu")


def test_graph_outputs_are_cloned_and_counters_registered():
    tree = {"a": torch.arange(3), "s": {"b": torch.ones(2)}, "t": (torch.zeros(1), 5)}
    out = graph._clone(tree)
    assert out["a"].data_ptr() != tree["a"].data_ptr() and torch.equal(out["a"], tree["a"])
    assert out["s"]["b"].data_ptr() != tree["s"]["b"].data_ptr()
    assert isinstance(out["t"], tuple) and out["t"][1] == 5
    wrapper_counters = {frontend.count, coarse_fit.count, coarse_fit.labels_count, fit.rank_count,
                        fit.lanes_count, fit.fused_count, refine.count, warp_decode.count,
                        warp_eval.count}
    assert wrapper_counters <= set(ops.counters())


def test_graph_refuses_specs_that_are_not_pairs():
    """``Graph`` takes its inputs as a non-empty sequence of (shape, dtype)
    pairs and refuses anything else before it touches a device."""
    for specs in ((2, 4), ((2, 4), torch.uint8), [], [((2, 4), "uint8")], [(2, torch.uint8)]):
        with pytest.raises(ValueError, match="input specs"):
            graph.Graph(lambda x: x, specs, "cuda")
    pairs = ((torch.Size([1, 4, 4]), torch.uint8), ([1, 2, 2], torch.bool))
    assert graph._pairs(pairs) == [((1, 4, 4), torch.uint8), ((1, 2, 2), torch.bool)]
