"""The port's masks route and streaming runtime on the card, against the
same functions on the CPU.  Imports no JAX; the tests need the card and
skip elsewhere:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_paths_gpu.py
"""

import time

import numpy as np
import pytest
import torch

from aruco3_tpu_torch import ARDictionary, Detector, DetectorConfig
from aruco3_tpu_torch.detector import detect_arrays, detect_from_masks, to_host
from aruco3_tpu_torch.ops import coarse_fit as k2
from aruco3_tpu_torch.ops import fit as kfit
from aruco3_tpu_torch.ops import frontend as k1
from aruco3_tpu_torch.ops import refine as k3
from aruco3_tpu_torch.ops import warp_eval as k8
from aruco3_tpu_torch.runtime import stream as rt
from torch_twin import cuda_device, make_scene

KINDS = ("single", "multi", "dark", "nested")
COUNTS = {"frontend": k1.count, "coarse_labels": k2.labels_count, "fused_fit": kfit.fused_count,
          "refine": k3.count, "warp_eval": k8.count}


def _summary(det):
    return sorted((m.id, m.code, tuple(m.corners)) for m in det.markers), det.stats


@pytest.mark.gpu
@pytest.mark.parametrize("w, h, refine", [(320, 240, True), (320, 240, False), (160, 120, True)])
def test_detect_from_masks_on_card_matches_cpu(w, h, refine):
    """Both routes of ``detect_from_masks``: kernel 3 then kernel 8 (320x240
    at ds 2 with refinement), and kernel 8 alone (no refinement, or ds 1)."""
    dev = cuda_device()
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    det = Detector(DetectorConfig(refine_corners=refine), d, device="cpu")
    frames = torch.from_numpy(np.stack([make_scene(k, w, h, w / 320)[0] for k in KINDS]))
    params, min_edge, min_sep, ds = det.geometry(h, w)
    coarse, _, _, black = k1.plain(frames, det.config.threshold_window, params.open_radius, ds,
                                   opened=True)
    ref = detect_from_masks(frames, black, coarse, d, det.config, params, min_edge, min_sep, ds)
    for c in COUNTS.values():
        c.reset()
    got = detect_from_masks(frames.to(dev), black.to(dev), coarse.to(dev), d, det.config,
                            params, min_edge, min_sep, ds)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in COUNTS.items()}
    assert launches == {"frontend": 0, "coarse_labels": 1, "fused_fit": 1,
                        "refine": int(refine and ds > 1), "warp_eval": 1}
    assert all(c.plain_calls == 0 for c in COUNTS.values())
    for b, kind in enumerate(KINDS):
        assert _summary(to_host(got, b)) == _summary(to_host(ref, b)), kind
        assert {m.id for m in to_host(got, b).markers} == make_scene(kind)[1]


@pytest.mark.gpu
def test_detect_arrays_on_card_matches_cpu():
    dev = cuda_device()
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    det = Detector(DetectorConfig(), d, device="cpu")
    img, ids = make_scene("nested")
    params, min_edge, min_sep, ds = det.geometry(*img.shape)
    ref = detect_arrays(torch.from_numpy(img), d, det.config, params, min_edge, min_sep, ds)
    k1.count.reset()
    got = detect_arrays(torch.from_numpy(img).to(dev), d, det.config, params, min_edge, min_sep,
                        ds)
    assert k1.count.launches == 1
    for key in ("marker_valid", "marker_id", "marker_code", "quads"):
        assert torch.equal(got[key].cpu(), ref[key]), key
    valid = ref["marker_valid"]
    assert {int(i) for i in ref["marker_id"][valid]} == ids


@pytest.mark.gpu
def test_stream_pipeline_on_card():
    """Two batches through the pinned, side-stream dispatch: every lane
    equals ``detect_batch`` of its frame on the card."""
    dev = cuda_device()
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    det = Detector(DetectorConfig(), d, device=dev)
    frames = np.stack([make_scene(k)[0] for k in KINDS])
    ref = det.detect_batch(frames)
    pipe = rt.StreamPipeline(det, (240, 320), n_streams=4, batch=4)
    for i in range(2):
        for s in range(4):
            pipe.push(s, frames[(s + i) % 4])
    pipe.start()
    items = []
    deadline = time.time() + 60
    while time.time() < deadline and sum(it["n"] for it in items) < 8:
        items += pipe.drain()
        time.sleep(0.01)
    pipe.stop()
    assert pipe.stats.batches == 2 and len(pipe._staging) == 2
    for item in items:
        out = item["outputs"]
        assert out["done"].query()
        for lane, (s, seq) in enumerate(zip(item["stream_ids"], item["seqs"])):
            f = (int(s) + int(seq)) % 4
            for key in ("marker_valid", "marker_id", "marker_corners"):
                assert torch.equal(out[key][lane], ref[key][f]), key
