"""End-to-end twin tests: the port's Detector against the JAX Detector (XLA
path) on the scenes of tests/test_detector.py at 320x240, both built from
the same carried-over state, plus the dictionaries, bit utilities, scene
rendering, state conversion and the port's independence from JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from aruco3_tpu import Detector as JDetector
from aruco3_tpu import DetectorConfig as JDetectorConfig
from aruco3_tpu import camera as jcamera
from aruco3_tpu import render as jrender
from aruco3_tpu import segment as jsegment
from aruco3_tpu import dictionaries as jdictionaries
from aruco3_tpu.utils import bits as jbits
from aruco3_tpu_torch import Detector, camera, convert, dictionaries, render
from aruco3_tpu_torch.detector import quad_params
from aruco3_tpu_torch.utils import bits
from torch_twin import make_scene, n, t

W, H = 320, 240
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_state(d, cfg, params):
    return {
        "name": d.name,
        "num_bits": d.num_bits,
        "tau": d.tau,
        "code_list": np.asarray(d.code_list),
        "config": dataclasses.asdict(cfg),
        "params": dataclasses.asdict(params),
    }


@pytest.fixture(scope="module")
def detectors():
    """(JAX detector, port detector) on the same dictionary and config;
    the port's state comes through convert.from_jax_state."""
    jd = jdictionaries.ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    jcfg = JDetectorConfig(use_pallas="never")
    ds = jsegment.choose_coarse_factor(H, W)
    d, cfg, _ = convert.from_jax_state(jax_state(jd, jcfg, jsegment.QuadParams()))
    return JDetector(jcfg, jd), Detector(cfg, d, device="cpu"), ds


def summary(det):
    return sorted((m.id, m.code, m.hamming_distance, tuple(m.corners)) for m in det.markers)


@pytest.mark.parametrize("kind", ["single", "multi", "dark", "nested", "rgb"])
def test_detect_matches_jax(detectors, kind):
    jdet, det, _ = detectors
    img, ids = make_scene(kind)
    ref = jdet.detect(img)
    got = det.detect(img)
    assert ids <= {m.id for m in ref.markers}
    assert summary(got) == summary(ref)
    assert got.candidates == ref.candidates
    assert got.stats == ref.stats


def test_detect_batch_matches_single(detectors):
    jdet, det, _ = detectors
    rng = np.random.default_rng(77)
    d = det.dictionary
    imgs = []
    for _ in range(4):
        img, _, _ = render.random_marker_scene(d, int(rng.integers(0, len(d))), (W, H), rng=rng)
        imgs.append(img)
    out = det.detect_batch(np.stack(imgs))
    for b, img in enumerate(imgs):
        single = det.detect(img)
        valid = n(out["marker_valid"][b])
        assert sorted(n(out["marker_id"][b])[valid].tolist()) == sorted(
            m.id for m in single.markers
        )
        assert summary(single) == summary(jdet.detect(img))


def test_convert_carries_state():
    jd = jdictionaries.ARDictionary.new_from_named_dict("ARTAG")
    jcfg = JDetectorConfig(max_candidates=16, coarse_factor=4, use_pallas="never")
    jparams = jsegment.QuadParams(max_candidates=16, coarse_factor=4, ccl_rounds=2)
    d, cfg, params = convert.from_jax_state(jax_state(jd, jcfg, jparams))
    assert (d.name, d.num_bits, d.tau) == (jd.name, jd.num_bits, jd.tau)
    np.testing.assert_array_equal(d.code_list, jd.code_list)
    assert dataclasses.asdict(params) == dataclasses.asdict(jparams)
    assert cfg.max_candidates == 16 and cfg.coarse_factor == 4
    ref = dataclasses.asdict(jsegment.QuadParams(max_candidates=16, coarse_factor=4))
    assert dataclasses.asdict(quad_params(cfg, 4)) == ref


def test_dictionaries_match_jax(rng):
    names = dictionaries.get_dictionary_names()
    assert names == jdictionaries.get_dictionary_names()
    for name in names:
        d = dictionaries.ARDictionary.new_from_named_dict(name.lower())
        jd = jdictionaries.ARDictionary.new_from_named_dict(name)
        assert (d.num_bits, d.tau, d.get_mark_size(), d.inner_size, len(d)) == (
            jd.num_bits, jd.tau, jd.get_mark_size(), jd.inner_size, len(jd)
        )
        np.testing.assert_array_equal(d.codebook_u32(), np.asarray(jd.codebook_u32()))
        np.testing.assert_array_equal(d.code_list, jd.code_list)
        for mid in (0, len(d) - 1):
            np.testing.assert_array_equal(d.marker_bit_matrix(mid), jd.marker_bit_matrix(mid))
        q = rng.integers(0, 2, size=(48, d.num_bits))
        q[:8] = (d.code_list[:8, None] >> np.arange(d.num_bits, dtype=np.uint64)) & 1
        ids, dists = d.find_nearest_bits(t(q))
        jids, jdists = jd.find_nearest_bits(q)
        np.testing.assert_array_equal(n(ids), np.asarray(jids))
        np.testing.assert_array_equal(n(dists), np.asarray(jdists))
        code = int(d.code_list[3])
        assert d.try_find_nearest(code) == jd.try_find_nearest(code)
    with pytest.raises(KeyError):
        dictionaries.ARDictionary.new_from_named_dict("NOPE")


def test_bits_match_jax(rng):
    codes = rng.integers(0, 2**63, size=16, dtype=np.uint64)
    np.testing.assert_array_equal(bits.pack_u64_to_u32(codes), jbits.pack_u64_to_u32(codes))
    np.testing.assert_array_equal(
        bits.unpack_u32_to_u64(bits.pack_u64_to_u32(codes)), codes
    )
    np.testing.assert_array_equal(
        bits.codes_to_bitplanes(codes, 36), jbits.codes_to_bitplanes(codes, 36)
    )
    assert bits.hamming_distance(codes[0], codes[1]) == jbits.hamming_distance(codes[0], codes[1])


def test_render_matches_jax():
    d = dictionaries.ARDictionary.new_from_named_dict("ARUCO_MIP_36H12")
    jd = jdictionaries.ARDictionary.new_from_named_dict("ARUCO_MIP_36H12")
    img, q, a = render.random_marker_scene(d, 9, (W, H), rng=np.random.default_rng(4))
    jimg, jq, ja = jrender.random_marker_scene(jd, 9, (W, H), rng=np.random.default_rng(4))
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(q, jq)
    intr = camera.CameraIntrinsics.new(W, H, 300.0, 300.0)
    jintr = jcamera.CameraIntrinsics.new(W, H, 300.0, 300.0)
    rot = np.diag([1.0, -1.0, -1.0])
    np.testing.assert_allclose(
        render.project_marker_corners(rot, [5.0, -3.0, 200.0], 40.0, intr),
        jrender.project_marker_corners(rot, [5.0, -3.0, 200.0], 40.0, jintr),
    )
    # The 1080p bench frame: the same construction as bench.py's.
    frame, truth = render.bench_scene(d, (1920, 1080), seed=0, noise_sigma=2.0)
    rng = np.random.default_rng(0)
    ref = np.full((1080, 1920), 255, np.uint8)
    for i in range(8):
        mid = int(rng.integers(0, len(jd)))
        for _ in range(20):
            tile, cor, _ = jrender.random_marker_scene(
                jd, mid, (480, 360), rng=rng, min_scale=0.45, max_scale=0.7, noise_sigma=0.0
            )
            if (cor[:, 0] > 8).all() and (cor[:, 0] < 472).all() and (
                cor[:, 1] > 8
            ).all() and (cor[:, 1] < 352).all():
                break
        y0, x0 = (i // 4) * 520 + 40, (i % 4) * 470 + 10
        ref[y0 : y0 + 360, x0 : x0 + 480] = np.minimum(ref[y0 : y0 + 360, x0 : x0 + 480], tile)
        assert truth[i][0] == mid
        np.testing.assert_array_equal(truth[i][1], cor + [x0, y0])
    ref = np.clip(ref + rng.normal(0, 2.0, ref.shape), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(frame, ref)


def test_port_imports_without_jax():
    code = (
        "import sys; import aruco3_tpu_torch, aruco3_tpu_torch.convert, "
        "aruco3_tpu_torch.ops._build, aruco3_tpu_torch.render; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert 'aruco3_tpu' not in sys.modules, 'aruco3_tpu imported'"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stderr


def test_codebooks_are_a_copy_of_the_jax_data():
    """The port keeps its own codebook file, equal byte for byte."""
    with open(os.path.join(REPO, "aruco3_tpu", "data", "codebooks.npz"), "rb") as f:
        ref = f.read()
    with open(dictionaries._DATA_PATH, "rb") as f:
        assert f.read() == ref
    assert os.path.dirname(dictionaries._DATA_PATH) == os.path.join(REPO, "aruco3_tpu_torch", "data")


def test_port_reads_no_file_of_the_jax_package():
    """Import the port, load every dictionary and detect frames on the CPU
    (both fit routes of the refine route; the tail route at coarse factor
    1 and without refinement) while an audit hook records every file
    opened."""
    code = (
        "import os, sys\n"
        "opened = []\n"
        "sys.addaudithook(lambda ev, args: opened.append(str(args[0])) "
        "if ev == 'open' and isinstance(args[0], (str, bytes, os.PathLike)) else None)\n"
        "import numpy as np\n"
        "from aruco3_tpu_torch import Detector, DetectorConfig, dictionaries, render\n"
        "for name in dictionaries.get_dictionary_names():\n"
        "    dictionaries.ARDictionary.new_from_named_dict(name)\n"
        "d = dictionaries.ARDictionary.new_from_named_dict('ARUCO_DEFAULT')\n"
        "img, _, _ = render.random_marker_scene(d, 3, (160, 120), rng=np.random.default_rng(0))\n"
        "Detector(DetectorConfig(), d, device='cpu').detect(img)\n"
        "Detector(DetectorConfig(max_candidates=130), d, device='cpu').detect(img)\n"
        "Detector(DetectorConfig(refine_corners=False), d, device='cpu').detect(\n"
        "    np.tile(img, (2, 2)))\n"
        "jax_dir = os.path.join(os.getcwd(), 'aruco3_tpu') + os.sep\n"
        "bad = [p for p in opened if os.path.abspath(p).startswith(jax_dir)]\n"
        "assert not bad, bad\n"
        "assert any(p.endswith('codebooks.npz') for p in opened)\n"
        "assert 'jax' not in sys.modules and 'aruco3_tpu' not in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stderr
