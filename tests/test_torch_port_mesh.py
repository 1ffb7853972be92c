"""The multi-device engine and frozen mesh programs against the JAX package's mesh forms, on the CPU.

``InferenceEngine(devices=[...])`` holds one replica a device and splits
each padded batch over them; here the CPU stands in for every device
(``["cpu"] * 4``), as JAX's 8 virtual CPU devices stand in for chips. Held,
after ``tests/test_serving.py:223-256`` and ``tests/test_aot.py:172``: the
buckets rounded to multiples of the device count, the features equal to
the single-device engine's (atol 1e-6) and within the f32 tolerance of
JAX's mesh engine (``test_torch_port_serving.py``: atol 5e-5 / rtol 1e-3),
bf16 and int8; the device bank padded and split over the devices; the
mesh programs' manifest as JAX's, and their features the live mesh
engine's bit for bit.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from clip_mixer_tpu import aot as jaot
from clip_mixer_tpu.config import CLIPConfig as JaxConfig
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.serving import InferenceEngine as JaxEngine

from clip_mixer_tpu_torch import aot, serving
from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import load_jax_params
from clip_mixer_tpu_torch.serving import InferenceEngine

CFG = dict(embed_dim=16, image_resolution=32, vision_layers=1, vision_width=32, vision_patch_size=16,
           context_length=16, vocab_size=49408, text_width=32, text_heads=1, text_layers=2, tower="mixer",
           compute_dtype="float32")
TEXTS = ["a cat", "a dog on a mat", "hello world"]
ATOL, RTOL = 5e-5, 1e-3  # the f32 engine against JAX's, test_torch_port_serving.py
MESH_ATOL = 1e-6  # tests/test_serving.py:244
FOUR = ["cpu"] * 4


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jclip.init(jax.random.key(1), JaxConfig(**CFG)))


@pytest.fixture(scope="module")
def model(jax_params):
    return load_jax_params(CLIP(CLIPConfig(**CFG), device="cpu"), jax_params)


def _images(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _jax_mesh(n=4):
    return Mesh(np.asarray(jax.devices()[:n]), ("data",))


def test_mesh_engine_matches_single_device_and_jax(model, jax_params):
    imgs = _images(10)
    single = InferenceEngine(model, batch_buckets=(4, 8))
    meshed = InferenceEngine(model, batch_buckets=(2, 4, 6, 8), devices=FOUR)
    jmeshed = JaxEngine(jax_params, JaxConfig(**CFG), batch_buckets=(2, 4, 6, 8), mesh=_jax_mesh())
    assert meshed.buckets == jmeshed.buckets == [4, 8]  # 2 -> 4, 6 -> 8: multiples of 4 devices
    assert len(meshed.replicas) == 4 and meshed.device == torch.device("cpu")
    for got, one, want in ((meshed.encode_image_arrays(imgs), single.encode_image_arrays(imgs),
                            jmeshed.encode_image_arrays(imgs)),
                           (meshed.encode_text(TEXTS), single.encode_text(TEXTS), jmeshed.encode_text(TEXTS))):
        np.testing.assert_allclose(got, one, rtol=0, atol=MESH_ATOL)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # int8 on every replica, from one calibration
    single.enable_int8(imgs[:4], sample_texts=TEXTS)
    meshed.enable_int8(imgs[:4], sample_texts=TEXTS)
    assert meshed.path_kinds == {"image": "int8", "text": "int8"} and len(meshed._image_path[1]) == 4
    np.testing.assert_allclose(meshed.encode_image_arrays(imgs), single.encode_image_arrays(imgs), rtol=0,
                               atol=MESH_ATOL)
    np.testing.assert_allclose(meshed.encode_text(TEXTS), single.encode_text(TEXTS), rtol=0, atol=MESH_ATOL)


def test_mesh_engine_device_bank_is_padded_and_split(model):
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(10, CFG["embed_dim"])).astype(np.float32)
    ids = [f"img{i}" for i in range(10)]
    host, meshed = InferenceEngine(model, batch_buckets=(4,)), InferenceEngine(model, batch_buckets=(4,), devices=FOUR)
    host.load_index(feats, ids, device=False)
    meshed.load_index(feats, ids, device=True)
    shards = meshed._index[0]
    assert [tuple(s.shape) for s in shards] == [(3, CFG["embed_dim"])] * 4  # 10 rows padded to 12
    assert float(shards[-1][-2:].abs().sum()) == 0.0
    got, want = meshed.retrieve(TEXTS, top_k=5), host.retrieve(TEXTS, top_k=5)
    assert [[r["id"] for r in row] for row in got] == [[r["id"] for r in row] for row in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([r["score"] for r in g], [r["score"] for r in w], rtol=0, atol=MESH_ATOL)
    assert meshed.retrieve(TEXTS, top_k=50)[0][-1]["id"] in ids  # the padding rows never come back
    meshed.warmup()


def test_mesh_frozen_programs_match_the_live_mesh_engine_and_jax(model, jax_params, tmp_path):
    out = str(tmp_path / "msrv")
    aot.export_servable(model, out, batch_buckets=(2, 8), mesh=FOUR)
    manifest = aot.read_manifest(out)
    assert manifest["mesh"] == {"axis_names": ["data"], "shape": [4]}
    assert manifest["buckets"] == [4, 8]  # rounded to device multiples
    jout = str(tmp_path / "jmsrv")
    jaot.export_servable(jax_params, JaxConfig(**CFG), jout, batch_buckets=(2, 8), mesh=_jax_mesh())
    jm = json.loads((Path(jout) / "servable" / "manifest.json").read_text())
    assert {k: manifest[k] for k in ("mesh", "buckets", "int8", "input_hw")} == \
        {k: jm[k] for k in ("mesh", "buckets", "int8", "input_hw")}

    frozen = aot.load_servable(out, device="cpu")
    assert frozen.frozen and len(frozen.replicas) == 4 and frozen.buckets == [4, 8]
    live = InferenceEngine(model, batch_buckets=(2, 8), devices=FOUR)
    single = InferenceEngine(model, batch_buckets=(8,))
    jfrozen = jaot.load_servable(jout)
    imgs = _images(6, seed=5)
    got_i, got_t = frozen.encode_image_arrays(imgs), frozen.encode_text(TEXTS)
    assert np.all(np.isfinite(got_i)) and np.all(np.isfinite(got_t))
    np.testing.assert_array_equal(got_i, live.encode_image_arrays(imgs))
    np.testing.assert_array_equal(got_t, live.encode_text(TEXTS))
    np.testing.assert_allclose(got_i, single.encode_image_arrays(imgs), atol=1e-5)
    np.testing.assert_allclose(got_i, jfrozen.encode_image_arrays(imgs), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_t, jfrozen.encode_text(TEXTS), atol=ATOL, rtol=RTOL)


def test_mesh_programs_need_their_devices(model, tmp_path, monkeypatch):
    """Loading on the card needs as many cards as the layout recorded, as
    JAX's load needs as many devices."""
    out = str(tmp_path / "msrv2")
    aot.export_servable(model, out, batch_buckets=(2,), mesh=["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"\(2 devices\) but this process sees 1"):
        aot.mesh_devices(aot.read_manifest(out), torch.device("cuda"))
    assert aot.mesh_devices(aot.read_manifest(out), torch.device("cpu")) == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert aot.mesh_devices(aot.read_manifest(out), torch.device("cuda")) == [torch.device("cuda", 0),
                                                                               torch.device("cuda", 1)]


@pytest.mark.parametrize("cards", [0, 1, 3])
def test_local_mesh_is_none_on_a_one_device_host(monkeypatch, cards):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got = serving.local_mesh()
    assert got == (None if cards <= 1 else [torch.device("cuda", i) for i in range(cards)])
    assert serving.visible_devices("cpu") == [torch.device("cpu")]
