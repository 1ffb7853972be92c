"""The port engine's int8 serving, calibration artifacts, classifier and
retrieval index against the JAX ``InferenceEngine``, on the CPU.

Both engines hold the same weights (``load_jax_params``). Bounds, each
stated where it is used: features from one artifact in both packages agree
at per-row cosine >= 0.99999 (f32, the encoders' bound in
``test_torch_port_quant.py``); the same engine fed the same scales gives the
same bits; top-k ids are equal.
"""

import io
import json
import threading
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

import jax

from clip_mixer_tpu.config import CLIPConfig as JaxConfig
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.ops import quant_io as jax_quant_io
from clip_mixer_tpu.serving import InferenceEngine as JaxEngine

from clip_mixer_tpu_torch import CLIP, CLIPConfig, load_jax_params
from clip_mixer_tpu_torch.evals.quant_gate import synthetic_images
from clip_mixer_tpu_torch.ops import quant_io
from clip_mixer_tpu_torch.serving import InferenceEngine, NotLoadedError, _topk, serve

CFG = dict(
    embed_dim=16,
    image_resolution=32,
    vision_layers=2,
    vision_width=32,
    vision_patch_size=16,
    context_length=77,
    vocab_size=49408,
    text_width=32,
    text_heads=1,
    text_layers=2,
    tower="mixer",
    compute_dtype="float32",
)
HW = (40, 48)
F32_COSINE = 0.99999
TEXTS = [f"a {a} photo of a {b}" for a in ("small", "dark", "bright") for b in ("cat", "dog", "car", "tree")]
CLASSES = ["cat", "dog", "car", "tree", "house", "bird"]
TEMPLATES = ["a photo of a {}.", "an image of a {}."]


@pytest.fixture(scope="module")
def weights():
    jc = JaxConfig(**CFG)
    return jc, jax.tree.map(np.asarray, jclip.init(jax.random.key(0), jc))


def _port(weights, input_hw=None, cfg=None):
    _, params = weights
    model = load_jax_params(CLIP(CLIPConfig(**(cfg or CFG)), device="cpu"), params)
    return InferenceEngine(model, batch_buckets=(2, 4), input_hw=input_hw)


def _jax(weights, input_hw=None):
    jc, params = weights
    return JaxEngine(params, jc, batch_buckets=(2, 4), input_hw=input_hw)


def _images(n, hw, seed=0):
    return synthetic_images(n, max(hw), seed=seed)[:, : hw[0], : hw[1]].copy()


def _cosine(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _features(engine, hw):
    return engine.encode_image_arrays(_images(5, hw, seed=3)), engine.encode_text(TEXTS[:5])


@pytest.mark.parametrize("input_hw", [None, HW], ids=["model_sized", "planar"])
def test_enable_int8_from_samples_and_from_its_artifact_agree(weights, tmp_path, input_hw):
    hw = input_hw or (32, 32)
    path = str(tmp_path / "scales.npz")
    a = _port(weights, input_hw)
    float_img, _ = _features(a, hw)
    a.enable_int8(_images(8, hw), TEXTS, save_calibration=path)
    assert a.path_kinds == {"image": "int8", "text": "int8"}
    b = _port(weights, input_hw)
    b.enable_int8(calibration=path)
    assert b.path_kinds == {"image": "int8", "text": "int8"}
    for got, want in zip(_features(b, hw), _features(a, hw)):
        np.testing.assert_array_equal(got, want)
    img, _ = _features(a, hw)
    assert not np.array_equal(img, float_img)  # the int8 path is the one serving
    assert _cosine(img, float_img).min() > 0.99


@pytest.mark.parametrize("input_hw", [None, HW], ids=["model_sized", "planar"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_artifact_of_either_package_serves_in_the_other(weights, tmp_path, writer, input_hw):
    hw = input_hw or (32, 32)
    path = str(tmp_path / f"{writer}.npz")
    eng, jeng = _port(weights, input_hw), _jax(weights, input_hw)
    first, second = (jeng, eng) if writer == "jax" else (eng, jeng)
    first.enable_int8(_images(8, hw), TEXTS, save_calibration=path)
    second.enable_int8(calibration=path)
    assert eng.path_kinds == jeng.path_kinds == {"image": "int8", "text": "int8"}
    art, jart = quant_io.load_calibration(path), jax_quant_io.load_calibration(path)
    assert art["cfg"] == jart["cfg"]
    for side in ("image_scales", "text_scales"):
        assert art[side].keys() == jart[side].keys()
        for k in art[side]:
            np.testing.assert_array_equal(art[side][k], jart[side][k])
    for got, want in zip(_features(eng, hw), _features(jeng, hw)):
        assert _cosine(got, want).min() >= F32_COSINE


@pytest.mark.parametrize("field,value,hard", [("text_width", 64, True), ("compute_dtype", "bfloat16", False)])
def test_check_cfg_refuses_another_architecture_and_warns_on_dtype(weights, tmp_path, field, value, hard):
    path = str(tmp_path / "scales.npz")
    _port(weights).enable_int8(sample_texts=TEXTS[:4], save_calibration=path)
    other = CLIPConfig(**dict(CFG, **{field: value}))
    saved = quant_io.load_calibration(path)["cfg"]
    if hard:
        with pytest.raises(ValueError, match="different architecture"):
            quant_io.check_cfg(saved, other)
        with pytest.raises(ValueError, match="different architecture"):
            jax_quant_io.check_cfg(saved, JaxConfig(**dict(CFG, **{field: value})))
    else:
        with pytest.warns(UserWarning, match="dtype mismatch"):
            quant_io.check_cfg(saved, other)
    # fields that change nothing of the serving forward are not compared
    quant_io.check_cfg(saved, CLIPConfig(**dict(CFG, fused_mlp=True, remat=True)))


def test_text_only_artifact_quantizes_only_text(weights, tmp_path):
    path = str(tmp_path / "text.npz")
    _port(weights).enable_int8(sample_texts=TEXTS, save_calibration=path)
    art = quant_io.load_calibration(path)
    assert art["image_scales"] is None and set(art["text_scales"]) == {"ch_in", "ch_hidden"}
    eng, ref = _port(weights), _port(weights)
    eng.enable_int8(calibration=path)
    assert eng.path_kinds == {"image": "float", "text": "int8"}
    imgs = _images(3, (32, 32))
    np.testing.assert_array_equal(eng.encode_image_arrays(imgs), ref.encode_image_arrays(imgs))
    assert not np.array_equal(eng.encode_text(TEXTS[:3]), ref.encode_text(TEXTS[:3]))


def test_enable_int8_refusals(weights):
    eng = _port(weights)
    with pytest.raises(ValueError, match="no scales"):
        eng.enable_int8()
    with pytest.raises(ValueError, match="local file"):
        eng.enable_int8(calibration="gs://bucket/scales.npz")
    with pytest.raises(ValueError, match="local file"):
        eng.enable_int8(sample_texts=TEXTS[:2], save_calibration="gs://bucket/scales.npz")
    assert eng.path_kinds == {"image": "float", "text": "float"}


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_classify_index_and_retrieve_give_jax_top_k(weights, tmp_path, int8):
    eng, jeng = _port(weights, HW), _jax(weights, HW)
    if int8:
        path = str(tmp_path / "scales.npz")
        jeng.enable_int8(_images(8, HW), TEXTS, save_calibration=path)
        eng.enable_int8(calibration=path)
    imgs = _images(6, HW, seed=4)
    for e in (eng, jeng):
        e.load_classifier(CLASSES, TEMPLATES)
    got, want = eng.classify(imgs, top_k=3), jeng.classify(imgs, top_k=3)
    assert [[r["label"] for r in row] for row in got] == [[r["label"] for r in row] for row in want]
    np.testing.assert_allclose([[r["prob"] for r in row] for row in got], [[r["prob"] for r in row] for row in want],
                               atol=1e-4)
    ids = [f"img{i}" for i in range(6)]
    for e in (eng, jeng):
        e.index_images(imgs, ids)
    got, want = eng.retrieve(TEXTS[:4], top_k=3), jeng.retrieve(TEXTS[:4], top_k=3)
    assert [[r["id"] for r in row] for row in got] == [[r["id"] for r in row] for row in want]
    np.testing.assert_allclose([[r["score"] for r in row] for row in got],
                               [[r["score"] for r in row] for row in want], atol=1e-5)


def test_device_bank_matches_the_host_bank_on_the_cpu(weights):
    eng = _port(weights)
    feats = np.random.default_rng(0).normal(size=(300, 16)).astype(np.float32)
    ids = [str(i) for i in range(300)]
    eng.load_index(feats, ids, device=False)
    assert isinstance(eng._index[0], np.ndarray)
    host = eng.retrieve(TEXTS, top_k=5)  # 12 queries: buckets of 4
    eng.load_index(feats, ids, device=True)
    assert isinstance(eng._index[0], torch.Tensor)
    eng.warmup()  # runs the bank's similarity too
    dev = eng.retrieve(TEXTS, top_k=5)
    assert [[r["id"] for r in row] for row in dev] == [[r["id"] for r in row] for row in host]
    np.testing.assert_allclose([[r["score"] for r in row] for row in dev],
                               [[r["score"] for r in row] for row in host], atol=1e-6)
    eng.DEVICE_BANK_MIN_ROWS = 300  # automatic placement by size
    eng.load_index(feats, ids)
    assert isinstance(eng._index[0], torch.Tensor)
    eng.load_index(feats[:299], ids[:299])
    assert isinstance(eng._index[0], np.ndarray)


def test_index_and_classifier_refusals(weights):
    eng = _port(weights)
    with pytest.raises(NotLoadedError):
        eng.retrieve(["a cat"])
    with pytest.raises(NotLoadedError):
        eng.classify(_images(1, (32, 32)))
    with pytest.raises(ValueError, match="does not match 3 ids"):
        eng.load_index(np.zeros((2, 16), np.float32), ["a", "b", "c"])
    with pytest.raises(ValueError, match="embed_dim"):
        eng.load_index(np.zeros((2, 8), np.float32), ["a", "b"])
    with pytest.raises(ValueError, match="top_k"):
        _topk(np.arange(4.0), 0)
    np.testing.assert_array_equal(_topk(np.array([0.1, 0.9, 0.5, 0.7]), 3), [1, 3, 2])
    np.testing.assert_array_equal(_topk(np.array([0.1, 0.9]), 5), [1, 0])


def _bank(tmp_path, name, meta):
    path = str(tmp_path / name)
    arrays = {"features": np.eye(4, 16, dtype=np.float32), "ids": np.array(["a", "b", "c", "d"])}
    if meta is not None:
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    return path


def test_load_index_file_checks_provenance(weights, tmp_path):
    eng = _port(weights, HW)
    cfg = quant_io._cfg_dict(eng.cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng.load_index_file(_bank(tmp_path, "ok.npz", {"cfg": cfg, "path": "float", "input_hw": list(HW)}))
    assert eng._index[1] == ["a", "b", "c", "d"]
    with pytest.warns(UserWarning, match="'int8' image path"):
        eng.load_index_file(_bank(tmp_path, "int8.npz", {"cfg": cfg, "path": "int8", "input_hw": list(HW)}))
    with pytest.warns(UserWarning, match="input_hw=None"):
        eng.load_index_file(_bank(tmp_path, "hw.npz", {"cfg": cfg, "path": "float", "input_hw": None}))
    with pytest.warns(UserWarning, match="no provenance"):
        eng.load_index_file(_bank(tmp_path, "bare.npz", None))
    wrong = dict(cfg, vision_width=64)
    with pytest.raises(ValueError, match="different architecture"):
        eng.load_index_file(_bank(tmp_path, "wrong.npz", {"cfg": wrong, "path": "float", "input_hw": list(HW)}))


def _png(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    import base64

    return base64.b64encode(buf.getvalue()).decode()


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _npy(img):
    import base64

    buf = io.BytesIO()
    np.save(buf, img)
    return base64.b64encode(buf.getvalue()).decode()


def test_npy_images_decode_without_pil(weights):
    import base64

    eng = _port(weights, HW)
    imgs = _images(2, HW, seed=8)
    blobs = [base64.b64decode(_npy(im)) for im in imgs]
    np.testing.assert_array_equal(eng.decode_and_preprocess(blobs), imgs)
    with pytest.raises(ValueError, match="uint8 40x48x3"):
        eng.decode_and_preprocess([base64.b64decode(_npy(imgs[0, :32]))])
    with pytest.raises(ValueError, match="uint8 32x32x3"):  # a model-sized engine takes the model's size
        _port(weights).decode_and_preprocess(blobs)


def test_http_classify_index_and_retrieve_on_an_int8_engine(weights):
    eng = _port(weights, HW)
    eng.enable_int8(_images(8, HW), TEXTS)
    imgs = _images(3, HW, seed=7)
    srv = serve(eng, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        port = srv.server_address[1]
        blobs = [_png(im) for im in imgs[:2]] + [_npy(imgs[2])]
        code, out = _post(port, "/encode_image", {"images_b64": blobs})
        assert code == 200
        np.testing.assert_allclose(out["features"], eng.encode_image_arrays(imgs), atol=1e-6)
        assert _post(port, "/classify", {"images_b64": blobs})[0] == 409
        assert _post(port, "/retrieve", {"texts": ["a cat"]})[0] == 409
        eng.load_classifier(CLASSES, TEMPLATES)
        code, out = _post(port, "/classify", {"images_b64": blobs, "top_k": 2})
        assert code == 200 and out["results"] == eng.classify(imgs, top_k=2)
        code, out = _post(port, "/index", {"images_b64": blobs, "ids": ["x", "y", "z"]})
        assert code == 200 and out == {"indexed": 3}
        code, out = _post(port, "/retrieve", {"texts": TEXTS[:2], "top_k": 2})
        assert code == 200 and out["results"] == eng.retrieve(TEXTS[:2], top_k=2)
        assert _post(port, "/retrieve", {"texts": ["a cat"], "top_k": 0})[0] == 400
        health = _get(port, "/healthz")
        assert health["paths"] == {"image": "int8", "text": "int8"} and health["index_size"] == 3
        metrics = _get(port, "/metrics")["endpoints"]
        assert metrics["/classify"] == dict(metrics["/classify"], count=2, errors=1)
        assert metrics["/retrieve"]["count"] == 3 and metrics["/retrieve"]["errors"] == 2
        assert metrics["/index"]["count"] == 1 and metrics["/index"]["errors"] == 0
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
