"""The port's drop-in for the reference ``clip`` module
(``clip_mixer_tpu_torch.compat``), ``tests/test_compat.py`` case for case,
against the JAX package's ``compat`` on the same saved checkpoint (a
reference-keyed ``.pt`` of JAX-initialised weights), on the CPU. f32
features agree within the JAX suite's atol 5e-5 / rtol 1e-3."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax

import clip_mixer_tpu.compat as jclip_compat
from clip_mixer_tpu.config import CLIPConfig as JaxConfig
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.models.convert import params_to_state_dict

import clip_mixer_tpu_torch.compat as clip
from clip_mixer_tpu_torch.ops.preprocess import preprocess_pil
from clip_mixer_tpu_torch.text.tokenize import tokenize as tokenize_np

ATOL, RTOL = 5e-5, 1e-3
TINY = dict(
    embed_dim=64,
    image_resolution=32,
    vision_layers=2,
    vision_width=64,
    vision_patch_size=16,
    context_length=16,
    vocab_size=49408,  # the full vocabulary, so real BPE tokens stay in range
    text_width=64,
    text_heads=1,
    text_layers=2,
    tower="mixer",
    compute_dtype="float32",
)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(port compat model, its preprocess, JAX compat model, JAX preprocess,
    the checkpoint path), both loaded from one reference-keyed ``.pt``."""
    params = jclip.init(jax.random.key(0), JaxConfig(**TINY))
    path = str(tmp_path_factory.mktemp("compat") / "tiny.pt")
    torch.save({k: torch.as_tensor(v.copy()) for k, v in params_to_state_dict(params, JaxConfig(**TINY)).items()},
               path)
    model, preprocess = clip.load(path, device="cpu")
    jmodel, jpreprocess = jclip_compat.load(path, device="cpu")
    return model, preprocess, jmodel, jpreprocess, path


def _pil(seed, h, w):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8))


def test_available_models():
    names = clip.available_models()
    assert names == jclip_compat.available_models()
    assert "ViT-B/32" in names and "mixer-b32" in names


def test_tokenize_matches_native_and_is_torch_long():
    texts = ["a diagram", "a dog", "a cat"]
    t = clip.tokenize(texts)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.long
    assert t.shape == (3, 77)
    np.testing.assert_array_equal(t.numpy(), np.asarray(tokenize_np(texts)))
    assert torch.equal(t, jclip_compat.tokenize(texts))
    with pytest.raises(RuntimeError):
        clip.tokenize(["word " * 50], context_length=8)


def test_reference_demo_shape(models):
    """The README demo, line for line, against the tiny model and JAX's."""
    model, preprocess, jmodel, jpreprocess, _ = models
    pil = _pil(0, 48, 64)
    image = preprocess(pil).unsqueeze(0)
    assert image.shape == (1, 3, 32, 32) and image.dtype == torch.float32
    np.testing.assert_allclose(image.numpy(), jpreprocess(pil).unsqueeze(0).numpy(), atol=1e-6)
    text = clip.tokenize(["a diagram", "a dog", "a cat"], context_length=16, truncate=True)

    with torch.no_grad():
        image_features = model.encode_image(image)
        text_features = model.encode_text(text)
        img_f, txt_f, scale = model(image, text)
    assert image_features.shape == (1, 64) and text_features.shape == (3, 64)
    assert image_features.device == model.device  # outputs stay on the model's device
    np.testing.assert_allclose(np.linalg.norm(img_f.numpy(), axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(txt_f.numpy(), axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(scale), np.exp(float(model.logit_scale)), rtol=1e-6)
    for got, want in zip((img_f, txt_f, scale), jmodel(image, text)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)

    per_image, per_text = model.logits(image, text)
    assert per_image.shape == (1, 3)
    np.testing.assert_allclose(per_image.numpy(), per_text.numpy().T, rtol=1e-6)
    np.testing.assert_allclose(per_image.softmax(dim=-1).numpy().sum(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(per_image.numpy(), jmodel.logits(image, text)[0].numpy(), atol=1e-3, rtol=RTOL)


def test_compat_agrees_with_native_api(models):
    """The normalised-NCHW path, the uint8 NHWC path and the text path agree
    with each other and with JAX's compat."""
    model, preprocess, jmodel, _, _ = models
    pil = _pil(1, 40, 56)
    compat_feats = model.encode_image(preprocess(pil).unsqueeze(0)).numpy()
    np.testing.assert_allclose(compat_feats, jmodel.encode_image(preprocess(pil).unsqueeze(0)).numpy(),
                               atol=ATOL, rtol=RTOL)

    hwc = preprocess_pil(pil, TINY["image_resolution"])[None]
    direct = model.encode_image(torch.from_numpy(hwc.copy())).numpy()  # uint8 NHWC, the native convention
    np.testing.assert_allclose(direct, compat_feats, atol=1e-5)
    np.testing.assert_allclose(direct, jmodel.encode_image(torch.from_numpy(hwc.copy())).numpy(), atol=ATOL,
                               rtol=RTOL)

    toks = torch.from_numpy(np.asarray(tokenize_np(["hello world"], context_length=16))).long()
    np.testing.assert_allclose(model.encode_text(toks).numpy(), jmodel.encode_text(toks).numpy(), atol=ATOL,
                               rtol=RTOL)


def test_torch_idioms_and_attributes(models):
    model, _, jmodel, _, _ = models
    assert model.eval() is model and model.to("cpu") is model and model.float() is model
    assert model.train(False) is model
    with pytest.raises(RuntimeError, match="inference-only"):
        model.train()
    for attr in ("context_length", "vocab_size", "input_resolution", "dtype"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert (model.context_length, model.vocab_size, model.input_resolution) == (16, 49408, 32)
    assert model.visual.input_resolution == 32  # the reference's training.py:288 reads it
    assert model.dtype == torch.float32
    np.testing.assert_allclose(float(model.logit_scale), float(jmodel.logit_scale), rtol=1e-7)


def test_state_dict_round_trips(models, tmp_path):
    """``torch.save(model.state_dict())`` loads back through ``load``, and
    holds JAX compat's keys and values."""
    model, _, jmodel, _, _ = models
    sd, jsd = model.state_dict(), jmodel.state_dict()
    assert all(isinstance(v, torch.Tensor) for v in sd.values()) and sd.keys() == jsd.keys()
    for k in sd:
        assert torch.equal(sd[k], jsd[k]), k
    pt = tmp_path / "compat.pt"
    torch.save(sd, pt)
    model2, _ = clip.load(str(pt), device="cpu")
    toks = clip.tokenize(["round trip"], context_length=16, truncate=True)
    assert torch.equal(model.encode_text(toks), model2.encode_text(toks))


def test_load_preset_by_name():
    model, _ = clip.load("mixer-debug", device="cpu")
    assert model.input_resolution == model.cfg.image_resolution
    img = torch.zeros(1, 3, model.input_resolution, model.input_resolution)
    assert model.encode_image(img).shape == (1, model.cfg.embed_dim)


def test_load_defaults_to_the_card_and_raises_without_one(monkeypatch, models):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clip.load(models[4])
