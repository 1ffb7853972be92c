"""The port's int8 noise-floor gates (``clip_mixer_tpu_torch/evals/``)
against the JAX package's ``clip_mixer_tpu/evals/quant_gate.py``, on the CPU.

The images are bit for bit JAX's; the gates run on the same weights
(``load_jax_params``) at a tiny size and must count the same flips as the
JAX gates, with the same verdict. The classifiers agree within 1e-5 (f32).
In bf16 compute the text gate's int8 features agree with JAX's per row at
cosine >= 0.999, a bound that a planted fault fails.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from clip_mixer_tpu.config import CLIPConfig as JaxConfig
from clip_mixer_tpu.evals import quant_gate as jgate
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.ops import quant as jq
from clip_mixer_tpu.ops.preprocess import normalize_images as jax_normalize
from clip_mixer_tpu.text import tokenize as jax_tokenize

from clip_mixer_tpu_torch import CLIP, CLIPConfig, load_jax_params
from clip_mixer_tpu_torch.evals import quant_gate as tgate
from clip_mixer_tpu_torch.models.clip import l2_normalize
from clip_mixer_tpu_torch.ops import quant as tq

CLASSNAMES = ["cat", "dog", "car", "tree", "house", "bird", "boat", "chair"]
TEMPLATES = ["a photo of a {}.", "an image of a {}."]
# tests/test_quant_gate.py's make_cfg("mixer")
CFG = dict(
    embed_dim=32,
    image_resolution=32,
    vision_layers=2,
    vision_width=64,
    vision_patch_size=16,
    context_length=77,
    vocab_size=49408,
    text_width=64,
    text_heads=1,
    text_layers=2,
    tower="mixer",
    compute_dtype="float32",
)
COUNTS = ("n", "flips_bf16", "flips_int8", "passed")


def _pair(dtype="float32", seed=0):
    cfg = dict(CFG, compute_dtype=dtype)
    jc = JaxConfig(**cfg)
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(seed), jc))
    return jc, params, load_jax_params(CLIP(CLIPConfig(**cfg), device="cpu"), params)


def _same_verdict(got, want):
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}, (got, want)
    assert set(got) == set(want)
    for k in ("flip_ratio", "flip_ratio_ci_low", "flip_ratio_ci_high", "margin_to_budget"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


@pytest.mark.parametrize("n,res,seed", [(10, 32, 0), (7, 64, 3), (5, 224, 1)])
def test_synthetic_images_bitwise(n, res, seed):
    got = tgate.synthetic_images(n, res, seed=seed)
    assert got.dtype == np.uint8 and got.shape == (n, res, res, 3)
    np.testing.assert_array_equal(got, jgate.synthetic_images(n, res, seed=seed))


def test_float_classifier_matches_jax():
    jc, params, model = _pair()
    got = tgate.build_float_classifier(model, CLASSNAMES, TEMPLATES, batch_size=4)
    want = jgate.build_float_classifier(params, jc, CLASSNAMES, TEMPLATES)
    assert got.shape == want.shape == (32, len(CLASSNAMES)) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_zeroshot_agreement_matches_jax():
    jc, params, model = _pair()
    imgs = tgate.synthetic_images(32, 32, seed=1)
    w = jgate.build_float_classifier(params, jc, CLASSNAMES, TEMPLATES)
    got = tgate.zeroshot_top1_agreement(model, imgs, w, calibrate_n=16, batch_size=16)
    want = jgate.zeroshot_top1_agreement(params, jc, imgs, w, calibrate_n=16, batch_size=16)
    assert got["n"] == want["n"] == 32 and got["agreement"] == want["agreement"]
    assert got["min_cosine"] == pytest.approx(want["min_cosine"], abs=1e-5)
    assert got["median_margin"] == pytest.approx(want["median_margin"], abs=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noise_floor_gate_counts_match_jax(dtype):
    jc, params, model = _pair(dtype, seed=2)
    imgs = tgate.synthetic_images(32, 32, seed=3)
    w = jgate.build_float_classifier(params, jc, CLASSNAMES, TEMPLATES)
    got = tgate.noise_floor_gate(model, imgs, w, calibrate_n=16, batch_size=16)
    want = jgate.noise_floor_gate(params, jc, imgs, w, calibrate_n=16, batch_size=16)
    _same_verdict(got, want)
    assert got["passed"] and got["min_cosine_int8_vs_f32"] > 0.99


@pytest.mark.parametrize("front_end", ["planar", "nhwc"])
def test_frontend_noise_floor_gate_counts_match_jax(front_end):
    jc, params, model = _pair()
    imgs = tgate.synthetic_images(48, 64, seed=3)  # the source resolution: 64 -> 32
    w = jgate.build_float_classifier(params, jc, CLASSNAMES, TEMPLATES)
    got = tgate.frontend_noise_floor_gate(model, imgs, w, calibrate_n=16, batch_size=16, front_end=front_end)
    want = jgate.frontend_noise_floor_gate(params, jc, imgs, w, calibrate_n=16, batch_size=16, front_end=front_end)
    _same_verdict(got, want)
    assert got["min_cosine_int8_vs_f32"] > 0.98
    with pytest.raises(ValueError, match="front_end"):
        tgate.frontend_noise_floor_gate(model, imgs, w, front_end="nchw")


def _text_gate_inputs(dtype):
    jc, params, model = _pair(dtype, seed=4)
    texts = np.asarray(jax_tokenize([f"a photo of a {a} {b}." for a in ("small", "big", "red", "old")
                                     for b in CLASSNAMES], truncate=True))
    imgs = tgate.synthetic_images(16, 32, seed=5)
    bank = np.asarray(jclip.l2_normalize(jclip.encode_image(params, jc, jax_normalize(imgs, dtype="float32"))),
                      np.float32).T
    return jc, params, model, texts, bank


def test_text_noise_floor_gate_counts_match_jax():
    jc, params, model, texts, bank = _text_gate_inputs("float32")
    got = tgate.text_noise_floor_gate(model, texts, bank, calibrate_n=16, batch_size=16)
    want = jgate.text_noise_floor_gate(params, jc, texts, bank, calibrate_n=16, batch_size=16)
    _same_verdict(got, want)
    assert got["passed"] and got["min_cosine_int8_vs_f32"] > 0.99


BF16_COSINE = 0.999  # per row, the port's int8 text features against JAX's in bf16 compute


def _gate_int8_text_feats(jc, params, model, texts):
    """Each package's int8 text features on the gate's texts, calibrated on
    the first 16 as the gates calibrate: (port, JAX), L2-normalised f32."""
    calibrate, quantize, encode_q = jq.text_quant_fns(jc)
    jqp = quantize(params, jc, calibrate(params, jc, jnp.asarray(texts[:16])))
    want = np.asarray(jclip.l2_normalize(encode_q(jqp, jc, jnp.asarray(texts))), np.float32)
    with torch.inference_mode():
        t = torch.from_numpy(texts)
        qtext = tq.quantize_text_tower(model, tq.calibrate_text_tower(model, t[:16]))
        got = l2_normalize(tq.encode_text_q(qtext, t)).float().numpy()
    return got, want


def test_text_noise_floor_gate_passes_in_bf16():
    """bf16 compute, as tests/test_quant_gate.py runs the JAX text gate, so
    the bf16 floor is live. The flip counts are not compared here: the two
    frameworks round bf16 at other places (XLA's CPU fusions keep f32
    between elementwise ops), and at this size the retrieval margins are
    near zero, so each path's few flips land on other texts; both drift from
    f32 alike (mean 1 - cosine 6.3e-5 here, 7.2e-5 in JAX). What the gate
    counts flips of, the int8 text features, is held per row against JAX's
    on the gate's own texts at the bf16 bound."""
    jc, params, model, texts, bank = _text_gate_inputs("bfloat16")
    got = tgate.text_noise_floor_gate(model, texts, bank, calibrate_n=16, batch_size=16)
    want = jgate.text_noise_floor_gate(params, jc, texts, bank, calibrate_n=16, batch_size=16)
    assert got["n"] == want["n"] == len(texts)
    assert got["passed"] and want["passed"], (got, want)
    assert got["min_cosine_int8_vs_f32"] > 0.99
    port, ref = _gate_int8_text_feats(jc, params, model, texts)
    cos = (port * ref).sum(-1)
    assert cos.min() >= BF16_COSINE, cos.min()


def _x_scale_twice(x, wq, x_scale=None, out_dtype=torch.bfloat16):
    out = _INT8_MATMUL(x, wq, x_scale, out_dtype)
    return out if x_scale is None else (out.float() * x_scale).to(out_dtype)


_INT8_MATMUL = tq.int8_matmul


@pytest.mark.parametrize("fault", ["dropped_b_in", "x_scale_twice"])
def test_gate_int8_text_features_planted_fault_fails_the_bf16_bound(fault, monkeypatch):
    """A fault in the int8 text tower fails the per-row bound that
    ``test_text_noise_floor_gate_passes_in_bf16`` holds the port to."""
    jc, params, model, texts, bank = _text_gate_inputs("bfloat16")
    if fault == "dropped_b_in":
        real = tq.quantize_text_tower

        def without_b_in(*a, **k):
            q = real(*a, **k)
            for block in q.blocks:
                block.b_in = torch.nn.Parameter(torch.zeros_like(block.b_in))
            return q

        monkeypatch.setattr(tq, "quantize_text_tower", without_b_in)
    else:
        monkeypatch.setattr(tq, "int8_matmul", _x_scale_twice)
    port, ref = _gate_int8_text_feats(jc, params, model, texts)
    assert (port * ref).sum(-1).min() < BF16_COSINE


@pytest.mark.parametrize("k,n", [(0, 10), (3, 100), (100, 100), (0, 0)])
def test_wilson_interval_matches_jax(k, n):
    assert tgate._wilson(k, n) == jgate._wilson(k, n)


def test_flip_verdict_matches_jax():
    rng = np.random.default_rng(0)
    t32 = rng.integers(0, 5, 200)
    t16 = np.where(rng.random(200) < 0.05, rng.integers(0, 5, 200), t32)
    tq = np.where(rng.random(200) < 0.08, rng.integers(0, 5, 200), t32)
    cos = rng.uniform(0.99, 1.0, 200)
    assert tgate._flip_verdict(t32, t16, tq, cos, 2.5) == jgate._flip_verdict(t32, t16, tq, cos, 2.5)
