"""The port's int8 (W8A8) ViT towers (``clip_mixer_tpu_torch/ops/quant.py``,
the transformer half) against the JAX package's ``clip_mixer_tpu/ops/quant.py``
(``quantize_vit_*``, ``calibrate_vit_*``, ``encode_*_vit_q``), on the CPU.

Weights are the JAX init moved by ``load_jax_params``; the int8 packs and
scales of a JAX quantized tree by ``load_jax_qparams``. Bounds, those of
``test_torch_port_quant.py``'s:

* the int8 packs the port quantises: bit for bit JAX's;
* calibration scales: within 1e-5 relative (f32);
* the encoders on carried-over qparams: per-row cosine >= 0.99999 in f32,
  >= 0.999 in bf16; planted faults fail the f32 bound;
* the int8 text tower ignores tokens after the EOT, bit for bit;
* the noise-floor gates count JAX's flips and give its verdict;
* a ViT int8 engine with ``input_hw`` takes the float front end, as JAX's
  ``encoder_fns(int8=True, input_hw=...)``; end to end through the two
  resizes the features agree at 0.9999 (the test says why).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_mixer_tpu.config import CLIPConfig as JaxConfig
from clip_mixer_tpu.evals import quant_gate as jgate
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.ops import quant as jq
from clip_mixer_tpu.ops import quant_io as jax_quant_io
from clip_mixer_tpu.ops.preprocess import make_batch_preprocess as make_jax_preprocess
from clip_mixer_tpu.ops.preprocess import normalize_images as jax_normalize
from clip_mixer_tpu.serving import InferenceEngine as JaxEngine
from clip_mixer_tpu.serving import encoder_fns as jax_encoder_fns
from clip_mixer_tpu.text import tokenize as jax_tokenize

from clip_mixer_tpu_torch import CLIP, CLIPConfig, load_jax_params
from clip_mixer_tpu_torch.evals import quant_gate as tgate
from clip_mixer_tpu_torch.models.clip import l2_normalize
from clip_mixer_tpu_torch.models.convert import load_jax_qparams
from clip_mixer_tpu_torch.ops import quant as tq
from clip_mixer_tpu_torch.ops import quant_io
from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
from clip_mixer_tpu_torch.serving import InferenceEngine, encoder_fns

# width 64, two layers, two text heads, patch 16 on 32 px, a 12-token context
CFG = dict(
    embed_dim=32,
    image_resolution=32,
    vision_layers=2,
    vision_width=64,
    vision_patch_size=16,
    context_length=12,
    vocab_size=128,
    text_width=64,
    text_heads=2,
    text_layers=2,
    tower="transformer",
    compute_dtype="float32",
)
# the engine and gate tests tokenize captions: the real vocabulary and context
SERVE = dict(CFG, context_length=77, vocab_size=49408)
F32_COSINE = 0.99999
BF16_COSINE = 0.999
SCALE_RTOL = 1e-5
VIT_SITES = ("qkv_in", "attn_out_in", "mlp_in", "mlp_hidden")
HW = (40, 48)
TEXTS = [f"a {a} photo of a {b}" for a in ("small", "dark", "bright") for b in ("cat", "dog", "car", "tree")]
CLASSNAMES = ["cat", "dog", "car", "tree", "house", "bird", "boat", "chair"]
TEMPLATES = ["a photo of a {}.", "an image of a {}."]
COUNTS = ("n", "flips_bf16", "flips_int8", "passed")


def _pair(dtype="float32", seed=2, cfg=CFG):
    """(JAX config, JAX params as numpy, the port model with the same weights)."""
    cfg = dict(cfg, compute_dtype=dtype)
    jc = JaxConfig(**cfg)
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(seed), jc))
    return jc, params, load_jax_params(CLIP(CLIPConfig(**cfg), device="cpu"), params)


def _images(n=8, seed=3):
    return np.random.default_rng(seed).normal(0, 1, (n, 32, 32, 3)).astype(np.float32)


def _text(n=6, seed=4):
    """Token ids with an EOT (the largest id) at a varying position."""
    rng = np.random.default_rng(seed)
    t = rng.integers(1, CFG["vocab_size"] - 1, (n, CFG["context_length"])).astype(np.int32)
    for i in range(n):
        t[i, 3 + i % (CFG["context_length"] - 3)] = CFG["vocab_size"] - 1
    return t


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


# ---- calibration, the packs, the encoders -----------------------------------------


def test_calibration_scales_match_jax():
    jc, params, model = _pair()
    imgs, text = _images(), _text()
    for want, got, keys in (
        (jq.calibrate_vit_vision_tower(params, jc, jnp.asarray(imgs)),
         tq.calibrate_vit_vision_tower(model, torch.from_numpy(imgs)), ("patch", *VIT_SITES)),
        (jq.calibrate_vit_text_tower(params, jc, jnp.asarray(text)),
         tq.calibrate_vit_text_tower(model, torch.from_numpy(text)), VIT_SITES),
    ):
        assert set(got) == set(keys) == set(want)
        for k in keys:
            assert got[k].shape == np.asarray(want[k]).shape
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=SCALE_RTOL, atol=0)


def _quantized(tower, dtype, static):
    """One tower's int8 encoder on the JAX qparams carried over: (the port's
    quant module, its encode function, the inputs, JAX's features)."""
    jc, params, model = _pair(dtype)
    calibrate, quantize, encode = (jq.image_quant_fns if tower == "image" else jq.text_quant_fns)(jc)
    x = _images() if tower == "image" else _text()
    qtree = jax.tree.map(np.asarray, quantize(params, jc, calibrate(params, jc, jnp.asarray(x)) if static else None))
    qvis, qtext = load_jax_qparams(model, qtree)
    module = qvis if tower == "image" else qtext
    assert (qtext if tower == "image" else qvis) is None and module.static == static
    t_encode = (tq.image_quant_fns if tower == "image" else tq.text_quant_fns)(model.cfg)[2]
    return module, t_encode, torch.from_numpy(x), np.asarray(encode(qtree, jc, jnp.asarray(x)), np.float32)


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tower", ["image", "text"])
def test_int8_encoders_match_jax(tower, dtype, static):
    module, encode, x, want = _quantized(tower, dtype, static)
    got = encode(module, x).float().numpy()
    assert got.shape == want.shape == (x.shape[0], CFG["embed_dim"])
    assert np.isfinite(got).all()
    cos = _cosine(got, want)
    assert cos.min() >= (F32_COSINE if dtype == "float32" else BF16_COSINE), cos.min()


def test_quantized_packs_equal_jax_quantize():
    """The port's own quantisation of the float model gives the int8 packs
    and scales the JAX trees carry, bit for bit, in both towers."""
    jc, params, model = _pair()
    vs = jq.calibrate_vit_vision_tower(params, jc, jnp.asarray(_images()))
    ts = jq.calibrate_vit_text_tower(params, jc, jnp.asarray(_text()))
    jv, _ = load_jax_qparams(model, jax.tree.map(np.asarray, jq.quantize_vit_vision_tower(params, jc, vs)))
    _, jt = load_jax_qparams(model, jax.tree.map(np.asarray, jq.quantize_vit_text_tower(params, jc, ts)))
    mine = (tq.quantize_vit_vision_tower(model, jax.tree.map(np.asarray, vs)),
            tq.quantize_vit_text_tower(model, jax.tree.map(np.asarray, ts)))
    for got, want in zip(mine, (jv, jt)):
        names = dict(want.named_buffers())
        assert set(dict(got.named_buffers())) == set(names)
        assert {"blocks.1.qkv_q", "blocks.1.out_scale", "blocks.0.w_out_q", "a_attn_out_in"} <= set(names)
        for name, buf in got.named_buffers():
            np.testing.assert_array_equal(buf.numpy(), names[name].numpy(), err_msg=name)
    block = model.transformer.resblocks[1]
    assert mine[1].blocks[1].qkv_bias is block.attn.in_proj_bias and mine[1].blocks[1].ln_2 is block.ln_2
    assert mine[1].blocks[1].qkv_q.shape == (3 * 64, 64) and mine[1].blocks[1].qkv_q.dtype == torch.int8
    assert mine[0].positional_embedding is model.visual.positional_embedding


def _twice(x, wq, x_scale=None, out_dtype=torch.bfloat16):
    """int8_matmul with the activation scale applied a second time."""
    out = _INT8_MATMUL(x, wq, x_scale, out_dtype)
    return out if x_scale is None else (out.float() * x_scale).to(out_dtype)


_INT8_MATMUL = tq.int8_matmul


@pytest.mark.parametrize("tower,fault", [("image", "zeroed_qkv_bias"), ("image", "x_scale_twice"),
                                         ("text", "zeroed_qkv_bias"), ("text", "x_scale_twice"),
                                         ("text", "dropped_causal_mask")])
def test_planted_fault_fails_the_f32_bound(tower, fault, monkeypatch):
    module, encode, x, want = _quantized(tower, "float32", static=True)
    if fault == "zeroed_qkv_bias":
        block = module.blocks[0]
        block.qkv_bias = torch.nn.Parameter(torch.zeros_like(block.qkv_bias))
    elif fault == "x_scale_twice":
        monkeypatch.setattr(tq, "int8_matmul", _twice)
    else:
        for block in module.blocks:
            block.mask = None
    cos = _cosine(encode(module, x).float().numpy(), want)
    assert cos.min() < F32_COSINE, cos.min()


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_int8_text_ignores_tokens_after_eot(static):
    """tests/test_quant.py:199-211 on the port: the int8 text features do not
    depend on tokens after the EOT, bit for bit."""
    _, _, model = _pair()
    scales = tq.calibrate_vit_text_tower(model, torch.from_numpy(_text())) if static else None
    q = tq.quantize_vit_text_tower(model, scales)
    base = torch.zeros((2, 12), dtype=torch.int64)
    base[:, 0], base[:, 1] = 10, 127  # eot at position 1
    base[1, 2:] = 40
    changed = base.clone()
    changed[:, 5], changed[1, 11] = 55, 3
    assert torch.equal(tq.encode_text_q(q, base), tq.encode_text_q(q, changed))


def test_int8_matmul_pads_a_k_that_is_no_multiple_of_8():
    """ViT-L/14's patch (14 x 14 x 3 = 588 inputs): zero columns pad K for
    ``_int_mm`` on the card and add nothing to the sums, so the result is
    JAX's bit for bit."""
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (3, 20, 588)).astype(np.float32)
    w = rng.normal(0, 0.05, (588, 72)).astype(np.float32)
    jw, tw = jq.quantize_weight(jnp.asarray(w)), tq.quantize_weight(torch.from_numpy(w))
    tw["q"] = tw["q"].t().contiguous().t()  # the modules' layout: the view of an [out, in] buffer
    for scale in (None, np.float32(np.abs(x).max() / 127.0)):
        want = jq.int8_matmul(jnp.asarray(x), jw, None if scale is None else jnp.asarray(scale), jnp.float32)
        got = tq.int8_matmul(torch.from_numpy(x), tw, None if scale is None else torch.tensor(scale), torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the engine, the artifacts ----------------------------------------------------


@pytest.fixture(scope="module")
def serve_weights():
    jc = JaxConfig(**SERVE)
    return jc, jax.tree.map(np.asarray, jclip.init(jax.random.key(0), jc))


def _u8(n, hw, seed=0):
    return tgate.synthetic_images(n, max(hw), seed=seed)[:, : hw[0], : hw[1]].copy()


def test_vit_int8_image_fn_with_input_hw_takes_the_float_front_end(serve_weights):
    """An int8 ViT image path from ``input_hw`` uint8 is the float resize,
    then the int8 tower, as JAX's ``encoder_fns(int8=True, input_hw=...)``
    (its planar front end serves Mixer towers only): the engine's function
    gives ``encode_image_q`` of the float preprocess bit for bit, the
    preprocess is JAX's at f32 tolerance, and the int8 tower on JAX's
    preprocessed images gives JAX's features at the encoders' bound. End to
    end the two packages' features agree at 0.9999 (read 0.99998961 on one
    row): a static activation scale turns the resizes' ulp differences into
    whole quantisation steps, as ``chip_smoke.py`` phase 6 reads on the
    card."""
    jc, params = serve_weights
    model = load_jax_params(CLIP(CLIPConfig(**SERVE), device="cpu"), params)
    u8 = _u8(6, HW, seed=1)
    calibrate, quantize, encode = jq.image_quant_fns(jc)
    scales = calibrate(params, jc, jax_normalize(_u8(8, (32, 32)), dtype="float32"))
    qtree = jax.tree.map(np.asarray, quantize(params, jc, scales))
    qvis, _ = load_jax_qparams(model, qtree)
    jax_pixels = make_jax_preprocess(HW, 32, normalize=True, dtype="float32")(jnp.asarray(u8))
    want = np.asarray(jax_encoder_fns(jc, int8=True, input_hw=HW)[0](qtree, jnp.asarray(u8)), np.float32)
    pre = make_batch_preprocess(HW, 32, normalize=True, dtype=torch.float32)
    with torch.inference_mode():
        x = pre(torch.from_numpy(u8))
        got = encoder_fns(model.cfg, int8=True, input_hw=HW)[0](qvis, torch.from_numpy(u8)).numpy()
        np.testing.assert_array_equal(got, l2_normalize(tq.encode_image_q(qvis, x)).numpy())
        np.testing.assert_allclose(x.numpy(), np.asarray(jax_pixels), atol=1e-5, rtol=1e-5)
        on_jax_pixels = tq.encode_image_q(qvis, torch.from_numpy(np.array(jax_pixels)))
    assert _cosine(on_jax_pixels, np.asarray(encode(qtree, jc, jax_pixels))).min() >= F32_COSINE
    assert _cosine(got, want).min() >= 0.9999


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_artifact_of_either_package_serves_in_the_other(serve_weights, tmp_path, writer):
    jc, params = serve_weights
    path = str(tmp_path / f"{writer}.npz")
    eng = InferenceEngine(load_jax_params(CLIP(CLIPConfig(**SERVE), device="cpu"), params),
                          batch_buckets=(2, 4), input_hw=HW)
    jeng = JaxEngine(params, jc, batch_buckets=(2, 4), input_hw=HW)
    first, second = (jeng, eng) if writer == "jax" else (eng, jeng)
    first.enable_int8(_u8(8, HW), TEXTS, save_calibration=path)
    second.enable_int8(calibration=path)
    assert eng.path_kinds == {"image": "int8", "text": "int8"}
    art, jart = quant_io.load_calibration(path), jax_quant_io.load_calibration(path)
    assert art["cfg"] == jart["cfg"] and set(art["image_scales"]) == {"patch", *VIT_SITES}
    for side in ("image_scales", "text_scales"):
        assert art[side].keys() == jart[side].keys()
        for k in art[side]:
            np.testing.assert_array_equal(art[side][k], jart[side][k])
    imgs = _u8(5, HW, seed=3)
    for got, want in ((eng.encode_image_arrays(imgs), jeng.encode_image_arrays(imgs)),
                      (eng.encode_text(TEXTS[:5]), jeng.encode_text(TEXTS[:5]))):
        assert _cosine(got, want).min() >= F32_COSINE
    # the reload from the artifact serves the same bits as the engine that wrote it
    if writer == "port":
        again = InferenceEngine(eng.model, batch_buckets=(2, 4), input_hw=HW)
        again.enable_int8(calibration=path)
        np.testing.assert_array_equal(again.encode_image_arrays(imgs), eng.encode_image_arrays(imgs))
        np.testing.assert_array_equal(again.encode_text(TEXTS[:5]), eng.encode_text(TEXTS[:5]))


# ---- the gates ----------------------------------------------------------------------


def _same_verdict(got, want):
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}, (got, want)
    for k in ("flip_ratio", "flip_ratio_ci_low", "flip_ratio_ci_high", "margin_to_budget"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_image_noise_floor_gate_counts_match_jax(serve_weights):
    """The image gate on a ViT tower: model-sized images through the float
    front end (the JAX front-end gate, like its planar path, serves Mixer
    towers only; so does the port's)."""
    jc, params = serve_weights
    model = load_jax_params(CLIP(CLIPConfig(**SERVE), device="cpu"), params)
    imgs = tgate.synthetic_images(32, 32, seed=3)
    w = jgate.build_float_classifier(params, jc, CLASSNAMES, TEMPLATES)
    got = tgate.noise_floor_gate(model, imgs, w, calibrate_n=16, batch_size=16)
    want = jgate.noise_floor_gate(params, jc, imgs, w, calibrate_n=16, batch_size=16)
    _same_verdict(got, want)
    assert got["min_cosine_int8_vs_f32"] > 0.99
    with pytest.raises(ValueError, match="Mixer towers"):
        tgate.frontend_noise_floor_gate(model, _u8(8, HW), w, front_end="nhwc")


def test_text_noise_floor_gate_counts_match_jax(serve_weights):
    jc, params = serve_weights
    model = load_jax_params(CLIP(CLIPConfig(**SERVE), device="cpu"), params)
    texts = np.asarray(jax_tokenize([f"a photo of a {a} {b}." for a in ("small", "big", "red", "old")
                                     for b in CLASSNAMES], truncate=True))
    bank = np.asarray(jclip.l2_normalize(jclip.encode_image(params, jc, jax_normalize(
        tgate.synthetic_images(16, 32, seed=5), dtype="float32"))), np.float32).T
    got = tgate.text_noise_floor_gate(model, texts, bank, calibrate_n=16, batch_size=16)
    want = jgate.text_noise_floor_gate(params, jc, texts, bank, calibrate_n=16, batch_size=16)
    _same_verdict(got, want)
    assert got["min_cosine_int8_vs_f32"] > 0.99
