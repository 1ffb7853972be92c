"""The port's int8 (W8A8) Mixer path (``clip_mixer_tpu_torch/ops/quant.py``)
against the JAX package's ``clip_mixer_tpu/ops/quant.py``, on the CPU.

Inputs come from numpy seeds; weights are the JAX init moved by
``load_jax_params``, and the int8 packs and scales by ``load_jax_qparams``.
Bounds, each stated where it is used:

* ``quantize_weight``'s q and scale, and ``int8_matmul``'s int32
  accumulator on the same int8 operands: bit for bit (the same division,
  round half to even, integer sums).
* the quantile helper: equal to ``numpy.quantile`` on float32 data, above
  2^24 elements too, where ``torch.quantile`` refuses.
* calibration scales: within 1e-5 relative of JAX's (the same f32 chain,
  summed in another order).
* the encoders on carried-over qparams: per-row cosine >= 0.99999 in f32
  and >= 0.999 in bf16 (bf16 rounds at other places in the two frameworks);
  a planted fault (a dropped b_in, x_scale applied twice) fails the f32
  bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_mixer_tpu.config import CLIPConfig as JaxConfig
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.ops import quant as jq

from clip_mixer_tpu_torch import CLIP, CLIPConfig, load_jax_params
from clip_mixer_tpu_torch.models.convert import load_jax_qparams
from clip_mixer_tpu_torch.ops import quant as tq
from clip_mixer_tpu_torch.ops.preprocess import normalize_images

# tests/test_quant.py's CFG (width 64, two blocks, f32)
CFG = dict(
    embed_dim=32,
    image_resolution=32,
    vision_layers=2,
    vision_width=64,
    vision_patch_size=16,
    context_length=12,
    vocab_size=128,
    text_width=64,
    text_heads=1,
    text_layers=2,
    tower="mixer",
    compute_dtype="float32",
)
F32_COSINE = 0.99999
BF16_COSINE = 0.999
SCALE_RTOL = 1e-5


def _pair(dtype="float32", seed=2):
    """(JAX config, JAX params as numpy, the port model with the same weights)."""
    cfg = dict(CFG, compute_dtype=dtype)
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


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# ---- quantize_weight, int8_matmul, the quantile ---------------------------------


@pytest.mark.parametrize("shape,std,seed", [((64, 256), 0.05, 0), ((3072 // 16, 96), 1.0, 1), ((40, 8), 1e-9, 2)])
def test_quantize_weight_bitwise(shape, std, seed):
    w = np.random.default_rng(seed).normal(0, std, shape).astype(np.float32)
    w[0, 0] = 0.0
    want = jq.quantize_weight(jnp.asarray(w))
    got = tq.quantize_weight(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and got["q"].shape == shape
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))


@pytest.mark.parametrize("lead", [(37,), (3, 50)])
def test_int8_accumulator_bitwise(lead):
    rng = np.random.default_rng(5)
    xq = rng.integers(-127, 128, (*lead, 64)).astype(np.int8)
    wq = rng.integers(-127, 128, (64, 96)).astype(np.int8)
    want = jax.lax.dot_general(jnp.asarray(xq), jnp.asarray(wq), (((xq.ndim - 1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    w_out_in = torch.from_numpy(wq.T.copy())  # the modules' [out, in] buffer, read as its transposed view
    got = torch._int_mm(torch.from_numpy(xq.reshape(-1, 64)), w_out_in.t())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().reshape(*lead, 96), np.asarray(want))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax(static, out_dtype):
    """The same quantisation, the same integer sums and the same f32
    dequantisation chain: equal bits, in f32 and after the bf16 cast."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (4, 8, 64)).astype(np.float32)
    w = rng.normal(0, 0.05, (64, 96)).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w))
    tw = tq.quantize_weight(torch.from_numpy(w))
    scale = np.float32(np.abs(x).max() / 127.0) if static else None
    want = jq.int8_matmul(jnp.asarray(x), jw, None if scale is None else jnp.asarray(scale), jnp.dtype(out_dtype))
    got = tq.int8_matmul(torch.from_numpy(x), tw, None if scale is None else torch.tensor(scale),
                         getattr(torch, out_dtype))
    assert got.shape == (4, 8, 96)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("n", [1, 2, 101, 3840, 2**24 + 12345], ids=lambda n: f"n{n}")
def test_quantile_matches_numpy(n):
    rng = np.random.default_rng(n % 1000)
    a = np.abs(rng.standard_normal(n, dtype=np.float32))
    if n == 3840:  # bf16 activations: many ties
        a = torch.from_numpy(a).bfloat16().float().numpy()
    got = tq.quantile(torch.from_numpy(a), 0.9999)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == np.quantile(a, 0.9999)
    if n > 2**24:  # the reason the port has its own
        with pytest.raises(RuntimeError, match="too large"):
            torch.quantile(torch.from_numpy(a), 0.9999)


# ---- calibration and the encoders -----------------------------------------------


def test_calibration_scales_match_jax():
    jc, params, model = _pair()
    imgs, text = _images(), _text()
    for want, got, keys in (
        (jq.calibrate_vision_tower(params, jc, jnp.asarray(imgs)),
         tq.calibrate_vision_tower(model, torch.from_numpy(imgs)), ("patch", "ch_in", "ch_hidden")),
        (jq.calibrate_text_tower(params, jc, jnp.asarray(text)),
         tq.calibrate_text_tower(model, torch.from_numpy(text)), ("ch_in", "ch_hidden")),
    ):
        assert set(got) == set(keys)
        for k in keys:
            assert got[k].shape == np.asarray(want[k]).shape
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=SCALE_RTOL, atol=0)


def _quantized(tower, dtype, static):
    """One tower's int8 encoder on the JAX qparams carried over: (the port's
    quant module, its encode function, the inputs, JAX's features)."""
    jc, params, model = _pair(dtype)
    if tower == "image":
        x = _images()
        scales = jq.calibrate_vision_tower(params, jc, jnp.asarray(x)) if static else None
        qtree = jax.tree.map(np.asarray, jq.quantize_vision_tower(params, jc, scales))
        qvis, qtext = load_jax_qparams(model, qtree)
        assert qtext is None and qvis.static == static
        return qvis, tq.encode_image_q, torch.from_numpy(x), np.asarray(jq.encode_image_q(qtree, jc, jnp.asarray(x)), np.float32)
    t = _text()
    scales = jq.calibrate_text_tower(params, jc, jnp.asarray(t)) if static else None
    qtree = jax.tree.map(np.asarray, jq.quantize_text_tower(params, jc, scales))
    qvis, qtext = load_jax_qparams(model, qtree)
    assert qvis is None and qtext.static == static
    return qtext, tq.encode_text_q, torch.from_numpy(t), np.asarray(jq.encode_text_q(qtree, jc, jnp.asarray(t)), np.float32)


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


def _twice(x, wq, x_scale=None, out_dtype=torch.bfloat16):
    """int8_matmul with the activation scale applied a second time."""
    out = _INT8_MATMUL(x, wq, x_scale, out_dtype)
    return out if x_scale is None else (out.float() * x_scale).to(out_dtype)


_INT8_MATMUL = tq.int8_matmul


@pytest.mark.parametrize("fault", ["dropped_b_in", "x_scale_twice"])
@pytest.mark.parametrize("tower", ["image", "text"])
def test_planted_fault_fails_the_f32_bound(tower, fault, monkeypatch):
    module, encode, x, want = _quantized(tower, "float32", static=True)
    if fault == "dropped_b_in":
        block = module.blocks[0]
        block.b_in = torch.nn.Parameter(torch.zeros_like(block.b_in))
    else:
        monkeypatch.setattr(tq, "int8_matmul", _twice)
    cos = _cosine(encode(module, x).float().numpy(), want)
    assert cos.min() < F32_COSINE, cos.min()


def test_quantized_weights_equal_jax_quantize():
    """The port's own quantisation of the float model gives the int8 packs
    the JAX tree carries, bit for bit."""
    jc, params, model = _pair()
    scales = jq.calibrate_vision_tower(params, jc, jnp.asarray(_images()))
    qvis_jax, _ = load_jax_qparams(model, jax.tree.map(np.asarray, jq.quantize_vision_tower(params, jc, scales)))
    qvis = tq.quantize_vision_tower(model, _np(scales))
    for name, buf in qvis.named_buffers():
        np.testing.assert_array_equal(buf.numpy(), dict(qvis_jax.named_buffers())[name].numpy(), err_msg=name)


def test_load_jax_qparams_refuses_other_float_weights():
    jc, params, _ = _pair(seed=2)
    _, _, other = _pair(seed=7)
    qtree = jax.tree.map(np.asarray, jq.quantize_text_tower(params, jc))
    with pytest.raises(ValueError, match="b_in differs"):
        load_jax_qparams(other, qtree)


def test_quant_towers_share_the_float_modules():
    _, _, model = _pair()
    qvis = tq.quantize_vision_tower(model)
    qtext = tq.quantize_text_tower(model)
    block = model.visual.transformer.mixBlocks[1]
    assert qvis.blocks[1].token_mix_seq is block.token_mix_seq
    assert qvis.blocks[1].b_in is block.channel_mix_seq.lin3.bias
    assert qvis.proj is model.visual.proj and qvis.ln_post is model.visual.ln_post
    assert qtext.token_embedding is model.token_embedding and qtext.text_projection is model.text_projection
    assert qvis.blocks[0].w_in_q.dtype == torch.int8 and qvis.blocks[0].w_in_q.shape == (256, 64)


@pytest.mark.parametrize("tower,layers", [("transformer", 2), ("transformer", (1, 1, 1, 1))],
                         ids=["transformer", "resnet"])
def test_other_towers_raise_naming_slice_d(tower, layers):
    """No tower kind raises any more: a transformer config dispatches to the
    ViT functions, and a ResNet config (``tower="transformer"`` for its
    text side) to the ResNet image functions and the ViT text functions,
    as the JAX package's ``image_quant_fns`` / ``text_quant_fns`` do."""
    cfg = CLIPConfig(**dict(CFG, tower=tower, vision_layers=layers))
    jc = JaxConfig(**dict(CFG, tower=tower, vision_layers=layers))
    for fns, jfns in ((tq.image_quant_fns, jq.image_quant_fns), (tq.text_quant_fns, jq.text_quant_fns)):
        assert fns(cfg) == tuple(getattr(tq, f.__name__) for f in jfns(jc))
    if cfg.is_resnet:
        assert tq.image_quant_fns(cfg)[2] is tq.encode_image_rn_q
        assert tq.text_quant_fns(cfg)[1] is tq.quantize_vit_text_tower


# ---- the planar front end ----------------------------------------------------


def test_patch_perm_matches_jax():
    np.testing.assert_array_equal(tq.patch_perm(16), jq.patch_perm(16))
    np.testing.assert_array_equal(tq.patch_perm(32), jq.patch_perm(32))


def test_planar_front_end_bitwise_vs_nhwc_at_identity_resize():
    """With the source at the model's resolution the resize matrices are
    the identity, so the planar path gives encode_image_q's features bit for
    bit (tests/test_quant.py:317-337, inside the port)."""
    _, _, model = _pair()
    u8 = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
    imgs = normalize_images(u8, dtype=torch.float32)
    qvis = tq.quantize_vision_tower(model, tq.calibrate_vision_tower(model, imgs))
    want = tq.encode_image_q(qvis, imgs)
    front = tq.make_planar_front_end(model.cfg, (32, 32), qvis.a_patch)
    patches = front(u8)
    assert patches.dtype == torch.int8 and patches.shape == (4, 4, 16 * 16 * 3)
    torch.testing.assert_close(tq.encode_image_q_patches(qvis, patches), want, rtol=0, atol=0)


def test_planar_patches_match_jax_on_a_real_resize():
    """64 -> 32: the two packages sum the bf16 resize in other orders, so a
    value at a rounding edge may land one step apart: at most 1e-3 of the
    int8 patch elements differ, and those by 1."""
    jc, params, model = _pair()
    u8 = np.random.default_rng(6).integers(0, 256, (6, 64, 64, 3), dtype=np.uint8)
    scale = np.float32(0.02)
    want = np.asarray(jq.make_planar_front_end(jc, (64, 64), jnp.asarray(scale))(jnp.asarray(u8)))
    got = tq.make_planar_front_end(model.cfg, (64, 64), torch.tensor(scale))(torch.from_numpy(u8)).numpy()
    assert got.dtype == np.int8 and got.shape == want.shape == (6, 4, 768)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, ((diff > 0).mean(), diff.max())


def test_planar_front_end_takes_the_scale_at_call_time():
    _, _, model = _pair()
    u8 = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 48, 40, 3), dtype=np.uint8))
    front = tq.make_planar_front_end(model.cfg, (48, 40))
    a = front(u8, patch_scale=torch.tensor(0.02))
    b = tq.make_planar_front_end(model.cfg, (48, 40), 0.02)(u8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_encode_image_q_patches_refuses_dynamic_scales():
    _, _, model = _pair()
    qvis = tq.quantize_vision_tower(model)
    with pytest.raises(ValueError, match="calibrated"):
        tq.encode_image_q_patches(qvis, torch.zeros(1, 4, 768, dtype=torch.int8))


def test_planar_int8_features_near_the_f32_front_end():
    """The planar front end + int8 tower against JAX's f32 resize + f32
    tower from the same uint8 (tests/test_quant.py:340's bound)."""
    from clip_mixer_tpu.ops.preprocess import make_batch_preprocess

    jc, params, model = _pair()
    u8 = np.random.default_rng(8).integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    pre = make_batch_preprocess((64, 64), 32, normalize=True, dtype=jnp.float32)
    want = np.asarray(jclip.encode_image(params, jc, pre(jnp.asarray(u8))))
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess as tpre

    x = tpre((64, 64), 32, normalize=True, dtype=torch.float32)(torch.from_numpy(u8))
    qvis = tq.quantize_vision_tower(model, tq.calibrate_vision_tower(model, x))
    got = tq.encode_image_q_patches(qvis, tq.make_planar_front_end(model.cfg, (64, 64), qvis.a_patch)(torch.from_numpy(u8)))
    assert _cosine(got.numpy(), want).min() > 0.995
