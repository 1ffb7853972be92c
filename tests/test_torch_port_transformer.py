"""The port's transformer towers (``clip_mixer_tpu_torch/models/transformer.py``
and the ViT / transformer-text CLIP) against the JAX package, on the CPU.

Weights are the JAX init moved by ``load_jax_params``; inputs come from
numpy seeds. Bounds, each stated where it is used:

* f32: the JAX suite's tolerances (atol 5e-5 / rtol 1e-3, as
  ``test_torch_port_model.py``);
* bf16: per-row cosine >= 0.999 against JAX's bf16 computation (the two
  frameworks round after different ops);
* text causality: the features do not depend on tokens after the EOT, bit
  for bit;
* the state dict: key for key and bit for bit the JAX package's
  ``params_to_state_dict``;
* planted faults (a dropped causal mask, the softmax in bf16, a zeroed
  ``in_proj_bias``) fail the bound that the port passes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_mixer_tpu import api as japi
from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.models import convert as jconvert
from clip_mixer_tpu.models import transformer as jtr

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.api import load_pretrained, save_pretrained
from clip_mixer_tpu_torch.models import transformer as ttr
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import jax_attn_block_arrays, jax_params_to_state_dict, load_jax_params
from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers

ATOL, RTOL = 5e-5, 1e-3
BF16_COSINE = 0.999

# width 64, two layers, two text heads, patch 16 on 32 px, a 12-token context
SMALL = dict(
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
# the vision tower has width // 64 heads: 128 gives it two
TWO_HEADS = dict(vision_width=128)


def _pair(seed=0, **over):
    """(JAX config, JAX params as numpy, the port model with the same weights)."""
    cfg = {**SMALL, **over}
    jc = jcfg.CLIPConfig(**cfg)
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(seed), jc))
    return jc, params, load_jax_params(CLIP(tcfg.CLIPConfig(**cfg), device="cpu"), params)


def _images(n=4, seed=1):
    return np.random.default_rng(seed).normal(0, 1, (n, 32, 32, 3)).astype(np.float32)


def _text(n=4, seed=2):
    """Token ids with the EOT (the largest id) at a varying position."""
    rng = np.random.default_rng(seed)
    t = rng.integers(1, SMALL["vocab_size"] - 1, (n, SMALL["context_length"])).astype(np.int32)
    for i in range(n):
        t[i, 2 + 3 * i % (SMALL["context_length"] - 2)] = SMALL["vocab_size"] - 1
    return t


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        flat = lambda a: a.reshape(-1, a.shape[-1])  # noqa: E731
        assert _cosine(flat(got), flat(want)).min() >= BF16_COSINE


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


# ---- the attention chain and the block -----------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_heads_core_matches_jax(dtype, masked):
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(0, 1, (3, 2, 12, 32)).astype(np.float32) for _ in range(3))
    mask = np.asarray(jtr.causal_mask(12)) if masked else None
    want = jtr.attention_heads_core(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                    None if mask is None else jnp.asarray(mask))
    got = ttr.attention_heads_core(*(_t(a, dtype) for a in (q, k, v)),
                                   None if mask is None else ttr.causal_mask(12))
    assert got.dtype == getattr(torch, dtype)
    _close(got.float(), want, dtype)


def test_causal_mask_is_jax():
    np.testing.assert_array_equal(ttr.causal_mask(12).numpy(), np.asarray(jtr.causal_mask(12)))


def _block_pair(seed=4, width=64, text_tower=True):
    tree = jax.tree.map(np.asarray, jtr.init_attention_block(jax.random.key(seed), width, text_tower, 2))
    # LN affines away from ones and zeros so a dropped affine shows
    rng = np.random.default_rng(seed)
    for ln in ("ln_1", "ln_2"):
        tree[ln] = {"scale": 1 + 0.1 * rng.normal(size=width).astype(np.float32),
                    "bias": 0.1 * rng.normal(size=width).astype(np.float32)}
    block = ttr.ResidualAttentionBlock(width, n_heads=2)
    block.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in jax_attn_block_arrays(tree).items()})
    return tree, block


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_matches_jax(dtype, masked):
    tree, block = _block_pair()
    x = np.random.default_rng(5).normal(0, 1, (3, 12, 64)).astype(np.float32)
    want = jtr.attention_block(tree, jnp.asarray(x, dtype), 2, jtr.causal_mask(12) if masked else None)
    with torch.no_grad():
        got = block(_t(x, dtype), ttr.causal_mask(12) if masked else None)
    _close(got.float(), want, dtype)


@pytest.mark.parametrize("text_tower", [False, True], ids=["vision", "text"])
def test_transformer_tower_matches_jax(text_tower):
    width, layers = 64, 2
    jt = jax.tree.map(np.asarray, jtr.init_transformer_tower(jax.random.key(6), width, layers, text_tower))
    tower = ttr.TransformerTower(width, layers, 2, context_length=12 if text_tower else None)
    sd = {f"resblocks.{i}.{k}": torch.from_numpy(np.ascontiguousarray(v)) for i in range(layers)
          for k, v in jax_attn_block_arrays(jax.tree.map(lambda a, i=i: a[i], jt["blocks"])).items()}
    tower.load_state_dict(sd, strict=True)
    assert "attn_mask" not in tower.state_dict()  # outside the reference layout
    x = np.random.default_rng(7).normal(0, 1, (2, 12, width)).astype(np.float32)
    want = jtr.transformer_tower(jt, jnp.asarray(x), 2, jtr.causal_mask(12) if text_tower else None)
    with torch.no_grad():
        _close(tower(torch.from_numpy(x)), want, "float32")


# ---- the encoders -----------------------------------------------------------------


@pytest.mark.parametrize("over", [{}, TWO_HEADS], ids=["width64", "two_vision_heads"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoders_match_jax(dtype, over):
    jc, params, model = _pair(compute_dtype=dtype, **over)
    images, text = _images(), _text()
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(images))
        txt = model.encode_text(torch.from_numpy(text))
    assert img.dtype == txt.dtype == getattr(torch, dtype)
    _close(img.float(), jclip.encode_image(params, jc, jnp.asarray(images)), dtype)
    _close(txt.float(), jclip.encode_text(params, jc, jnp.asarray(text)), dtype)


def test_forward_and_logits_match_jax():
    jc, params, model = _pair(seed=3, **TWO_HEADS)
    images, text = _images(seed=8), _text(seed=9)
    with torch.no_grad():
        img, txt, scale = model(torch.from_numpy(images), torch.from_numpy(text))
        per_image, _ = model.logits(torch.from_numpy(images), torch.from_numpy(text))
    j_img, j_txt, j_scale = jclip.forward(params, jc, jnp.asarray(images), jnp.asarray(text))
    _close(img, j_img, "float32")
    _close(txt, j_txt, "float32")
    np.testing.assert_allclose(float(scale), float(j_scale), rtol=1e-6)
    j_pi, _ = jclip.logits(params, jc, jnp.asarray(images), jnp.asarray(text))
    np.testing.assert_allclose(per_image.numpy(), np.asarray(j_pi), atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_features_ignore_tokens_after_eot(dtype):
    """The causal mask: the EOT row does not see later positions, so
    changing them leaves the features bit for bit (tests/test_quant.py:199)."""
    _, _, model = _pair(compute_dtype=dtype)
    base = torch.zeros((2, 12), dtype=torch.int64)
    base[:, 0], base[:, 1] = 10, 127  # eot at position 1
    base[1, 2:] = 40
    changed = base.clone()
    changed[:, 5], changed[1, 11] = 55, 3
    with torch.no_grad():
        assert torch.equal(model.encode_text(base), model.encode_text(changed))


def test_fused_mlp_and_route_towers_leave_transformer_towers_alone():
    """``fused_mlp`` applies to mixer blocks only, as in the JAX package, and
    ``route_towers`` leaves transformer towers on their own chain."""
    _, params, model = _pair()
    fused = load_jax_params(CLIP(tcfg.CLIPConfig(**dict(SMALL, fused_mlp=True)), device="cpu"), params)
    route_towers(fused, True)
    assert "forward" not in vars(fused.transformer) and "forward" not in vars(fused.visual.transformer)
    images, text = torch.from_numpy(_images()), torch.from_numpy(_text())
    with torch.no_grad():
        assert torch.equal(fused.encode_image(images), model.encode_image(images))
        assert torch.equal(fused.encode_text(text), model.encode_text(text))


# ---- planted faults --------------------------------------------------------------


def _no_mask(self, x, mask=None):
    return _BLOCK_FORWARD(self, x, None)


def _bf16_softmax(q, k, v, mask):
    dt = q.dtype
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    if mask is not None:
        scores = scores + mask.to(scores.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores.bfloat16(), dim=-1).to(dt), v)


_BLOCK_FORWARD = ttr.ResidualAttentionBlock.forward


@pytest.mark.parametrize("fault", ["dropped_causal_mask", "bf16_softmax", "zeroed_in_proj_bias"])
def test_planted_fault_fails_the_f32_bound(fault, monkeypatch):
    jc, params, model = _pair()
    text = _text()
    want = np.asarray(jclip.encode_text(params, jc, jnp.asarray(text)), np.float32)
    if fault == "dropped_causal_mask":
        monkeypatch.setattr(ttr.ResidualAttentionBlock, "forward", _no_mask)
    elif fault == "bf16_softmax":
        monkeypatch.setattr(ttr, "attention_heads_core", _bf16_softmax)
    else:
        with torch.no_grad():
            model.transformer.resblocks[0].attn.in_proj_bias.zero_()
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(text)).numpy()
    with pytest.raises(AssertionError):
        _close(got, want, "float32")


# ---- the state dict, the export ----------------------------------------------------


@pytest.mark.parametrize("over", [{}, dict(logit_bias_init=-10.0)], ids=["infonce", "siglip"])
def test_state_dict_is_jax_params_to_state_dict(over):
    jc, params, model = _pair(**over)
    want = jconvert.params_to_state_dict(params, jc)
    got = jax_params_to_state_dict(params, model.cfg)
    assert set(got) == set(model.state_dict())
    # the reference layout has no slot for the SigLIP bias: the JAX
    # converter drops it, the port's keeps it (the model trains it)
    assert set(got) - set(want) == ({"logit_bias"} if over else set()) and set(want) <= set(got)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v, err_msg=k)
    if over:
        np.testing.assert_array_equal(got["logit_bias"].numpy(), params["logit_bias"])
    # the packed QKV (W, 3W) becomes in_proj_weight (3W, W)
    qkv = params["text"]["tower"]["blocks"]["attn"]["qkv_kernel"][1]
    np.testing.assert_array_equal(got["transformer.resblocks.1.attn.in_proj_weight"].numpy(), qkv.T)
    for key in ("positional_embedding", "visual.positional_embedding", "visual.transformer.resblocks.0.ln_1.weight",
                "transformer.resblocks.1.mlp.c_fc.bias", "visual.transformer.resblocks.1.attn.out_proj.weight"):
        assert key in got


def test_jax_api_load_reads_the_port_export(tmp_path):
    """The JAX ``api.load`` sniffs the architecture from the export's
    reference-keyed ``model.pt``; its heads are width // 64."""
    over = dict(text_width=128, text_heads=2, **TWO_HEADS)
    _, _, model = _pair(seed=5, **over)
    save_pretrained(model, model.cfg, str(tmp_path / "export"))
    params, jc, _ = japi.load(str(tmp_path / "export" / "model.pt"), compute_dtype="float32")
    assert jc.use_transformer and (jc.vision_width, jc.text_width, jc.text_heads) == (128, 128, 2)
    assert (jc.context_length, jc.vocab_size, jc.vision_layers, jc.text_layers) == (12, 128, 2, 2)
    images, text = _images(seed=6), _text(seed=7)
    with torch.no_grad():
        img, txt, _ = model(torch.from_numpy(images), torch.from_numpy(text))
    j_img, j_txt, _ = jclip.forward(params, jc, jnp.asarray(images), jnp.asarray(text))
    _close(img, j_img, "float32")
    _close(txt, j_txt, "float32")
    back, cfg = load_pretrained(str(tmp_path / "export"), device="cpu")
    assert cfg == model.cfg
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


# ---- the init ------------------------------------------------------------------------


def test_init_distributions_match_jax_per_tensor():
    """A port init and a JAX init (both ViT, vision and text width 256, two
    layers) follow the same law per tensor: the std within ~4 standard
    errors (2% floor), torch-default uniforms inside U(+-1/sqrt(fan_in)),
    LayerNorms at ones and zeros."""
    over = dict(SMALL, vision_width=256, text_width=256, text_heads=4, vocab_size=2048)
    jc = jcfg.CLIPConfig(**over)
    jsd = jax_params_to_state_dict(jax.tree.map(np.asarray, jclip.init(jax.random.key(7), jc)),
                                   tcfg.CLIPConfig(**over))
    tsd = CLIP(tcfg.CLIPConfig(**over), device="cpu", generator=torch.Generator().manual_seed(7)).state_dict()
    assert set(jsd) == set(tsd)
    for k, t in tsd.items():
        j = jsd[k]
        assert t.shape == j.shape, k
        if k == "logit_scale" or ((".ln_" in f".{k}") and k.endswith(".weight")):
            torch.testing.assert_close(t, j)
            continue
        if ".ln_" in f".{k}":
            assert (t == 0).all() and (j == 0).all(), k
            continue
        ts, js = float(t.std()), float(j.std())
        assert abs(ts - js) <= max(0.02, 4 / np.sqrt(2 * t.numel())) * js, (k, ts, js)
        if k.startswith("visual.transformer") or (k.endswith("bias") and ".resblocks." in k):
            fan_in = t.shape[-1] if t.ndim == 2 else tsd[k.replace("bias", "weight")].shape[-1]
            assert float(t.abs().max()) <= fan_in**-0.5 and float(j.abs().max()) <= fan_in**-0.5, k
    # the text tower's explicit normals
    for key, std in (("transformer.resblocks.0.attn.in_proj_weight", 256**-0.5),
                     ("transformer.resblocks.0.mlp.c_fc.weight", (2 * 256) ** -0.5),
                     ("transformer.resblocks.0.mlp.c_proj.weight", 256**-0.5 * 4**-0.5),
                     ("positional_embedding", 0.01), ("visual.positional_embedding", 256**-0.5)):
        assert abs(float(tsd[key].std()) - std) <= 0.03 * std, key


@pytest.mark.parametrize("field,value", [("model_axis", "model"), ("pipeline_axis", "pipe")])
def test_multi_device_fields_raise_naming_slice_f(field, value):
    """model_axis is ported (the blocks split once parallel/tp.py cuts
    them); pipeline_axis still raises, naming its ROADMAP item."""
    if field == "model_axis":
        assert CLIP(tcfg.CLIPConfig(**dict(SMALL, **{field: value})), device="cpu").cfg.model_axis == value
        return
    with pytest.raises(NotImplementedError, match="item 16b, pipeline stages"):
        CLIP(tcfg.CLIPConfig(**dict(SMALL, **{field: value})), device="cpu")
