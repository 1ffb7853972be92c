"""The PyTorch port's config, layers, mixer blocks, towers and CLIP against
the JAX package, on the CPU at small sizes.

Inputs and weights come from numpy seeds / ``jax.random``; the JAX parameter
tree moves into the port through ``load_jax_params``. f32 tolerances are the
JAX suite's own (atol 5e-5 / rtol 1e-3, as in ``test_torch_parity.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.models import layers as jlayers
from clip_mixer_tpu.models import mixer as jmixer

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.models import layers as tlayers
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params

ATOL, RTOL = 5e-5, 1e-3

SMALL = dict(
    embed_dim=32,
    image_resolution=32,
    vision_layers=2,
    vision_width=64,
    vision_patch_size=16,
    context_length=16,
    vocab_size=512,
    text_width=64,
    text_heads=1,
    text_layers=2,
    tower="mixer",
    compute_dtype="float32",
)


def _pair(**over):
    """(jax cfg, jax params as numpy, port model) with the same weights."""
    jc = jcfg.CLIPConfig(**{**SMALL, **over})
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(0), jc))
    model = CLIP(tcfg.CLIPConfig(**{**SMALL, **over}), device="cpu")
    load_jax_params(model, params)
    return jc, params, model


def _inputs(batch=3, res=32, ctx=16, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (batch, res, res, 3)).astype(np.float32)
    text = np.zeros((batch, ctx), np.int32)
    for i in range(batch):
        n = int(rng.integers(3, ctx))
        text[i, 0] = vocab - 2
        text[i, 1 : n - 1] = rng.integers(1, vocab - 2, n - 2)
        text[i, n - 1] = vocab - 1  # eot = max id
    return images, text


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_match_jax_field_by_field(name):
    j, t = jcfg.PRESETS[name], tcfg.PRESETS[name]
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("use_transformer", "is_resnet", "vision_heads"):
        assert getattr(t, prop) == getattr(j, prop)
    if not j.is_resnet:
        assert (t.grid_size, t.vision_tokens) == (j.grid_size, j.vision_tokens)
    assert dataclasses.asdict(t.for_siglip()) == dataclasses.asdict(j.for_siglip())


def test_config_validation_matches_jax():
    assert dataclasses.asdict(tcfg.CLIPConfig()) == dataclasses.asdict(jcfg.CLIPConfig())
    for bad in (dict(tower="resnet"), dict(remat_policy="some")):
        with pytest.raises(ValueError):
            jcfg.CLIPConfig(**bad)
        with pytest.raises(ValueError):
            tcfg.CLIPConfig(**bad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quick_gelu_and_layer_norm(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (4, 7, 96)).astype(np.float32)
    scale = rng.normal(1, 0.1, 96).astype(np.float32)
    bias = rng.normal(0, 0.1, 96).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    j_ln = jlayers.layer_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jx)
    t_ln = tlayers.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias))
    j_g = jlayers.quick_gelu(jx)
    t_g = tlayers.quick_gelu(tx)
    assert t_ln.dtype == tx.dtype and t_g.dtype == tx.dtype
    if dtype == "float32":
        _close(t_ln, j_ln)
        _close(t_g, j_g)
    else:
        # LN runs in f32 in both and rounds once to bf16: at most one bf16
        # ulp apart (2**-8 relative). QuickGELU is computed in bf16 by both
        # (two roundings each side): two ulps.
        _close(t_ln.float(), np.asarray(j_ln, np.float32), atol=1e-2, rtol=2**-8)
        _close(t_g.float(), np.asarray(j_g, np.float32), atol=1e-2, rtol=2**-7)


def test_mixer_block_and_tower_match_jax():
    jc, params, model = _pair()
    rng = np.random.default_rng(2)
    T, W = jc.vision_tokens, jc.vision_width
    x = rng.normal(0, 1, (3, T, W)).astype(np.float32)
    blocks = params["visual"]["tower"]["blocks"]
    block0 = jax.tree.map(lambda a: a[0], blocks)
    j_block = jmixer.mixer_block(block0, jnp.asarray(x))
    j_tower = jmixer.mixer_tower(params["visual"]["tower"], jnp.asarray(x))
    with torch.no_grad():
        t_block = model.visual.transformer.mixBlocks[0](torch.from_numpy(x))
        t_tower = model.visual.transformer(torch.from_numpy(x))
    _close(t_block, j_block)
    _close(t_tower, j_tower)


def test_token_mix_matches_jax():
    jc, params, model = _pair()
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, jc.context_length, jc.text_width)).astype(np.float32)
    block0 = jax.tree.map(lambda a: a[0], params["text"]["tower"]["blocks"])
    from clip_mixer_tpu_torch.models.mixer import token_mix

    with torch.no_grad():
        got = token_mix(model.transformer.mixBlocks[0], torch.from_numpy(x))
    _close(got, jmixer.token_mix(block0, jnp.asarray(x)))


def test_clip_encoders_forward_and_logits_match_jax():
    jc, params, model = _pair()
    images, text = _inputs()
    ji, jt = jnp.asarray(images), jnp.asarray(text)
    ti, tt = torch.from_numpy(images), torch.from_numpy(text)
    with torch.no_grad():
        _close(model.encode_image(ti), jclip.encode_image(params, jc, ji))
        _close(model.encode_text(tt), jclip.encode_text(params, jc, jt))
        img, txt, scale = model(ti, tt)
        j_img, j_txt, j_scale = jclip.forward(params, jc, ji, jt)
        _close(img, j_img, atol=1e-4)
        _close(txt, j_txt, atol=1e-4)
        np.testing.assert_allclose(float(scale), float(j_scale), rtol=1e-6)
        per_image, per_text = model.logits(ti, tt)
        j_pi, j_pt = jclip.logits(params, jc, ji, jt)
        _close(per_image, j_pi, atol=2e-3)
        _close(per_text, j_pt, atol=2e-3)


def test_bf16_model_matches_jax_within_rounding():
    jc, params, model = _pair(compute_dtype="bfloat16")
    images, text = _inputs(seed=4)
    with torch.no_grad():
        t_img = model.encode_image(torch.from_numpy(images))
        t_txt = model.encode_text(torch.from_numpy(text))
    assert t_img.dtype == torch.bfloat16 and t_txt.dtype == torch.bfloat16
    for got, want in (
        (t_img, jclip.encode_image(params, jc, jnp.asarray(images))),
        (t_txt, jclip.encode_text(params, jc, jnp.asarray(text))),
    ):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        # bf16 keeps 8 significant bits (one rounding ~2**-9 relative); the
        # two frameworks round after different ops over two blocks per
        # tower, so the features agree to ~1% in relative Frobenius norm.
        assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def test_fused_mlp_model_matches_jax_fused_path(interpret_pallas):
    jc, params, model = _pair(fused_mlp=True)
    images, text = _inputs(seed=5)
    with torch.no_grad():
        _close(model.encode_image(torch.from_numpy(images)), jclip.encode_image(params, jc, jnp.asarray(images)))
        _close(model.encode_text(torch.from_numpy(text)), jclip.encode_text(params, jc, jnp.asarray(text)))


def test_state_dict_keys_are_the_reference_names():
    jc, params, model = _pair()
    sd = jax_params_to_state_dict(params, model.cfg)
    assert set(sd) == set(model.state_dict())
    for key in (
        "visual.conv1.weight",
        "visual.transformer.mixBlocks.1.layerNorm1.weight",
        "visual.transformer.mixBlocks.0.token_mix_seq.lin1.weight",
        "transformer.mixBlocks.1.channel_mix_seq.lin4.bias",
        "token_embedding.weight",
        "text_projection",
        "logit_scale",
    ):
        assert key in sd
    # (in, out) kernels become nn.Linear's (out, in)
    w_in = params["text"]["tower"]["blocks"]["channel_mix"]["w_in"][1]
    np.testing.assert_array_equal(sd["transformer.mixBlocks.1.channel_mix_seq.lin3.weight"].numpy(), w_in.T)


def _init_stats():
    """Per-key (std, max |x|) of a port init and a JAX init of mixer-b32-wide
    geometry cut to two layers."""
    over = dict(SMALL, vision_width=256, text_width=128, vocab_size=2048, compute_dtype="float32")
    jc = jcfg.CLIPConfig(**over)
    jsd = jax_params_to_state_dict(jax.tree.map(np.asarray, jclip.init(jax.random.key(7), jc)), tcfg.CLIPConfig(**over))
    model = CLIP(tcfg.CLIPConfig(**over), device="cpu", generator=torch.Generator().manual_seed(7))
    return jsd, {k: v.detach() for k, v in model.state_dict().items()}


def _is_layer_norm(key):
    return ".ln_" in f".{key}" or ".layerNorm" in key


def _fan_in(key, tsd):
    """1/sqrt(fan_in) bound of a torch-default uniform tensor."""
    if key == "visual.conv1.weight":
        return tsd[key][0].numel() ** -0.5
    weight = tsd[key.replace(".bias", ".weight")]
    return weight.shape[1] ** -0.5


def test_init_distributions_match_jax_per_tensor():
    jsd, tsd = _init_stats()
    assert set(jsd) == set(tsd)
    for k, t in tsd.items():
        j = jsd[k]
        assert t.shape == j.shape, k
        if k == "logit_scale" or (_is_layer_norm(k) and k.endswith(".weight")):
            torch.testing.assert_close(t, j)  # ones, and the logit-scale init
            continue
        if _is_layer_norm(k):
            assert (t == 0).all() and (j == 0).all(), k
            continue
        # Random tensors follow the same law: std within ~4 standard errors
        # of the sample std (2% floor).
        ts, js = float(t.std()), float(j.std())
        assert abs(ts - js) <= max(0.02, 4 / np.sqrt(2 * t.numel())) * js, (k, ts, js)
        # Uniform laws (every vision linear, conv1 and every bias) stay
        # inside U(+-1/sqrt(fan_in)).
        if k.startswith("visual.conv1") or (k.startswith("visual.transformer") or k.endswith(".bias")) and ".lin" in k:
            bound = _fan_in(k, tsd)
            assert float(t.abs().max()) <= bound and float(j.abs().max()) <= bound, k
    # Text linears are normal: lin3 std (2w)^-1/2, lin4 std w^-1/2 (2L)^-1/2.
    w3 = tsd["transformer.mixBlocks.0.channel_mix_seq.lin3.weight"]
    w4 = tsd["transformer.mixBlocks.0.channel_mix_seq.lin4.weight"]
    assert abs(float(w3.std()) - (2 * 128) ** -0.5) <= 0.02 * (2 * 128) ** -0.5
    assert abs(float(w4.std()) - 128**-0.5 * 4**-0.5) <= 0.02 * 128**-0.5 * 4**-0.5


# every transformer preset, full size, with its parameter count (OpenAI's
# ViT-B/32 and ViT-L/14 have these too)
TRANSFORMER_PRESETS = {"transformer-b32": 151_277_313, "vit-b32": 151_277_313, "vit-b16": 149_620_737,
                       "vit-l14": 427_616_513, "vit-l14-336": 427_944_193}


# every ResNet preset
RESNET_PRESETS = ("rn50", "rn101", "rn50x4", "rn50x16", "rn50x64")


def _jax_leaf_elements(name):
    """The element count of the JAX init's tree for preset ``name``, read
    through ``jax.eval_shape`` (no full-size JAX init runs)."""
    shapes = jax.eval_shape(lambda key: jclip.init(key, jcfg.PRESETS[name]), jax.random.key(0))
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))


def test_transformer_and_resnet_configs_raise():
    """Neither tower kind raises any more: every transformer preset builds
    at full size with its parameter count, and every ResNet preset builds
    at full size with its parameters plus its BatchNorm running statistics
    as many elements as the JAX tree, which holds those statistics as
    leaves."""
    for name in RESNET_PRESETS:
        model = CLIP(tcfg.PRESETS[name], device="cpu")
        running = sum(b.numel() for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var")))
        assert sum(p.numel() for p in model.parameters()) + running == _jax_leaf_elements(name), name
        assert [len(getattr(model.visual, f"layer{i}")) for i in range(1, 5)] == list(tcfg.PRESETS[name].vision_layers)
        del model
    for name, n_params in TRANSFORMER_PRESETS.items():
        model = CLIP(tcfg.PRESETS[name], device="cpu")
        assert sum(p.numel() for p in model.parameters()) == n_params, name
        assert len(model.visual.transformer.resblocks) == tcfg.PRESETS[name].vision_layers
        del model
