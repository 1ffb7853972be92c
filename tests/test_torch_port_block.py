"""The port's whole-block kernel module against the JAX Pallas block kernel.

On the CPU ``fused_mixer_block_tbd`` takes its plain PyTorch version (the
CUDA kernel has no interpret mode); the JAX kernel runs in Pallas interpret
mode, as ``test_pallas_kernels.py`` runs it. Both packages get the same
block through ``load_jax_mixer``, inputs come from numpy seeds, and the
tolerances are the JAX suite's (``test_pallas_kernels.py:57,93,106,121``).
The CUDA kernel itself is held against the plain version in
``test_torch_port_cuda.py``.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from clip_mixer_tpu.models.mixer import init_mixer_block, init_mixer_tower
from clip_mixer_tpu.ops.pallas import block_kernel as jblock
from clip_mixer_tpu.ops.pallas.mlp_kernel import ln_mlp as jax_ln_mlp

from clip_mixer_tpu_torch import PRESETS
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import jax_block_arrays, jax_params_to_state_dict, load_jax_mixer
from clip_mixer_tpu_torch.models.layers import quick_gelu
from clip_mixer_tpu_torch.models.mixer import MixerBlock, MixerTower
from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp, ln_mlp_plain
from clip_mixer_tpu_torch.ops.kernels.mixer_block import (
    block_params,
    fused_mixer_block_tbd,
    mixer_block_fused,
    mixer_block_plain,
    mixer_tower_fused,
)

F32_TOL = dict(atol=2e-5, rtol=1e-4)  # test_pallas_kernels.py:93,106
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)  # test_pallas_kernels.py:80,121
BRANCH_TOL = 5e-3  # chip_smoke.py's bf16 tolerance on the branch out - x


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _perturb_ln(tree, rng):
    """LN scales and biases off their ones / zeros init, so the affine counts."""
    for ln in ("ln_token", "ln_channel"):
        p = tree[ln]
        p["scale"] = p["scale"] + rng.normal(0, 0.1, p["scale"].shape).astype(np.float32)
        p["bias"] = p["bias"] + rng.normal(0, 0.1, p["bias"].shape).astype(np.float32)
    return tree


def _block_pair(T, D, seed):
    """(JAX block tree with numpy leaves, port MixerBlock) with the same weights."""
    tree = jax.tree.map(np.asarray, init_mixer_block(jax.random.key(seed), width=D, tokens=T, text_tower=True, n_layers=2))
    tree = _perturb_ln(tree, np.random.default_rng(seed))
    return tree, load_jax_mixer(MixerBlock(D, T), tree)


def _jax_block(tree, x, dtype, **kw):
    params = jax.tree.map(jnp.asarray, tree)
    return np.asarray(jblock.fused_mixer_block_tbd(params, jnp.asarray(x, dtype), **kw), np.float32)


def _branch_err(got, want, x):
    return float(np.linalg.norm((got - x) - (want - x)) / np.linalg.norm(want - x))


# (T, B, D, JAX kernel options): the JAX suite's shape, and an odd token count it lacks
SHAPES = [(8, 16, 128, dict(batch_tile=8, hidden_chunks=2)), (50, 8, 128, dict(batch_tile=8, hidden_chunks=4))]


@pytest.mark.parametrize("T,B,D,kw", SHAPES)
def test_block_cpu_path_matches_jax_kernel_f32(T, B, D, kw):
    tree, block = _block_pair(T, D, seed=T)
    x = np.random.default_rng(1).normal(0, 1, (T, B, D)).astype(np.float32)
    want = _jax_block(tree, x, jnp.float32, **kw)
    with torch.no_grad():
        got = fused_mixer_block_tbd(block, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("T,B,D,kw", SHAPES)
def test_block_cpu_path_matches_jax_kernel_bf16(T, B, D, kw):
    tree, block = _block_pair(T, D, seed=T + 1)
    x = np.random.default_rng(2).normal(0, 1, (T, B, D)).astype(np.float32)
    want = _jax_block(tree, x, jnp.bfloat16, **kw)
    xb = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        got = fused_mixer_block_tbd(block, xb)
    assert got.dtype == torch.bfloat16
    # Same rounding points on both sides (y, the token hidden, z, LN_ch(z)
    # and the channel hidden in bf16; f32 sums and epilogues); only the f32
    # summation order differs, which can flip a bf16 rounding: two ulps.
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2**-7)
    # The residual dominates the output and would hide a dropped bias.
    x32 = xb.float().numpy()
    assert _branch_err(got.float().numpy(), want, x32) <= BRANCH_TOL


@pytest.mark.parametrize("bias", ["token_mix_seq.lin2.bias", "channel_mix_seq.lin4.bias"])
def test_block_branch_check_fails_a_dropped_bias(bias):
    T, B, D, kw = SHAPES[1]
    tree, block = _block_pair(T, D, seed=3)
    x = np.random.default_rng(4).normal(0, 1, (T, B, D)).astype(np.float32)
    want = _jax_block(tree, x, jnp.bfloat16, **kw)
    faulty = copy.deepcopy(block)
    with torch.no_grad():
        faulty.get_parameter(bias).zero_()
        got = fused_mixer_block_tbd(faulty, torch.from_numpy(x).bfloat16())
    assert _branch_err(got.float().numpy(), want, torch.from_numpy(x).bfloat16().float().numpy()) > BRANCH_TOL


@pytest.mark.parametrize("T", [8, 50])
def test_tower_cpu_path_matches_jax_fused_tower(T):
    B, D = 12, 128  # B=12 takes the JAX wrapper's pad-to-batch_tile path
    tree = jax.tree.map(np.asarray, init_mixer_tower(jax.random.key(T), width=D, tokens=T, n_layers=2, text_tower=False))
    tower = load_jax_mixer(MixerTower(D, T, 2), tree)
    x = np.random.default_rng(5).normal(0, 1, (B, T, D)).astype(np.float32)
    want = np.asarray(jblock.mixer_tower_fused(jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    with torch.no_grad():
        got = mixer_tower_fused(tower, torch.from_numpy(x))
    assert got.shape == (B, T, D)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_block_grads_match_jax_custom_vjp():
    T, B, D = 8, 8, 128  # test_pallas_kernels.py:109-121
    tree, block = _block_pair(T, D, seed=6)
    x = np.random.default_rng(7).normal(0, 1, (T, B, D)).astype(np.float32)
    j_params, j_x = jax.grad(
        lambda p, v: jblock.mixer_block_fused(p, v).sum(), argnums=(0, 1)
    )(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    mixer_block_fused(block, tx).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_x), **GRAD_TOL)
    want = jax_block_arrays(jax.tree.map(np.asarray, j_params))  # kernels transposed to (out, in)
    got = dict(block.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], err_msg=name, **GRAD_TOL)


def test_ln_mlp_grads_match_jax_custom_vjp():
    rng = np.random.default_rng(2)  # test_pallas_kernels.py:60-80
    R, W = 128, 128
    a = dict(
        scale=np.ones(W, np.float32), bias=np.zeros(W, np.float32),
        w_in=rng.normal(0, 0.05, (W, 4 * W)).astype(np.float32), b_in=np.zeros(4 * W, np.float32),
        w_out=rng.normal(0, 0.05, (4 * W, W)).astype(np.float32), b_out=np.zeros(W, np.float32),
    )
    x = rng.normal(0, 1, (R, W)).astype(np.float32)
    ln = {"scale": jnp.asarray(a["scale"]), "bias": jnp.asarray(a["bias"])}
    mlp = {k: jnp.asarray(a[k]) for k in ("w_in", "b_in", "w_out", "b_out")}
    (j_ln, j_mlp), j_x = jax.grad(lambda p, v: jax_ln_mlp(p[0], p[1], v).sum(), argnums=(0, 1))((ln, mlp), jnp.asarray(x))
    names = ("x", "scale", "bias", "w_in", "b_in", "w_out", "b_out")
    args = [torch.from_numpy(np.ascontiguousarray(v)).requires_grad_()
            for v in (x, a["scale"], a["bias"], a["w_in"].T, a["b_in"], a["w_out"].T, a["b_out"])]
    ln_mlp(*args).sum().backward()
    want = dict(x=j_x, scale=j_ln["scale"], bias=j_ln["bias"], w_in=np.asarray(j_mlp["w_in"]).T, b_in=j_mlp["b_in"],
                w_out=np.asarray(j_mlp["w_out"]).T, b_out=j_mlp["b_out"])
    for name, t in zip(names, args):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want[name]), err_msg=name, **GRAD_TOL)


def _routed(model):
    """The model with both towers' forward bound to mixer_tower_fused."""
    for tower in (model.visual.transformer, model.transformer):
        tower.forward = functools.partial(mixer_tower_fused, tower)
    return model


def test_clip_with_fused_towers_matches_plain_towers():
    cfg = PRESETS["mixer-debug"]
    model = CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(8))
    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.normal(0, 1, (3, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32))
    text = torch.from_numpy(rng.integers(1, cfg.vocab_size - 1, (3, cfg.context_length)).astype(np.int64))
    text[:, 7] = cfg.vocab_size - 1  # eot, the argmax id
    with torch.no_grad():
        want = (model.encode_image(images), model.encode_text(text))
        _routed(model)
        got = (model.encode_image(images), model.encode_text(text))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=5e-5, rtol=1e-3)  # the port model tests' f32 tolerance
    # routing changed no state-dict key
    assert set(model.state_dict()) == set(CLIP(cfg, device="cpu").state_dict())


def test_clip_with_fused_towers_trains_every_tower_parameter():
    cfg = PRESETS["mixer-debug"]
    model = _routed(CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(10)))
    images = torch.from_numpy(np.random.default_rng(11).normal(0, 1, (2, 32, 32, 3)).astype(np.float32))
    model.encode_image(images).square().sum().backward()
    for name, p in model.visual.transformer.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name


def test_load_jax_mixer_fills_what_the_full_loader_fills():
    from clip_mixer_tpu import config as jcfg
    from clip_mixer_tpu.models import clip as jclip

    cfg = PRESETS["mixer-debug"]
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(12), jcfg.PRESETS["mixer-debug"]))
    sd = jax_params_to_state_dict(params, cfg)
    tower = load_jax_mixer(MixerTower(cfg.text_width, cfg.context_length, cfg.text_layers), params["text"]["tower"])
    for k, v in tower.state_dict().items():
        torch.testing.assert_close(v, sd[f"transformer.{k}"], atol=0, rtol=0)
    block1 = jax.tree.map(lambda a: a[1], params["visual"]["tower"]["blocks"])
    block = load_jax_mixer(MixerBlock(cfg.vision_width, cfg.vision_tokens), block1)
    for k, v in block.state_dict().items():
        torch.testing.assert_close(v, sd[f"visual.transformer.mixBlocks.1.{k}"], atol=0, rtol=0)
    with pytest.raises(TypeError, match="MixerBlock or a MixerTower"):
        load_jax_mixer(torch.nn.Linear(2, 2), block1)


def test_block_plain_follows_kernel_rounding_not_the_unfused_block():
    """In bf16 the plain version rounds where the kernel does: y, the token
    hidden and z once each; the unfused MixerBlock.forward rounds the token
    mix's einsums and biases separately."""
    _, block = _block_pair(8, 128, seed=13)
    x = torch.from_numpy(np.random.default_rng(14).normal(0, 1, (8, 4, 128)).astype(np.float32)).bfloat16()
    lt_w, lt_b, w1, b1, w2, b2, lc_w, lc_b, w3, b3, w4, b4 = [p.float() for p in block_params(block, torch.bfloat16)]
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (((x32 - mean) * torch.rsqrt(var + 1e-5)) * lt_w + lt_b).bfloat16().float()
    h = quick_gelu(torch.einsum("ut,tbd->ubd", w1, y) + b1[:, None, None]).bfloat16().float()
    z = (x32 + torch.einsum("tu,ubd->tbd", w2, h) + b2[:, None, None]).bfloat16()
    args = [t.bfloat16() for t in (lc_w, lc_b, w3, b3, w4, b4)]
    want = ln_mlp_plain(z.reshape(-1, 128), *args).reshape(8, 4, 128)
    with torch.no_grad():
        torch.testing.assert_close(mixer_block_plain(block, x), want, atol=0, rtol=0)
        unfused = block(x.transpose(0, 1)).transpose(0, 1)
    assert not torch.equal(unfused, want)


def test_block_wrapper_takes_either_layout_and_refuses_other_devices():
    _, block = _block_pair(8, 128, seed=15)
    x = torch.from_numpy(np.random.default_rng(16).normal(0, 1, (4, 8, 128)).astype(np.float32))  # [B, T, D]
    with torch.no_grad():
        a = fused_mixer_block_tbd(block, x.transpose(0, 1))
        b = fused_mixer_block_tbd(block, x.transpose(0, 1).contiguous())
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_mixer_block_tbd(block.to("meta"), x.transpose(0, 1).to("meta"))
