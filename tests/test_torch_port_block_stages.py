"""The bf16 whole block's stages (the token kernel, then ``ln_mlp``'s two
GEMMs) against the whole, on the CPU.

On the card a bf16 block is three launches: ``token_mix`` (z = x + the token
MLP, and y2 = LN_ch(z)), then ``linear_gelu`` on y2 and ``linear_residual``
on z. Composed, the plain stages must be ``mixer_block_plain`` bit for bit
(splitting the block adds no rounding point), and the stage wrappers
composed (on the CPU, their plain versions) must match the JAX Pallas block
kernel in interpret mode at the tolerances of ``test_torch_port_block.py``.
The CUDA token kernel itself is held against its plain version in
``test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from clip_mixer_tpu.models.mixer import init_mixer_block
from clip_mixer_tpu.ops.pallas import block_kernel as jblock

from clip_mixer_tpu_torch.models.convert import load_jax_mixer
from clip_mixer_tpu_torch.models.mixer import MixerBlock
from clip_mixer_tpu_torch.ops.kernels import ln_mlp as kln
from clip_mixer_tpu_torch.ops.kernels import mixer_block as kmb

F32_TOL = dict(atol=2e-5, rtol=1e-4)  # test_torch_port_block.py:41 (test_pallas_kernels.py:93,106)
BRANCH_TOL = 5e-3  # test_torch_port_block.py:43, chip_smoke.py's bf16 tolerance on the branch out - x
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}
TOKENS = [8, 50, 77]  # the JAX suite's token count and both towers'
B, D = 4, 128


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _block_pair(T, seed):
    """(JAX block tree with numpy leaves, port MixerBlock) with the same
    weights; LN scales and biases off their init so the affine counts."""
    tree = jax.tree.map(np.asarray, init_mixer_block(jax.random.key(seed), width=D, tokens=T, text_tower=True, n_layers=2))
    rng = np.random.default_rng(seed)
    for ln in ("ln_token", "ln_channel"):
        for k in ("scale", "bias"):
            tree[ln][k] = tree[ln][k] + rng.normal(0, 0.1, tree[ln][k].shape).astype(np.float32)
    return tree, load_jax_mixer(MixerBlock(D, T), tree)


def _stages(x, params, token_mix, linear_gelu, linear_residual):
    """The bf16 block's three launches in turn on x [T, B, D]."""
    T, B_, D_ = x.shape
    z, y2 = token_mix(x, *params[:8])
    h = linear_gelu(y2.reshape(T * B_, D_), params[8], params[9])
    return linear_residual(h, params[10], params[11], z.reshape(T * B_, D_)).reshape(T, B_, D_)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", TOKENS)
def test_plain_stages_compose_to_mixer_block_plain_exactly(T, dtype):
    _, block = _block_pair(T, seed=T)
    x = torch.from_numpy(np.random.default_rng(T).normal(0, 1, (T, B, D)).astype(np.float32)).to(DTYPES[dtype][0])
    params = kmb.block_params(block, x.dtype)
    with torch.no_grad():
        z, y2 = kmb.token_mix_plain(x, *params[:8])
        assert z.shape == y2.shape == x.shape and z.dtype == y2.dtype == x.dtype
        # y2 is LN_ch of z, as ln_mlp's LN pass computes it
        torch.testing.assert_close(y2.reshape(-1, D), kln.ln_rows_plain(z.reshape(-1, D), *params[6:8]), atol=0, rtol=0)
        got = _stages(x, params, kmb.token_mix_plain, kln.linear_gelu_plain, kln.linear_residual_plain)
        torch.testing.assert_close(got, kmb.mixer_block_plain(block, x), atol=0, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", TOKENS)
def test_stage_wrappers_match_jax_kernel(T, dtype):
    tree, block = _block_pair(T, seed=T + 1)
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(T + 1).normal(0, 1, (T, B, D)).astype(np.float32)
    # a batch tile of 8 takes the JAX wrapper's shapes as test_torch_port_block.py does
    xp = np.concatenate([x, np.zeros((T, 8 - B, D), np.float32)], axis=1)
    params_j = jax.tree.map(jnp.asarray, tree)
    want = np.asarray(jblock.fused_mixer_block_tbd(params_j, jnp.asarray(xp, jdt), batch_tile=8, hidden_chunks=2),
                      np.float32)[:, :B]
    xt = torch.from_numpy(x).to(tdt)
    before = (kmb.token_mix.launches, kln.linear_gelu.launches, kln.linear_residual.launches)
    with torch.no_grad():
        got = _stages(xt, kmb.block_params(block, tdt), kmb.token_mix, kln.linear_gelu, kln.linear_residual)
    # on the CPU the wrappers run their plain versions and launch nothing
    assert (kmb.token_mix.launches, kln.linear_gelu.launches, kln.linear_residual.launches) == before
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
        return
    # Same rounding points on both sides; f32 summation order can flip a bf16
    # rounding: within two bf16 ulps, and the branch at chip_smoke.py's tolerance.
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2**-7)
    x32 = xt.float().numpy()
    assert np.linalg.norm((got - x32) - (want - x32)) <= BRANCH_TOL * np.linalg.norm(want - x32)


def test_token_mix_wrapper_keeps_the_layout_and_refuses_other_devices():
    _, block = _block_pair(8, seed=3)
    params = kmb.block_params(block, torch.float32)
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (B, 8, D)).astype(np.float32))  # [B, T, D]
    with torch.no_grad():
        a = kmb.token_mix(x.transpose(0, 1), *params[:8])
        b = kmb.token_mix(x.transpose(0, 1).contiguous(), *params[:8])
    for u, v in zip(a, b):
        assert u.shape == (8, B, D)
        torch.testing.assert_close(u, v, atol=0, rtol=0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kmb.token_mix(x.transpose(0, 1).to("meta"), *(p.to("meta") for p in params[:8]))


@pytest.mark.parametrize("T,U,D_,fits", [(50, 200, 768, True), (77, 308, 512, True), (77, 308, 768, False),
                                         (80, 320, 512, True), (48, 192, 1024, True), (64, 256, 1024, False)])
def test_token_smem_budget(T, U, D_, fits):
    """Both Mixer-B/32 towers fit the token kernel's shared memory; the text
    tower's tokens at the vision width do not."""
    assert (kmb.token_smem_bytes(T, U, D_) <= kmb.SMEM_MAX) == fits
