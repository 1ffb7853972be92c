"""The port's kernel modules against the JAX Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version (the CUDA kernels
have no interpret mode); the JAX kernels run in Pallas interpret mode, as
``test_pallas_kernels.py`` runs them. The CUDA kernels themselves are held
against their plain versions in ``test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from clip_mixer_tpu.ops import preprocess as jpre
from clip_mixer_tpu.ops.pallas.mlp_kernel import fused_ln_mlp
from clip_mixer_tpu.ops.pallas.preprocess_kernel import make_pallas_preprocess

from clip_mixer_tpu_torch.ops import preprocess as tpre
from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre
from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp, ln_mlp_plain


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _ln_mlp_inputs(R, W, seed):
    rng = np.random.default_rng(seed)
    return dict(
        scale=rng.normal(1, 0.1, W).astype(np.float32),
        bias=rng.normal(0, 0.1, W).astype(np.float32),
        w_in=rng.normal(0, 0.05, (W, 4 * W)).astype(np.float32),
        b_in=rng.normal(0, 0.01, 4 * W).astype(np.float32),
        w_out=rng.normal(0, 0.05, (4 * W, W)).astype(np.float32),
        b_out=rng.normal(0, 0.01, W).astype(np.float32),
        x=rng.normal(0, 1, (R, W)).astype(np.float32),
    )


def _jax_ln_mlp(a, dtype, **kw):
    ln = {"scale": jnp.asarray(a["scale"]), "bias": jnp.asarray(a["bias"])}
    mlp = {k: jnp.asarray(a[k]) for k in ("w_in", "b_in", "w_out", "b_out")}
    out = fused_ln_mlp(ln, mlp, jnp.asarray(a["x"], dtype), **kw)
    return np.asarray(out, np.float32)


def _torch_args(a, dtype, device="cpu"):
    """The wrapper's arguments: (in, out) kernels become (out, in), all cast
    to the activation dtype as the model does."""
    def t(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device=device, dtype=dtype)

    return (t(a["x"]), t(a["scale"]), t(a["bias"]), t(a["w_in"].T), t(a["b_in"]), t(a["w_out"].T), t(a["b_out"]))


@pytest.mark.parametrize("R,row_tile", [(256, 128), (231, None)])
def test_ln_mlp_cpu_path_matches_jax_kernel_f32(R, row_tile):
    a = _ln_mlp_inputs(R, 128, seed=1)
    want = _jax_ln_mlp(a, jnp.float32, row_tile=row_tile, hidden_chunks=4)
    got = ln_mlp(*_torch_args(a, torch.float32))
    # the tolerance of test_pallas_kernels.py::test_fused_ln_mlp_matches_plain
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)


def test_ln_mlp_cpu_path_matches_jax_kernel_bf16():
    a = _ln_mlp_inputs(256, 128, seed=2)
    want = _jax_ln_mlp(a, jnp.bfloat16, row_tile=128, hidden_chunks=4)
    got = ln_mlp(*_torch_args(a, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # Same rounding points on both sides (y and h in bf16, f32 sums, f32
    # epilogue); only f32 summation order differs, which can flip a bf16
    # rounding of h or of the output: within two bf16 ulps (2**-7 relative).
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2**-7)
    # The residual dominates the output and would hide a dropped bias; the
    # branch out - x is held too, at the tolerance chip_smoke.py gives it.
    x = a["x"].astype(np.float32)
    branch = got.float().numpy() - x
    assert np.linalg.norm(branch - (want - x)) <= 5e-3 * np.linalg.norm(want - x)


def test_ln_mlp_plain_follows_kernel_rounding_not_plain_chain():
    """In bf16 the fused path rounds LN's output and the hidden activation
    once each; the plain version repeats exactly that."""
    a = _ln_mlp_inputs(64, 128, seed=3)
    args = _torch_args(a, torch.bfloat16)
    x, lw, lb, wi, bi, wo, bo = [v.float() for v in args]
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (((x - mean) * torch.rsqrt(var + 1e-5)) * lw + lb).bfloat16().float()
    h = y @ wi.t() + bi
    h = (h * torch.sigmoid(1.702 * h)).bfloat16().float()
    want = (x + h @ wo.t() + bo).bfloat16()
    torch.testing.assert_close(ln_mlp_plain(*args), want, atol=0, rtol=0)


def test_ln_mlp_wrapper_refuses_other_devices():
    a = _ln_mlp_inputs(32, 128, seed=4)
    args = [t.to("meta") for t in _torch_args(a, torch.float32)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ln_mlp(*args)


@pytest.mark.parametrize("hw,n_px", [((64, 64), 32), ((256, 256), 224), ((48, 80), 32)])
def test_preprocess_cpu_path_matches_jax_kernel(hw, n_px):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = np.asarray(make_pallas_preprocess(hw, n_px, dtype=jnp.float32)(jnp.asarray(imgs)))
    got = tpre.make_batch_preprocess(hw, n_px, dtype=torch.float32, backend="kernel")(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_torch_backend_matches_jax_xla_backend(normalize):
    rng = np.random.default_rng(6)
    imgs = rng.integers(0, 256, (3, 64, 48, 3), dtype=np.uint8)
    want = np.asarray(jpre.make_batch_preprocess((64, 48), 32, normalize=normalize)(jnp.asarray(imgs)))
    got = tpre.make_batch_preprocess((64, 48), 32, normalize=normalize)(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    want_n = np.asarray(jpre.normalize_images(jnp.asarray(imgs)))
    np.testing.assert_allclose(tpre.normalize_images(torch.from_numpy(imgs)).numpy(), want_n, atol=1e-5)


@pytest.mark.parametrize("h,w,n", [(256, 256, 224), (64, 64, 32), (300, 200, 224), (224, 224, 224)])
def test_resize_matrices_and_bands(h, w, n):
    rh, rw = tpre._cached_matrices(h, w, n)
    jrh, jrw = jpre._cached_matrices(h, w, n)
    np.testing.assert_array_equal(rh, jrh)
    np.testing.assert_array_equal(rw, jrw)
    assert tpre.resize_geometry(h, w, n) == jpre.resize_geometry(h, w, n)
    for m in (rh, rw):
        taps, start = kpre.band(m)
        assert (start >= 0).all() and (start + taps.shape[1] <= m.shape[1]).all()
        dense = np.zeros_like(m)
        for r, s in enumerate(start):
            dense[r, s : s + taps.shape[1]] = taps[r]
        np.testing.assert_array_equal(dense, m)  # every non-zero is inside its band


def test_banded_loop_matches_plain_version():
    """The CUDA kernel's two banded loops, written out in numpy in the
    kernel's order, against the plain (dense) version."""
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    bands = kpre.ResizeBands.build((256, 256), 224, "cpu")
    rh_t, rh_s = bands.rh_taps.numpy(), bands.rh_start.numpy()
    rw_t, rw_s = bands.rw_taps.numpy(), bands.rw_start.numpy()
    norm = bands.norm.numpy()
    x = imgs.astype(np.float32)
    t = np.stack([(rh_t[o][:, None, None, None] * x[:, rh_s[o] : rh_s[o] + rh_t.shape[1]].transpose(1, 0, 2, 3)).sum(0)
                  for o in range(224)], axis=1)  # [B, 224, W, 3]
    o = np.stack([(rw_t[p][:, None, None, None] * t[:, :, rw_s[p] : rw_s[p] + rw_t.shape[1]].transpose(2, 0, 1, 3)).sum(0)
                  for p in range(224)], axis=2)  # [B, 224, 224, 3]
    got = (o - norm[:3]) * norm[3:]
    want = kpre.preprocess_plain(torch.from_numpy(imgs), bands, torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_kernel_backend_refuses_unnormalized():
    with pytest.raises(ValueError):
        tpre.make_batch_preprocess((64, 64), 32, normalize=False, backend="kernel")
