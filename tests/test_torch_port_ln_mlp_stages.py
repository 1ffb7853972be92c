"""``ln_mlp``'s three stages (LN pass, GEMM 1 with QuickGELU, GEMM 2 with the
residual) against the whole, on the CPU.

In bf16 on the card ``ln_mlp`` is three launches; each stage has a plain
version with the kernel's rounding points. Composed, the plain stages must
be ``ln_mlp_plain`` bit for bit (splitting the call adds no rounding point),
and the stage wrappers composed (on the CPU, their plain versions) must
match the JAX Pallas kernel in interpret mode at the tolerances of
``test_torch_port_kernels.py``. The CUDA stages themselves are held against
their plain versions in ``test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from clip_mixer_tpu.ops.pallas.mlp_kernel import fused_ln_mlp

from clip_mixer_tpu_torch.ops.kernels import ln_mlp as kln

SHAPES = [(1, 128), (77, 256), (231, 384)]
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _inputs(R, W, seed):
    """The JAX kernel's parameters, (in, out) kernels, as numpy f32."""
    rng = np.random.default_rng(seed)
    H = 4 * W
    return dict(
        scale=rng.normal(1, 0.1, W).astype(np.float32),
        bias=rng.normal(0, 0.1, W).astype(np.float32),
        w_in=rng.normal(0, W**-0.5, (W, H)).astype(np.float32),
        b_in=rng.normal(0, 0.1, H).astype(np.float32),
        w_out=rng.normal(0, H**-0.5, (H, W)).astype(np.float32),
        b_out=rng.normal(0, 0.1, W).astype(np.float32),
        x=rng.normal(0, 1, (R, W)).astype(np.float32),
    )


def _torch_args(a, dtype):
    """``ln_mlp``'s arguments: (out, in) weights, all in the activation dtype."""
    def t(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dtype)

    return t(a["x"]), t(a["scale"]), t(a["bias"]), t(a["w_in"].T), t(a["b_in"]), t(a["w_out"].T), t(a["b_out"])


def _stages(x, ln_w, ln_b, w_in, b_in, w_out, b_out, ln_rows, linear_gelu, linear_residual):
    return linear_residual(linear_gelu(ln_rows(x, ln_w, ln_b), w_in, b_in), w_out, b_out, x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,W", SHAPES)
def test_plain_stages_compose_to_ln_mlp_plain_exactly(R, W, dtype):
    args = _torch_args(_inputs(R, W, seed=R + W), DTYPES[dtype][0])
    got = _stages(*args, kln.ln_rows_plain, kln.linear_gelu_plain, kln.linear_residual_plain)
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    torch.testing.assert_close(got, kln.ln_mlp_plain(*args), atol=0, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,W", SHAPES)
def test_stages_match_jax_kernel(R, W, dtype):
    a = _inputs(R, W, seed=2 * R + W)
    tdt, jdt = DTYPES[dtype]
    ln = {"scale": jnp.asarray(a["scale"]), "bias": jnp.asarray(a["bias"])}
    mlp = {k: jnp.asarray(a[k]) for k in ("w_in", "b_in", "w_out", "b_out")}
    want = np.asarray(fused_ln_mlp(ln, mlp, jnp.asarray(a["x"], jdt)), np.float32)
    before = (kln.ln_rows.launches, kln.linear_gelu.launches, kln.linear_residual.launches)
    got = _stages(*_torch_args(a, tdt), kln.ln_rows, kln.linear_gelu, kln.linear_residual).float().numpy()
    # on the CPU the wrappers run their plain versions and launch nothing
    assert (kln.ln_rows.launches, kln.linear_gelu.launches, kln.linear_residual.launches) == before
    if dtype == "f32":
        # the tolerance of test_pallas_kernels.py::test_fused_ln_mlp_matches_plain
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
        return
    # Same rounding points on both sides; f32 summation order can flip a bf16
    # rounding of h or of the output: within two bf16 ulps (2**-7 relative).
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2**-7)
    # and the residual branch, which the output hides, at chip_smoke.py's tolerance
    x = torch.from_numpy(a["x"]).to(tdt).float().numpy()
    assert np.linalg.norm((got - x) - (want - x)) <= 5e-3 * np.linalg.norm(want - x)
