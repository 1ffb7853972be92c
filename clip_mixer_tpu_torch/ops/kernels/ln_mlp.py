"""Fused LN + channel MLP: ``x + QuickGELU(LN(x) W_in^T + b_in) W_out^T + b_out``.

Replaces ``clip_mixer_tpu/ops/pallas/mlp_kernel.py::fused_ln_mlp``. The CUDA
kernel is ``csrc/ln_mlp.cu`` (its header says what bounds it on an H100 and
how the design answers that). :func:`ln_mlp` launches it for CUDA tensors
and raises on what it does not take; it uses :func:`ln_mlp_plain` only for
tensors on the CPU.

Weights are in ``nn.Linear``'s (out, in) layout: ``w_in`` [H, W], ``w_out``
[W, H]. Every parameter arrives already cast to ``x.dtype`` (the LN scale and
bias too, as the TPU kernel casts them). :func:`ln_mlp` is differentiable, as
the JAX ``custom_vjp`` is: the kernel computes the forward, and the backward
is the VJP of :func:`ln_mlp_plain`, recomputed from the saved inputs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from clip_mixer_tpu_torch.models.layers import quick_gelu
from clip_mixer_tpu_torch.ops.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I, _I, _I, _P]


def ln_mlp_plain(x, ln_w, ln_b, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, with its rounding points:
    LN in f32 with the affine from ``x.dtype`` parameters, y and the hidden
    activation rounded to ``x.dtype``, f32 accumulation, f32 epilogue."""
    dt = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    y = (y * ln_w.float() + ln_b.float()).to(dt).float()
    h = y @ w_in.float().t() + b_in.float()
    h = quick_gelu(h).to(dt).float()
    return (x32 + h @ w_out.float().t() + b_out.float()).to(dt)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("ln_mlp")
    for fn in (lib.ln_mlp_bf16, lib.ln_mlp_f32):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(x, ln_w, ln_b, w_in, b_in, w_out, b_out) -> None:
    if x.dim() != 2:
        raise ValueError(f"ln_mlp takes x of shape [R, W], got {tuple(x.shape)}")
    R, W = x.shape
    H = w_in.shape[0]
    want = {"ln_w": (W,), "ln_b": (W,), "w_in": (H, W), "b_in": (H,), "w_out": (W, H), "b_out": (W,)}
    got = {"ln_w": ln_w, "ln_b": ln_b, "w_in": w_in, "b_in": b_in, "w_out": w_out, "b_out": b_out}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ln_mlp: {name} has shape {tuple(t.shape)}, expected {want[name]}")
    for name, t in {"x": x, **got}.items():
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"ln_mlp: {name} is {t.dtype} on {t.device}, expected {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ln_mlp: {name} must be contiguous")
        if t.data_ptr() % 32:
            raise ValueError(f"ln_mlp: {name} must be 32-byte aligned")
    if x.dtype == torch.bfloat16:
        if W % 128 or W > 1024:
            raise ValueError(f"ln_mlp (bf16) needs W % 128 == 0 and W <= 1024, got W={W}")
    elif x.dtype == torch.float32:
        if W > 1024:
            raise ValueError(f"ln_mlp (f32) needs W <= 1024, got W={W}")
    else:
        raise ValueError(f"ln_mlp takes bfloat16 or float32, got {x.dtype}")
    if H % 128:
        raise ValueError(f"ln_mlp needs H % 128 == 0, got H={H}")


def _forward(x, ln_w, ln_b, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return ln_mlp_plain(x, ln_w, ln_b, w_in, b_in, w_out, b_out)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mlp runs on CUDA or CPU tensors, got {x.device}")
    _check(x, ln_w, ln_b, w_in, b_in, w_out, b_out)
    R, W = x.shape
    H = w_in.shape[0]
    out = torch.empty_like(x)
    if R == 0:
        return out
    lib = _lib()
    fn = lib.ln_mlp_bf16 if x.dtype == torch.bfloat16 else lib.ln_mlp_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
            w_out.data_ptr(), b_out.data_ptr(), out.data_ptr(), R, W, H, stream,
        )
    _build.check(rc, "ln_mlp")
    ln_mlp.launches += 1
    return out


def plain_vjp(plain, saved, grad):
    """The gradients of ``plain(*saved)`` against every saved input, for
    ``grad`` of its output: the plain op chain recomputed with autograd."""
    inputs = [t.detach().requires_grad_() for t in saved]
    with torch.enable_grad():
        out = plain(*inputs)
    return torch.autograd.grad(out, inputs, grad)


class _LnMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _forward(*args)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(ln_mlp_plain, ctx.saved_tensors, grad)


def ln_mlp(x, ln_w, ln_b, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """x: [R, W] -> x + MLP(LN(x)), same shape and dtype; differentiable in
    x and all six parameters."""
    return _LnMlp.apply(x, ln_w, ln_b, w_in, b_in, w_out, b_out)


ln_mlp.launches = 0
