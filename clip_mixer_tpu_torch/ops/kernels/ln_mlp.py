"""Fused LN + channel MLP: ``x + QuickGELU(LN(x) W_in^T + b_in) W_out^T + b_out``.

Replaces ``clip_mixer_tpu/ops/pallas/mlp_kernel.py::fused_ln_mlp``. The CUDA
kernels are ``csrc/ln_mlp.cu`` and the GEMM of ``csrc/gemm_sm90.cuh`` (their
headers say what bounds them on an H100 and how the design answers that).
:func:`ln_mlp` launches them for CUDA tensors and raises on what they do not
take; it uses :func:`ln_mlp_plain` only for tensors on the CPU.

In bf16 a call is three launches on the current stream: :func:`ln_rows`
(y = LN(x) in bf16), :func:`linear_gelu` (h = QuickGELU(y W_in^T + b_in) in
bf16) and :func:`linear_residual` (x + h W_out^T + b_out), with y and h in
scratch that :func:`ln_mlp` allocates. Each stage is a wrapper of its own
with its plain version (``*_plain``), for the checks on the card; the three
plain versions composed are :func:`ln_mlp_plain`, bit for bit.

Weights are in ``nn.Linear``'s (out, in) layout: ``w_in`` [H, W], ``w_out``
[W, H]. The kernels and the ``*_plain`` versions take every parameter already
cast to ``x.dtype`` (the LN scale and bias too, as the TPU kernel casts them).
:func:`ln_mlp` is differentiable, as the JAX ``custom_vjp`` is, and takes the
parameters as the model holds them (the f32 masters): its forward casts them
to ``x.dtype`` and runs the kernels, and its backward is the VJP of the
model's unfused channel mix (``models.layers.channel_mlp``: LN with its f32
affine, the weights cast to ``x.dtype``), recomputed on the saved masters.
That is the counterpart of the JAX backward, the VJP of ``_plain_ln_mlp``;
the kernel-rounding chain :func:`ln_mlp_plain` is the forward's plain
version only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from clip_mixer_tpu_torch.models.layers import channel_mlp, quick_gelu
from clip_mixer_tpu_torch.ops.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entries of csrc/ln_mlp.cu: pointers, then sizes, then the stream
_ARGTYPES = {
    "ln_mlp_bf16": [_P] * 10 + [_I] * 3 + [_P],  # x, 6 parameters, out, y, h; R, W, H
    "ln_mlp_f32": [_P] * 8 + [_I] * 3 + [_P],  # x, 6 parameters, out; R, W, H
    "ln_mlp_ln_rows": [_P] * 4 + [_I] * 2 + [_P],  # x, ln_w, ln_b, y; R, W
    "ln_mlp_linear_gelu": [_P] * 4 + [_I] * 3 + [_P],  # y, w_in, b_in, h; R, H, W
    "ln_mlp_linear_residual": [_P] * 5 + [_I] * 3 + [_P],  # h, w_out, b_out, x, out; R, W, H
}


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


def ln_rows_plain(x, ln_w, ln_b) -> torch.Tensor:
    """Stage 1 of :func:`ln_mlp_plain`: y = LN(x) in f32 with the affine
    from ``x.dtype`` parameters, rounded to ``x.dtype``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (y * ln_w.float() + ln_b.float()).to(x.dtype)


def linear_gelu_plain(y, w_in, b_in) -> torch.Tensor:
    """Stage 2: h = QuickGELU(y W_in^T + b_in), f32 sums, rounded to ``y.dtype``."""
    h = y.float() @ w_in.float().t() + b_in.float()
    return quick_gelu(h).to(y.dtype)


def linear_residual_plain(h, w_out, b_out, x) -> torch.Tensor:
    """Stage 3: x + h W_out^T + b_out, f32 sums and epilogue, rounded to ``x.dtype``."""
    return (x.float() + h.float() @ w_out.float().t() + b_out.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("ln_mlp")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_tensors(what, dtype, device, want, got) -> None:
    """Shapes as ``want``; all of ``dtype`` on ``device``, contiguous and 32-byte aligned."""
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {want[name]}")
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, expected {dtype} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 32:
            raise ValueError(f"{what}: {name} must be 32-byte aligned")


def _check_widths(what, dtype, W, H=None) -> None:
    """The widths the kernels take: bf16 W % 128 == 0 and W <= 1024 (the LN
    pass's row templates), f32 W <= 1024, H % 128 == 0 (when given)."""
    if dtype == torch.bfloat16:
        if W % 128 or W > 1024:
            raise ValueError(f"{what} (bf16) needs W % 128 == 0 and W <= 1024, got W={W}")
    elif dtype == torch.float32:
        if W > 1024:
            raise ValueError(f"{what} (f32) needs W <= 1024, got W={W}")
    else:
        raise ValueError(f"{what} takes bfloat16 or float32, got {dtype}")
    if H is not None and H % 128:
        raise ValueError(f"{what} needs H % 128 == 0, got H={H}")


def _check(x, ln_w, ln_b, w_in, b_in, w_out, b_out) -> None:
    if x.dim() != 2:
        raise ValueError(f"ln_mlp takes x of shape [R, W], got {tuple(x.shape)}")
    R, W = x.shape
    H = w_in.shape[0]
    want = {"x": (R, W), "ln_w": (W,), "ln_b": (W,), "w_in": (H, W), "b_in": (H,), "w_out": (W, H), "b_out": (W,)}
    got = {"x": x, "ln_w": ln_w, "ln_b": ln_b, "w_in": w_in, "b_in": b_in, "w_out": w_out, "b_out": b_out}
    _check_tensors("ln_mlp", x.dtype, x.device, want, got)
    _check_widths("ln_mlp", x.dtype, W, H)


def _launch(entry, what, device, *args) -> None:
    """Call the C entry on the current stream of ``device`` and raise on its error code."""
    with torch.cuda.device(device):
        rc = getattr(_lib(), entry)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, what)


def _on_card(what, x) -> bool:
    """False for CPU tensors (the plain version runs), True for CUDA ones."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {x.device}")
    return True


def _forward(x, ln_w, ln_b, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """The kernels on CUDA tensors, the plain version on CPU tensors."""
    if not _on_card("ln_mlp", x):
        return ln_mlp_plain(x, ln_w, ln_b, w_in, b_in, w_out, b_out)
    _check(x, ln_w, ln_b, w_in, b_in, w_out, b_out)
    R, W = x.shape
    H = w_in.shape[0]
    out = torch.empty_like(x)
    if R == 0:
        return out
    params = [t.data_ptr() for t in (x, ln_w, ln_b, w_in, b_in, w_out, b_out)]
    if x.dtype == torch.bfloat16:
        y, h = torch.empty_like(x), torch.empty((R, H), dtype=x.dtype, device=x.device)
        _launch("ln_mlp_bf16", "ln_mlp", x.device, *params, out.data_ptr(), y.data_ptr(), h.data_ptr(), R, W, H)
    else:
        _launch("ln_mlp_f32", "ln_mlp", x.device, *params, out.data_ptr(), R, W, H)
    ln_mlp.launches += 1
    return out


def ln_rows(x, ln_w, ln_b) -> torch.Tensor:
    """Stage 1 alone (bf16 on the card): y = LN(x), [R, W]."""
    if not _on_card("ln_rows", x):
        return ln_rows_plain(x, ln_w, ln_b)
    R, W = x.shape
    _check_tensors("ln_rows", torch.bfloat16, x.device, {"x": (R, W), "ln_w": (W,), "ln_b": (W,)},
                   {"x": x, "ln_w": ln_w, "ln_b": ln_b})
    _check_widths("ln_rows", x.dtype, W)
    y = torch.empty_like(x)
    if R:
        _launch("ln_mlp_ln_rows", "ln_rows", x.device, x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                y.data_ptr(), R, W)
        ln_rows.launches += 1
    return y


def linear_gelu(y, w_in, b_in) -> torch.Tensor:
    """Stage 2 alone (bf16 on the card): h = QuickGELU(y W_in^T + b_in), [R, H]."""
    if not _on_card("linear_gelu", y):
        return linear_gelu_plain(y, w_in, b_in)
    R, W = y.shape
    H = w_in.shape[0]
    _check_tensors("linear_gelu", torch.bfloat16, y.device, {"y": (R, W), "w_in": (H, W), "b_in": (H,)},
                   {"y": y, "w_in": w_in, "b_in": b_in})
    _check_widths("linear_gelu", y.dtype, W, H)
    h = torch.empty((R, H), dtype=y.dtype, device=y.device)
    if R:
        _launch("ln_mlp_linear_gelu", "linear_gelu", y.device, y.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
                h.data_ptr(), R, H, W)
        linear_gelu.launches += 1
    return h


def linear_residual(h, w_out, b_out, x) -> torch.Tensor:
    """Stage 3 alone (bf16 on the card): x + h W_out^T + b_out, [R, W]."""
    if not _on_card("linear_residual", h):
        return linear_residual_plain(h, w_out, b_out, x)
    R, H = h.shape
    W = w_out.shape[0]
    _check_tensors("linear_residual", torch.bfloat16, h.device,
                   {"h": (R, H), "w_out": (W, H), "b_out": (W,), "x": (R, W)},
                   {"h": h, "w_out": w_out, "b_out": b_out, "x": x})
    _check_widths("linear_residual", h.dtype, W, H)
    out = torch.empty_like(x)
    if R:
        _launch("ln_mlp_linear_residual", "linear_residual", h.device, h.data_ptr(), w_out.data_ptr(),
                b_out.data_ptr(), x.data_ptr(), out.data_ptr(), R, W, H)
        linear_residual.launches += 1
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
    def forward(ctx, x, *params):
        ctx.save_for_backward(x, *params)
        return _forward(x, *(p.to(x.dtype) for p in params))

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(channel_mlp, ctx.saved_tensors, grad)


def ln_mlp(x, ln_w, ln_b, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """x: [R, W] -> x + MLP(LN(x)), same shape and dtype; differentiable in
    x and all six parameters, which it casts to ``x.dtype`` for the kernels
    (gradients reach them in their own dtype)."""
    return _LnMlp.apply(x, ln_w, ln_b, w_in, b_in, w_out, b_out)


ln_mlp.launches = 0
ln_rows.launches = 0
linear_gelu.launches = 0
linear_residual.launches = 0
