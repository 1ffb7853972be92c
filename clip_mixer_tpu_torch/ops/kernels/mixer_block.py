"""A whole mixer block in one kernel: token mix, then channel mix.

Replaces ``clip_mixer_tpu/ops/pallas/block_kernel.py::fused_mixer_block_tbd``
and keeps its names:

- :func:`fused_mixer_block_tbd` runs one block on x [T, B, D] (the JAX
  layout). It launches the CUDA kernel ``csrc/mixer_block.cu`` for CUDA
  tensors (its header says what bounds it on an H100 and how the design
  answers that) and raises on what it does not take; it uses
  :func:`mixer_block_plain` only for tensors on the CPU.
- :func:`mixer_block_fused` is the differentiable form, as the JAX
  ``custom_vjp``: the kernel forward, the VJP of the plain chain backward.
- :func:`mixer_tower_fused` is the drop-in for ``MixerTower.forward`` on x
  [B, T, D]. No config field reaches it: a caller routes a tower through it.

The kernel reads the token and sample strides of x, so the tower hands it
the [B, T, D] activations as a [T, B, D] view and nothing is transposed in
memory. The JAX wrapper's ``batch_tile`` and ``hidden_chunks`` pick the TPU's
VMEM tiles and do not change the result; the CUDA kernel takes any B, so
they have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from clip_mixer_tpu_torch.models.layers import layer_norm, quick_gelu
from clip_mixer_tpu_torch.ops.kernels import _build
from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp_plain, plain_vjp

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _L, _L, _I, _I, _I, _I, _I] + [_P] * 12 + [_P]

_NAMES = (
    "layerNorm1.weight", "layerNorm1.bias", "lin1.weight", "lin1.bias", "lin2.weight", "lin2.bias",
    "layerNorm2.weight", "layerNorm2.bias", "lin3.weight", "lin3.bias", "lin4.weight", "lin4.bias",
)
# The kernel's limits (csrc/mixer_block.cu): the padded token count
# T_pad = 16 * ceil(T / 16) rows of f32 accumulators live in registers in
# bf16, at most five row tiles and 24 fragments of 16 x 16 a warp
# (T_pad / 16 * D / 128 <= 24), and the padded token weights in shared memory.
MAX_TOKENS = 80
MAX_TOKEN_HIDDEN = 320


def block_params(block, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """A ``MixerBlock``'s twelve parameters cast to ``dtype``, in the
    kernel's order (as the TPU kernel casts them, LN parameters too).
    Linear weights stay in ``nn.Linear``'s (out, in) layout: the token
    weights are [U, T] and [T, U], the channel weights [H, D] and [D, H]."""
    tm, cm = block.token_mix_seq, block.channel_mix_seq
    ts = (
        block.layerNorm1.weight, block.layerNorm1.bias, tm.lin1.weight, tm.lin1.bias, tm.lin2.weight, tm.lin2.bias,
        block.layerNorm2.weight, block.layerNorm2.bias, cm.lin3.weight, cm.lin3.bias, cm.lin4.weight, cm.lin4.bias,
    )
    return tuple(t.to(dtype) for t in ts)


def _plain(x, lt_w, lt_b, w1, b1, w2, b2, lc_w, lc_b, w3, b3, w4, b4) -> torch.Tensor:
    """The TPU kernel's arithmetic on x [T, B, D], with its rounding points:
    LN_tok in f32, y rounded to x.dtype; the token hidden an f32 sum plus the
    bias, QuickGELU in f32, rounded; the token output an f32 sum plus the
    bias; z = f32(x) + tok rounded once; then exactly ``ln_mlp_plain``."""
    T, B, D = x.shape
    dt = x.dtype
    x32 = x.float()
    y = layer_norm(x32, lt_w, lt_b).to(dt).float()
    h = torch.einsum("ut,tbd->ubd", w1.float(), y) + b1.float()[:, None, None]
    h = quick_gelu(h).to(dt).float()
    tok = torch.einsum("tu,ubd->tbd", w2.float(), h) + b2.float()[:, None, None]
    z = (x32 + tok).to(dt)
    return ln_mlp_plain(z.reshape(T * B, D), lc_w, lc_b, w3, b3, w4, b4).reshape(T, B, D)


def mixer_block_plain(block, x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, x [T, B, D]. Not the port's
    unfused ``MixerBlock.forward``, which rounds the token mix at other
    places in bf16."""
    return _plain(x, *block_params(block, x.dtype))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("mixer_block")
    for fn in (lib.mixer_block_bf16, lib.mixer_block_f32):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(x, params) -> None:
    if x.dim() != 3:
        raise ValueError(f"fused_mixer_block_tbd takes x of shape [T, B, D], got {tuple(x.shape)}")
    T, B, D = x.shape
    U, H = params[2].shape[0], params[8].shape[0]
    want = ((D,), (D,), (U, T), (U,), (T, U), (T,), (D,), (D,), (H, D), (H,), (D, H), (D,))
    for name, t, shape in zip(_NAMES, params, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_mixer_block_tbd: {name} has shape {tuple(t.shape)}, expected {shape}")
    for name, t in zip(("x",) + _NAMES, (x,) + tuple(params)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"fused_mixer_block_tbd: {name} is {t.dtype} on {t.device}, expected {x.dtype} on {x.device}"
            )
        if t.data_ptr() % 32:
            raise ValueError(f"fused_mixer_block_tbd: {name} must be 32-byte aligned")
    if not all(t.is_contiguous() for t in params):
        raise ValueError("fused_mixer_block_tbd: the parameters must be contiguous")
    if x.stride() not in ((B * D, D, 1), (D, T * D, 1)):
        raise ValueError(
            f"fused_mixer_block_tbd: x must be a contiguous [T, B, D] or a [T, B, D] view of a contiguous "
            f"[B, T, D], got strides {x.stride()}"
        )
    if T > MAX_TOKENS or U > MAX_TOKEN_HIDDEN:
        raise ValueError(f"fused_mixer_block_tbd needs T <= {MAX_TOKENS} and U <= {MAX_TOKEN_HIDDEN}, got T={T} U={U}")
    if H % 128:
        raise ValueError(f"fused_mixer_block_tbd needs H % 128 == 0, got H={H}")
    if x.dtype == torch.bfloat16:
        if D % 128 or D > 1024:
            raise ValueError(f"fused_mixer_block_tbd (bf16) needs D % 128 == 0 and D <= 1024, got D={D}")
        row_tiles = min(5, 24 // (D // 128))
        if T > 16 * row_tiles:
            raise ValueError(f"fused_mixer_block_tbd (bf16) at D={D} needs T <= {16 * row_tiles}, got T={T}")
    elif x.dtype == torch.float32:
        if D > 1024:
            raise ValueError(f"fused_mixer_block_tbd (f32) needs D <= 1024, got D={D}")
    else:
        raise ValueError(f"fused_mixer_block_tbd takes bfloat16 or float32, got {x.dtype}")


def _forward(x, *params) -> torch.Tensor:
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return _plain(x, *params)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mixer_block_tbd runs on CUDA or CPU tensors, got {x.device}")
    _check(x, params)
    T, B, D = x.shape
    U, H = params[2].shape[0], params[8].shape[0]
    # the output keeps x's layout, so a tower's activations stay [B, T, D]
    out = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    lib = _lib()
    fn = lib.mixer_block_bf16 if x.dtype == torch.bfloat16 else lib.mixer_block_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            x.data_ptr(), out.data_ptr(), x.stride(0), x.stride(1), B, T, U, D, H,
            *(t.data_ptr() for t in params), stream,
        )
    _build.check(rc, "fused_mixer_block_tbd")
    fused_mixer_block_tbd.launches += 1
    return out


def fused_mixer_block_tbd(block, x: torch.Tensor) -> torch.Tensor:
    """One mixer block on x [T, B, D] (token-major, as the JAX function);
    the result has x's shape, dtype and strides. Not differentiable on the
    card: :func:`mixer_block_fused` is."""
    return _forward(x, *block_params(block, x.dtype))


fused_mixer_block_tbd.launches = 0


class _MixerBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *params):
        ctx.save_for_backward(x, *params)
        return _forward(x, *params)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(_plain, ctx.saved_tensors, grad)


def mixer_block_fused(block, x: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`fused_mixer_block_tbd`: gradients reach x and,
    through the casts, the block's f32 master parameters."""
    return _MixerBlock.apply(x, *block_params(block, x.dtype))


def mixer_tower_fused(tower, x: torch.Tensor) -> torch.Tensor:
    """Every block of ``tower`` (a ``MixerTower``) through
    :func:`mixer_block_fused`, on x [B, T, D]: the drop-in for
    ``tower(x)``."""
    h = x.transpose(0, 1)  # [T, B, D] view; the kernel reads its strides
    for block in tower.mixBlocks:
        h = mixer_block_fused(block, h)
    return h.transpose(0, 1)
