"""A whole mixer block: token mix, then channel mix.

Replaces ``clip_mixer_tpu/ops/pallas/block_kernel.py::fused_mixer_block_tbd``
and keeps its names:

- :func:`fused_mixer_block_tbd` runs one block on x [T, B, D] (the JAX
  layout). It launches the CUDA kernels of ``csrc/mixer_block.cu`` for CUDA
  tensors (its header says what bounds them on an H100 and how the design
  answers that) and raises on what they do not take; it uses
  :func:`mixer_block_plain` only for tensors on the CPU.
- :func:`mixer_block_fused` is the differentiable form, as the JAX
  ``custom_vjp``: the kernels forward, the VJP of the plain chain backward.
- :func:`mixer_tower_fused` is the drop-in for ``MixerTower.forward`` on x
  [B, T, D]. No config field reaches it: a caller routes a tower through it.

In bf16 a block is three launches on the current stream: the token kernel
(:func:`token_mix`: z = x + the token MLP, and y2 = LN_ch(z)), then
``ln_mlp``'s two GEMMs on y2 (``gemm_sm90.cuh``, with the QuickGELU and the
residual epilogues), the second in place on z. The token stage is a wrapper
of its own with its plain version, :func:`token_mix_plain`; that plain
version followed by ``ln_mlp``'s plain GEMM stages is
:func:`mixer_block_plain`, bit for bit. In f32 a block is one launch.

The kernels read the token and sample strides of x, so the tower hands them
the [B, T, D] activations as a [T, B, D] view and nothing is transposed in
memory. The JAX wrapper's ``batch_tile`` and ``hidden_chunks`` pick the TPU's
VMEM tiles and do not change the result; the CUDA kernels take any B, so
they have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from clip_mixer_tpu_torch.models.layers import layer_norm, quick_gelu
from clip_mixer_tpu_torch.ops.kernels import _build
from clip_mixer_tpu_torch.ops.kernels.ln_mlp import _on_card, ln_mlp_plain, ln_rows_plain, plain_vjp

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entries of csrc/mixer_block.cu: pointers, strides and sizes, then the stream
_ARGTYPES = {
    # x, out, ts, ss, B, T, U, D, H, 12 parameters, y2, h
    "mixer_block_bf16": [_P, _P, _L, _L, _I, _I, _I, _I, _I] + [_P] * 14 + [_P],
    # x, out, ts, ss, B, T, U, D, H, 12 parameters
    "mixer_block_f32": [_P, _P, _L, _L, _I, _I, _I, _I, _I] + [_P] * 12 + [_P],
    # x, z, y2, ts, ss, B, T, U, D, 8 parameters (LN_tok, W1, b1, W2, b2, LN_ch)
    "mixer_block_token_mix": [_P, _P, _P, _L, _L, _I, _I, _I, _I] + [_P] * 8 + [_P],
    "mixer_block_linear_gelu": [_P] * 4 + [_I] * 3 + [_P],  # y2, w3, b3, h; R, H, D
    "mixer_block_linear_residual": [_P] * 4 + [_I] * 3 + [_P],  # h, w4, b4, out; R, D, H
}

_NAMES = (
    "layerNorm1.weight", "layerNorm1.bias", "lin1.weight", "lin1.bias", "lin2.weight", "lin2.bias",
    "layerNorm2.weight", "layerNorm2.bias", "lin3.weight", "lin3.bias", "lin4.weight", "lin4.bias",
)
# The kernels' limits (csrc/mixer_block.cu). T <= 80: in bf16 the token
# kernel's output accumulators, T_pad / 2 <= 40 registers a thread
# (T_pad = 16 ceil(T / 16)); in f32 its shared memory, as U <= 320. In bf16
# U has no limit of its own: the token kernel holds the sample's x, the
# padded token weights and four Y^T slices in shared memory, which
# token_smem_bytes counts and SMEM_MAX bounds; D % 128 == 0 and D <= 1024
# (the GEMM tiles, the LN rows a warp holds), H % 128 == 0.
MAX_TOKENS = 80
MAX_TOKEN_HIDDEN = 320
SMEM_MAX = 232448  # 227 KB, the most one block may opt into on an H100


def token_smem_bytes(T: int, U: int, D: int) -> int:
    """The bf16 token kernel's shared memory in bytes (``TokenSmem`` of
    ``csrc/mixer_block.cu``): x [T, D + 8] bf16; W1 and W2 padded to
    [U_pad, T_pad] and [T_pad, U_pad] bf16 (U_pad = 64 ceil(U / 64)) and
    four Y^T slices [64, T_pad] bf16 (one a warpgroup), each in the
    core-matrix layout (8-column groups of R_pad + 1 rows of 16 bytes); b1
    [U_pad] and b2, mean, 1/std [T_pad] f32; an mbarrier; 128 bytes of
    alignment slack."""
    def a128(n):
        return -(-n // 128) * 128

    def operand(rows_pad, k_pad):
        return k_pad // 8 * (rows_pad + 1) * 16

    tp, up = -(-T // 16) * 16, -(-U // 64) * 64
    n = a128(T * (D + 8) * 2)
    n = a128(n + operand(up, tp))
    n = a128(n + operand(tp, up))
    n = a128(n + 4 * operand(64, tp))
    return n + up * 4 + 3 * tp * 4 + 8 + 128


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


def _token_half(x, lt_w, lt_b, w1, b1, w2, b2) -> torch.Tensor:
    """z = x + the token MLP on x [T, B, D], with the TPU kernel's rounding
    points: LN_tok in f32, y rounded to x.dtype; the token hidden an f32 sum
    plus the bias, QuickGELU in f32, rounded; the token output an f32 sum
    plus the bias; z = f32(x) + tok rounded once."""
    dt = x.dtype
    x32 = x.float()
    y = layer_norm(x32, lt_w, lt_b).to(dt).float()
    h = torch.einsum("ut,tbd->ubd", w1.float(), y) + b1.float()[:, None, None]
    h = quick_gelu(h).to(dt).float()
    tok = torch.einsum("tu,ubd->tbd", w2.float(), h) + b2.float()[:, None, None]
    return (x32 + tok).to(dt)


def token_mix_plain(x, lt_w, lt_b, w1, b1, w2, b2, lc_w, lc_b) -> Tuple[torch.Tensor, torch.Tensor]:
    """The token kernel's arithmetic on x [T, B, D]: z = x + the token MLP
    (:func:`_token_half`'s rounding points) and y2 = LN_ch(z) as
    ``ln_rows_plain``. Returns (z, y2), both [T, B, D]."""
    T, B, D = x.shape
    z = _token_half(x, lt_w, lt_b, w1, b1, w2, b2)
    return z, ln_rows_plain(z.reshape(T * B, D), lc_w, lc_b).reshape(T, B, D)


def _plain(x, lt_w, lt_b, w1, b1, w2, b2, lc_w, lc_b, w3, b3, w4, b4) -> torch.Tensor:
    """The TPU kernel's arithmetic on x [T, B, D]: the token half, then
    exactly ``ln_mlp_plain`` on z. Bit for bit, that is :func:`token_mix_plain`
    followed by ``ln_mlp``'s plain GEMM stages (``linear_gelu_plain`` on y2,
    ``linear_residual_plain`` on z), the bf16 block's three launches."""
    T, B, D = x.shape
    z = _token_half(x, lt_w, lt_b, w1, b1, w2, b2)
    return ln_mlp_plain(z.reshape(T * B, D), lc_w, lc_b, w3, b3, w4, b4).reshape(T, B, D)


def mixer_block_plain(block, x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, x [T, B, D]. Not the port's
    unfused ``MixerBlock.forward``, which rounds the token mix at other
    places in bf16."""
    return _plain(x, *block_params(block, x.dtype))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("mixer_block")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(what, x, params) -> None:
    """x [T, B, D] in one of the two layouts, and ``params`` (the first
    ``len(params)`` of the twelve, in order) of x's shape, dtype and device,
    contiguous and 32-byte aligned; the widths the kernels take."""
    if x.dim() != 3:
        raise ValueError(f"{what} takes x of shape [T, B, D], got {tuple(x.shape)}")
    T, B, D = x.shape
    U = params[2].shape[0]
    H = params[8].shape[0] if len(params) > 8 else None
    want = ((D,), (D,), (U, T), (U,), (T, U), (T,), (D,), (D,), (H, D), (H,), (D, H), (D,))
    for name, t, shape in zip(_NAMES, params, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
    for name, t in zip(("x",) + _NAMES, (x,) + tuple(params)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, expected {x.dtype} on {x.device}")
        if t.data_ptr() % 32:
            raise ValueError(f"{what}: {name} must be 32-byte aligned")
    if not all(t.is_contiguous() for t in params):
        raise ValueError(f"{what}: the parameters must be contiguous")
    if x.stride() not in ((B * D, D, 1), (D, T * D, 1)):
        raise ValueError(
            f"{what}: x must be a contiguous [T, B, D] or a [T, B, D] view of a contiguous [B, T, D], "
            f"got strides {x.stride()}"
        )
    if H is not None and H % 128:
        raise ValueError(f"{what} needs H % 128 == 0, got H={H}")
    if x.dtype == torch.bfloat16:
        if T > MAX_TOKENS:
            raise ValueError(f"{what} (bf16) needs T <= {MAX_TOKENS}, got T={T}")
        if D % 128 or D > 1024:
            raise ValueError(f"{what} (bf16) needs D % 128 == 0 and D <= 1024, got D={D}")
        smem = token_smem_bytes(T, U, D)
        if smem > SMEM_MAX:
            raise ValueError(
                f"{what} (bf16) needs the token kernel's shared memory <= {SMEM_MAX} bytes, "
                f"got {smem} at T={T} U={U} D={D}"
            )
    elif x.dtype == torch.float32:
        if T > MAX_TOKENS or U > MAX_TOKEN_HIDDEN:
            raise ValueError(f"{what} (f32) needs T <= {MAX_TOKENS} and U <= {MAX_TOKEN_HIDDEN}, got T={T} U={U}")
        if D > 1024:
            raise ValueError(f"{what} (f32) needs D <= 1024, got D={D}")
    else:
        raise ValueError(f"{what} takes bfloat16 or float32, got {x.dtype}")


def _launch(entry, what, device, *args) -> None:
    """Call the C entry on the current stream of ``device`` and raise on its error code."""
    with torch.cuda.device(device):
        rc = getattr(_lib(), entry)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, what)


def _forward(x, *params) -> torch.Tensor:
    """The kernels on CUDA tensors, the plain version on CPU tensors."""
    if not _on_card("fused_mixer_block_tbd", x):
        return _plain(x, *params)
    _check("fused_mixer_block_tbd", x, params)
    T, B, D = x.shape
    U, H = params[2].shape[0], params[8].shape[0]
    # the output keeps x's layout, so a tower's activations stay [B, T, D]
    out = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    args = [x.data_ptr(), out.data_ptr(), x.stride(0), x.stride(1), B, T, U, D, H, *(t.data_ptr() for t in params)]
    if x.dtype == torch.bfloat16:
        # y2 = LN_ch(z) and the channel hidden, in out's row order
        y2 = torch.empty((B * T, D), dtype=x.dtype, device=x.device)
        h = torch.empty((B * T, H), dtype=x.dtype, device=x.device)
        _launch("mixer_block_bf16", "fused_mixer_block_tbd", x.device, *args, y2.data_ptr(), h.data_ptr())
    else:
        _launch("mixer_block_f32", "fused_mixer_block_tbd", x.device, *args)
    fused_mixer_block_tbd.launches += 1
    return out


def token_mix(x, lt_w, lt_b, w1, b1, w2, b2, lc_w, lc_b) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 block's first launch alone (bf16 on the card): (z, y2), z =
    x + the token MLP and y2 = LN_ch(z), both with x's shape and strides, so
    that each is the block's [B*T, D] rows in memory order."""
    params = (lt_w, lt_b, w1, b1, w2, b2, lc_w, lc_b)
    if not _on_card("token_mix", x):
        return token_mix_plain(x, *params)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"token_mix (the bf16 token kernel) takes bfloat16, got {x.dtype}")
    _check("token_mix", x, params)
    T, B, D = x.shape
    z = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
    y2 = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
    if B:
        _launch("mixer_block_token_mix", "token_mix", x.device, x.data_ptr(), z.data_ptr(), y2.data_ptr(),
                x.stride(0), x.stride(1), B, T, w1.shape[0], D, *(t.data_ptr() for t in params))
        token_mix.launches += 1
    return z, y2


def fused_mixer_block_tbd(block, x: torch.Tensor) -> torch.Tensor:
    """One mixer block on x [T, B, D] (token-major, as the JAX function);
    the result has x's shape, dtype and strides. Not differentiable on the
    card: :func:`mixer_block_fused` is."""
    return _forward(x, *block_params(block, x.dtype))


fused_mixer_block_tbd.launches = 0
token_mix.launches = 0


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
