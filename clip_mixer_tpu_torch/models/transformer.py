"""Pre-LN transformer block and tower (the reference's attention variant).

Counterpart of ``clip_mixer_tpu/models/transformer.py``: pre-LN multi-head
attention with a packed QKV projection (``nn.MultiheadAttention``'s
``in_proj_weight`` [3W, W] and ``in_proj_bias``, then ``out_proj``), then a
pre-LN 4x MLP with QuickGELU (``mlp.c_fc``, ``mlp.c_proj``). The text tower
adds an additive upper-triangular -inf causal mask.

Attention is plain products, op for op the JAX chain: the scores are
multiplied by the scale in the compute dtype, cast to f32 for the mask and
the softmax, and cast back before the product with v. A fused attention
(``scaled_dot_product_attention``) keeps the scores in f32 throughout, which
is another result. The MLP is the model's unfused channel mix
(``models/layers.py::channel_mlp``); ``CLIPConfig.fused_mlp`` applies to
mixer blocks only, as in the JAX package.

With a remat policy each block runs under ``torch.utils.checkpoint``, as the
mixer tower's do (``models/mixer.py``): ``mlp_hidden`` keeps the MLP's
hidden product, and so does ``all_hidden`` (a transformer block has no token
hidden). Parameter names follow the reference state dict
(``resblocks.{i}.ln_1``, ``.attn.in_proj_weight``, ``.attn.out_proj``,
``.ln_2``, ``.mlp.c_fc``, ``.mlp.c_proj``).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from clip_mixer_tpu_torch.models.layers import (
    LayerNorm,
    channel_mlp,
    init_linear_normal,
    init_linear_torch_default,
    layer_norm,
)
from clip_mixer_tpu_torch.models.mixer import remat_context_fn
from clip_mixer_tpu_torch.parallel.tp import tp_attention, tp_channel_mlp


def attention_heads_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, H, T, hd] q, k, v -> [B, H, T, hd]: the one chain of scaled scores
    and f32 softmax, which the float and the int8 blocks and the calibration
    share. The scale is rounded to the compute dtype first, as JAX rounds a
    Python float that multiplies a bf16 array."""
    dt = q.dtype
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=dt).item()
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    scores = scores.float()
    if mask is not None:
        scores = scores + mask.float()
    attn = torch.softmax(scores, dim=-1).to(dt)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


def attention_core(qkv: torch.Tensor, n_heads: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Packed QKV [B, T, 3W] -> the heads' outputs concatenated [B, T, W]
    (the input of the out-projection)."""
    B, T, W3 = qkv.shape
    W = W3 // 3
    q, k, v = qkv.split(W, dim=-1)

    def heads(t):  # [B, T, W] -> [B, H, T, hd]
        return t.reshape(B, T, n_heads, W // n_heads).transpose(1, 2)

    out = attention_heads_core(heads(q), heads(k), heads(v), mask)
    return out.transpose(1, 2).reshape(B, T, W)


class Attention(nn.Module):
    """The packed-QKV parameters of ``nn.MultiheadAttention`` under its
    names; the forward is :func:`multi_head_attention`."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


def multi_head_attention(attn: Attention, x: torch.Tensor, n_heads: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Packed-QKV MHA on x [B, T, W] with the weights cast to ``x.dtype``;
    ``mask`` additive [T, T] or None."""
    dt = x.dtype
    qkv = x @ attn.in_proj_weight.to(dt).t() + attn.in_proj_bias.to(dt)
    out = attention_core(qkv, n_heads, mask)
    return out @ attn.out_proj.weight.to(dt).t() + attn.out_proj.bias.to(dt)


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class ResidualAttentionBlock(nn.Module):
    """x + MHA(LN_1(x)), then + MLP(LN_2(x)), on x [B, T, W]. With
    ``model_group`` (set by ``parallel/tp.py::shard_model_tp``) attention
    is split by heads and the MLP by its hidden dimension over that group,
    as in JAX."""

    def __init__(self, width: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.model_group = None
        self.ln_1 = LayerNorm(width)
        self.attn = Attention(width)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        m, g = self.mlp, self.model_group
        if g is not None:
            y = layer_norm(x, self.ln_1.weight, self.ln_1.bias)
            x = x + tp_attention(self.attn, y, x.shape[-1] // self.n_heads, mask, g)
            return tp_channel_mlp(x, self.ln_2.weight, self.ln_2.bias, m.c_fc.weight, m.c_fc.bias, m.c_proj.weight,
                                  m.c_proj.bias, g)
        x = x + multi_head_attention(self.attn, layer_norm(x, self.ln_1.weight, self.ln_1.bias), self.n_heads, mask)
        # the MLP's hidden product carries the "mlp_hidden" tag (remat)
        return channel_mlp(x, self.ln_2.weight, self.ln_2.bias, m.c_fc.weight, m.c_fc.bias, m.c_proj.weight,
                           m.c_proj.bias)


@torch.no_grad()
def init_attention_block(block: ResidualAttentionBlock, text_tower: bool, n_layers: int,
                         generator: torch.Generator) -> None:
    """text_tower=True: the reference's explicit normals (QKV std w^-1/2,
    out and c_proj std w^-1/2 (2L)^-1/2, c_fc std (2w)^-1/2; biases
    torch-default). text_tower=False: torch's Linear default everywhere
    (the reference never re-initialises the vision tower's blocks)."""
    width = block.ln_1.normalized_shape[0]
    # the packed QKV as the init helpers read a linear
    qkv = SimpleNamespace(weight=block.attn.in_proj_weight, bias=block.attn.in_proj_bias, in_features=width)
    linears = (qkv, block.attn.out_proj, block.mlp.c_fc, block.mlp.c_proj)
    if text_tower:
        proj_std = (width**-0.5) * ((2 * n_layers) ** -0.5)
        stds = (width**-0.5, proj_std, (2 * width) ** -0.5, proj_std)
        for lin, std in zip(linears, stds):
            init_linear_normal(lin, std, generator)
    else:
        for lin in linears:
            init_linear_torch_default(lin, generator)
    for ln in (block.ln_1, block.ln_2):
        ln.weight.fill_(1.0)
        ln.bias.zero_()


def causal_mask(context_length: int, device=None) -> torch.Tensor:
    """Additive upper-triangular -inf mask [T, T], f32."""
    return torch.full((context_length, context_length), float("-inf"), device=device).triu(1)


class TransformerTower(nn.Module):
    """``n_layers`` blocks applied in order to x [B, T, W]; ``context_length``
    (the text tower) adds the causal mask, held as a buffer outside the state
    dict. With ``remat_policy`` (a ``REMAT_KEEPS`` name; None = no remat)
    each block is rematerialised whenever autograd records. With
    ``pipeline`` (``parallel/pp.py::shard_model_pp``) the blocks run through
    the GPipe schedule, as the mixer tower's do."""

    def __init__(self, width: int, n_layers: int, n_heads: int, context_length: Optional[int] = None,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, n_heads) for _ in range(n_layers))
        self.register_buffer("attn_mask", None if context_length is None else causal_mask(context_length),
                             persistent=False)
        self.remat_contexts = remat_context_fn(remat_policy)
        self.pipeline = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pipeline is not None:
            from clip_mixer_tpu_torch.parallel.pp import pipeline_tower

            return pipeline_tower(x, self.run_blocks, self.pipeline)
        return self.run_blocks(x)

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks this module holds, in order, on x."""
        remat = self.remat_contexts is not None and torch.is_grad_enabled()
        for block in self.resblocks:
            if remat:  # the blocks compute nothing random
                x = checkpoint(block, x, self.attn_mask, use_reentrant=False, context_fn=self.remat_contexts,
                               preserve_rng_state=False)
            else:
                x = block(x, self.attn_mask)
        return x


def init_transformer_tower(tower: TransformerTower, text_tower: bool, generator: torch.Generator) -> None:
    n = len(tower.resblocks)
    for block in tower.resblocks:
        init_attention_block(block, text_tower, n, generator)
