"""MLP-Mixer block and tower.

Counterpart of ``clip_mixer_tpu/models/mixer.py``: a pre-LN token-mixing MLP
(contracting the token axis, expansion x4) and a pre-LN channel-mixing MLP
(expansion x4), both residual, both QuickGELU. The token mix is one einsum
over the token axis (``btw,ut->buw``) with per-token biases, so the width
stays the last dimension for both mixes. The tower is an ``nn.ModuleList``
walked in order (the JAX package scans stacked parameters instead).

Parameter names follow the reference state dict (``mixBlocks.{i}
.layerNorm1``, ``.token_mix_seq.lin1`` ... ``.channel_mix_seq.lin4``), so a
reference checkpoint's keys load directly.
"""

from __future__ import annotations

import torch
from torch import nn

from clip_mixer_tpu_torch.models.layers import (
    LayerNorm,
    block_parameters,
    init_linear_normal,
    init_linear_torch_default,
    mixer_block_chain,
    token_mix_branch,
)
from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp


class TokenMix(nn.Module):
    def __init__(self, tokens: int):
        super().__init__()
        self.lin1 = nn.Linear(tokens, tokens * 4)
        self.lin2 = nn.Linear(tokens * 4, tokens)


class ChannelMix(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.lin3 = nn.Linear(width, width * 4)
        self.lin4 = nn.Linear(width * 4, width)


def token_mix(block: "MixerBlock", x: torch.Tensor) -> torch.Tensor:
    """The token-mixing residual branch of ``block``."""
    return token_mix_branch(x, *block_parameters(block)[:6])


class MixerBlock(nn.Module):
    """One block on x [B, T, W]. ``fused_mlp`` runs the channel mix through
    the fused LN + MLP kernel."""

    def __init__(self, width: int, tokens: int, fused_mlp: bool = False):
        super().__init__()
        self.fused_mlp = fused_mlp
        self.layerNorm1 = LayerNorm(width)
        self.token_mix_seq = TokenMix(tokens)
        self.layerNorm2 = LayerNorm(width)
        self.channel_mix_seq = ChannelMix(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = block_parameters(self)
        if not self.fused_mlp:
            return mixer_block_chain(x, *params)
        x = x + token_mix_branch(x, *params[:6])
        B, T, W = x.shape
        # ln_mlp takes the f32 masters and casts them to x.dtype itself
        return ln_mlp(x.reshape(B * T, W), *params[6:]).reshape(B, T, W)


@torch.no_grad()
def init_mixer_block(block: MixerBlock, text_tower: bool, n_layers: int, generator: torch.Generator) -> None:
    """text_tower=True: the reference's explicit normal init (lin1/lin3 std
    (2w)^-1/2, lin2/lin4 std w^-1/2 (2L)^-1/2, w the text width, biases
    torch-default). text_tower=False: torch-default init everywhere, the
    reference's vision-tower behaviour. LayerNorms start at ones and zeros."""
    tm, cm = block.token_mix_seq, block.channel_mix_seq
    width = block.layerNorm1.normalized_shape[0]
    linears = (tm.lin1, tm.lin2, cm.lin3, cm.lin4)
    if text_tower:
        fc_std = (2 * width) ** -0.5
        proj_std = (width**-0.5) * ((2 * n_layers) ** -0.5)
        for lin, std in zip(linears, (fc_std, proj_std, fc_std, proj_std)):
            init_linear_normal(lin, std, generator)
    else:
        for lin in linears:
            init_linear_torch_default(lin, generator)
    for ln in (block.layerNorm1, block.layerNorm2):
        ln.weight.fill_(1.0)
        ln.bias.zero_()


class MixerTower(nn.Module):
    """``n_layers`` blocks applied in order to x [B, T, W]."""

    def __init__(self, width: int, tokens: int, n_layers: int, fused_mlp: bool = False):
        super().__init__()
        self.mixBlocks = nn.ModuleList(MixerBlock(width, tokens, fused_mlp) for _ in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.mixBlocks:
            x = block(x)
        return x


def init_mixer_tower(tower: MixerTower, text_tower: bool, generator: torch.Generator) -> None:
    n = len(tower.mixBlocks)
    for block in tower.mixBlocks:
        init_mixer_block(block, text_tower, n, generator)
