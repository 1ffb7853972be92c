"""MLP-Mixer block and tower.

Counterpart of ``clip_mixer_tpu/models/mixer.py``: a pre-LN token-mixing MLP
(contracting the token axis, expansion x4) and a pre-LN channel-mixing MLP
(expansion x4), both residual, both QuickGELU. The token mix is one einsum
over the token axis (``btw,ut->buw``) with per-token biases, so the width
stays the last dimension for both mixes. The tower is an ``nn.ModuleList``
walked in order (the JAX package scans stacked parameters instead).

With a remat policy (``CLIPConfig.remat``) each block runs under
``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint`` around the
JAX scan body: the forward keeps the block's input and, through selective
checkpointing, the hidden products the policy names; the backward recomputes
the rest.

Parameter names follow the reference state dict (``mixBlocks.{i}
.layerNorm1``, ``.token_mix_seq.lin1`` ... ``.channel_mix_seq.lin4``), so a
reference checkpoint's keys load directly.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from clip_mixer_tpu_torch.models.layers import (
    LayerNorm,
    block_parameters,
    checkpoint_tag,
    init_linear_normal,
    init_linear_torch_default,
    mixer_block_chain,
    token_mix_branch,
)
from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp
from clip_mixer_tpu_torch.parallel.tp import tp_channel_mlp


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
    the fused LN + MLP kernel. ``model_group`` (set by
    ``parallel/tp.py::shard_model_tp``, which cuts the channel mix's hidden
    dimension to this rank's slice) runs the channel mix split over that
    group; the token mix stays whole, as in JAX."""

    def __init__(self, width: int, tokens: int, fused_mlp: bool = False):
        super().__init__()
        self.fused_mlp = fused_mlp
        self.model_group = None
        self.layerNorm1 = LayerNorm(width)
        self.token_mix_seq = TokenMix(tokens)
        self.layerNorm2 = LayerNorm(width)
        self.channel_mix_seq = ChannelMix(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = block_parameters(self)
        if self.model_group is not None:
            if self.fused_mlp:
                raise ValueError("fused_mlp runs no kernel under a model group (as in JAX): use the plain route")
            return tp_channel_mlp(x + token_mix_branch(x, *params[:6]), *params[6:], self.model_group)
        if not self.fused_mlp:
            return mixer_block_chain(x, *params)
        x = x + token_mix_branch(x, *params[:6])
        B, T, W = x.shape
        # ln_mlp takes the f32 masters and casts them to x.dtype itself. Its
        # backward needs only its inputs, so a remat recompute, which runs
        # for what the backward saved, launches nothing.
        return ln_mlp(x.reshape(B * T, W), *params[6:], compute=not replaying()).reshape(B, T, W)


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


# What each CLIPConfig.remat_policy keeps besides the block's input: the
# products the chains tag with checkpoint_name (models/layers.py), each
# kept before its bias (the bias add is recomputed with LN and QuickGELU).
# With fused_mlp the channel mix is the ln_mlp kernel, which makes no
# "mlp_hidden" and keeps only its inputs, as the JAX kernel's custom_vjp.
REMAT_KEEPS = {"none": (), "mlp_hidden": ("mlp_hidden",), "all_hidden": ("mlp_hidden", "token_hidden")}
# The ops a tagged product reaches the dispatcher as (einsum and matmul
# lower to these); the views around them are recomputed.
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
_REPLAY = threading.local()


def _keep_tagged(names):
    """Selective-checkpoint policy: keep the products tagged with ``names``."""

    def policy(ctx, op, *args, **kwargs):
        if op in _PRODUCTS and checkpoint_tag() in names:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


@contextlib.contextmanager
def _replaying(inner):
    """The backward's recompute of a block: ``inner`` (the selective
    checkpoint's recompute context), with :func:`replaying` true."""
    _REPLAY.on = True
    try:
        with inner:
            yield
    finally:
        _REPLAY.on = False


def replaying() -> bool:
    """Whether this thread is recomputing a rematerialised block."""
    return getattr(_REPLAY, "on", False)


def _remat_contexts(names):
    """``checkpoint``'s ``context_fn``: the forward's and the recompute's contexts."""
    if names:
        forward, recompute = create_selective_checkpoint_contexts(_keep_tagged(names))
    else:
        forward, recompute = contextlib.nullcontext(), contextlib.nullcontext()
    return forward, _replaying(recompute)


def remat_context_fn(remat_policy: Optional[str]):
    """``checkpoint``'s ``context_fn`` for a ``REMAT_KEEPS`` policy name;
    None (no remat) for None."""
    return None if remat_policy is None else functools.partial(_remat_contexts, REMAT_KEEPS[remat_policy])


class MixerTower(nn.Module):
    """``n_layers`` blocks applied in order to x [B, T, W]; with
    ``remat_policy`` (a ``REMAT_KEEPS`` name; None = no remat) each block is
    rematerialised whenever autograd records."""

    def __init__(self, width: int, tokens: int, n_layers: int, fused_mlp: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.mixBlocks = nn.ModuleList(MixerBlock(width, tokens, fused_mlp) for _ in range(n_layers))
        self.remat_contexts = remat_context_fn(remat_policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.remat_contexts is not None and torch.is_grad_enabled()
        for block in self.mixBlocks:
            if remat:  # the blocks compute nothing random
                x = checkpoint(block, x, use_reentrant=False, context_fn=self.remat_contexts,
                               preserve_rng_state=False)
            else:
                x = block(x)
        return x


def init_mixer_tower(tower: MixerTower, text_tower: bool, generator: torch.Generator) -> None:
    n = len(tower.mixBlocks)
    for block in tower.mixBlocks:
        init_mixer_block(block, text_tower, n, generator)
