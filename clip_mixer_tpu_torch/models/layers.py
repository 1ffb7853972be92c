"""Shared primitives: f32-internal LayerNorm, QuickGELU, the unfused channel
mix, token mix and block chains, linear init helpers.

Counterpart of ``clip_mixer_tpu/models/layers.py``. Linear weights here are
``nn.Linear``'s (out, in); the JAX package stores (in, out) kernels, and
``models/convert.py`` transposes between the two.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch import nn


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """Exactly x * sigmoid(1.702 x) (not the tanh or erf GELU)."""
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 whatever the activation dtype: biased variance,
    eps 1e-5, affine in f32, cast back to the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


_TAG = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Tags the products computed inside as ``name`` (``"mlp_hidden"``,
    ``"token_hidden"``: the hidden pre-activations), as ``checkpoint_name``
    does in the JAX package, so that a remat policy can keep them
    (``models/mixer.py``)."""
    outer, _TAG.name = checkpoint_tag(), name
    try:
        yield
    finally:
        _TAG.name = outer


def checkpoint_tag():
    """The name given by the innermost :func:`checkpoint_name`, or None."""
    return getattr(_TAG, "name", None)


def channel_mlp(x, ln_w, ln_b, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """x + QuickGELU(LN(x) W_in^T + b_in) W_out^T + b_out on x [..., W], the
    model's unfused channel mix: LN with its affine in f32 (:func:`layer_norm`),
    then the two linears with the weights cast to ``x.dtype``. Weights are in
    ``nn.Linear``'s (out, in) layout."""
    dt = x.dtype
    y = layer_norm(x, ln_w, ln_b)
    w_in = w_in.to(dt)
    with checkpoint_name("mlp_hidden"):
        h = y @ w_in.t()
    h = quick_gelu(h + b_in.to(dt))
    h = h @ w_out.to(dt).t() + b_out.to(dt)
    return x + h


def token_mix_branch(x, ln_w, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """The token-mixing residual branch on x [B, T, W]: LN -> contract T ->
    gelu -> contract back, with the weights cast to ``x.dtype``."""
    dt = x.dtype
    y = layer_norm(x, ln_w, ln_b)
    # w1 is [4T, T] (out, in): u indexes the hidden tokens.
    w1 = w1.to(dt)
    with checkpoint_name("token_hidden"):
        h = torch.einsum("btw,ut->buw", y, w1)
    h = h + b1.to(dt)[:, None]
    h = quick_gelu(h)
    h = torch.einsum("buw,tu->btw", h, w2.to(dt))
    return h + b2.to(dt)[:, None]


def block_parameters(block: nn.Module):
    """A ``MixerBlock``'s twelve parameters as the module holds them (the f32
    masters), in the order of :func:`mixer_block_chain` and of the block
    kernel: LN_tok, lin1, lin2, LN_ch, lin3, lin4 (weight, then bias)."""
    tm, cm = block.token_mix_seq, block.channel_mix_seq
    return (
        block.layerNorm1.weight, block.layerNorm1.bias, tm.lin1.weight, tm.lin1.bias, tm.lin2.weight, tm.lin2.bias,
        block.layerNorm2.weight, block.layerNorm2.bias, cm.lin3.weight, cm.lin3.bias, cm.lin4.weight, cm.lin4.bias,
    )


def mixer_block_chain(x, lt_w, lt_b, w1, b1, w2, b2, lc_w, lc_b, w3, b3, w4, b4) -> torch.Tensor:
    """The unfused block on x [B, T, W] with its parameters given:
    ``MixerBlock.forward`` with ``fused_mlp=False``."""
    x = x + token_mix_branch(x, lt_w, lt_b, w1, b1, w2, b2)
    return channel_mlp(x, lc_w, lc_b, w3, b3, w4, b4)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` parameters (``weight``, ``bias``) with the f32-internal
    forward of :func:`layer_norm`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


@torch.no_grad()
def init_linear_normal(linear: nn.Linear, std: float, generator: torch.Generator) -> None:
    """Normal(0, std) weight with torch-default uniform bias U(+-1/sqrt(fan_in))."""
    linear.weight.normal_(0.0, std, generator=generator)
    if linear.bias is not None:
        bound = 1.0 / math.sqrt(linear.in_features)
        linear.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_linear_torch_default(linear: nn.Linear, generator: torch.Generator) -> None:
    """torch's default Linear init: weight and bias both U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(linear.in_features)
    linear.weight.uniform_(-bound, bound, generator=generator)
    if linear.bias is not None:
        linear.bias.uniform_(-bound, bound, generator=generator)
