"""Shared primitives: f32-internal LayerNorm, QuickGELU, linear init helpers.

Counterpart of ``clip_mixer_tpu/models/layers.py``. Linear weights here are
``nn.Linear``'s (out, in); the JAX package stores (in, out) kernels, and
``models/convert.py`` transposes between the two.
"""

from __future__ import annotations

import math

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
