"""ModifiedResNet vision tower (OpenAI CLIP's RN50 and kin), NHWC.

Counterpart of ``clip_mixer_tpu/models/resnet.py``: a 3-conv stem with a
2x2 average pool, anti-aliased bottlenecks (an average pool before every
stride-2 product: after ``conv2`` on the main branch, before the 1x1 conv
of the downsample branch) and a QKV attention pool whose query is the mean
token.

Activations are NHWC tensors, as the JAX tower's and the ``preprocess``
output are: a convolution takes the NCHW view of NHWC memory
(``torch.channels_last``), so cuDNN runs it in that layout and nothing is
transposed. Weights are the reference's OIHW (``nn.Conv2d``'s), cast to the
compute dtype at each use. An f32 convolution on the card runs in true f32:
cuDNN's TF32 is switched off around it, forward and backward.

BatchNorm is functional with f32 internals, in the JAX package's order:
``(x32 - mean) * rsqrt(var + eps) * scale + bias``, then the cast. The
modules hold ``nn.BatchNorm2d``'s parameters and buffers (``weight``,
``bias``, ``running_mean``, ``running_var``, ``num_batches_tracked``, the
reference state-dict keys) but not its forward: cuDNN's Welford moments and
its in-forward running-stat update are not JAX's. :meth:`ModifiedResNet.forward`
normalises with the running statistics, whatever the module's ``training``
flag; :func:`resnet_encoder_train` normalises with the batch moments
(``E[x^2] - E[x]^2`` in f32, gradients through them, written out so that
the backward keeps the BN input and not three f32 copies of it) and
returns them per site, and :func:`apply_bn_updates` merges them into the running statistics
with torch's semantics (momentum 0.1, unbiased variance) after the
optimiser step. With ``CLIPConfig.remat`` each bottleneck runs under
``torch.utils.checkpoint`` with its moments among the outputs, so a
recompute changes no running statistic.

The attention pool's scores are cast to f32 and then multiplied by
``head_dim ** -0.5`` (``clip_mixer_tpu/models/resnet.py:157``): not the
transformer's ``attention_heads_core``, which rounds the scale to the
compute dtype first.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.device import compute_dtype

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


@contextlib.contextmanager
def true_f32():
    """cuDNN without TF32 inside the context (the flag is restored on exit)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _TrueF32Conv(torch.autograd.Function):
    """An f32 convolution on the card with TF32 off in its forward and in its
    backward (which autograd runs outside any context of the forward)."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: int):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        with true_f32():
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        s, p = ctx.stride, ctx.padding
        with true_f32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [s, s], [p, p], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


def conv(weight: torch.Tensor, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """x NHWC [B, H, W, Cin] -> NHWC [B, H', W', Cout]; ``weight`` OIHW, cast
    to ``x.dtype``; symmetric zero ``padding``."""
    w = weight.to(x.dtype)
    xn = x.permute(0, 3, 1, 2)  # the NCHW view of NHWC memory
    if x.dtype == torch.float32 and x.is_cuda:
        y = _TrueF32Conv.apply(xn, w, stride, padding)
    else:
        y = F.conv2d(xn, w, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def bn_normalize(x: torch.Tensor, mean, var, scale, bias, eps: float = BN_EPS) -> torch.Tensor:
    """The one BatchNorm normalisation, f32 inside, over the last (channel)
    axis of x; the result in ``x.dtype``."""
    x32 = x.float()
    inv = torch.rsqrt(var + eps)
    return ((x32 - mean) * inv * scale + bias).to(x.dtype)


def batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) over (N, H, W) in f32, the variance as E[x^2] - E[x]^2."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 1, 2))
    mean_sq = x32.square().mean(dim=(0, 1, 2))
    return mean, mean_sq - mean.square()


class _BatchNormTrain(torch.autograd.Function):
    """``bn_normalize(x, *batch_moments(x), scale, bias)`` -> (y, mean, var),
    op for op, with the exact gradient through the moments written out. It
    keeps x (in its own dtype) and three vectors for the backward, where
    autograd of the chain would keep three f32 copies of x (bf16 RN50 at
    B = 256 holds some 3.1e9 BN inputs)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        mean, var = batch_moments(x)
        inv = torch.rsqrt(var + eps)
        y = ((x.float() - mean) * inv * scale + bias).to(x.dtype)
        ctx.save_for_backward(x, mean, inv, scale)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, mean, inv, scale = ctx.saved_tensors
        dims = (0, 1, 2)
        g = gy.float()
        xhat = (x.float() - mean) * inv
        gx = None
        if ctx.needs_input_grad[0]:
            gxhat = g * scale
            gx = ((gxhat - gxhat.mean(dim=dims) - xhat * (gxhat * xhat).mean(dim=dims)) * inv).to(x.dtype)
        gscale = (g * xhat).sum(dim=dims) if ctx.needs_input_grad[1] else None
        gbias = g.sum(dim=dims) if ctx.needs_input_grad[2] else None
        return gx, gscale, gbias, None


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k windows at stride k (the rows and columns past the last whole
    window dropped): the window sum over k^2, in ``x.dtype``."""
    B, H, W, C = x.shape
    h, w = H // k, W // k
    s = x[:, :h * k, :w * k].reshape(B, h, k, w, k, C).sum(dim=(2, 4))
    return s / float(k * k)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d``'s parameters and buffers; the forward normalises
    NHWC ``x`` with the running statistics (:func:`bn_normalize`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bn_normalize(x, self.running_mean, self.running_var, self.weight, self.bias, self.eps)


def _conv2d(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> (avg pool when strided) -> 1x1 (x4 channels), with a
    downsample branch (avg pool when strided -> 1x1 conv -> BN) where the
    stride or the width changes. Keys: ``conv1..3``, ``bn1..3``,
    ``downsample.0`` (conv), ``downsample.1`` (BN)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = _conv2d(inplanes, planes, 1), BatchNorm(planes)
        self.conv2, self.bn2 = _conv2d(planes, planes, 3), BatchNorm(planes)
        self.conv3, self.bn3 = _conv2d(planes, planes * 4, 1), BatchNorm(planes * 4)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(_conv2d(inplanes, planes * 4, 1), BatchNorm(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bottleneck(self, x, _running_norm)


def _running_norm(name: str, bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    return bn(x)


def bottleneck(block: Bottleneck, x: torch.Tensor, norm) -> torch.Tensor:
    """One anti-aliased bottleneck on NHWC ``x``; ``norm(site, bn, y)``
    normalises each BN site (``"bn1"``, ``"bn2"``, ``"bn3"``,
    ``"downsample.1"``)."""
    out = F.relu(norm("bn1", block.bn1, conv(block.conv1.weight, x)))
    out = F.relu(norm("bn2", block.bn2, conv(block.conv2.weight, out, padding=1)))
    if block.stride > 1:
        out = avg_pool(out, block.stride)
    out = norm("bn3", block.bn3, conv(block.conv3.weight, out))
    identity = x
    if block.downsample is not None:
        identity = x if block.stride == 1 else avg_pool(x, block.stride)
        identity = norm("downsample.1", block.downsample[1], conv(block.downsample[0].weight, identity))
    return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pooling with the mean token as the only query. Keys:
    ``positional_embedding`` [HW + 1, C], ``{q,k,v,c}_proj``."""

    def __init__(self, spacial: int, embed_dim: int, n_heads: int, output_dim: int):
        super().__init__()
        self.n_heads = n_heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial * spacial + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return attention_pool(self, x)


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    return x @ lin.weight.to(dt).t() + lin.bias.to(dt)


def attention_pool(pool: AttentionPool2d, x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, output_dim], in ``x.dtype``; the scores and
    the softmax in f32."""
    B, H, W, C = x.shape
    dt = x.dtype
    tokens = x.reshape(B, H * W, C)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)  # [B, HW + 1, C]
    tokens = tokens + pool.positional_embedding.to(dt)
    nh = pool.n_heads
    hd = C // nh

    def heads(t):  # [B, T, C] -> [B, nh, T, hd]
        return t.reshape(B, -1, nh, hd).transpose(1, 2)

    q = heads(_linear(pool.q_proj, tokens[:, :1]))
    k = heads(_linear(pool.k_proj, tokens))
    v = heads(_linear(pool.v_proj, tokens))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * (hd**-0.5)
    attn = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bhqk,bhkd->bhqd", attn, v).transpose(1, 2).reshape(B, C)
    return _linear(pool.c_proj, out)


class ModifiedResNet(nn.Module):
    """The ResNet vision encoder of ``cfg`` (``cfg.is_resnet``): images
    NHWC [B, R, R, 3], normalised, any float dtype -> [B, embed_dim] in the
    compute dtype. Keys: ``conv1..3``, ``bn1..3``, ``layer{1..4}.{b}.*``,
    ``attnpool.*`` (the reference's ``visual.*`` layout)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        width = cfg.vision_width
        self.conv1, self.bn1 = _conv2d(3, width // 2, 3), BatchNorm(width // 2)
        self.conv2, self.bn2 = _conv2d(width // 2, width // 2, 3), BatchNorm(width // 2)
        self.conv3, self.bn3 = _conv2d(width // 2, width, 3), BatchNorm(width)
        inplanes = width
        for i, blocks in enumerate(cfg.vision_layers):
            planes = width * 2**i
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(inplanes, planes, (1 if i == 0 else 2) if b == 0 else 1))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.attnpool = AttentionPool2d(cfg.image_resolution // 32, width * 32, cfg.vision_heads, cfg.embed_dim)

    def blocks(self) -> List[Tuple[str, Bottleneck]]:
        """Every bottleneck in order, with its key prefix (``layer1.0``, ...)."""
        return [(f"layer{i}.{b}", blk) for i in range(1, 5) for b, blk in enumerate(getattr(self, f"layer{i}"))]

    def bn_sites(self) -> Dict[str, BatchNorm]:
        """Every BatchNorm by key prefix, in forward order."""
        return {name: m for name, m in self.named_modules() if isinstance(m, BatchNorm)}

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """``init_resnet``'s distributions: convs U(+-(fan_in)^-1/2); BN scale 1
        (each bottleneck's ``bn3``: 0), bias 0, running mean 0, var 1; the
        attention pool's table and projections N(0, C^-1/2), biases 0."""
        convs = [self.conv1, self.conv2, self.conv3]
        for _, blk in self.blocks():
            convs += [blk.conv1, blk.conv2, blk.conv3] + ([blk.downsample[0]] if blk.downsample is not None else [])
        for c in convs:
            bound = (c.in_channels * c.kernel_size[0] * c.kernel_size[1]) ** -0.5
            c.weight.uniform_(-bound, bound, generator=generator)
        for bn in self.bn_sites().values():
            bn.reset_parameters()
        for _, blk in self.blocks():
            blk.bn3.weight.zero_()
        pool = self.attnpool
        std = pool.positional_embedding.shape[1] ** -0.5
        pool.positional_embedding.normal_(0.0, std, generator=generator)
        for lin in (pool.q_proj, pool.k_proj, pool.v_proj, pool.c_proj):
            lin.weight.normal_(0.0, std, generator=generator)
            lin.bias.zero_()

    def stem(self, x: torch.Tensor, norm) -> torch.Tensor:
        x = F.relu(norm("bn1", self.bn1, conv(self.conv1.weight, x, stride=2, padding=1)))
        x = F.relu(norm("bn2", self.bn2, conv(self.conv2.weight, x, padding=1)))
        x = F.relu(norm("bn3", self.bn3, conv(self.conv3.weight, x, padding=1)))
        return avg_pool(x, 2)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Inference: every BN site with its running statistics."""
        x = self.stem(images.to(compute_dtype(self.cfg.compute_dtype)), _running_norm)
        for _, blk in self.blocks():
            x = blk(x)
        return self.attnpool(x)


BnStats = Dict[str, Dict[str, torch.Tensor]]


def _batch_norm_into(stats: Dict, prefix: str):
    """A ``norm`` that normalises with the batch moments and records
    ``(mean, var, n)`` under ``prefix + site``."""

    def norm(site: str, bn: BatchNorm, y: torch.Tensor) -> torch.Tensor:
        out, mean, var = _BatchNormTrain.apply(y, bn.weight, bn.bias, bn.eps)
        stats[prefix + site] = (mean, var, float(y.shape[0] * y.shape[1] * y.shape[2]))
        return out

    return norm


def _block_train(block: Bottleneck, x: torch.Tensor, counts: List[float]):
    """One bottleneck on batch moments: (its output, its sites' means, their
    variances); the element counts go to ``counts`` (plain floats, the same
    on a recompute)."""
    stats: Dict = {}
    out = bottleneck(block, x, _batch_norm_into(stats, ""))
    counts[:] = [n for _, _, n in stats.values()]
    return out, tuple(m for m, _, _ in stats.values()), tuple(v for _, v, _ in stats.values())


def resnet_encoder_train(visual: ModifiedResNet, images: torch.Tensor) -> Tuple[torch.Tensor, BnStats]:
    """The training forward: every BN site on its batch moments. Returns
    ``(features, bn_stats)``, ``bn_stats[site] = {"mean", "var", "n"}`` for
    every BN site by key prefix (``"bn1"``, ``"layer1.0.downsample.1"``,
    ...; ``n`` the element count of the site's input, a float) for
    :func:`apply_bn_updates`. With ``cfg.remat`` and autograd recording,
    each bottleneck is rematerialised."""
    stats: Dict = {}
    x = visual.stem(images.to(compute_dtype(visual.cfg.compute_dtype)), _batch_norm_into(stats, ""))
    remat = visual.cfg.remat and torch.is_grad_enabled()
    for prefix, blk in visual.blocks():
        counts: List[float] = []
        if remat:  # the blocks compute nothing random
            x, means, variances = checkpoint(_block_train, blk, x, counts, use_reentrant=False,
                                             preserve_rng_state=False)
        else:
            x, means, variances = _block_train(blk, x, counts)
        sites = ["bn1", "bn2", "bn3"] + (["downsample.1"] if blk.downsample is not None else [])
        for site, m, v, n in zip(sites, means, variances, counts):
            stats[f"{prefix}.{site}"] = (m, v, n)
    feats = visual.attnpool(x)
    return feats, {k: {"mean": m, "var": v, "n": n} for k, (m, v, n) in stats.items()}


@torch.no_grad()
def apply_bn_updates(visual: ModifiedResNet, bn_stats: BnStats, momentum: float = BN_MOMENTUM) -> None:
    """Merge batch moments into the running statistics, in place, with
    ``nn.BatchNorm2d``'s semantics: ``running = (1 - m) running + m batch``,
    the variance's batch term unbiased (``var * n / (n - 1)``); each site's
    ``num_batches_tracked`` counts the merge. No gradient flows here: call it
    after the optimiser step."""
    sites = visual.bn_sites()
    for name, s in bn_stats.items():
        bn = sites[name]
        n = s["n"]
        unbiased = s["var"].detach() * float(np.float32(n) / np.float32(max(n - 1.0, 1.0)))  # the f32 ratio
        bn.running_mean.copy_((1.0 - momentum) * bn.running_mean + momentum * s["mean"].detach())
        bn.running_var.copy_((1.0 - momentum) * bn.running_var + momentum * unbiased)
        bn.num_batches_tracked.add_(1)
