"""Vision and text encoders, mixer mode.

Counterpart of ``clip_mixer_tpu/models/towers.py``. Images are NHWC and the
patch embedding is a reshape plus one matmul (the reference's stride=kernel
conv is a patch matmul). The mixer path carries no positional embeddings:
position enters only through the token-mixing MLP. Text features are pooled
at the EOT token, found as the argmax id (eot 49407 is the largest id).

Transformer and ResNet towers are not ported yet (ROADMAP.md, Queue 1
items 13 and 14).
"""

from __future__ import annotations

import torch
from torch import nn

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.device import compute_dtype
from clip_mixer_tpu_torch.models.layers import LayerNorm
from clip_mixer_tpu_torch.models.mixer import MixerTower, init_mixer_tower


def require_mixer(cfg: CLIPConfig) -> None:
    """Raise for the towers the port does not have yet."""
    if cfg.is_resnet:
        raise NotImplementedError(
            "the ResNet vision tower is not ported yet (ROADMAP.md, Queue 1 item 14)"
        )
    if cfg.use_transformer:
        raise NotImplementedError(
            "transformer towers are not ported yet (ROADMAP.md, Queue 1 item 13)"
        )
    for field in ("remat", "model_axis", "pipeline_axis"):
        if getattr(cfg, field):
            raise NotImplementedError(f"CLIPConfig.{field} is not ported yet (ROADMAP.md, Slices B and F)")


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, (H/p)*(W/p), p*p*3] in (ph, pw, c) order."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, gh, gw, ph, pw, C]
    return x.reshape(B, gh * gw, patch * patch * C)


class VisionEncoder(nn.Module):
    """Patch embed + CLS -> ln_pre -> mixer tower -> ln_post on CLS -> proj."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        require_mixer(cfg)
        self.cfg = cfg
        width, p = cfg.vision_width, cfg.vision_patch_size
        # Reference conv layout [W, 3, p, p]; applied as a patch matmul.
        self.conv1 = nn.Conv2d(3, width, kernel_size=p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.ln_pre = LayerNorm(width)
        self.transformer = MixerTower(width, cfg.vision_tokens, cfg.vision_layers, cfg.fused_mlp)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, cfg.embed_dim))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        width = self.cfg.vision_width
        scale = width**-0.5
        bound = (self.cfg.vision_patch_size**2 * 3) ** -0.5
        self.conv1.weight.uniform_(-bound, bound, generator=generator)
        self.class_embedding.normal_(0.0, scale, generator=generator)
        self.proj.normal_(0.0, scale, generator=generator)
        for ln in (self.ln_pre, self.ln_post):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
        init_mixer_tower(self.transformer, text_tower=False, generator=generator)

    def patch_kernel(self) -> torch.Tensor:
        """The conv weight as the [(ph pw c), W] matmul kernel."""
        p = self.cfg.vision_patch_size
        return self.conv1.weight.permute(2, 3, 1, 0).reshape(p * p * 3, self.cfg.vision_width)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3], normalised, any float dtype -> [B, embed_dim]."""
        dt = compute_dtype(self.cfg.compute_dtype)
        x = patchify(images.to(dt), self.cfg.vision_patch_size)
        x = x @ self.patch_kernel().to(dt)  # [B, T-1, W]
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)  # [B, T, W]
        x = self.ln_pre(x)
        x = self.transformer(x)
        x = self.ln_post(x[:, 0, :])  # CLS token only
        return x @ self.proj.to(dt)


def text_encoder(token_embedding: nn.Embedding, tower: MixerTower, ln_final: LayerNorm,
                 projection: torch.Tensor, text: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """text: int [B, context_length] -> [B, embed_dim]. The parts live on the
    CLIP module itself, where the reference state dict puts them."""
    x = token_embedding.weight[text.long()].to(dt)  # [B, T, W]
    x = tower(x)
    x = ln_final(x).to(dt)
    eot = text.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]  # [B, W]
    return pooled @ projection.to(dt)
