"""Vision and text encoders, mixer and transformer mode.

Counterpart of ``clip_mixer_tpu/models/towers.py``. Images are NHWC and the
patch embedding is a reshape plus one matmul (the reference's stride=kernel
conv is a patch matmul). The mixer path carries no positional embeddings:
position enters only through the token-mixing MLP. The transformer path
adds ``positional_embedding`` (vision: after the CLS token, before
``ln_pre``; text: to the token embeddings) and masks the text tower
causally. Text features are pooled at the EOT token, found as the argmax id
(eot 49407 is the largest id).

A ResNet config (a tuple ``vision_layers``) carries ``tower="transformer"``
for its text side: its vision encoder is ``models/resnet.py``'s
:class:`~clip_mixer_tpu_torch.models.resnet.ModifiedResNet`
(:func:`make_visual`), and every dispatch on the vision tower tests
``cfg.is_resnet`` before ``cfg.use_transformer``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.device import compute_dtype
from clip_mixer_tpu_torch.models.layers import LayerNorm
from clip_mixer_tpu_torch.models.mixer import MixerTower, init_mixer_tower
from clip_mixer_tpu_torch.models.resnet import ModifiedResNet
from clip_mixer_tpu_torch.models.transformer import TransformerTower, init_transformer_tower


def require_ported(cfg: CLIPConfig) -> None:
    """Raise for what the port does not have yet: pipeline stages.
    ``model_axis`` is taken: the blocks split over a model group once
    ``parallel/tp.py::shard_model_tp`` has cut them."""
    if cfg.pipeline_axis:
        raise NotImplementedError("CLIPConfig.pipeline_axis is not ported yet "
                                  "(ROADMAP.md, Queue 1 item 16b, pipeline stages)")


def remat_policy(cfg: CLIPConfig) -> Optional[str]:
    """The towers' remat policy: ``cfg.remat_policy`` when ``cfg.remat``, else None."""
    return cfg.remat_policy if cfg.remat else None


def make_tower(cfg: CLIPConfig, text: bool):
    """A tower of ``cfg``'s kind: the text tower (causally masked when a
    transformer) or the vision tower of a patch encoder."""
    if cfg.is_resnet and not text:
        raise ValueError("a ResNet config has no vision tower of blocks; make_visual builds its encoder")
    width, layers = (cfg.text_width, cfg.text_layers) if text else (cfg.vision_width, cfg.vision_layers)
    if cfg.use_transformer:
        heads = cfg.text_heads if text else cfg.vision_heads
        return TransformerTower(width, layers, heads, cfg.context_length if text else None, remat_policy(cfg))
    tokens = cfg.context_length if text else cfg.vision_tokens
    return MixerTower(width, tokens, layers, cfg.fused_mlp, remat_policy(cfg))


def init_tower(tower, text_tower: bool, generator: torch.Generator) -> None:
    if isinstance(tower, TransformerTower):
        init_transformer_tower(tower, text_tower, generator)
    else:
        init_mixer_tower(tower, text_tower, generator)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, (H/p)*(W/p), p*p*3] in (ph, pw, c) order."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, gh, gw, ph, pw, C]
    return x.reshape(B, gh * gw, patch * patch * C)


def make_visual(cfg: CLIPConfig) -> nn.Module:
    """The vision encoder of ``cfg``: a :class:`ModifiedResNet` when
    ``cfg.is_resnet``, else the patch encoder :class:`VisionEncoder`."""
    return ModifiedResNet(cfg) if cfg.is_resnet else VisionEncoder(cfg)


class VisionEncoder(nn.Module):
    """Patch embed + CLS (+ positional embedding, transformer) -> ln_pre ->
    tower -> ln_post on CLS -> proj."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        width, p = cfg.vision_width, cfg.vision_patch_size
        # Reference conv layout [W, 3, p, p]; applied as a patch matmul.
        self.conv1 = nn.Conv2d(3, width, kernel_size=p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        if cfg.use_transformer:
            self.positional_embedding = nn.Parameter(torch.empty(cfg.vision_tokens, width))
        self.ln_pre = LayerNorm(width)
        self.transformer = make_tower(cfg, text=False)
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
        if self.cfg.use_transformer:
            self.positional_embedding.normal_(0.0, scale, generator=generator)
        for ln in (self.ln_pre, self.ln_post):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
        init_tower(self.transformer, text_tower=False, generator=generator)

    def patch_kernel(self) -> torch.Tensor:
        """The conv weight as the [(ph pw c), W] matmul kernel."""
        p = self.cfg.vision_patch_size
        return self.conv1.weight.permute(2, 3, 1, 0).reshape(p * p * 3, self.cfg.vision_width)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3], normalised, any float dtype -> [B, embed_dim]."""
        dt = compute_dtype(self.cfg.compute_dtype)
        x = patchify(images.to(dt), self.cfg.vision_patch_size)
        x = embed_patches(self, x @ self.patch_kernel().to(dt))
        x = self.transformer(x)
        x = self.ln_post(x[:, 0, :])  # CLS token only
        return x @ self.proj.to(dt)


def embed_patches(visual, x: torch.Tensor) -> torch.Tensor:
    """The patch embeddings [B, T-1, W] in the compute dtype -> the vision
    tower's input [B, T, W]: CLS first, the positional embedding
    (transformer), ``ln_pre``. ``visual`` holds the parts (the float
    encoder, or a quantised vision tower sharing them)."""
    dt = x.dtype
    cls = visual.class_embedding.to(dt).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)  # [B, T, W]
    if visual.cfg.use_transformer:
        x = x + visual.positional_embedding.to(dt)
    return visual.ln_pre(x)


def embed_text(model, text: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Token ids [B, context_length] -> the text tower's input [B, T, W]: the
    token embeddings (+ ``positional_embedding``, transformer) in ``dt``.
    ``model`` holds the parts (a CLIP, or a quantised text tower sharing
    them)."""
    x = model.token_embedding.weight[text.long()].to(dt)
    if model.cfg.use_transformer:
        x = x + model.positional_embedding.to(dt)
    return x


def pool_text(model, x: torch.Tensor, text: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The tower's output -> ``ln_final`` -> the EOT token's row ->
    ``text_projection``: [B, embed_dim]."""
    x = model.ln_final(x).to(dt)
    eot = text.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]  # [B, W]
    return pooled @ model.text_projection.to(dt)
