"""Top-level CLIP module: encode_image / encode_text, forward, logits.

Counterpart of ``clip_mixer_tpu/models/clip.py``. ``forward`` returns the
reference triple (image features, text features, exp(logit_scale)) with both
feature sets L2-normalised; :meth:`CLIP.forward_train` adds the batch-norm
statistics of the JAX training forward (empty but for a ResNet vision
tower); :meth:`CLIP.logits` is the demo path. A ResNet config's vision
encoder is ``models/resnet.py``'s ``ModifiedResNet``; its text tower is a
transformer. The module's state-dict keys are the reference checkpoint's
(``visual.*``, ``token_embedding.weight``, ``transformer.mixBlocks.*`` or,
for transformer towers, ``positional_embedding`` and
``transformer.resblocks.*``, ``ln_final.*``, ``text_projection``,
``logit_scale``; a ResNet's ``visual.conv1..3``, ``visual.bn*``,
``visual.layer{i}.{b}.*`` and ``visual.attnpool.*``), plus ``logit_bias``
when ``cfg.logit_bias_init`` is set (the SigLIP loss's learnable bias).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from clip_mixer_tpu_torch.models.layers import LayerNorm
from clip_mixer_tpu_torch.models.resnet import resnet_encoder_train
from clip_mixer_tpu_torch.models.towers import (
    embed_text,
    init_tower,
    make_tower,
    make_visual,
    pool_text,
)


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Norm in f32, result in the input dtype."""
    x32 = x.float()
    return (x32 / torch.linalg.vector_norm(x32, dim=dim, keepdim=True)).to(x.dtype)


class CLIP(nn.Module):
    """CLIP with mixer, transformer or ResNet towers and f32 master parameters,
    initialised from ``generator`` (a CPU ``torch.Generator``; seed 0 when
    omitted) and placed on ``device`` (``cuda`` when omitted; see
    ``device.resolve_device``)."""

    def __init__(self, cfg: CLIPConfig, device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        width = cfg.text_width
        self.visual = make_visual(cfg)
        self.token_embedding = nn.Embedding(cfg.vocab_size, width)
        if cfg.use_transformer:
            self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, width))
        self.transformer = make_tower(cfg, text=True)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init, dtype=torch.float32))
        if cfg.logit_bias_init is not None:
            self.logit_bias = nn.Parameter(torch.tensor(cfg.logit_bias_init, dtype=torch.float32))
        self.init_parameters(generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        self.visual.init_parameters(generator)
        width = self.cfg.text_width
        self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
        self.text_projection.normal_(0.0, width**-0.5, generator=generator)
        if self.cfg.use_transformer:
            self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.ln_final.weight.fill_(1.0)
        self.ln_final.bias.zero_()
        init_tower(self.transformer, text_tower=True, generator=generator)
        self.logit_scale.fill_(self.cfg.logit_scale_init)
        if self.cfg.logit_bias_init is not None:
            self.logit_bias.fill_(self.cfg.logit_bias_init)

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        """text: int [B, context_length] -> [B, embed_dim], pooled at the EOT
        token (the argmax id)."""
        dt = compute_dtype(self.cfg.compute_dtype)
        return pool_text(self, self.transformer(embed_text(self, text, dt)), text, dt)

    def forward(self, images: torch.Tensor, text: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        img = l2_normalize(self.encode_image(images))
        txt = l2_normalize(self.encode_text(text))
        return img, txt, self.logit_scale.exp()

    def forward_train(self, images: torch.Tensor, text: torch.Tensor, bn_eval: bool = False, group=None):
        """The training forward: (image features, text features,
        exp(logit_scale), bn_stats). A ResNet vision tower normalises with
        its batch moments (over ``group``'s ranks when one is given: SyncBN,
        as JAX passes ``axis_name``), returned per BN site in ``bn_stats``
        (``models/resnet.py::resnet_encoder_train``) for the running-stat
        merge after the optimiser step; other towers return ``{}``.
        ``bn_eval``: the ResNet normalises with its running statistics and
        returns ``{}`` (a frozen vision tower keeps them, as torch's
        ``eval()`` does)."""
        if not self.cfg.is_resnet or bn_eval:
            # forward itself, not self(...): under FSDP this method is the
            # root's registered forward (parallel/fsdp.py), hooked once
            img, txt, scale = self.forward(images, text)
            return img, txt, scale, {}
        feats, bn_stats = resnet_encoder_train(self.visual, images, group)
        return l2_normalize(feats), l2_normalize(self.encode_text(text)), self.logit_scale.exp(), bn_stats

    def logits(self, images: torch.Tensor, text: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits_per_image, logits_per_text)."""
        img, txt, scale = self(images, text)
        per_image = scale * img.float() @ txt.float().t()
        return per_image, per_image.t()
