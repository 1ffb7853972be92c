"""Top-level CLIP module: encode_image / encode_text, forward, logits.

Counterpart of ``clip_mixer_tpu/models/clip.py``. ``forward`` returns the
reference triple (image features, text features, exp(logit_scale)) with both
feature sets L2-normalised; :meth:`CLIP.logits` is the demo path. The
module's state-dict keys are the reference checkpoint's (``visual.*``,
``token_embedding.weight``, ``transformer.mixBlocks.*``, ``ln_final.*``,
``text_projection``, ``logit_scale``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from clip_mixer_tpu_torch.models.layers import LayerNorm
from clip_mixer_tpu_torch.models.mixer import MixerTower, init_mixer_tower
from clip_mixer_tpu_torch.models.towers import VisionEncoder, require_mixer, text_encoder


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Norm in f32, result in the input dtype."""
    x32 = x.float()
    return (x32 / torch.linalg.vector_norm(x32, dim=dim, keepdim=True)).to(x.dtype)


class CLIP(nn.Module):
    """Mixer CLIP with f32 master parameters, initialised from ``generator``
    (a CPU ``torch.Generator``; seed 0 when omitted) and placed on ``device``
    (``cuda`` when omitted; see ``device.resolve_device``)."""

    def __init__(self, cfg: CLIPConfig, device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        require_mixer(cfg)
        self.cfg = cfg
        width = cfg.text_width
        self.visual = VisionEncoder(cfg)
        self.token_embedding = nn.Embedding(cfg.vocab_size, width)
        self.transformer = MixerTower(width, cfg.context_length, cfg.text_layers, cfg.fused_mlp)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init, dtype=torch.float32))
        self.init_parameters(generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        self.visual.init_parameters(generator)
        width = self.cfg.text_width
        self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
        self.text_projection.normal_(0.0, width**-0.5, generator=generator)
        self.ln_final.weight.fill_(1.0)
        self.ln_final.bias.zero_()
        init_mixer_tower(self.transformer, text_tower=True, generator=generator)
        self.logit_scale.fill_(self.cfg.logit_scale_init)

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.cfg.compute_dtype)
        return text_encoder(self.token_embedding, self.transformer, self.ln_final, self.text_projection, text, dt)

    def forward(self, images: torch.Tensor, text: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        img = l2_normalize(self.encode_image(images))
        txt = l2_normalize(self.encode_text(text))
        return img, txt, self.logit_scale.exp()

    def logits(self, images: torch.Tensor, text: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits_per_image, logits_per_text)."""
        img, txt, scale = self(images, text)
        per_image = scale * img.float() @ txt.float().t()
        return per_image, per_image.t()
