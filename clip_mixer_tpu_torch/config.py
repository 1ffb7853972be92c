"""Model configuration for the PyTorch port.

A field-for-field copy of ``clip_mixer_tpu.config.CLIPConfig`` and its
``PRESETS`` (the port imports nothing of the JAX package). Fields that only
the JAX package's training and parallel paths read (``remat``,
``model_axis``, ``pipeline_*``) are kept so a configuration moves between
the two packages unchanged; the port's towers refuse the ones they do not
implement yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Architecture hyperparameters. Defaults are the trained Mixer-B/32."""

    embed_dim: int = 512
    # vision tower
    image_resolution: int = 224
    vision_layers: int | Tuple[int, int, int, int] = 12
    vision_width: int = 768
    vision_patch_size: Optional[int] = 32
    # text tower
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    # "mixer" or "transformer"; a tuple vision_layers selects the ResNet
    # vision trunk.
    tower: str = "mixer"
    # params are stored float32; activations run in compute_dtype with
    # float32 LayerNorm internals.
    compute_dtype: str = "bfloat16"
    remat: bool = False
    remat_policy: str = "none"
    # Route every mixer block's LN + channel MLP through the fused kernel
    # (ops/kernels/ln_mlp.py).
    fused_mlp: bool = False
    model_axis: Optional[str] = None
    pipeline_axis: Optional[str] = None
    pipeline_stages: int = 0
    pipeline_microbatches: int = 1
    logit_scale_init: float = math.log(1.0 / 0.07)
    logit_bias_init: Optional[float] = None

    def __post_init__(self):
        if self.tower not in ("mixer", "transformer"):
            raise ValueError(
                f"tower must be 'mixer' or 'transformer' (got {self.tower!r}); "
                "select the ResNet vision trunk with a tuple vision_layers"
            )
        if self.remat_policy not in ("none", "mlp_hidden", "all_hidden"):
            raise ValueError(
                f"remat_policy must be 'none', 'mlp_hidden' or 'all_hidden' "
                f"(got {self.remat_policy!r})"
            )

    @property
    def use_transformer(self) -> bool:
        return self.tower == "transformer"

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.vision_layers, (tuple, list))

    @property
    def vision_heads(self) -> int:
        if self.is_resnet:
            return self.vision_width * 32 // 64
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        if self.is_resnet:
            raise ValueError("a ResNet vision trunk has no patch grid")
        return self.image_resolution // self.vision_patch_size

    @property
    def vision_tokens(self) -> int:
        """Patch tokens + CLS."""
        return self.grid_size**2 + 1

    def replace(self, **kw) -> "CLIPConfig":
        return dataclasses.replace(self, **kw)

    def for_siglip(self) -> "CLIPConfig":
        """SigLIP init: learnable bias -10 and temperature log(10)."""
        return self.replace(logit_bias_init=-10.0, logit_scale_init=math.log(10.0))


PRESETS = {
    "mixer-b32": CLIPConfig(tower="mixer"),
    "transformer-b32": CLIPConfig(tower="transformer"),
    "vit-b32": CLIPConfig(tower="transformer"),
    "vit-b16": CLIPConfig(tower="transformer", vision_patch_size=16),
    "vit-l14": CLIPConfig(
        tower="transformer",
        embed_dim=768,
        vision_layers=24,
        vision_width=1024,
        vision_patch_size=14,
        text_width=768,
        text_heads=12,
        text_layers=12,
    ),
    "mixer-debug": CLIPConfig(
        embed_dim=32,
        image_resolution=32,
        vision_layers=2,
        vision_width=64,
        vision_patch_size=16,
        context_length=16,
        text_width=64,
        text_heads=1,
        text_layers=2,
        tower="mixer",
        compute_dtype="float32",
    ),
    "rn50": CLIPConfig(
        tower="transformer",
        embed_dim=1024,
        vision_layers=(3, 4, 6, 3),
        vision_width=64,
        vision_patch_size=None,
    ),
    "vit-l14-336": CLIPConfig(
        tower="transformer",
        embed_dim=768,
        image_resolution=336,
        vision_layers=24,
        vision_width=1024,
        vision_patch_size=14,
        text_width=768,
        text_heads=12,
        text_layers=12,
    ),
    "rn101": CLIPConfig(
        tower="transformer",
        embed_dim=512,
        vision_layers=(3, 4, 23, 3),
        vision_width=64,
        vision_patch_size=None,
    ),
    "rn50x4": CLIPConfig(
        tower="transformer",
        embed_dim=640,
        image_resolution=288,
        vision_layers=(4, 6, 10, 6),
        vision_width=80,
        vision_patch_size=None,
        text_width=640,
        text_heads=10,
    ),
    "rn50x16": CLIPConfig(
        tower="transformer",
        embed_dim=768,
        image_resolution=384,
        vision_layers=(6, 8, 18, 8),
        vision_width=96,
        vision_patch_size=None,
        text_width=768,
        text_heads=12,
    ),
    "rn50x64": CLIPConfig(
        tower="transformer",
        embed_dim=1024,
        image_resolution=448,
        vision_layers=(3, 15, 36, 10),
        vision_width=128,
        vision_patch_size=None,
        text_width=1024,
        text_heads=16,
    ),
}
