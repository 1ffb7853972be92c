"""Model and training configuration for the PyTorch port.

Field-for-field copies of ``clip_mixer_tpu.config.CLIPConfig``, its
``PRESETS`` and ``TrainConfig`` (the port imports nothing of the JAX
package). Fields that only the JAX package's multi-device paths read
(``model_axis``, ``pipeline_*``, ``fsdp``, the preemption sync cadence, ...)
are kept so a configuration moves between the two packages unchanged; the
port refuses or ignores the ones it does not implement yet.
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


# The reference's clamp at ln(100) would bind under the sigmoid objective
# (SigLIP's released models converge near t ~ 118 and the paper applies no
# clamp), so SigLIP runs use this bound for TrainConfig.logit_scale_max.
SIGLIP_LOGIT_SCALE_MAX = math.log(1000.0)


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation hyperparameters; defaults are the reference run's.

    The port's single-device train step (``parallel/train_step.py``) reads
    the optimiser, schedule, loss, accumulation, clamp, EMA, freeze and
    augmentation fields; its trainer (``train/trainer.py``) reads the batch,
    epoch and step counts, the checkpoint and validation cadences, the
    retention, the non-finite abort, the fault drills, ``max_inflight_steps``,
    the seed and ``freeze_serving`` (the export's frozen serving programs,
    ``aot.freeze_programs``) and, across processes,
    ``preemption_sync_every_steps`` (the cadence of the agreed stop) and
    ``fsdp`` (the parameters and optimiser state sharded over the mesh's
    data dimension, ``parallel/fsdp.py``). ``pipeline_microbatches`` waits
    for the pipelined step (ROADMAP.md, item 16b); it is carried and
    validated as the JAX package validates it.
    """

    global_batch_size: int = 32768
    epochs: int = 32
    steps_per_epoch: Optional[int] = None
    learning_rate: float = 5e-4
    min_lr_ratio: float = 0.01
    warmup_steps: int = 2
    weight_decay: float = 0.2  # only on parameters with ndim >= 2
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-6
    grad_clip_norm: float = 20.0
    # Exact (GradCache) accumulation: the step's batch runs as this many
    # microbatches while the loss still sees the whole batch. 1 = off.
    accum_steps: int = 1
    fsdp: bool = False
    pipeline_microbatches: int = 8
    logit_scale_max: float = math.log(100.0)
    checkpoint_every_steps: int = 400
    keep_checkpoints: int = 3
    preemption_sync_every_steps: int = 20
    validate_every_steps: Optional[int] = None
    abort_on_nonfinite_loss: bool = True
    freeze_serving: bool = False
    crash_after_steps: Optional[int] = None
    hang_after_steps: Optional[int] = None
    # "info_nce" (softmax) or "siglip" (pairwise sigmoid; needs a model
    # with logit_bias_init set)
    loss: str = "info_nce"
    # EMA of the post-step parameters, decay per step; None = off
    ema_decay: Optional[float] = None
    # Locked-tower training: "visual" or "text" gets no gradient, no
    # moments and no weight decay
    freeze: Optional[str] = None
    # In-step random crop to the model's resolution + 50% horizontal flip,
    # keyed on (seed, step) (ops/augment.py)
    augment: bool = False
    max_inflight_steps: int = 2
    seed: int = 0
    # normalisation applied inside the train step to the uint8 batch
    image_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)

    def __post_init__(self):
        if self.loss not in ("info_nce", "siglip"):
            raise ValueError(f"loss must be 'info_nce' or 'siglip' (got {self.loss!r})")
        if self.freeze not in (None, "visual", "text"):
            raise ValueError(f"freeze must be 'visual' or 'text' (got {self.freeze!r})")
        if self.max_inflight_steps < 1:
            raise ValueError(f"max_inflight_steps must be >= 1 (got {self.max_inflight_steps})")
        if self.ema_decay is not None and not (0.0 < self.ema_decay < 1.0):
            raise ValueError(
                f"ema_decay must be in (0, 1) (got {self.ema_decay}); typical values 0.999-0.9999"
            )
