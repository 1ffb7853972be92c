"""Training augmentation on the device: a random crop and horizontal flip.

Counterpart of ``clip_mixer_tpu/ops/augment.py``. The data source delivers
uint8 images larger than the model's resolution (:func:`source_size`), and
the train step crops and flips them on the device before it normalises.
The draws are stateless: they come from a generator seeded by
``(seed ^ 0x5EED, step)``, so a resumed run replays the same stream.

The port cannot reproduce ``jax.random``'s draws, so the JAX and the port
augmentation streams differ. :func:`crop_flip` takes the per-sample offsets
and flips explicitly, and given the same ones it is bit for bit the JAX
``random_crop_flip``.
"""

from __future__ import annotations

import numpy as np
import torch


def source_size(resolution: int) -> int:
    """The decode size for random cropping: ~14% larger than the model's
    resolution, rounded up to a multiple of 8 (224 -> 256, 32 -> 40)."""
    return (resolution * 8 // 7 + 7) // 8 * 8


def crop_flip(images_u8: torch.Tensor, out_size: int, oy: torch.Tensor, ox: torch.Tensor,
              flip: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> uint8 [B, out_size, out_size, 3]: sample b
    cropped at rows oy[b].., columns ox[b].., mirrored left-right where
    flip[b]."""
    B, H, W, _ = images_u8.shape
    if not (0 <= int(oy.min()) and int(oy.max()) <= H - out_size and 0 <= int(ox.min())
            and int(ox.max()) <= W - out_size):
        raise ValueError(f"crop offsets out of range for {out_size}^2 crops of {H}x{W} images")
    dev = images_u8.device
    oy, ox, flip = oy.to(dev), ox.to(dev), flip.to(dev)
    k = torch.arange(out_size, device=dev)
    rows = oy[:, None] + k  # [B, out]
    cols = ox[:, None] + torch.where(flip[:, None], out_size - 1 - k, k)
    b = torch.arange(B, device=dev)[:, None, None]
    return images_u8[b, rows[:, :, None], cols[:, None, :]]


def draw_crops(seed: int, step: int, batch: int, height: int, width: int, out_size: int):
    """The (oy, ox, flip) of one step's crops, from a CPU generator keyed on
    (seed, step): stateless, so the same step draws the same crops."""
    key = np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)
    g = torch.Generator().manual_seed(int(key[0] >> np.uint64(1)))
    oy = torch.randint(0, height - out_size + 1, (batch,), generator=g)
    ox = torch.randint(0, width - out_size + 1, (batch,), generator=g)
    flip = torch.rand(batch, generator=g) < 0.5
    return oy, ox, flip


def maybe_augment(tcfg, cfg, step: int, images_u8: torch.Tensor, rank: int = 0, world: int = 1) -> torch.Tensor:
    """The train step's augmentation hook: a no-op unless ``tcfg.augment``;
    otherwise crops to the model's resolution and flips, keyed on
    (``tcfg.seed ^ 0x5EED``, ``step``). Under data parallelism ``images_u8``
    is rank ``rank``'s rows of a global batch over ``world`` ranks: the
    draws are for the global batch, as JAX draws per row of the global
    array, and this rank crops with its rows of them, so a run crops alike
    whatever its number of ranks."""
    if not tcfg.augment:
        return images_u8
    B, H, W, _ = images_u8.shape
    crops = draw_crops(tcfg.seed ^ 0x5EED, step, B * world, H, W, cfg.image_resolution)
    return crop_flip(images_u8, cfg.image_resolution, *(c[rank * B:(rank + 1) * B] for c in crops))
