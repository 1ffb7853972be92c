"""Image preprocessing: PIL-parity resize weights, the batched device path and
the host PIL path.

Counterpart of ``clip_mixer_tpu/ops/preprocess.py``. The reference pipeline
is ``Resize(n_px, BICUBIC)`` (short side, antialiased, PIL) ->
``CenterCrop(n_px)`` -> RGB uint8, with /255 + mean/std normalisation after.
Antialiased bicubic resampling is linear, so resize + crop is
``out = R_h @ img @ R_w^T`` per channel with the numpy-built PIL-style
weight matrices below (copied from the JAX package, which stays the
reference).

:func:`make_batch_preprocess` has two backends: ``"torch"`` (two einsums, the
counterpart of the JAX ``"xla"`` backend) and ``"kernel"`` (the CUDA kernel of
``ops/kernels/preprocess.py``, the counterpart of ``"pallas"``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

# CLIP RGB normalisation constants.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys bicubic kernel with a=-0.5 (PIL's BICUBIC)."""
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    return np.where(
        x < 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * (x3 - 5.0 * x2 + 8.0 * x - 4.0), 0.0),
    )


def resize_weight_matrix(in_size: int, out_size: int, crop_offset: int = 0, crop_size: Optional[int] = None) -> np.ndarray:
    """[crop_size, in_size] row-stochastic matrix: PIL antialiased bicubic
    resize in_size->out_size composed with the crop [crop_offset,
    crop_offset + crop_size) of the resized axis."""
    crop_size = crop_size if crop_size is not None else out_size
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale  # bicubic support = 2
    W = np.zeros((crop_size, in_size), np.float64)
    for r in range(crop_size):
        i = r + crop_offset
        center = (i + 0.5) * scale
        jmin = max(int(center - support + 0.5), 0)
        jmax = min(int(center + support + 0.5), in_size)
        js = np.arange(jmin, jmax)
        w = _bicubic((js + 0.5 - center) / filterscale)
        W[r, jmin:jmax] = w / w.sum()
    return W.astype(np.float32)


def resize_geometry(h: int, w: int, n_px: int) -> Tuple[int, int, int, int]:
    """torchvision Resize(short-side)+CenterCrop geometry: resized (oh, ow)
    and crop offsets (top, left). The long side truncates."""
    if w <= h:
        ow, oh = n_px, int(n_px * h / w)
    else:
        oh, ow = n_px, int(n_px * w / h)
    top = int(round((oh - n_px) / 2.0))
    left = int(round((ow - n_px) / 2.0))
    return oh, ow, top, left


@functools.lru_cache(maxsize=32)
def _cached_matrices(h: int, w: int, n_px: int) -> Tuple[np.ndarray, np.ndarray]:
    oh, ow, top, left = resize_geometry(h, w, n_px)
    return (
        resize_weight_matrix(h, oh, top, n_px),
        resize_weight_matrix(w, ow, left, n_px),
    )


def norm_constants(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(255 * mean, 1 / (255 * std)) as f32 [3] tensors, computed in f32."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=device) * 255.0
    std_inv = 1.0 / (torch.tensor(CLIP_STD, dtype=torch.float32, device=device) * 255.0)
    return mean, std_inv


def make_batch_preprocess(
    input_hw: Tuple[int, int],
    n_px: int = 224,
    normalize: bool = True,
    dtype: torch.dtype = torch.float32,
    backend: str = "torch",
):
    """A function uint8/float [B, H, W, 3] -> [B, n_px, n_px, 3] ``dtype``,
    on the device of its input.

    ``backend="kernel"`` routes through the CUDA kernel (CPU inputs take its
    plain version); it always normalises.
    """
    if backend == "kernel":
        if not normalize:
            raise ValueError("the kernel preprocess backend always normalizes")
        from clip_mixer_tpu_torch.ops.kernels.preprocess import make_kernel_preprocess

        return make_kernel_preprocess(input_hw, n_px, dtype=dtype)
    if backend != "torch":
        raise ValueError(f"backend must be 'torch' or 'kernel', got {backend!r}")
    h, w = input_hw
    rh_np, rw_np = _cached_matrices(h, w, n_px)
    consts = {}

    def fn(images: torch.Tensor) -> torch.Tensor:
        dev = images.device
        if dev not in consts:
            consts[dev] = (torch.from_numpy(rh_np).to(dev), torch.from_numpy(rw_np).to(dev), *norm_constants(dev))
        rh, rw, mean, std_inv = consts[dev]
        x = resize(images, rh, rw)
        x = (x - mean) * std_inv if normalize else x / 255.0
        return x.to(dtype)

    return fn


def resize(images: torch.Tensor, rh: torch.Tensor, rw: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> f32 [B, n, n, 3]: R_h over H, then R_w over W, per channel."""
    x = torch.einsum("oh,bhwc->bowc", rh, images.float())
    return torch.einsum("pw,bowc->bopc", rw, x)


def normalize_images(images: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised float."""
    mean, std_inv = norm_constants(images.device)
    return ((images.float() - mean) * std_inv).to(dtype)


def preprocess_pil(image, n_px: int = 224) -> np.ndarray:
    """Host path: PIL bicubic short-side resize -> centre crop -> RGB -> HWC
    uint8. Imports PIL only when called."""
    from PIL import Image

    w, h = image.size
    oh, ow, top, left = resize_geometry(h, w, n_px)
    image = image.resize((ow, oh), Image.BICUBIC)
    image = image.crop((left, top, left + n_px, top + n_px))
    return np.asarray(image.convert("RGB"), dtype=np.uint8)
