"""Drop-in for the reference ``clip`` module (its torch surface).

Counterpart of ``clip_mixer_tpu/compat.py``: ``import
clip_mixer_tpu_torch.compat as clip`` runs the reference's README demo
line for line::

    import clip_mixer_tpu_torch.compat as clip
    model, preprocess = clip.load("ViT-B/32")          # the card
    image = preprocess(Image.open("CLIP.png")).unsqueeze(0)
    text = clip.tokenize(["a diagram", "a dog", "a cat"])
    with torch.no_grad():
        image_features = model.encode_image(image)
        text_features = model.encode_text(text)
        img_f, txt_f, scale = model(image, text)

* ``load`` (the reference's clip.py:95-195) takes whatever
  :func:`clip_mixer_tpu_torch.api.load` takes. ``device=None`` is the card,
  and raises without one. ``"cpu"`` computes in float32 (the reference's
  ``model.float()``); a CUDA device in bf16. ``jit`` is accepted and
  ignored.
* ``preprocess`` is the reference transform: PIL -> normalised CHW
  float32 tensor.
* ``tokenize``: the reference's tokens as ``torch.long``.
* ``model(image, text)`` returns the reference triple (L2-normalised image
  and text features, exp(logit_scale)); ``model.logits`` gives
  (logits_per_image, logits_per_text).

Outputs stay on the model's device, as in the reference (the JAX package
hands back CPU tensors only because JAX computes underneath). The wrapper
is inference only: ``train(True)`` raises.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from clip_mixer_tpu_torch import api
from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.device import compute_dtype, resolve_device
from clip_mixer_tpu_torch.models.clip import CLIP as _Model
from clip_mixer_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD, normalize_images
from clip_mixer_tpu_torch.text.tokenize import tokenize as _tokenize_np

__all__ = ["available_models", "load", "tokenize"]


def available_models():
    """Names :func:`load` takes (the reference's clip.py:90-92, and the presets)."""
    return api.available_models()


def tokenize(texts, context_length: int = 77, truncate: bool = False) -> torch.Tensor:
    """The reference ``clip.tokenize``: [N, context_length] ``torch.long``
    tokens, raising on an over-long text unless ``truncate``."""
    return torch.from_numpy(_tokenize_np(texts, context_length=context_length, truncate=truncate).astype(np.int64))


class _VisualShim:
    """``model.visual.input_resolution``, which reference call sites read."""

    def __init__(self, input_resolution: int):
        self.input_resolution = input_resolution


class CLIP:
    """The reference's model surface (model.py:293-442) over a port
    :class:`~clip_mixer_tpu_torch.models.clip.CLIP`, inference only.
    ``model`` / ``cfg`` are the port model and its config."""

    def __init__(self, model: _Model, cfg: CLIPConfig):
        self.model = model.eval()
        self.cfg = cfg
        self.device = model.device
        self.context_length = cfg.context_length
        self.vocab_size = cfg.vocab_size
        self.input_resolution = cfg.image_resolution
        self.visual = _VisualShim(cfg.image_resolution)

    # reference call sites (`model.eval()`, `.to(device)`, `.float()`) stay legal
    def eval(self):
        return self

    def train(self, mode: bool = True):
        if mode:
            raise RuntimeError(
                "compat.CLIP is inference-only; train with clip_mixer_tpu_torch.train "
                "(python -m clip_mixer_tpu_torch.train_cli)"
            )
        return self

    def to(self, device=None, dtype=None):
        return self

    def float(self):
        return self

    def half(self):
        return self

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (the reference sniffs conv1's, model.py:405-407)."""
        return compute_dtype(self.cfg.compute_dtype)

    @property
    def logit_scale(self) -> torch.Tensor:
        """The learned scalar before exp, like the reference parameter."""
        return self.model.logit_scale.detach()

    def _prep_images(self, image) -> torch.Tensor:
        """The reference preprocess output (normalised [B, 3, H, W] float)
        or uint8 HWC / NHWC -> the model's input: normalised NHWC in the
        compute dtype on the model's device."""
        x = torch.as_tensor(image)
        if x.ndim == 3:
            x = x[None]
        if x.ndim != 4:
            raise ValueError(f"expected [B,C,H,W] or [B,H,W,C] images, got {tuple(x.shape)}")
        if x.shape[1] == 3 and x.shape[-1] != 3:
            x = x.permute(0, 2, 3, 1)  # NCHW -> NHWC
        x = x.to(self.device)
        if x.dtype == torch.uint8:
            return normalize_images(x, dtype=self.dtype)
        return x.float().to(self.dtype)

    def _tokens(self, text) -> torch.Tensor:
        return torch.as_tensor(text).to(self.device, torch.long)

    def encode_image(self, image) -> torch.Tensor:
        """[B, embed_dim] f32 features, not normalised (model.py:410-411)."""
        with torch.inference_mode():
            return self.model.encode_image(self._prep_images(image)).float()

    def encode_text(self, text) -> torch.Tensor:
        """[B, embed_dim] f32 features, not normalised (model.py:413-426)."""
        with torch.inference_mode():
            return self.model.encode_text(self._tokens(text)).float()

    def forward(self, image, text) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The reference forward triple (model.py:428-442): L2-normalised
        image and text features (f32) and exp(logit_scale)."""
        with torch.inference_mode():
            img, txt, scale = self.model(self._prep_images(image), self._tokens(text))
        return img.float(), txt.float(), scale.float()

    __call__ = forward

    def logits(self, image, text) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits_per_image, logits_per_text), the OpenAI demo's contract."""
        with torch.inference_mode():
            return self.model.logits(self._prep_images(image), self._tokens(text))

    def state_dict(self) -> dict:
        """The reference-keyed state dict (model.py naming; ``logit_bias``,
        which the reference format has no slot for, left out), so that
        ``torch.save(model.state_dict(), ...)`` loads back through
        :func:`load` or the reference's ``build_model``."""
        return {k: v.detach() for k, v in self.model.state_dict().items() if k != "logit_bias"}


def _make_torch_transform(hwc_uint8):
    """The reference ``_transform(n_px)`` with its normalisation: PIL ->
    normalised CHW float32 tensor on the CPU, as the reference's.
    ``hwc_uint8`` is the transform ``api.load`` returns (PIL -> HWC uint8)."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32).view(3, 1, 1)
    std = torch.tensor(CLIP_STD, dtype=torch.float32).view(3, 1, 1)

    def transform(image) -> torch.Tensor:
        x = torch.from_numpy(np.array(hwc_uint8(image), np.uint8, copy=True))
        x = x.permute(2, 0, 1).to(torch.float32) / 255.0
        return (x - mean) / std

    return transform


def load(
    name: str,
    device: Optional[Union[str, torch.device]] = None,
    jit: bool = False,
    download_root: Optional[str] = None,
):
    """The reference ``clip.load``: ``(model, preprocess)``, the model on
    ``device`` (the card when None, which must exist), computing in float32
    on the CPU and in bf16 on a CUDA device. ``jit`` is ignored."""
    del jit
    device = resolve_device(device)
    dtype = "float32" if device.type == "cpu" else "bfloat16"
    model, cfg, preprocess_hwc = api.load(name, download_root=download_root, compute_dtype=dtype, device=device)
    return CLIP(model, cfg), _make_torch_transform(preprocess_hwc)
