"""PyTorch/CUDA port of the CLIP models (Mixer, transformer and ResNet towers) in ``clip_mixer_tpu``.

The JAX package beside it is the reference this port is tested against. The
port imports neither JAX nor ``clip_mixer_tpu``. Its entry points run on the
CUDA device unless the caller names another (``device="cpu"``).

Quick start (the reference README's demo)::

    import torch
    import clip_mixer_tpu_torch as clip
    from clip_mixer_tpu_torch.ops.preprocess import normalize_images

    model, cfg, preprocess = clip.load("mixer-b32")        # the card; device="cpu" on the CPU
    image = torch.tensor(preprocess(PIL.Image.open("CLIP.png")))[None].to(model.device)  # [1, H, W, 3] uint8
    text = torch.from_numpy(clip.tokenize(["a diagram", "a dog", "a cat"])).to(model.device)
    with torch.no_grad():
        per_image, per_text = model.logits(normalize_images(image), text)
    probs = per_image.softmax(-1)

``load`` also takes an OpenAI registry name, a torch checkpoint or a port
export directory (``save_pretrained``); see ``api.py``.
"""

from clip_mixer_tpu_torch.api import available_models, load, load_pretrained, save_pretrained
from clip_mixer_tpu_torch.config import PRESETS, CLIPConfig, TrainConfig
from clip_mixer_tpu_torch.device import resolve_device
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import load_jax_params
from clip_mixer_tpu_torch.text import tokenize

__version__ = "0.1.0"

__all__ = [
    "available_models",
    "load",
    "load_pretrained",
    "save_pretrained",
    "tokenize",
    "CLIPConfig",
    "TrainConfig",
    "PRESETS",
    "__version__",
    "CLIP",
    "load_jax_params",
    "resolve_device",
]
