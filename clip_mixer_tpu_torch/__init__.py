"""PyTorch/CUDA port of the Mixer CLIP in ``clip_mixer_tpu``.

The JAX package beside it is the reference this port is tested against. The
port imports neither JAX nor ``clip_mixer_tpu``. Its entry points run on the
CUDA device unless the caller names another (``device="cpu"``).
"""

from clip_mixer_tpu_torch.config import PRESETS, CLIPConfig
from clip_mixer_tpu_torch.device import resolve_device
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import load_jax_params

__all__ = ["CLIP", "CLIPConfig", "PRESETS", "load_jax_params", "resolve_device"]
