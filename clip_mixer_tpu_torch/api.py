"""The inference export: ``save_pretrained`` and ``load_pretrained``.

Counterpart of the export part of ``clip_mixer_tpu/api.py``: the bridge from
the trainer to serving (``outputs/<run>/export``). An export directory holds

* ``config.json``, ``dataclasses.asdict`` of the :class:`CLIPConfig`;
* ``model.pt``, the model's reference-keyed state dict, f32 but for a
  ResNet's integer ``num_batches_tracked`` (the upstream
  CLIP-mixer layout), which the JAX package's
  ``models/convert.py::load_torch_checkpoint`` (and so its ``api.load``)
  reads too. The JAX package exports orbax params instead (ROADMAP.md,
  Queue 3).

The rest of ``api.py`` (``load``, the model registry) waits for Slice E.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Tuple, Union

import torch

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.device import DeviceLike
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.train.metrics import require_local


def save_pretrained(model: Union[torch.nn.Module, Mapping[str, torch.Tensor]], cfg: CLIPConfig, path: str) -> None:
    """Write ``config.json`` and ``model.pt`` (a CLIP's state dict, or the
    state dict itself, as CPU tensors: floats in f32) to the directory
    ``path``."""
    require_local(path, "export path")
    sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    target = os.path.join(path, "model.pt")
    tmp = f"{target}.tmp{os.getpid()}"
    torch.save({k: v.detach().to("cpu", torch.float32 if v.is_floating_point() else v.dtype).contiguous()
                for k, v in sd.items()}, tmp)
    os.replace(tmp, target)


def load_config(path: str) -> CLIPConfig:
    """The export's ``config.json``; keys this version does not know are
    ignored (an export written by a newer version still loads)."""
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    if isinstance(raw.get("vision_layers"), list):
        raw["vision_layers"] = tuple(raw["vision_layers"])
    known = {f.name for f in dataclasses.fields(CLIPConfig)}
    return CLIPConfig(**{k: v for k, v in raw.items() if k in known})


def load_pretrained(path: str, device: DeviceLike = None) -> Tuple[CLIP, CLIPConfig]:
    """An export directory -> ``(model, cfg)``, the model on ``device``
    (the card unless another is named) with the exported weights."""
    cfg = load_config(path)
    model = CLIP(cfg, device=device)
    sd = torch.load(os.path.join(path, "model.pt"), map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=True)
    return model, cfg
