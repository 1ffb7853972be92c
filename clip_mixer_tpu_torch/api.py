"""Public API: ``available_models``, ``load``, ``tokenize`` and the export
(``save_pretrained`` / ``load_pretrained``).

Counterpart of ``clip_mixer_tpu/api.py``. :func:`load` takes

* an OpenAI registry name ("ViT-B/32", "RN50", ...): the checkpoint is
  downloaded with its SHA256 checked (:func:`_download`) and imported;
* a local path: a torch ``.pt`` (a TorchScript archive or a state dict), a
  ``.safetensors`` file, an Accelerate save directory, or a port export
  directory (``config.json`` + ``model.pt``);
* a preset name ("mixer-b32", "vit-b32", ...): a model with the preset's
  architecture and the port's own random weights.

and returns ``(model, cfg, preprocess)``: a port :class:`CLIP` on the card
unless another device is named, and the host transform PIL.Image -> HWC
uint8 (normalisation stays with the encode paths, as in the reference).

The export is the bridge from the trainer to serving
(``outputs/<run>/export``). An export directory holds

* ``config.json``, ``dataclasses.asdict`` of the :class:`CLIPConfig`;
* ``model.pt``, the model's reference-keyed state dict, f32 but for a
  ResNet's integer ``num_batches_tracked`` (the upstream
  CLIP-mixer layout), which the JAX package's
  ``models/convert.py::load_torch_checkpoint`` (and so its ``api.load``)
  reads too. The JAX package exports orbax params instead (ROADMAP.md,
  Queue 3); a directory of those is refused here.
"""

from __future__ import annotations

import dataclasses
import fcntl
import hashlib
import json
import os
import sys
import time
import urllib.request
import warnings
from typing import Mapping, Optional, Tuple, Union

import torch

from clip_mixer_tpu_torch.config import PRESETS, CLIPConfig
from clip_mixer_tpu_torch.device import DeviceLike
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import load_torch_checkpoint
from clip_mixer_tpu_torch.ops.preprocess import make_transform
from clip_mixer_tpu_torch.text.tokenize import tokenize  # re-exported  # noqa: F401

# OpenAI checkpoint registry (the reference's clip.py:31-41); a URL's
# second-to-last component is the file's SHA256.
_MODELS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "RN50x64": "https://openaipublic.azureedge.net/clip/models/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}


def available_models():
    """Registry names, then the presets (the reference's clip.py:90-92)."""
    return list(_MODELS.keys()) + list(PRESETS.keys())


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _download(url: str, root: str, retries: int = 4) -> str:
    """The checkpoint at ``url`` in the cache directory ``root``, its SHA256
    checked (the reference's clip.py:44-73). Bytes stream into a
    ``.partial`` file; a dropped connection resumes with an HTTP Range
    request at the byte already on disk; the finished file lands by an
    atomic rename, so a torn download is never taken for a cached one.
    Concurrent callers are serialised by an ``flock`` on ``<file>.lock``:
    the second finds the first's verified file."""
    os.makedirs(root, exist_ok=True)
    expected_sha256 = url.split("/")[-2]
    target = os.path.join(root, os.path.basename(url))
    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")
    if os.path.isfile(target):
        if _sha256(target) == expected_sha256:
            return target
        warnings.warn(f"{target} exists with wrong SHA256; re-downloading")
    with open(target + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.isfile(target) and _sha256(target) == expected_sha256:
                return target
            return _download_locked(url, target, expected_sha256, retries)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _download_locked(url: str, target: str, expected_sha256: str, retries: int) -> str:
    partial = target + ".partial"
    delay = 2.0
    for attempt in range(retries + 1):
        done = os.path.getsize(partial) if os.path.exists(partial) else 0
        req = urllib.request.Request(url)
        if done:
            req.add_header("Range", f"bytes={done}-")
        try:
            with urllib.request.urlopen(req, timeout=60) as src:
                # a server that ignores Range answers 200 with the whole body:
                # start the file over instead of appending it
                resumed = done and getattr(src, "status", 200) == 206
                total = src.headers.get("Content-Length")
                total = int(total) + (done if resumed else 0) if total else None
                if not resumed:
                    done = 0
                last_print = 0
                with open(partial, "ab" if resumed else "wb") as out:
                    while True:
                        buf = src.read(1 << 16)
                        if not buf:
                            break
                        out.write(buf)
                        done += len(buf)
                        if done - last_print >= (8 << 20):
                            last_print = done
                            pct = f" ({100 * done / total:.0f}%)" if total else ""
                            print(f"\rdownloading {os.path.basename(target)}: {done >> 20} MiB{pct}",
                                  end="", file=sys.stderr)
                if last_print:
                    print(file=sys.stderr)
            break
        except Exception as e:
            status = getattr(e, "code", None) or getattr(e, "status", None)
            if status == 416 and done:  # the partial file is already whole
                break
            if attempt == retries:
                raise
            print(f"download interrupted at {done} bytes ({e}); resuming in {delay:.0f}s "
                  f"[{attempt + 1}/{retries}]", file=sys.stderr)
            time.sleep(delay)
            delay *= 2
    if _sha256(partial) != expected_sha256:
        os.remove(partial)  # poisoned bytes would fail every later resume
        raise RuntimeError("Model downloaded but the SHA256 checksum does not match")
    os.replace(partial, target)
    return target


def save_pretrained(model: Union[torch.nn.Module, Mapping[str, torch.Tensor]], cfg: CLIPConfig, path: str) -> None:
    """Write ``config.json`` and ``model.pt`` (a CLIP's state dict, or the
    state dict itself, as CPU tensors: floats in f32) to the directory
    ``path``."""
    # here, not at the top: the package's import (which takes this module) stays free of train/
    from clip_mixer_tpu_torch.train.metrics import require_local

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


def load_pretrained(path: str, device: DeviceLike = None, compute_dtype: Optional[str] = None) -> Tuple[CLIP, CLIPConfig]:
    """An export directory -> ``(model, cfg)``, the model on ``device``
    (the card unless another is named) with the exported weights;
    ``compute_dtype`` overrides the exported config's."""
    cfg = load_config(path)
    if compute_dtype is not None:
        cfg = cfg.replace(compute_dtype=compute_dtype)
    model = CLIP(cfg, device=device)
    sd = torch.load(os.path.join(path, "model.pt"), map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=True)
    return model, cfg


def load(
    name: str,
    download_root: Optional[str] = None,
    compute_dtype: Optional[str] = None,
    seed: int = 0,
    device: DeviceLike = None,
):
    """Load a CLIP model: ``(model, cfg, preprocess)``, the model on
    ``device`` (the card unless another is named).

    ``name`` resolves in the JAX package's order: a registry name (downloaded
    to ``download_root``, default ``~/.cache/clip``), a remote URI (refused:
    the port reads local paths only), a port export directory, a JAX orbax
    export directory (refused: convert it first), any other directory or a
    file (a torch checkpoint), a preset. A preset's weights are the port's
    own draw from ``torch.Generator().manual_seed(seed)``, not the JAX
    package's ``jax.random`` draw for the same seed. ``compute_dtype``
    overrides the config's activation dtype ("float32" for parity checks)."""
    if name in _MODELS:
        path = _download(_MODELS[name], download_root or os.path.expanduser("~/.cache/clip"))
        model, cfg = load_torch_checkpoint(path, device=device, compute_dtype=compute_dtype)
    elif "://" in name:
        raise RuntimeError(f"Model {name}: the port reads local paths only (ROADMAP.md, Queue 3: no gs:// paths)")
    elif os.path.isdir(name) and os.path.exists(os.path.join(name, "config.json")):
        if not os.path.exists(os.path.join(name, "model.pt")):
            if os.path.isdir(os.path.join(name, "params")):
                raise RuntimeError(
                    f"Model {name} is a JAX (orbax) export, which the port cannot read: convert it with "
                    f"`python scripts/convert_checkpoint.py {name} model.pt --to torch` and load the .pt"
                )
            raise RuntimeError(f"Model {name}: config.json without model.pt is no port export directory")
        model, cfg = load_pretrained(name, device=device, compute_dtype=compute_dtype)
    elif os.path.isdir(name) or os.path.isfile(name):
        model, cfg = load_torch_checkpoint(name, device=device, compute_dtype=compute_dtype)
    elif name in PRESETS:
        cfg = PRESETS[name]
        if compute_dtype is not None:
            cfg = cfg.replace(compute_dtype=compute_dtype)
        model = CLIP(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    else:
        raise RuntimeError(f"Model {name} not found; available models = {available_models()}")
    return model, cfg, make_transform(cfg.image_resolution)
