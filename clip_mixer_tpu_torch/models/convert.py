"""Weight bridge from the JAX package's parameter tree to the port's module.

The tree is the JAX ``models.clip.init`` layout with numpy leaves: tower
blocks stacked along a leading layer axis ``[L, ...]`` and linear kernels
stored (in, out). :func:`jax_params_to_state_dict` maps it to the reference
state-dict keys (the names the port's modules carry); :func:`load_jax_params`
loads that into a :class:`~clip_mixer_tpu_torch.models.clip.CLIP` strictly.
:func:`load_jax_mixer` fills a single block or tower from its JAX subtree;
both go through the one per-block mapping, :func:`jax_block_arrays`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.models.mixer import MixerBlock, MixerTower
from clip_mixer_tpu_torch.models.towers import require_mixer


def _f32(a) -> np.ndarray:
    return np.array(a, np.float32)


def _tensors(arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(a, np.float32, order="C")) for k, a in arrays.items()}


def jax_block_arrays(block: Mapping) -> Dict[str, np.ndarray]:
    """One unstacked JAX mixer block (``{"ln_token", "token_mix",
    "ln_channel", "channel_mix"}``, numpy leaves, (in, out) kernels) ->
    f32 arrays under a :class:`MixerBlock`'s own state-dict keys."""
    tm, cm = block["token_mix"], block["channel_mix"]
    return {
        "layerNorm1.weight": _f32(block["ln_token"]["scale"]),
        "layerNorm1.bias": _f32(block["ln_token"]["bias"]),
        "token_mix_seq.lin1.weight": _f32(tm["w_in"]).T,
        "token_mix_seq.lin1.bias": _f32(tm["b_in"]),
        "token_mix_seq.lin2.weight": _f32(tm["w_out"]).T,
        "token_mix_seq.lin2.bias": _f32(tm["b_out"]),
        "layerNorm2.weight": _f32(block["ln_channel"]["scale"]),
        "layerNorm2.bias": _f32(block["ln_channel"]["bias"]),
        "channel_mix_seq.lin3.weight": _f32(cm["w_in"]).T,
        "channel_mix_seq.lin3.bias": _f32(cm["b_in"]),
        "channel_mix_seq.lin4.weight": _f32(cm["w_out"]).T,
        "channel_mix_seq.lin4.bias": _f32(cm["b_out"]),
    }


def _layer(tree: Mapping, i: int) -> Dict:
    """Layer ``i`` of a tree of stacked ``[L, ...]`` leaves."""
    return {k: _layer(v, i) if isinstance(v, Mapping) else np.asarray(v)[i] for k, v in tree.items()}


def _tower_arrays(tower: Mapping) -> Dict[str, np.ndarray]:
    """A JAX tower ``{"blocks": stacked blocks}`` -> a :class:`MixerTower`'s keys."""
    blocks = tower["blocks"]
    n_layers = np.asarray(blocks["ln_token"]["scale"]).shape[0]
    return {
        f"mixBlocks.{i}.{k}": v for i in range(n_layers) for k, v in jax_block_arrays(_layer(blocks, i)).items()
    }


def load_jax_mixer(module: Union[MixerBlock, MixerTower], tree: Mapping):
    """Fill a :class:`MixerBlock` from one unstacked JAX block tree, or a
    :class:`MixerTower` from a JAX tower ``{"blocks": stacked blocks}``
    (what ``clip_mixer_tpu.models.mixer.init_mixer_tower`` returns); strict,
    in place. Returns ``module``."""
    if isinstance(module, MixerBlock):
        arrays = jax_block_arrays(tree)
    elif isinstance(module, MixerTower):
        arrays = _tower_arrays(tree)
    else:
        raise TypeError(f"load_jax_mixer fills a MixerBlock or a MixerTower, got {type(module).__name__}")
    module.load_state_dict(_tensors(arrays), strict=True)
    return module


def jax_params_to_state_dict(tree: Mapping, cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """JAX mixer param tree (numpy leaves) -> reference-keyed state dict."""
    require_mixer(cfg)
    sd: Dict[str, np.ndarray] = {}

    def put_ln(prefix, ln):
        sd[f"{prefix}.weight"] = _f32(ln["scale"])
        sd[f"{prefix}.bias"] = _f32(ln["bias"])

    def put_tower(prefix, tower):
        sd.update({f"{prefix}.{k}": v for k, v in _tower_arrays(tower).items()})

    v = tree["visual"]
    p = cfg.vision_patch_size
    w = _f32(v["patch_embed"]["kernel"])  # [(ph pw c), W]
    sd["visual.conv1.weight"] = w.reshape(p, p, 3, cfg.vision_width).transpose(3, 2, 0, 1)
    sd["visual.class_embedding"] = _f32(v["class_embedding"])
    put_ln("visual.ln_pre", v["ln_pre"])
    put_tower("visual.transformer", v["tower"])
    put_ln("visual.ln_post", v["ln_post"])
    sd["visual.proj"] = _f32(v["proj"])

    t = tree["text"]
    sd["token_embedding.weight"] = _f32(t["token_embedding"])
    put_tower("transformer", t["tower"])
    put_ln("ln_final", t["ln_final"])
    sd["text_projection"] = _f32(t["projection"])
    # A "logit_bias" leaf (sigmoid-loss training only) has no slot here and
    # does not change inference.
    sd["logit_scale"] = _f32(tree["logit_scale"])
    return _tensors(sd)


def load_jax_params(model, tree: Mapping):
    """Fill ``model`` (a port CLIP) from a JAX param tree; returns ``model``."""
    model.load_state_dict(jax_params_to_state_dict(tree, model.cfg), strict=True)
    return model
