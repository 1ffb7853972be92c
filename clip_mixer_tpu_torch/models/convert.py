"""Weight bridge from the JAX package's parameter tree to the port's module.

The tree is the JAX ``models.clip.init`` layout with numpy leaves: tower
blocks stacked along a leading layer axis ``[L, ...]`` and linear kernels
stored (in, out). :func:`jax_params_to_state_dict` maps it to the reference
state-dict keys (the names the port's modules carry); :func:`load_jax_params`
loads that into a :class:`~clip_mixer_tpu_torch.models.clip.CLIP` strictly.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.models.towers import require_mixer


def _f32(a) -> np.ndarray:
    return np.array(a, np.float32)


def jax_params_to_state_dict(tree: Mapping, cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """JAX mixer param tree (numpy leaves) -> reference-keyed state dict."""
    require_mixer(cfg)
    sd: Dict[str, np.ndarray] = {}

    def put_ln(prefix, ln):
        sd[f"{prefix}.weight"] = _f32(ln["scale"])
        sd[f"{prefix}.bias"] = _f32(ln["bias"])

    def put_tower(prefix, tower):
        blocks = tower["blocks"]
        n_layers = np.asarray(blocks["ln_token"]["scale"]).shape[0]
        for i in range(n_layers):
            p = f"{prefix}.mixBlocks.{i}"
            tm, cm = blocks["token_mix"], blocks["channel_mix"]
            put_ln(f"{p}.layerNorm1", {k: v[i] for k, v in blocks["ln_token"].items()})
            sd[f"{p}.token_mix_seq.lin1.weight"] = _f32(tm["w_in"][i]).T
            sd[f"{p}.token_mix_seq.lin1.bias"] = _f32(tm["b_in"][i])
            sd[f"{p}.token_mix_seq.lin2.weight"] = _f32(tm["w_out"][i]).T
            sd[f"{p}.token_mix_seq.lin2.bias"] = _f32(tm["b_out"][i])
            put_ln(f"{p}.layerNorm2", {k: v[i] for k, v in blocks["ln_channel"].items()})
            sd[f"{p}.channel_mix_seq.lin3.weight"] = _f32(cm["w_in"][i]).T
            sd[f"{p}.channel_mix_seq.lin3.bias"] = _f32(cm["b_in"][i])
            sd[f"{p}.channel_mix_seq.lin4.weight"] = _f32(cm["w_out"][i]).T
            sd[f"{p}.channel_mix_seq.lin4.bias"] = _f32(cm["b_out"][i])

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
    return {k: torch.from_numpy(np.array(a, np.float32, order="C")) for k, a in sd.items()}


def load_jax_params(model, tree: Mapping):
    """Fill ``model`` (a port CLIP) from a JAX param tree; returns ``model``."""
    model.load_state_dict(jax_params_to_state_dict(tree, model.cfg), strict=True)
    return model
