"""Weight bridge from the JAX package's parameter tree to the port's module.

The tree is the JAX ``models.clip.init`` layout with numpy leaves: tower
blocks stacked along a leading layer axis ``[L, ...]`` and linear kernels
stored (in, out). :func:`jax_params_to_state_dict` maps it to the reference
state-dict keys (the names the port's modules carry); :func:`load_jax_params`
loads that into a :class:`~clip_mixer_tpu_torch.models.clip.CLIP` strictly.
:func:`load_jax_mixer` fills a single block or tower from its JAX subtree;
both go through the one per-block mapping, :func:`jax_block_arrays`.
:func:`load_jax_qparams` builds the int8 towers of ``ops/quant.py`` from the
JAX package's quantized tree (``quantize_vision_tower`` /
``quantize_text_tower``), so both packages run the same int8 weights and
scales.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.models.mixer import MixerBlock, MixerTower
from clip_mixer_tpu_torch.models.towers import require_mixer
from clip_mixer_tpu_torch.ops.quant import QuantTextTower, QuantVisionTower


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
    sd["logit_scale"] = _f32(tree["logit_scale"])
    if "logit_bias" in tree:  # the SigLIP loss's learnable bias
        sd["logit_bias"] = _f32(tree["logit_bias"])
    return _tensors(sd)


def load_jax_params(model, tree: Mapping):
    """Fill ``model`` (a port CLIP) from a JAX param tree; returns ``model``."""
    model.load_state_dict(jax_params_to_state_dict(tree, model.cfg), strict=True)
    return model


def _copy_pack(q_out_in: torch.Tensor, scale: torch.Tensor, pack: Mapping) -> None:
    """A JAX int8 pack ``{"q": [in, out], "scale": [out]}`` into a quant
    module's [out, in] buffer and its scale."""
    q_out_in.copy_(torch.from_numpy(np.ascontiguousarray(np.asarray(pack["q"], np.int8).T)))
    scale.copy_(torch.from_numpy(_f32(pack["scale"])))


def _load_quant_blocks(blocks, cm: Mapping) -> None:
    """A JAX tower's stacked int8 channel mix into :class:`QuantMixerBlock`s;
    the biases it carries must be the float model's."""
    for i, block in enumerate(blocks):
        for name, bias in (("in", block.b_in), ("out", block.b_out)):
            if not np.array_equal(_f32(cm[f"b_{name}"])[i], bias.detach().cpu().numpy()):
                raise ValueError(
                    f"block {i}: b_{name} differs from the model's; load the tree's float "
                    "weights into the model first (load_jax_params)"
                )
            _copy_pack(getattr(block, f"w_{name}_q"), getattr(block, f"w_{name}_scale"), _layer(cm[f"w_{name}_q"], i))


@torch.no_grad()
def load_jax_qparams(model, qtree: Mapping) -> Tuple[Optional[QuantVisionTower], Optional[QuantTextTower]]:
    """The int8 towers of a JAX quantized tree (numpy leaves) on ``model``,
    the port CLIP that holds the tree's float weights (``load_jax_params``):
    ``(vision, text)``, each None where the tree's tower is not quantized.
    The int8 weights, their scales and the activation scales (``a_scales``,
    absent: dynamic) are the tree's."""
    v, t = qtree["visual"], qtree["text"]
    vision = text = None
    if "kernel_q" in v["patch_embed"]:
        vision = QuantVisionTower(model.visual, v.get("a_scales"))
        _copy_pack(vision.patch_q, vision.patch_scale, v["patch_embed"]["kernel_q"])
        vision.set_planar()
        _load_quant_blocks(vision.blocks, v["tower"]["blocks"]["channel_mix"])
    if "w_in_q" in t["tower"]["blocks"]["channel_mix"]:
        text = QuantTextTower(model, t.get("a_scales"))
        _load_quant_blocks(text.blocks, t["tower"]["blocks"]["channel_mix"])
    return vision, text
