"""Weight bridge from the JAX package's parameter tree to the port's module.

The tree is the JAX ``models.clip.init`` layout with numpy leaves: tower
blocks stacked along a leading layer axis ``[L, ...]`` and linear kernels
stored (in, out). :func:`jax_params_to_state_dict` maps it to the reference
state-dict keys (the names the port's modules carry), for mixer and
transformer towers; :func:`load_jax_params` loads that into a
:class:`~clip_mixer_tpu_torch.models.clip.CLIP` strictly.
:func:`load_jax_mixer` fills a single mixer block or tower from its JAX
subtree; both go through the per-block mappings, :func:`jax_block_arrays`
and :func:`jax_attn_block_arrays`. :func:`load_jax_qparams` builds the int8
towers of ``ops/quant.py`` from the JAX package's quantized tree
(``quantize_vision_tower`` / ``quantize_text_tower``, their ViT
counterparts and ``quantize_resnet_tower``), so both packages run the same
int8 weights and scales. A ResNet's keys are the reference's
(:func:`jax_resnet_arrays`).
"""

from __future__ import annotations

import json
import os
import struct
import zipfile
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.mixer import MixerBlock, MixerTower
from clip_mixer_tpu_torch.ops.quant import QuantResNet, QuantTextTower, QuantVisionTower


def _f32(a) -> np.ndarray:
    return np.array(a, np.float32)


def _tensors(arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """f32 tensors, but integer arrays (``num_batches_tracked``) as int64."""
    return {k: torch.from_numpy(np.array(a, np.int64 if np.asarray(a).dtype.kind in "iu" else np.float32, order="C"))
            for k, a in arrays.items()}


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


def jax_attn_block_arrays(block: Mapping) -> Dict[str, np.ndarray]:
    """One unstacked JAX transformer block (``{"ln_1", "attn", "ln_2",
    "mlp"}``) -> f32 arrays under a ``ResidualAttentionBlock``'s keys: the
    packed ``qkv_kernel`` (W, 3W) becomes ``in_proj_weight`` (3W, W)."""
    attn, mlp = block["attn"], block["mlp"]
    return {
        "ln_1.weight": _f32(block["ln_1"]["scale"]),
        "ln_1.bias": _f32(block["ln_1"]["bias"]),
        "attn.in_proj_weight": _f32(attn["qkv_kernel"]).T,
        "attn.in_proj_bias": _f32(attn["qkv_bias"]),
        "attn.out_proj.weight": _f32(attn["out_kernel"]).T,
        "attn.out_proj.bias": _f32(attn["out_bias"]),
        "ln_2.weight": _f32(block["ln_2"]["scale"]),
        "ln_2.bias": _f32(block["ln_2"]["bias"]),
        "mlp.c_fc.weight": _f32(mlp["w_in"]).T,
        "mlp.c_fc.bias": _f32(mlp["b_in"]),
        "mlp.c_proj.weight": _f32(mlp["w_out"]).T,
        "mlp.c_proj.bias": _f32(mlp["b_out"]),
    }


def _layer(tree: Mapping, i: int) -> Dict:
    """Layer ``i`` of a tree of stacked ``[L, ...]`` leaves."""
    return {k: _layer(v, i) if isinstance(v, Mapping) else np.asarray(v)[i] for k, v in tree.items()}


def _tower_arrays(tower: Mapping) -> Dict[str, np.ndarray]:
    """A JAX tower ``{"blocks": stacked blocks}`` -> a :class:`MixerTower`'s
    keys, or a ``TransformerTower``'s for transformer blocks."""
    blocks = tower["blocks"]
    if "ln_1" in blocks:
        prefix, arrays, ln = "resblocks", jax_attn_block_arrays, "ln_1"
    else:
        prefix, arrays, ln = "mixBlocks", jax_block_arrays, "ln_token"
    n_layers = np.asarray(blocks[ln]["scale"]).shape[0]
    return {f"{prefix}.{i}.{k}": v for i in range(n_layers) for k, v in arrays(_layer(blocks, i)).items()}


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
    """JAX param tree (numpy leaves; mixer, transformer or ResNet towers) ->
    reference-keyed state dict: key for key and value for value the JAX
    package's ``params_to_state_dict``."""
    sd: Dict[str, np.ndarray] = {}

    def put_ln(prefix, ln):
        sd[f"{prefix}.weight"] = _f32(ln["scale"])
        sd[f"{prefix}.bias"] = _f32(ln["bias"])

    def put_tower(prefix, tower):
        sd.update({f"{prefix}.{k}": v for k, v in _tower_arrays(tower).items()})

    v = tree["visual"]
    if cfg.is_resnet:
        sd.update(jax_resnet_arrays(v, cfg))
    else:
        p = cfg.vision_patch_size
        w = _f32(v["patch_embed"]["kernel"])  # [(ph pw c), W]
        sd["visual.conv1.weight"] = w.reshape(p, p, 3, cfg.vision_width).transpose(3, 2, 0, 1)
        sd["visual.class_embedding"] = _f32(v["class_embedding"])
        if cfg.use_transformer:
            sd["visual.positional_embedding"] = _f32(v["pos_embedding"])
        put_ln("visual.ln_pre", v["ln_pre"])
        put_tower("visual.transformer", v["tower"])
        put_ln("visual.ln_post", v["ln_post"])
        sd["visual.proj"] = _f32(v["proj"])

    t = tree["text"]
    sd["token_embedding.weight"] = _f32(t["token_embedding"])
    if cfg.use_transformer:
        sd["positional_embedding"] = _f32(t["pos_embedding"])
    put_tower("transformer", t["tower"])
    put_ln("ln_final", t["ln_final"])
    sd["text_projection"] = _f32(t["projection"])
    sd["logit_scale"] = _f32(tree["logit_scale"])
    if "logit_bias" in tree:  # the SigLIP loss's learnable bias
        sd["logit_bias"] = _f32(tree["logit_bias"])
    return _tensors(sd)


def jax_resnet_blocks(v: Mapping, cfg: CLIPConfig):
    """(key prefix, JAX bottleneck subtree) of every bottleneck of a JAX
    ResNet visual tree, in forward order."""
    return [(f"layer{i + 1}.{b}", bp) for i in range(len(cfg.vision_layers)) for b, bp in enumerate(v[f"layer{i + 1}"])]


def jax_resnet_convs(v: Mapping, cfg: CLIPConfig):
    """(conv key prefix, BN key prefix, JAX conv subtree, JAX BN subtree) of
    every conv site of a JAX ResNet visual tree, in forward order."""
    sites = [(f"conv{i}", f"bn{i}", v[f"conv{i}"], v[f"bn{i}"]) for i in (1, 2, 3)]
    for p, bp in jax_resnet_blocks(v, cfg):
        sites += [(f"{p}.conv{j}", f"{p}.bn{j}", bp[f"conv{j}"], bp[f"bn{j}"]) for j in (1, 2, 3)]
        if "downsample" in bp:
            sites.append((f"{p}.downsample.0", f"{p}.downsample.1", bp["downsample"]["conv"], bp["downsample"]["bn"]))
    return sites


def jax_resnet_arrays(v: Mapping, cfg: CLIPConfig) -> Dict[str, np.ndarray]:
    """A JAX ResNet visual tree -> the reference's ``visual.*`` keys: HWIO
    kernels become OIHW ``.weight``s, each BN site ``weight``, ``bias``,
    ``running_mean``, ``running_var`` and ``num_batches_tracked`` (0, as the
    JAX export writes it), the attention pool's (in, out) kernels
    ``{q,k,v,c}_proj`` weights (out, in)."""
    sd: Dict[str, np.ndarray] = {}
    for conv_key, bn_key, conv, bn in jax_resnet_convs(v, cfg):
        sd[f"visual.{conv_key}.weight"] = _f32(conv["kernel"]).transpose(3, 2, 0, 1)
        sd[f"visual.{bn_key}.weight"] = _f32(bn["scale"])
        sd[f"visual.{bn_key}.bias"] = _f32(bn["bias"])
        sd[f"visual.{bn_key}.running_mean"] = _f32(bn["mean"])
        sd[f"visual.{bn_key}.running_var"] = _f32(bn["var"])
        sd[f"visual.{bn_key}.num_batches_tracked"] = np.asarray(0, np.int64)
    pool = v["attnpool"]
    sd["visual.attnpool.positional_embedding"] = _f32(pool["pos_embedding"])
    for name in ("q", "k", "v", "c"):
        sd[f"visual.attnpool.{name}_proj.weight"] = _f32(pool[name]["kernel"]).T
        sd[f"visual.attnpool.{name}_proj.bias"] = _f32(pool[name]["bias"])
    return sd


def load_jax_params(model, tree: Mapping):
    """Fill ``model`` (a port CLIP) from a JAX param tree; returns ``model``."""
    model.load_state_dict(jax_params_to_state_dict(tree, model.cfg), strict=True)
    return model


def _copy_pack(q_out_in: torch.Tensor, scale: torch.Tensor, pack: Mapping) -> None:
    """A JAX int8 pack ``{"q": [in, out], "scale": [out]}`` into a quant
    module's [out, in] buffer (its columns past ``in``, the padding of K,
    zero) and its scale."""
    q = np.asarray(pack["q"], np.int8).reshape(-1, q_out_in.shape[0])
    q_out_in.zero_()
    q_out_in[:, :q.shape[0]].copy_(torch.from_numpy(np.ascontiguousarray(q.T)))
    scale.copy_(torch.from_numpy(_f32(pack["scale"])))


def _load_quant_resnet(model, v: Mapping) -> QuantResNet:
    """A JAX quantized ResNet visual tree (``quantize_resnet_tower``: per
    conv site ``{"q": int8 HWIO, "scale", "bias", "a"}``) as a
    :class:`QuantResNet` on ``model``'s float tower: the tree's int8
    kernels (flattened in (kh, kw, cin) order), scales, folded biases and
    activation scales."""
    sites = [(f"conv{i}", v[f"conv{i}"]) for i in (1, 2, 3)]
    for p, bp in jax_resnet_blocks(v, model.cfg):
        sites += [(f"{p}.{k}", pack) for k, pack in bp.items()]  # conv1..3 and downsample: the port's names
    a_scales: Dict = {f"conv{i}": v[f"conv{i}"]["a"] for i in (1, 2, 3)}
    for i in range(len(model.cfg.vision_layers)):
        a_scales[f"layer{i + 1}"] = [{k: p["a"] for k, p in bp.items()} for bp in v[f"layer{i + 1}"]]
    vision = QuantResNet(model.visual, a_scales)
    for name, pack in sites:
        qc = vision.get_submodule(name)
        _copy_pack(qc.q, qc.scale, pack)  # HWIO flattens to the patch order (kh, kw, cin) x out
        qc.bias.copy_(torch.from_numpy(_f32(pack["bias"])))
    return vision


# (pack, bias attribute of the quant block, the JAX block subtree, its int8
# pack key, its bias key) for each int8 product of a block
_MIXER_PACKS = (("w_in", "b_in", "channel_mix", "w_in_q", "b_in"),
                ("w_out", "b_out", "channel_mix", "w_out_q", "b_out"))
_ATTN_PACKS = (("qkv", "qkv_bias", "attn", "qkv_q", "qkv_bias"),
               ("out", "out_bias", "attn", "out_q", "out_bias"),
               ("w_in", "b_in", "mlp", "w_in_q", "b_in"),
               ("w_out", "b_out", "mlp", "w_out_q", "b_out"))


def _load_quant_blocks(tower, tree_blocks: Mapping) -> None:
    """A JAX tower's stacked int8 packs into ``tower``'s quant blocks (Mixer
    or transformer); the biases the tree carries must be the float model's."""
    packs = _ATTN_PACKS if tower.cfg.use_transformer else _MIXER_PACKS
    for i, block in enumerate(tower.blocks):
        for pack, bias_attr, sub, q_key, bias_key in packs:
            bias = getattr(block, bias_attr)
            if not np.array_equal(_f32(tree_blocks[sub][bias_key])[i], bias.detach().cpu().numpy()):
                raise ValueError(
                    f"block {i}: {bias_key} differs from the model's; load the tree's float "
                    "weights into the model first (load_jax_params)"
                )
            _copy_pack(getattr(block, f"{pack}_q"), getattr(block, f"{pack}_scale"), _layer(tree_blocks[sub][q_key], i))


@torch.no_grad()
def load_jax_qparams(model, qtree: Mapping) -> Tuple[Optional[nn.Module], Optional[QuantTextTower]]:
    """The int8 towers of a JAX quantized tree (numpy leaves; Mixer, ViT or
    ResNet: a :class:`QuantVisionTower` or :class:`QuantResNet`)
    on ``model``, the port CLIP that holds the tree's float weights
    (``load_jax_params``): ``(vision, text)``, each None where the tree's
    tower is not quantized. The int8 weights, their scales and the
    activation scales (``a_scales``, absent: dynamic) are the tree's."""
    v, t = qtree["visual"], qtree["text"]
    # the subtree and key of a block's first int8 pack, present when the text tower is quantized
    first, q_key = ("attn", "qkv_q") if model.cfg.use_transformer else ("channel_mix", "w_in_q")
    vision = text = None
    if model.cfg.is_resnet:
        if "q" in v["conv1"]:
            vision = _load_quant_resnet(model, v)
    elif "kernel_q" in v["patch_embed"]:
        vision = QuantVisionTower(model.visual, v.get("a_scales"))
        _copy_pack(vision.patch_q, vision.patch_scale, v["patch_embed"]["kernel_q"])
        vision.set_planar()
        _load_quant_blocks(vision, v["tower"]["blocks"])
    if q_key in t["tower"]["blocks"][first]:
        text = QuantTextTower(model, t.get("a_scales"))
        _load_quant_blocks(text, t["tower"]["blocks"])
    return vision, text


# ---- reference-keyed checkpoints: the import -----------------------------------


def sniff_config(sd: Mapping) -> CLIPConfig:
    """The architecture of a reference-keyed state dict, from its keys and
    ``.shape``s alone (a copy of the JAX package's ``sniff_config``, which
    extends the reference's ``build_model`` with the Mixer branch)."""
    is_vit = "visual.proj" in sd
    is_mixer = any(".mixBlocks." in k for k in sd)

    embed_dim = sd["text_projection"].shape[1]
    vocab_size = sd["token_embedding.weight"].shape[0]
    text_width = sd["ln_final.weight"].shape[0]
    if is_mixer:
        context_length = sd["transformer.mixBlocks.0.token_mix_seq.lin1.weight"].shape[1]
        text_layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.mixBlocks")})
    else:
        context_length = sd["positional_embedding"].shape[0]
        text_layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")})

    if is_vit:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_patch = sd["visual.conv1.weight"].shape[-1]
        if is_mixer:
            vision_layers = len({k.split(".")[3] for k in sd if k.startswith("visual.transformer.mixBlocks")})
            vis_tokens = sd["visual.transformer.mixBlocks.0.token_mix_seq.lin1.weight"].shape[1]
            grid = round((vis_tokens - 1) ** 0.5)
        else:
            vision_layers = len([k for k in sd if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")])
            grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch * grid
    else:
        vision_layers = tuple(
            len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")}) for b in (1, 2, 3, 4)
        )
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        vision_patch = None
        out_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = out_width * 32

    return CLIPConfig(
        embed_dim=embed_dim,
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch,
        context_length=context_length,
        vocab_size=vocab_size,
        text_width=text_width,
        text_heads=text_width // 64,
        text_layers=text_layers,
        tower="mixer" if is_mixer else "transformer",
    )


# keys of the reference's JIT archives that are no weights (its model.py:507-509)
_BOOKKEEPING = ("input_resolution", "context_length", "vocab_size")


def _non_persistent(model: nn.Module):
    """State-dict names of ``model``'s non-persistent buffers (the causal
    mask), which a TorchScript archive's ``state_dict`` carries."""
    return {f"{name}.{b}" if name else b for name, m in model.named_modules() for b in m._non_persistent_buffers_set}


@torch.no_grad()
def load_reference_state_dict(sd: Mapping, device=None, compute_dtype: Optional[str] = None):
    """A reference-keyed state dict (any float dtype; OpenAI's archives are
    fp16) -> ``(CLIP, cfg)``, the model on ``device`` (the card unless
    another is named) with the weights as f32 masters.

    The architecture is sniffed (:func:`sniff_config`); ``compute_dtype``
    overrides its activation dtype. As the JAX importer does, the reference's
    bookkeeping keys and a ``logit_bias`` are dropped (the sniffed config has
    no slot for it); a ResNet's absent ``num_batches_tracked`` is taken as
    0. Every other tensor must fit: a missing, unexpected or misshapen one
    raises, and no model is returned."""
    sd = {k: v for k, v in sd.items() if k not in _BOOKKEEPING and k != "logit_bias"}
    cfg = sniff_config(sd)
    if compute_dtype is not None:
        cfg = cfg.replace(compute_dtype=compute_dtype)
    model = CLIP(cfg, device=device)
    skip = _non_persistent(model)
    want = model.state_dict()
    got: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k in skip:
            continue
        v = torch.as_tensor(v)
        got[k] = v.to(torch.float32) if v.is_floating_point() else v.to(torch.int64)
    for k in want:
        if k.endswith(".num_batches_tracked") and k not in got:
            got[k] = torch.zeros((), dtype=torch.int64)
    try:
        model.load_state_dict(got, strict=True)
    except RuntimeError as e:
        raise RuntimeError(f"the state dict does not fit the sniffed {cfg.tower} architecture: {e}") from None
    return model, cfg


# safetensors dtype -> numpy dtype, little-endian (BF16 read as its uint16 bits)
_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2", "I64": "<i8", "I32": "<i4",
    "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> CPU tensors, read without the
    ``safetensors`` package: an 8-byte little-endian header length, a JSON
    header (dtype, shape, data offsets per tensor), then the raw
    little-endian bytes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.path.getsize(path) - 8 - n)
        f.readinto(data)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the reader does not know")
        dt = np.dtype(_SAFETENSORS_DTYPES[info["dtype"]])
        begin, end = info["data_offsets"]
        count = int(np.prod(info["shape"], dtype=np.int64))
        if end - begin != count * dt.itemsize or end > len(data):
            raise ValueError(f"{path}: {name}'s data offsets {begin}..{end} do not fit {info['shape']} {info['dtype']}")
        t = torch.from_numpy(np.frombuffer(data, dt, count, begin).reshape(info["shape"]))
        out[name] = t.view(torch.bfloat16) if info["dtype"] == "BF16" else t
    return out


def _is_torchscript(path: str) -> bool:
    """A TorchScript archive is a zip holding ``<name>/constants.pkl``; a
    ``torch.save`` zip holds none."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("/constants.pkl") for n in z.namelist())


# an Accelerate save_state directory's weight files, in the order looked for
CHECKPOINT_FILES = ("model.safetensors", "pytorch_model.bin", "pytorch_model/mp_rank_00_model_states.pt")


def read_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a torch checkpoint: a TorchScript archive (OpenAI's
    ``.pt``), a ``torch.save`` file (loaded with ``weights_only=True``), a
    ``.safetensors`` file, or an Accelerate ``save_state`` directory (its
    first of :data:`CHECKPOINT_FILES`). A ``{"state_dict": ...}`` wrapper
    is opened and a ``module.`` prefix on every key removed."""
    if os.path.isdir(path):
        for name in CHECKPOINT_FILES:
            if os.path.exists(os.path.join(path, name)):
                path = os.path.join(path, name)
                break
        else:
            raise FileNotFoundError(f"no model weights found under {path} (looked for {', '.join(CHECKPOINT_FILES)})")
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
    elif _is_torchscript(path):
        sd = dict(torch.jit.load(path, map_location="cpu").state_dict())
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, Mapping) and "state_dict" in sd:
        sd = sd["state_dict"]
    if sd and all(k.startswith("module.") for k in sd):  # DDP-wrapped (Accelerate)
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return dict(sd)


def load_torch_checkpoint(path: str, device=None, compute_dtype: Optional[str] = None):
    """A torch checkpoint (:func:`read_torch_checkpoint`) -> ``(CLIP, cfg)``
    through :func:`load_reference_state_dict`."""
    return load_reference_state_dict(read_torch_checkpoint(path), device=device, compute_dtype=compute_dtype)
