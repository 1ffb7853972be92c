"""Tensor parallelism over the mesh's "model" dimension (megatron-style).

Counterpart of ``clip_mixer_tpu/parallel/tp.py``. Each block's MLP hidden
dimension (4W) is split over the ranks of a model group: ``w_in`` by its
output rows, ``w_out`` by its input columns (``nn.Linear``'s [out, in]
layout). Attention is split by heads: each rank computes nh/m heads end to
end and one all-reduce reassembles the out-projection. Token mixes, norms and
embeddings stay whole on every rank.

JAX runs these blocks inside ``shard_map`` on hidden-sharded parameters; here
each rank holds plain local slices (:func:`shard_model_tp` cuts them in place)
and the blocks call the two collectives explicitly:

* :func:`f_psum`: the identity forward, an all-reduce backward: the partial
  input cotangents of a hidden-sharded contraction summed to the full one;
* :func:`g_psum`: an all-reduce forward, the identity backward. A raw
  all-reduce must not be used there: its gradient would be another all-reduce,
  which multiplies the replicated cotangents by the group size.

The packed QKV of ``nn.MultiheadAttention`` (q|k|v, each [W, W]) cannot be
cut into heads by one contiguous slice, so :func:`shard_model_tp` permutes its
rows to head-major order (for each head h: q_h|k_h|v_h,
:func:`reorder_attn_head_major`), takes this rank's contiguous block of heads,
and packs that block back as q|k|v of its own heads, the layout the whole
model's attention reads (so a model group of one holds the whole QKV as it
was, bit for bit); :func:`gather_tp` undoes the three. The out-projection's
input columns are head-major already.

No kernel runs under a model group, as in JAX (``clip_mixer_tpu/models/
mixer.py:65``): ``fused_mlp`` and the fused-block route refuse it.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from clip_mixer_tpu_torch.models.layers import checkpoint_name, layer_norm, quick_gelu


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _FPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def f_psum(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward (x whole on every rank of ``group``); all-reduce of
    the cotangent backward."""
    return _FPsum.apply(x, group)


def g_psum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce over ``group`` forward; the identity backward."""
    return _GPsum.apply(x, group)


def sharded_mlp(y, w_in, b_in, w_out, b_out, group) -> torch.Tensor:
    """g_psum(QuickGELU(f_psum(y) w_in^T + b_in) w_out^T) + b_out on y
    [..., W], whole on every rank of ``group``; ``w_in`` [H/m, W], ``b_in``
    [H/m] and ``w_out`` [W, H/m] are this rank's slices, ``b_out`` [W] whole
    and added after the reduction. The weights are cast to y's dtype; the
    hidden product carries the ``mlp_hidden`` tag, as the whole MLP's does."""
    dt = y.dtype
    y = f_psum(y, group)
    with checkpoint_name("mlp_hidden"):
        h = y @ w_in.to(dt).t()
    h = quick_gelu(h + b_in.to(dt))
    return g_psum(h @ w_out.to(dt).t(), group) + b_out.to(dt)


def tp_channel_mlp(x, ln_w, ln_b, w_in, b_in, w_out, b_out, group) -> torch.Tensor:
    """``layers.channel_mlp`` with its hidden dimension split over ``group``."""
    return x + sharded_mlp(layer_norm(x, ln_w, ln_b), w_in, b_in, w_out, b_out, group)


def tp_attention(attn, y: torch.Tensor, head_dim: int, mask: Optional[torch.Tensor], group) -> torch.Tensor:
    """Head-split multi-head attention on y [B, T, W], whole on every rank:
    ``attn.in_proj_weight`` [3 * nh_local * hd, W] holds this rank's heads
    packed q|k|v, ``attn.out_proj.weight`` [W, nh_local * hd] the matching
    columns; the out bias is whole and added after the reduction."""
    from clip_mixer_tpu_torch.models.transformer import attention_core

    dt = y.dtype
    nh_local = attn.in_proj_weight.shape[0] // (3 * head_dim)
    y = f_psum(y, group)
    qkv = y @ attn.in_proj_weight.to(dt).t() + attn.in_proj_bias.to(dt)
    out = attention_core(qkv, nh_local, mask)
    return g_psum(out @ attn.out_proj.weight.to(dt).t(), group) + attn.out_proj.bias.to(dt)


# ---- which leaves are split -------------------------------------------------------------------------

# port parameter suffix -> (JAX path keys, the dimension it is split on, in
# the port's layout). JAX's rule (tp_leaf_dim) reads [L, in, out] kernels;
# nn.Linear's weights are [out, in], so a hidden output dim is the port's 0.
_TP_DIMS = {
    "channel_mix_seq.lin3.weight": (("channel_mix", "w_in"), 0),
    "channel_mix_seq.lin3.bias": (("channel_mix", "b_in"), 0),
    "channel_mix_seq.lin4.weight": (("channel_mix", "w_out"), 1),
    "mlp.c_fc.weight": (("mlp", "w_in"), 0),
    "mlp.c_fc.bias": (("mlp", "b_in"), 0),
    "mlp.c_proj.weight": (("mlp", "w_out"), 1),
    "attn.in_proj_weight": (("attn", "qkv_kernel"), 0),
    "attn.in_proj_bias": (("attn", "qkv_bias"), 0),
    "attn.out_proj.weight": (("attn", "out_kernel"), 1),
}
_BLOCK = re.compile(r"^(?:visual\.)?transformer\.(?:mixBlocks|resblocks)\.\d+\.(.+)$")


def tp_leaf_dim(keys) -> Optional[int]:
    """The dimension (negative index) a JAX leaf splits over the model axis,
    or None: JAX's rule on its path keys, kept as it is (``clip_mixer_tpu/
    parallel/tp.py:70``), for the FSDP x TP storage rule of
    ``parallel/fsdp.py``."""
    if not keys:
        return None
    name = keys[-1]
    if "channel_mix" in keys or "mlp" in keys:
        if name in ("w_in", "b_in"):
            return -1
        if name == "w_out":
            return -2
    if "attn" in keys:
        if name in ("qkv_kernel", "qkv_bias"):
            return -1
        if name == "out_kernel":
            return -2
    return None


def port_tp_dim(name: str) -> Optional[int]:
    """The dimension of the port parameter ``name`` (a state-dict key) that
    tensor parallelism splits, in the port's layout, or None (whole on every
    rank): the blocks' MLP hidden dims and attention's packed QKV rows and
    out-projection columns, as JAX's ``tp_leaf_dim``."""
    m = _BLOCK.match(name)
    if m is None:
        return None
    entry = _TP_DIMS.get(m.group(1))
    return None if entry is None else entry[1]


def tp_param_specs(model) -> Dict[str, Optional[int]]:
    """Each parameter's split dimension under tensor parallelism (None =
    whole), by name: the counterpart of JAX's ``tp_param_specs``. A ResNet
    vision trunk has no blocks of this kind and stays whole."""
    return {n: port_tp_dim(n) for n, _ in model.named_parameters()}


def _head_major_perm(width: int, n_heads: int) -> np.ndarray:
    """Row permutation: canonical packed q|k|v -> per-head q_h|k_h|v_h."""
    hd = width // n_heads
    return np.arange(3 * width).reshape(3, n_heads, hd).transpose(1, 0, 2).reshape(-1)


def reorder_attn_head_major(t: torch.Tensor, n_heads: int, inverse: bool = False) -> torch.Tensor:
    """A packed QKV weight [3W, W] or bias [3W] with its rows in head-major
    order (``inverse``: back to q|k|v)."""
    perm = _head_major_perm(t.shape[0] // 3, n_heads)
    if inverse:
        perm = np.argsort(perm)
    return t[torch.as_tensor(perm, device=t.device)]


def _towers(model):
    """(tower module, n_heads or None, tower name) of each block tower that
    tensor parallelism splits: a ResNet trunk is not one."""
    cfg = model.cfg
    out = []
    if not cfg.is_resnet:
        out.append((model.visual.transformer, cfg.vision_heads if cfg.use_transformer else None, "visual"))
    out.append((model.transformer, cfg.text_heads if cfg.use_transformer else None, "text"))
    return out


def check_tp(cfg, m: int) -> None:
    """JAX's checks of a model axis of ``m`` ranks (``clip_mixer_tpu/
    parallel/train_step.py:231-235``), and the port's: no kernel route."""
    if cfg.use_transformer:
        if cfg.text_heads % m:
            raise ValueError(f"text_heads={cfg.text_heads} is not divisible by the {m} ranks of the model axis")
        if not cfg.is_resnet and cfg.vision_heads % m:
            raise ValueError(f"vision_heads={cfg.vision_heads} is not divisible by the {m} ranks of the model axis")
    widths = [cfg.text_width] + ([] if cfg.is_resnet else [cfg.vision_width])
    for w in widths:
        if (4 * w) % m:
            raise ValueError(f"the MLP hidden dim {4 * w} is not divisible by the {m} ranks of the model axis")
    if cfg.fused_mlp:
        raise ValueError("fused_mlp runs no kernel under a model axis (as in JAX): train the plain route "
                         "(fused_mlp=False) with tensor parallelism")


@torch.no_grad()
def shard_model_tp(model, group):
    """Cut ``model``'s block parameters to this rank's slices of ``group``
    (the mesh's model group), in place, and route its blocks through the
    split MLP and attention; returns the model. Every rank must hold the same
    whole model before (``mesh.replicate``). The Adam moments and EMA made
    after this are sliced alike."""
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import is_routed

    m, r = group_size(group), (0 if group is None else dist.get_rank(group))
    check_tp(model.cfg, m)
    if is_routed(model):
        raise ValueError("the fused-block route runs no kernel under a model axis (as in JAX): unroute the "
                         "towers (route_towers(model, False)) for tensor parallelism")
    for tower, n_heads, _ in _towers(model):
        blocks = tower.resblocks if n_heads is not None else tower.mixBlocks
        for block in blocks:
            for suffix, (_, dim) in _TP_DIMS.items():
                mod_path, _, leaf = suffix.rpartition(".")
                mod = _resolve(block, mod_path)
                if mod is None or not hasattr(mod, leaf):
                    continue
                t = getattr(mod, leaf).detach()
                qkv = suffix.startswith("attn.in_proj")
                if qkv:
                    t = reorder_attn_head_major(t, n_heads)
                size = t.shape[dim] // m
                t = t.narrow(dim, r * size, size)
                if qkv:  # this rank's heads, packed q|k|v
                    t = reorder_attn_head_major(t, n_heads // m, inverse=True)
                setattr(mod, leaf, torch.nn.Parameter(t.contiguous()))
            block.model_group = group
    model.tp_group = group
    return model


def _resolve(module, path: str):
    for part in path.split(".") if path else ():
        module = getattr(module, part, None)
        if module is None:
            return None
    return module


def gather_tp(name: str, local: torch.Tensor, group, n_heads: Optional[int]) -> torch.Tensor:
    """The whole parameter ``name`` from each rank's ``local`` slice (a
    collective over ``group``: every rank calls it), QKV rows back in q|k|v
    order; ``local`` as it is for a parameter that is not split."""
    dim = port_tp_dim(name)
    if dim is None or group is None:
        return local
    m = group_size(group)
    parts = [torch.empty_like(local) for _ in range(m)]
    dist.all_gather(parts, local.contiguous(), group=group)
    if ".attn.in_proj" not in name:
        return torch.cat(parts, dim=dim)
    whole = torch.cat([reorder_attn_head_major(t, n_heads // m) for t in parts])
    return reorder_attn_head_major(whole, n_heads, inverse=True)


def heads_of(model, name: str) -> Optional[int]:
    """The head count of the tower that holds parameter ``name`` (None for a
    mixer tower or a parameter outside the towers)."""
    cfg = model.cfg
    if not cfg.use_transformer:
        return None
    return cfg.vision_heads if name.startswith("visual.") else cfg.text_heads
