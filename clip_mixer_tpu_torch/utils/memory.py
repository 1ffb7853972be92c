"""Analytic per-card memory planning for every parallelism mode.

Counterpart of ``clip_mixer_tpu/utils/memory.py``: per-card bytes for the
f32 master parameters, Adam's moments, the gradients and the activation
working set of a training step, under plain data parallelism, FSDP, FSDP x
TP, TP and pipeline stages, and :func:`suggest`, the cheapest plan that fits
a card.

The byte terms come from the port's own model (built on the ``meta``
device: shapes, no storage) and its own sharding rules: FSDP's and TP's
storage spec (``parallel/fsdp.py::_merged_spec``, ``parallel/tp.py``) and
the pipeline's (``parallel/pp.py::pp_param_specs``). JAX stacks a tower's
blocks into ``[L, ...]`` leaves and its rules read those; so each block
leaf of the port is priced as its tower's stacked leaf, in JAX's layout
(:func:`jax_leaves`), and every term equals JAX's (the CPU tests hold them
to ``clip_mixer_tpu.utils.memory`` preset by preset). The model state is the
JAX tree's: the parameters and the float buffers (a ResNet's BatchNorm
running statistics, leaves of the JAX tree; not ``num_batches_tracked``).

The activation model is JAX's as it is (:func:`_activation_bytes`): it was
fitted to the TPU's compiler and has not been fitted to the card. The
default card is 80 GiB (an H100; JAX's default is a 16 GiB v5e).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from clip_mixer_tpu_torch.config import CLIPConfig

HBM_BYTES = 80 << 30  # an H100's memory


class Leaf(NamedTuple):
    """One leaf of the JAX tree: its path keys as the sharding rules read
    them, its shape in JAX's layout, its bytes, and whether it stacks a
    tower's blocks."""

    keys: Tuple[str, ...]
    shape: Tuple[int, ...]
    nbytes: int
    stacked: bool
    name: str  # a port name of it (the first block's, for a stacked leaf)


def param_shapes(cfg: CLIPConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The model state's shapes and dtypes by state-dict name: the
    parameters and the float buffers of a ``CLIP`` built on the ``meta``
    device (nothing is allocated)."""
    from clip_mixer_tpu_torch.models.clip import CLIP

    with torch.device("meta"):
        model = CLIP(cfg, device="meta")
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items() if v.is_floating_point()}


_LINEAR = re.compile(r"(_proj|\.lin\d|\.c_fc)\.weight$|in_proj_weight$")


def _jax_shape(name: str, shape: Tuple[int, ...], patch_conv: bool) -> Tuple[int, ...]:
    """A port leaf's shape in JAX's layout: ``nn.Linear`` weights [out, in]
    -> [in, out], convs [O, I, kh, kw] -> [kh, kw, I, O], and the patch
    conv (``patch_conv``: ``visual.conv1`` of a patch encoder) -> the
    [p p 3, W] patch kernel; the rest as they are."""
    if len(shape) == 4:
        if patch_conv and name == "visual.conv1.weight":
            return (shape[1] * shape[2] * shape[3], shape[0])
        return (shape[2], shape[3], shape[1], shape[0])
    if len(shape) == 2 and _LINEAR.search(name):
        return (shape[1], shape[0])
    return shape


def jax_leaves(shapes) -> List[Leaf]:
    """The JAX tree's leaves from the port's state (:func:`param_shapes`):
    each tower's blocks stacked into one leaf per block parameter, with the
    tensor-parallel path keys of ``parallel/tp.py`` (the only keys the
    rules read)."""
    from clip_mixer_tpu_torch.parallel.pp import _BLOCK
    from clip_mixer_tpu_torch.parallel.tp import _TP_DIMS

    leaves, stacks = [], {}
    patch_conv = "visual.class_embedding" in shapes  # a patch encoder, not a ResNet stem
    for name, (shape, dtype) in shapes.items():
        size = math.prod(shape) * torch.empty((), dtype=dtype, device="meta").element_size()
        m = _BLOCK.match(name)
        if m is None:
            leaves.append(Leaf((), _jax_shape(name, shape, patch_conv), size, False, name))
            continue
        rest = m.group(3)[1:]  # the block's own key, past the index's dot
        key = (m.group(1), rest)
        if key not in stacks:
            entry = _TP_DIMS.get(rest)
            stacks[key] = [entry[0] if entry else (), _jax_shape(rest, shape, False), 0, 0, name]
        stacks[key][2] += size
        stacks[key][3] += 1
    for keys, shape, size, depth, name in stacks.values():
        leaves.append(Leaf(tuple(keys), (depth, *shape), size, True, name))
    return leaves


def _full_bytes(leaves) -> int:
    return sum(leaf.nbytes for leaf in leaves)


def _fsdp_bytes(leaves, n_data: int, n_model: int = 1) -> int:
    """Per-card bytes under FSDP's storage rule over ``n_data`` (x the
    model axis of ``n_model``: each leaf divided by the product of the axes
    its merged spec shards over)."""
    from clip_mixer_tpu_torch.parallel.fsdp import _merged_spec
    from clip_mixer_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

    total = 0
    for leaf in leaves:
        div = 1
        for s in _merged_spec(leaf.shape, leaf.keys, n_data, n_model):
            div *= n_data if s == DATA_AXIS else n_model if s == MODEL_AXIS else 1
        total += leaf.nbytes // div
    return total


def _pp_bytes(leaves, n_stages: int) -> int:
    """Per-card bytes under the pipeline's placement (``pp_param_specs``
    over the whole model's block names): a stacked block leaf the stages
    split is divided by them."""
    from clip_mixer_tpu_torch.parallel.pp import _BLOCK, STAGE_AXIS, pp_param_specs

    names = {}
    for leaf in leaves:
        if leaf.stacked:
            m = _BLOCK.match(leaf.name)
            names.update({f"{m.group(1)}{i}{m.group(3)}": leaf.shape[1:] for i in range(leaf.shape[0])})
    specs = pp_param_specs(names, n_stages)
    return sum(leaf.nbytes // (n_stages if leaf.stacked and specs[leaf.name] == STAGE_AXIS else 1)
               for leaf in leaves)


@dataclasses.dataclass
class MemoryPlan:
    mode: str
    params_bytes: int  # f32 masters, per card
    opt_bytes: int  # Adam mu+nu (and the EMA), per card
    grad_bytes: int  # transient gradient buffer, per card
    act_bytes: int  # the activation working set, per card
    total_bytes: int

    def row(self) -> str:
        gib = 1 << 30
        return (
            f"{self.mode:<22} params {self.params_bytes / gib:6.2f}  "
            f"adam {self.opt_bytes / gib:6.2f}  grads {self.grad_bytes / gib:6.2f}  "
            f"acts {self.act_bytes / gib:6.2f}  total {self.total_bytes / gib:6.2f} GiB"
        )


def _activation_bytes(cfg: CLIPConfig, per_chip_batch: int, accum_steps: int = 1, n_stages: int = 1) -> int:
    """The training working set per card, JAX's estimate as it is: under
    remat the blocks' inputs [B, T, W] (plus the hidden products the
    ``remat_policy`` keeps) and one block's recompute transient; without
    remat every block's stored backward set. Accumulation divides the live
    batch; pipeline stages keep their L/S blocks' sets (the microbatch count
    cancels out of the estimate)."""
    if cfg.is_resnet:
        # ModifiedResNet's conv pyramid (stem at res/2, bottleneck stages of
        # widths w..8w at res/4..res/32): with remat the block inputs and one
        # block's recompute transient, without it every conv input
        b = per_chip_batch // max(accum_steps, 1)
        w = cfg.vision_width
        res = cfg.image_resolution
        bf = 2
        per_img = (res // 2) ** 2 * 2 * w * bf  # stem convs (not rematted)
        transient = 0
        for i, blocks in enumerate(cfg.vision_layers):
            c = w * (2 ** i)
            stage_res = res // (4 * (2 ** i))
            if cfg.remat:
                per_img += blocks * stage_res ** 2 * 4 * c * bf  # inputs
                transient = max(transient, stage_res ** 2 * 10 * c * bf)
            else:
                per_img += blocks * stage_res ** 2 * 10 * c * bf
        # the text tower follows cfg.tower and cfg.remat on its own
        if cfg.remat:
            txt_b = b * cfg.context_length * cfg.text_width * cfg.text_layers * bf
        else:
            per_tok = 9 * cfg.text_width  # input + QuickGELU hidden pair
            per_block = cfg.context_length * per_tok
            if cfg.tower == "mixer":
                per_block += 8 * cfg.context_length * cfg.text_width
            else:
                per_block += cfg.text_heads * cfg.context_length ** 2
            txt_b = b * cfg.text_layers * per_block * bf
        return int(b * (per_img + transient) + txt_b)
    bsz = per_chip_batch // max(accum_steps, 1)
    bf16 = 2
    v_tokens, v_width, v_layers = cfg.vision_tokens, cfg.vision_width, cfg.vision_layers
    t_tokens, t_width, t_layers = cfg.context_length, cfg.text_width, cfg.text_layers
    if not cfg.remat:
        # every block's backward set: the input, the QuickGELU hidden pair,
        # and the softmax probs (attention) or the token-mix hidden pair
        attn_ = cfg.tower != "mixer"

        def stored_block(tokens, width, heads):
            t = tokens * 9 * width
            if attn_:
                t += heads * tokens * tokens
            else:
                t += 8 * tokens * width
            return bsz * t * bf16

        vis = v_layers * stored_block(v_tokens, v_width, cfg.vision_heads)
        txt = t_layers * stored_block(t_tokens, t_width, cfg.text_heads)
        if n_stages > 1:
            vis //= n_stages
            txt //= n_stages
        return vis + txt
    vis = bsz * v_tokens * v_width * v_layers * bf16
    txt = bsz * t_tokens * t_width * t_layers * bf16
    # the policy's kept hidden products on top of the block inputs
    saved_sets = {"none": 0, "mlp_hidden": 1, "all_hidden": 2 if cfg.tower == "mixer" else 1}[cfg.remat_policy]
    vis += saved_sets * 4 * vis
    txt += saved_sets * 4 * txt
    if n_stages > 1:
        vis = vis // n_stages
        txt = txt // n_stages

    # one block's recompute + backward at a time: the score tensors of an
    # attention block (~3 copies) or the token-mix hidden pair, and the MLP
    # hidden pair
    def block_transient(tokens, width, heads, attention):
        t = 2 * tokens * 4 * width * bf16
        if attention:
            t += 3 * heads * tokens * tokens * bf16
        else:
            t += 2 * 4 * tokens * width * bf16
        return bsz * t

    attn = cfg.tower != "mixer"
    transient = max(
        block_transient(v_tokens, v_width, cfg.vision_heads if attn else 0, attn),
        block_transient(t_tokens, t_width, cfg.text_heads, True if attn else False),
    )
    return vis + txt + transient


def suggest(cfg: CLIPConfig, n_devices: int, global_batch: int, hbm_bytes: int = HBM_BYTES,
            headroom: float = 0.9, ema: bool = False):
    """The cheapest parallelism plan that fits ``hbm_bytes`` a card.

    Candidates in JAX's preference order: plain DP, FSDP with accumulation
    1, 2, 4, 8, FSDP x TP(2) (from 4 cards), then GPipe PP(2); the first
    whose total is within ``headroom * hbm_bytes`` wins. A ResNet tries no
    accumulation (its BatchNorm moments refuse it). Returns ``(best,
    tried)``: the winning :class:`MemoryPlan` or None, and every ``(label,
    plan or None, fits or the reason)`` in order."""
    budget = int(hbm_bytes * headroom)
    leaves = jax_leaves(param_shapes(cfg))  # once, not once per candidate
    accums = (1,) if cfg.is_resnet else (1, 2, 4, 8)

    def candidates():
        yield "dp", dict(mode="dp", n_devices=n_devices), n_devices, 1
        for a in accums:
            yield f"fsdp accum{a}", dict(mode="fsdp", n_devices=n_devices), n_devices, a
        if n_devices >= 4 and n_devices % 2 == 0:
            for a in accums:
                yield f"fsdp x tp2 accum{a}", dict(mode="fsdp", n_devices=n_devices, n_model=2), n_devices // 2, a
        if n_devices % 2 == 0:
            for a in accums:
                yield f"pp2 accum{a}", dict(mode="pp", n_devices=2), n_devices // 2, a

    best = None
    tried = []
    for label, kw, n_data, accum in candidates():
        if global_batch % n_data:
            tried.append((label, None, f"global batch {global_batch} not divisible by {n_data} data shards"))
            continue
        per_chip = global_batch // n_data
        if per_chip % accum:
            tried.append((label, None, f"per-chip batch {per_chip} not divisible by accum {accum}"))
            continue
        try:
            p = plan(cfg, per_chip_batch=per_chip, accum_steps=accum, leaves=leaves, ema=ema, **kw)
        except ValueError as e:
            tried.append((label, None, str(e)))
            continue
        fits = p.total_bytes <= budget
        tried.append((label, p, fits))
        if fits and best is None:
            best = p
    return best, tried


def plan(cfg: CLIPConfig, mode: str, n_devices: int, per_chip_batch: int, accum_steps: int = 1, n_model: int = 1,
         leaves: Optional[List[Leaf]] = None, ema: bool = False) -> MemoryPlan:
    """The per-card plan. ``mode``: dp | fsdp | tp | pp (the tp / pp
    divisor is ``n_devices``: a pure mesh). ``n_model > 1`` with
    ``mode="fsdp"`` plans FSDP x TP on an (n_devices / n_model) x n_model
    grid. TP is priced at its storage: whole masters, moments and gradients
    (the slices live inside the step). ``leaves``: :func:`jax_leaves` of
    the config, for a caller pricing many plans. ``ema``: an EMA copy
    stored like the parameters."""
    if leaves is None:
        leaves = jax_leaves(param_shapes(cfg))
    full = _full_bytes(leaves)
    n_stages = 1
    if mode in ("dp", "tp"):
        p_bytes, opt_bytes, grad_bytes = full, 2 * full, full
    elif mode == "fsdp":
        if n_devices % n_model:
            raise ValueError(f"n_model {n_model} does not divide {n_devices} devices")
        p_bytes = _fsdp_bytes(leaves, n_devices // n_model, n_model)
        opt_bytes, grad_bytes = 2 * p_bytes, p_bytes
    elif mode == "pp":
        if cfg.is_resnet:
            raise ValueError("pp needs a uniform block stack")
        if cfg.vision_layers % n_devices or cfg.text_layers % n_devices:
            raise ValueError(f"pp needs both tower depths divisible by stages: "
                             f"{cfg.vision_layers}/{cfg.text_layers} vs {n_devices}")
        p_bytes = _pp_bytes(leaves, n_devices)
        opt_bytes, grad_bytes = 2 * p_bytes, p_bytes
        n_stages = n_devices
    else:
        raise ValueError(mode)

    if ema:
        opt_bytes += p_bytes  # the EMA is stored as the parameters are
    act = _activation_bytes(cfg, per_chip_batch, accum_steps, n_stages)
    total = p_bytes + opt_bytes + grad_bytes + act
    label = f"{mode}x{n_devices}"
    if mode == "fsdp" and n_model > 1:
        label = f"fsdp{n_devices // n_model}x tp{n_model}"
    return MemoryPlan(mode=label + (f" accum{accum_steps}" if accum_steps > 1 else ""), params_bytes=p_bytes,
                      opt_bytes=opt_bytes, grad_bytes=grad_bytes, act_bytes=act, total_bytes=total)
