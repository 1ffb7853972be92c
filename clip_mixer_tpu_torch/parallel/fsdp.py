"""FSDP (ZeRO-3): parameters and optimiser state sharded over the data axis.

Counterpart of ``clip_mixer_tpu/parallel/fsdp.py``. JAX pins a
``NamedSharding`` on every leaf and lets the SPMD partitioner insert the
all-gathers and reduce-scatters; here PyTorch's FSDP2 (``fully_shard``) does
that work with module hooks:

* :func:`apply_fsdp` shards ``model`` over the mesh's ``"data"`` group. Each
  parameter that JAX's rule shards (:func:`fsdp_spec` / :func:`_merged_spec`,
  kept as they are: a leaf of at least ``_MIN_SHARD_ELEMS`` elements, on the
  last dimension the axis divides, in JAX's layout) is stored as a ``DTensor``
  shard on that dimension (FSDP's ``shard_placement_fn``); every other
  parameter (small leaves, leaves no dimension of which the axis divides, and
  the scalar ``logit_scale`` / ``logit_bias``, which ``fully_shard`` refuses)
  stays whole on every rank, outside FSDP (``ignored_params``), and the step
  averages its gradient itself (``train_step.average_gradients``).
* The units are the blocks (a ``MixerBlock`` or ``ResidualAttentionBlock``
  each), then the root for the rest. A tower routed through the fused-block
  kernel (``ops/kernels/mixer_block.py::route_towers``) reads its blocks'
  parameters without calling the blocks, so the tower is one unit: its call
  unshards every block's parameters before the kernels read them, FSDP's
  pre-backward hook gathers them again for the backward that the kernels'
  autograd functions saved them for, and its post-backward hook
  reduce-scatters every block's gradient. ``CLIP.forward_train`` is
  registered as a forward method of the root, so a ResNet trunk, whose
  training forward calls no module, is unsharded around it too.
* :func:`make_fsdp_train_step` is the data-parallel step with
  ``grad_through_gather=True``, always, as JAX's FSDP step trains the exact
  globally coupled loss (``clip_mixer_tpu/parallel/fsdp.py:164-185``).
  FSDP's reduce-scatter averages the sharded leaves' gradients over the data
  group; the rest are averaged by the step. The optimiser works on the local
  shards (Adam's moments and the EMA are stored sharded alike) and takes the
  global gradient norm over them (``train/optimizer.py``).

With tensor parallelism (a model dimension above one), ``parallel/tp.py``
cuts the slices first; FSDP then shards each slice over ``"data"`` on
another dimension, JAX's grid-sharded storage: a channel ``w_in`` [H, W]
on a 2 x 2 mesh is held as [H/2, W/2] a rank.

FSDP's mixed-precision policy stays at its default: the all-gather and the
reduce-scatter are f32, and the routes cast as they do on one device, so a
world of one is bit for bit the single-device step.

Stated deviations: a port leaf is one block's, where JAX stacks the blocks
[L, ...]. The size rule is read on the stacked size, as JAX reads it; JAX's
stacked axis itself is never sharded here (JAX would shard it only for a
leaf no other dimension of which the axis divides, which no preset has).
Under tensor parallelism the hidden leaves are always sliced (the split
compute needs them), where JAX's storage rule leaves a small one whole.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from clip_mixer_tpu_torch.config import CLIPConfig, TrainConfig
from clip_mixer_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, data_group
from clip_mixer_tpu_torch.parallel.pp import gather_stages, stage_local_name
from clip_mixer_tpu_torch.parallel.tp import gather_tp, group_size, heads_of, port_tp_dim, tp_leaf_dim
from clip_mixer_tpu_torch.parallel.train_step import make_train_step
from clip_mixer_tpu_torch.train.optimizer import Optimizer, local

# Leaves smaller than this stay replicated: sharding a small bias saves
# nothing and costs a collective.
_MIN_SHARD_ELEMS = 4096


def fsdp_spec(shape: Tuple[int, ...], n_shard: int, min_elems: int = _MIN_SHARD_ELEMS) -> tuple:
    """The leaf's spec (a tuple of axis names or None, () = replicated),
    sharding the last dim divisible by ``n_shard`` over the data axis; JAX's
    ``fsdp_spec`` with its ``PartitionSpec`` as a tuple."""
    return _merged_spec(shape, (), n_shard, 1, min_elems)


def _merged_spec(shape: Tuple[int, ...], path_keys, n_data: int, n_model: int,
                 min_elems: int = _MIN_SHARD_ELEMS) -> tuple:
    """FSDP x TP storage spec of a JAX-layout leaf: the tensor-parallel
    dimension (``tp_leaf_dim`` of its path) to the model axis, then the LAST
    remaining dim divisible by ``n_data`` to the data axis; with a model dim
    assigned, the data scan skips the leading stacked-layer axis of
    ndim >= 2 leaves. JAX's rule as it is (``clip_mixer_tpu/parallel/
    fsdp.py:68``)."""
    ndim = len(shape)
    spec = [None] * ndim
    size = 1
    for d in shape:
        size *= d
    if n_model > 1 and ndim > 0 and size >= min_elems:
        dim = tp_leaf_dim(list(path_keys))
        if dim is not None:
            dim %= ndim
            if shape[dim] >= n_model and shape[dim] % n_model == 0:
                spec[dim] = MODEL_AXIS
    if n_data > 1 and size >= min_elems:
        lowest = 1 if (MODEL_AXIS in spec and ndim >= 2) else 0
        for ax in range(ndim - 1, lowest - 1, -1):
            if spec[ax] is None and shape[ax] >= n_data and shape[ax] % n_data == 0:
                spec[ax] = DATA_AXIS
                break
    if all(s is None for s in spec):
        return ()
    return tuple(spec)


# ---- the port's leaves in JAX's terms -----------------------------------------------------------------

_BLOCK = re.compile(r"^(?:visual\.)?transformer\.(?:mixBlocks|resblocks)\.\d+\.")
_STACK = "L"  # JAX's stacked-layer axis, which a port leaf does not have


def _scan_order(name: str, shape: Tuple[int, ...], stacked: bool) -> list:
    """The port dims of ``name`` in the order JAX's rule scans its own
    layout (last dim first), ending with the stacked axis for a block leaf.
    ``nn.Linear`` weights are [out, in] where JAX's kernels are [in, out];
    a conv's [O, I, kh, kw] is JAX's [kh, kw, I, O] (the patch conv's JAX
    kernel flattens kh, kw, I into one dim, which the port cannot shard)."""
    if len(shape) == 2 and re.search(r"(_proj|\.lin\d|\.c_fc)\.weight$|in_proj_weight$", name):
        order = [0, 1]
    elif len(shape) == 4:
        order = [0] if name == "visual.conv1.weight" else [0, 1, 3, 2]
    else:
        order = list(range(len(shape) - 1, -1, -1))
    return order + ([_STACK] if stacked else [])


def leaf_dims(name: str, shape: Tuple[int, ...], n_layers: int, n_data: int, n_model: int,
              min_elems: int = _MIN_SHARD_ELEMS) -> Tuple[Optional[int], Optional[int]]:
    """(data dim, model dim) of the port leaf ``name`` of whole shape
    ``shape``, in the port's layout: :func:`_merged_spec` read on the JAX
    layout of the leaf (the size on the stacked [L, ...] leaf for a block's,
    ``n_layers`` blocks). Unlike JAX's, a data axis of one rank still picks
    a dim (FSDP manages the leaf; its shard is the whole of it). The model
    dim is the split dim of ``parallel/tp.py`` whenever ``n_model > 1``."""
    stacked = _BLOCK.match(name) is not None
    size = 1
    for d in shape:
        size *= d
    if stacked:
        size *= n_layers
    model_dim = port_tp_dim(name) if n_model > 1 else None
    data_dim = None
    if size >= min_elems and len(shape) > 0:
        for d in _scan_order(name, shape, stacked):
            if d == _STACK:
                break  # JAX would shard the stacked axis (or, with a model dim, skip it): the port keeps it whole
            if d != model_dim and shape[d] >= n_data and shape[d] % n_data == 0:
                data_dim = d
                break
    return data_dim, model_dim


def _tower_layers(cfg: CLIPConfig, name: str) -> int:
    return cfg.vision_layers if name.startswith("visual.") and not cfg.is_resnet else cfg.text_layers


# ---- applying FSDP ---------------------------------------------------------------------------------------


def _units(model):
    """The modules ``fully_shard`` wraps below the root: each tower's blocks,
    or the whole tower where the fused-block route reads its blocks'
    parameters without calling them."""
    towers = [getattr(model.visual, "transformer", None), model.transformer]
    units = []
    for tower in towers:
        if tower is None:
            continue
        if "forward" in vars(tower):  # route_towers(model, True)
            units.append(tower)
        else:
            units.extend(getattr(tower, "mixBlocks", None) or tower.resblocks)
    return units


def apply_fsdp(model, mesh):
    """Shard ``model`` (a CLIP, its blocks already cut by
    ``tp.shard_model_tp`` under a model dimension) over ``mesh``'s data
    group with FSDP2, in place; returns the model. Route the towers
    (``route_towers``) before, not after."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    data_mesh = mesh[DATA_AXIS]
    n_data, n_model = mesh.size(0), mesh.size(1)
    tp = getattr(model, "tp_group", None)
    if n_model > 1 and tp is None:
        raise ValueError("a mesh with a model dimension needs the blocks cut first (parallel/tp.py::shard_model_tp)")
    placement, ignored = {}, set()
    for name, p in model.named_parameters():
        whole = list(p.shape)
        tp_dim = port_tp_dim(name) if tp is not None else None
        if tp_dim is not None:
            whole[tp_dim] *= group_size(tp)
        d, _ = leaf_dims(name, tuple(whole), _tower_layers(model.cfg, name), n_data, n_model)
        if d is None:
            ignored.add(p)
        else:
            placement[p] = Shard(d)
    kw = dict(mesh=data_mesh, shard_placement_fn=lambda p: placement[p], ignored_params=ignored)
    for unit in _units(model):
        fully_shard(unit, **kw)
    fully_shard(model, **kw)
    register_fsdp_forward_method(model, "forward_train")
    model.fsdp_mesh = data_mesh
    return model


def is_sharded(model) -> bool:
    """Whether ``model``'s parameters are split over ranks (FSDP, tensor
    parallelism, or pipeline stages of more than one rank): a checkpoint or
    an export then needs every rank."""
    return (getattr(model, "fsdp_mesh", None) is not None or getattr(model, "tp_group", None) is not None
            or getattr(model, "pp_stages", 1) > 1)


def layout(model) -> Optional[dict]:
    """The sharded layout of ``model`` (None when every rank holds it
    whole): the world, the mesh's dims, whether FSDP shards it, the
    pipeline stages (when more than one), and each parameter's local shape,
    a stage's blocks keyed by their index within the stage (so the layout is
    alike on every rank)."""
    if not is_sharded(model):
        return None
    fsdp_mesh, tp = getattr(model, "fsdp_mesh", None), getattr(model, "tp_group", None)
    lay = {"world": dist.get_world_size(), "n_data": 1 if fsdp_mesh is None else fsdp_mesh.size(),
           "n_model": group_size(tp), "fsdp": fsdp_mesh is not None}
    if getattr(model, "pp_stages", 1) > 1:
        lay["n_stage"] = model.pp_stages
    lay["shapes"] = {stage_local_name(model, n): list(local(p).shape) for n, p in model.named_parameters()}
    return lay


def describe(lay: Optional[dict]) -> str:
    if lay is None:
        return "whole on every rank (replicated)"
    stages = f", {lay['n_stage']} pipeline stages" if "n_stage" in lay else ""
    return (f"a world of {lay['world']}: data {lay['n_data']} x model {lay['n_model']}{stages}, "
            f"{'FSDP-sharded' if lay['fsdp'] else 'not FSDP-sharded'}")


def gather_full(model, tensors: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The whole, canonical tensors of ``model``'s state dict (or of
    ``tensors``, keyed alike and laid out as the model's: the EMA), on the
    model's device: each FSDP shard gathered over the data group, each
    tensor-parallel slice over the model group, each pipeline stage's
    blocks over the stage group (``pp.gather_stages``). A collective: every
    rank calls it, in the same order."""
    params = dict(model.named_parameters())
    sd = model.state_dict() if tensors is None else tensors
    fsdp_mesh, tp = getattr(model, "fsdp_mesh", None), getattr(model, "tp_group", None)
    out = {}
    for k, v in sd.items():
        t = local(v).detach()
        p = params.get(k)
        if fsdp_mesh is not None and p is not None and hasattr(p, "placements") and fsdp_mesh.size() > 1:
            dim = p.placements[0].dim
            parts = [torch.empty_like(t) for _ in range(fsdp_mesh.size())]
            dist.all_gather(parts, t.contiguous(), group=fsdp_mesh.get_group())
            t = torch.cat(parts, dim=dim)
        if p is not None:
            t = gather_tp(k, t, tp, heads_of(model, k))
        out[k] = t
    return gather_stages(model, out)


def make_fsdp_train_step(cfg: CLIPConfig, tcfg: TrainConfig, optimizer: Optimizer, mesh,
                         chunk_size: Optional[int] = None, accum_steps: int = 1):
    """``step(state, batch) -> (state, metrics)`` for a model sharded by
    :func:`apply_fsdp` over ``mesh``: the data-parallel step over the mesh's
    data group with ``grad_through_gather=True`` (the exact global loss),
    two-pass GradCache accumulation, EMA, the ``logit_scale`` clamp and the
    ResNet BN merge, as JAX's ``make_fsdp_train_step``; the batch is this
    rank's rows (``mesh.shard_batch`` over the data group)."""
    step = make_train_step(cfg, tcfg, optimizer, grad_through_gather=True, chunk_size=chunk_size,
                           accum_steps=accum_steps, group=data_group(mesh))

    def fsdp_step(state, batch):
        if getattr(state.model, "fsdp_mesh", None) is None:
            raise ValueError("make_fsdp_train_step trains a model sharded by parallel/fsdp.py::apply_fsdp")
        return step(state, batch)

    return fsdp_step
