"""Pipeline parallelism: the towers' blocks split over a "stage" mesh dimension.

Counterpart of ``clip_mixer_tpu/parallel/pp.py``. Each rank of a stage group
holds a contiguous ``L / S`` slice of each tower's blocks
(:func:`shard_model_pp`); everything else (the embeddings, ``ln_pre``, the
heads, ``logit_scale``) stays whole on every stage rank. The blocks keep
their indices in the whole tower, so a stage rank's state-dict keys are the
whole model's keys of its blocks (:class:`StageBlocks`).

Schedule: GPipe fill-drain over ``n_micro + S - 1`` ticks
(:func:`pipeline_tower`). Every tick each stage runs its slice on its
current microbatch and hands the result to the next stage (:class:`_Hop`,
point-to-point over the stage group, the counterpart of JAX's ``ppermute``);
stage 0 feeds microbatch ``min(t, n_micro - 1)``, the last stage collects
microbatch ``t - (S - 1)``. Autograd derives the backward schedule: the
hop's backward sends each cotangent to the previous stage. The bubble is
(S - 1) / (n_micro + S - 1).

The graph is the same on every rank: the stage-0 select and the last
stage's collect are ``torch.where`` on a 0-d flag, never a Python ``if``, so
every rank records every hop and calls every hop's backward in the same
order (a branch would drop stage 0's received state from its graph, its
hop's backward would never run, and stage 1 would block on its send). The
last tick's hand-off, whose result no rank reads, is not made on any rank.

Two fixups keep the replicated parameters' gradients equal on every stage
rank, with no extra all-reduce (one would double them), as in JAX:

* the tower's input enters at stage 0 only, so its cotangent lands there
  alone: ``tp.f_psum`` over the stage group (identity forward, all-reduce
  backward) gives every stage rank the full cotangent for the embeddings;
* the output is collected on the last stage only (zeros elsewhere):
  ``tp.g_psum`` (all-reduce forward, identity backward) gives every stage
  rank the activations for the replicated head, while the cotangent enters
  the pipeline at the last stage alone (the masked collect).

:func:`make_pp_train_step` is the data-parallel step over the mesh's data
group (``parallel/train_step.py``) on a model cut by :func:`shard_model_pp`:
the loss and its gathers run over the data group, the gradients are
averaged over the data group only (a block's gradient belongs to its
stage), and the global gradient norm sums the block leaves' squares over the
stage group (``train_step.split_groups``). With ``accum_steps > 1`` each
GradCache chunk runs the whole schedule.

NCCL takes no two ranks on one card, so on one card the stage group has one
rank and no hop moves anything: the card proves the schedule and the
microbatching and the kernels under it, the CPU worlds over gloo the hops.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from clip_mixer_tpu_torch.config import CLIPConfig, TrainConfig
from clip_mixer_tpu_torch.device import DeviceLike, resolve_device
from clip_mixer_tpu_torch.parallel.mesh import DATA_AXIS, data_group
from clip_mixer_tpu_torch.parallel.tp import f_psum, g_psum
from clip_mixer_tpu_torch.parallel.train_step import make_train_step
from clip_mixer_tpu_torch.train.optimizer import Optimizer

STAGE_AXIS = "stage"
# a block leaf: (tower prefix up to the list, block index, the rest)
_BLOCK = re.compile(r"^((?:visual\.)?transformer\.(?:mixBlocks|resblocks)\.)(\d+)(\..+)$")


class Pipeline(NamedTuple):
    """What a tower runs its blocks under: the stage group, the stages, the
    microbatches a step."""

    group: object
    n_stages: int
    n_micro: int


class StageBlocks(nn.ModuleList):
    """A stage's contiguous blocks of a tower, registered under their
    indices in the whole tower (``offset`` on), so their state-dict keys are
    the whole model's; indexing, ``len`` and iteration are the slice's."""

    def __init__(self, blocks, offset: int):
        super().__init__()
        self.offset = offset
        for i, block in enumerate(blocks):
            self.add_module(str(offset + i), block)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]


def make_pp_mesh(n_data: int, n_stage: int, device: DeviceLike = None):
    """A ``(data, stage)`` mesh over every rank of the default process group
    (which must be up), of ``device``'s type. Stages sit on adjacent ranks:
    rank ``i * n_stage + j`` is data row ``i``, stage ``j``, so a data row's
    hand-offs stay on one host. A layout that would leave ranks idle is
    refused, as ``mesh.make_mesh`` refuses one."""
    from torch.distributed.device_mesh import init_device_mesh

    if n_data < 1 or n_stage < 1:
        raise ValueError(f"a {n_data} x {n_stage} mesh has no ranks")
    if not dist.is_initialized():
        raise RuntimeError("make_pp_mesh needs an initialised process group (parallel/dist.py)")
    n = dist.get_world_size()
    if n_data * n_stage != n:
        raise ValueError(f"a {n_data} x {n_stage} (data, stage) mesh does not cover the {n} ranks")
    return init_device_mesh(resolve_device(device).type, (n_data, n_stage), mesh_dim_names=(DATA_AXIS, STAGE_AXIS))


def n_stages_of(mesh) -> int:
    """The stages of ``mesh`` (1 for no mesh or a mesh without a stage dimension)."""
    if mesh is None or STAGE_AXIS not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(STAGE_AXIS))


# ---- the hand-off and the schedule ---------------------------------------------------------------------


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Every rank of ``group`` sends ``x`` to rank ``r + step`` and returns
    what rank ``r - step`` sent it (zeros where there is no such rank), one
    batch of point-to-point operations, waited on."""
    r, n = dist.get_rank(group), dist.get_world_size(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if 0 <= r + step < n:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, r + step), group))
    if 0 <= r - step < n:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, r - step), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Hop(torch.autograd.Function):
    """Stage s's activations to stage s + 1 (stage 0 receives zeros); the
    backward sends each cotangent to stage s - 1 (the last stage's output
    cotangent from the hop is zeros): JAX's ``ppermute`` and its transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _collected(t: int, n_stages: int, n_micro: int) -> Optional[int]:
    """The microbatch the last stage collects at tick ``t``: ``t - (S - 1)``
    once the pipe is full (None while it fills)."""
    m = t - (n_stages - 1)
    return m if 0 <= m < n_micro else None


def pipeline_tower(x: torch.Tensor, stage_fn: Callable[[torch.Tensor], torch.Tensor], pipe: Pipeline) -> torch.Tensor:
    """The whole block stack on x [B, T, W] (whole on every stage rank)
    through the GPipe schedule: ``stage_fn`` runs this stage's blocks on one
    microbatch. Returns [B, T, W], whole on every stage rank."""
    group, S, n_micro = pipe
    B = x.shape[0]
    if n_micro < 1 or B % n_micro:
        raise ValueError(f"a batch of {B} rows does not split into {n_micro} pipeline microbatches")
    stage = dist.get_rank(group)
    x = f_psum(x, group)
    x_mb = x.reshape(n_micro, B // n_micro, *x.shape[1:])
    first = torch.full((), stage == 0, device=x.device)
    last = torch.full((), stage == S - 1, device=x.device)
    n_ticks = n_micro + S - 1
    state = torch.zeros_like(x_mb[0])
    outs = [torch.zeros_like(x_mb[0]) for _ in range(n_micro)]
    for t in range(n_ticks):
        inp = torch.where(first, x_mb[min(t, n_micro - 1)], state)
        out = stage_fn(inp)
        m = _collected(t, S, n_micro)
        if m is not None:
            outs[m] = torch.where(last, out, outs[m])
        if S > 1 and t < n_ticks - 1:
            state = _Hop.apply(out, group)
    return g_psum(torch.cat(outs) if n_micro > 1 else outs[0], group)


# ---- the layout ------------------------------------------------------------------------------------------


def _block_lists(model) -> Dict[str, tuple]:
    """(tower, the name of its block list) of each block tower of
    ``model``, by the state-dict prefix of its blocks."""
    out = {}
    for prefix, tower in (("visual.transformer.", getattr(model.visual, "transformer", None)),
                          ("transformer.", model.transformer)):
        if tower is not None:
            attr = "mixBlocks" if hasattr(tower, "mixBlocks") else "resblocks"
            out[f"{prefix}{attr}."] = (tower, attr)
    return out


def check_pp(cfg: CLIPConfig, n_stages: int) -> None:
    """JAX's refusals: a ResNet trunk is no uniform block stack, and both
    towers' depths must divide by the stages."""
    if cfg.is_resnet:
        raise NotImplementedError("pipeline parallelism needs a uniform block stack (mixer/transformer)")
    if cfg.vision_layers % n_stages or cfg.text_layers % n_stages:
        raise ValueError(f"pipeline parallelism needs both tower depths divisible by the stages: "
                         f"{cfg.vision_layers}/{cfg.text_layers} vs {n_stages}")


@torch.no_grad()
def shard_model_pp(model, mesh):
    """Cut ``model``'s towers to this rank's stage of ``mesh`` (a
    ``make_pp_mesh`` mesh) in place and run them through the schedule (one
    microbatch until :func:`set_microbatches`, which the step calls);
    returns the model. Every rank must hold the same whole model before
    (``mesh.replicate``). A stage dimension of one keeps every block and
    still runs the schedule."""
    S = n_stages_of(mesh)
    check_pp(model.cfg, S)
    if getattr(model, "tp_group", None) is not None or getattr(model, "fsdp_mesh", None) is not None:
        raise ValueError("pipeline parallelism does not compose with tensor parallelism or FSDP")
    group = mesh.get_group(STAGE_AXIS)
    s = mesh.get_local_rank(STAGE_AXIS)
    for tower, attr in _block_lists(model).values():
        blocks = list(getattr(tower, attr))
        per = len(blocks) // S
        setattr(tower, attr, StageBlocks(blocks[s * per:(s + 1) * per], s * per))
        tower.pipeline = Pipeline(group, S, 1)
    model.pp_group, model.pp_stages, model.pp_stage = group, S, s
    return model


def set_microbatches(model, n_micro: int) -> None:
    """Run ``model``'s pipelined towers with ``n_micro`` microbatches."""
    for tower, _ in _block_lists(model).values():
        pipe = getattr(tower, "pipeline", None)
        if pipe is not None and pipe.n_micro != n_micro:
            tower.pipeline = pipe._replace(n_micro=n_micro)


def is_stage_block(name: str) -> bool:
    """Whether the parameter ``name`` is a tower block's (what a stage holds a slice of)."""
    return _BLOCK.match(name) is not None


def pp_param_specs(shapes: Mapping[str, tuple], n_stages: int) -> Dict[str, Optional[str]]:
    """Each leaf's pipeline placement, by name: ``STAGE_AXIS`` for a tower
    block's leaf when the tower's depth divides by ``n_stages`` (each stage
    holds its slice of the blocks), None (whole on every stage rank) for the
    rest. ``shapes``: state-dict names (of the whole model) to shapes; the
    counterpart of JAX's ``pp_param_specs``, which keys on the stacked
    ``blocks`` leaves."""
    depth: Dict[str, set] = {}
    for name in shapes:
        m = _BLOCK.match(name)
        if m is not None:
            depth.setdefault(m.group(1), set()).add(int(m.group(2)))
    out = {}
    for name in shapes:
        m = _BLOCK.match(name)
        out[name] = STAGE_AXIS if m is not None and len(depth[m.group(1)]) % n_stages == 0 else None
    return out


def _stage_index(model, m) -> int:
    """A matched block key's index within this rank's stage."""
    tower, attr = _block_lists(model)[m.group(1)]
    return int(m.group(2)) - getattr(getattr(tower, attr), "offset", 0)


def stage_local_name(model, name: str) -> str:
    """``name`` with a block's index counted within this rank's stage: the
    key that is alike on every stage rank (the checkpoint layout's)."""
    m = _BLOCK.match(name)
    return name if m is None else f"{m.group(1)}{_stage_index(model, m)}{m.group(3)}"


def gather_stages(model, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The whole model's tensors from each stage rank's ``tensors`` (keyed
    like the model's state dict: its parameters, or the EMA): each block
    tensor gathered over the stage group and keyed by its index in the whole
    tower. A collective: every rank calls it, in the same order."""
    group, S = getattr(model, "pp_group", None), getattr(model, "pp_stages", 1)
    if group is None or S == 1:
        return dict(tensors)
    lists = _block_lists(model)
    out = {}
    for k, v in tensors.items():
        m = _BLOCK.match(k)
        if m is None:
            out[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(S)]
        dist.all_gather(parts, v.detach().contiguous(), group=group)
        tower, attr = lists[m.group(1)]
        per, i = len(getattr(tower, attr)), _stage_index(model, m)
        for j, part in enumerate(parts):
            out[f"{m.group(1)}{j * per + i}{m.group(3)}"] = part
    return out


# ---- the step --------------------------------------------------------------------------------------------


def make_pp_train_step(cfg: CLIPConfig, tcfg: TrainConfig, mesh, optimizer: Optimizer, n_micro: int,
                       grad_through_gather: bool = False, chunk_size: Optional[int] = None, accum_steps: int = 1):
    """``step(state, batch) -> (state, metrics)`` over a (data, stage) mesh
    for a model cut by :func:`shard_model_pp`: the step of
    ``parallel/train_step.py`` over the mesh's data group (in-step
    normalisation, InfoNCE or SigLIP over the data group, gradients averaged
    over it, AdamW, the ``logit_scale`` clamp, the EMA) with both towers'
    blocks through the GPipe schedule of ``n_micro`` microbatches a step,
    or a GradCache chunk with ``accum_steps > 1``. ``batch`` is this rank's
    data row's rows (every stage rank of a row holds the same rows)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    check_pp(cfg, n_stages_of(mesh))
    step = make_train_step(cfg, tcfg, optimizer, grad_through_gather, chunk_size, accum_steps=accum_steps,
                           group=data_group(mesh))

    def pp_step(state, batch):
        model = state.model
        if getattr(model, "pp_group", None) is None:
            raise ValueError("make_pp_train_step trains a model cut by parallel/pp.py::shard_model_pp")
        local_b = len(batch["images"])
        if local_b % accum_steps or (local_b // accum_steps) % n_micro:
            raise ValueError(f"each chunk of {local_b} rows / accum_steps {accum_steps} must split into "
                             f"{n_micro} pipeline microbatches")
        set_microbatches(model, n_micro)
        return step(state, batch)

    return pp_step

