"""The train step, on one device or data-parallel: forward, contrastive loss, AdamW, clamp, EMA.

Counterpart of ``clip_mixer_tpu/parallel/train_step.py``. With ``group``
(a process group, the data axis of ``parallel/mesh.py``), each rank holds a
replica of the model and its rows of the global batch, as JAX's step under
``shard_map`` does. A step runs, in order:

1. the augmentation hook (``TrainConfig.augment``; the crops are drawn for
   the global batch and each rank takes its rows of the draw), then the
   in-step normalisation of the uint8 batch to the model's compute dtype;
2. ``CLIP.forward_train`` (SyncBN over the group for a ResNet tower), the
   contrastive loss over the global batch (``ops/losses.py``), and its
   backward; with ``accum_steps > 1``, the two-pass GradCache instead
   (:func:`two_pass_accum_grads`), whose loss and cotangents are those of
   the gathered global features;
2b. across a group, the gradients and the loss averaged over the ranks
   (:func:`average_gradients`: one flat bucket, one all-reduce), JAX's
   ``pmean``. This is an explicit collective, not
   ``DistributedDataParallel``: DDP's module hooks would fight the
   two-pass GradCache, :func:`freeze_subtree`'s toggling of
   ``requires_grad`` and the fused-block route, which reads a block's
   parameters without calling the block;
3. the global gradient norm, taken before the clip;
4. the optimiser update (clip, AdamW);
5. the ``logit_scale`` clamp to ``TrainConfig.logit_scale_max``, after the
   update, then, for a ResNet vision tower, the merge of the step's batch
   moments into the BatchNorm running statistics
   (``models/resnet.py::apply_bn_updates``);
6. the EMA update, after them, over the parameters and the running
   statistics.

A ResNet vision tower trains on batch moments; under ``freeze="visual"``
it normalises with its running statistics and keeps them (``bn_eval``).
GradCache refuses it: per-microbatch moments are not the batch's.

Its parts run inside ``torch.profiler.record_function`` ranges
(``train_step/forward``, ``/backward`` or ``/gradcache``, ``/update``),
which a profiler reads (``scripts/torch_train_profile.py``).

Steps 3-6 run alike on every rank, on the averaged gradients, so the
replicas stay bit-identical.

The same step trains a model split over ranks: under tensor parallelism
(``parallel/tp.py``, the blocks' collectives over the mesh's model group)
and under FSDP (``parallel/fsdp.py``, whose hooks gather the shards and
reduce-scatter their gradients over the data group). The loss, its gather
and :func:`average_gradients` run over the data group only, and the latter
leaves FSDP's shards to FSDP; the optimiser works on each rank's pieces and
takes the norm of the whole (:func:`split_groups`).

The model is ``torch`` state, so the step updates ``TrainState`` in place
and returns it with the metrics (0-d tensors on the model's device; nothing
in the step waits for the device). The step runs on the model's device: on
the card the kernel routes launch their kernels or raise. Under pipeline
stages (``parallel/pp.py``) each rank holds its stage's blocks, and the
gradient norm sums their squares over the stage group.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from clip_mixer_tpu_torch.config import CLIPConfig, TrainConfig
from clip_mixer_tpu_torch.device import compute_dtype
from clip_mixer_tpu_torch.models.resnet import apply_bn_updates
from clip_mixer_tpu_torch.ops.augment import maybe_augment
from clip_mixer_tpu_torch.ops.losses import contrastive_loss, gather_features, loss_param_keys
from clip_mixer_tpu_torch.ops.preprocess import normalize_images
from clip_mixer_tpu_torch.parallel.dist import world
from clip_mixer_tpu_torch.parallel.tp import group_size, port_tp_dim
from clip_mixer_tpu_torch.train.optimizer import OptState, Optimizer, ema_sources, tower_of


@dataclasses.dataclass
class TrainState:
    """A port CLIP (holding the f32 master parameters), the optimiser's state
    (the EMA, when on, is ``opt_state.ema``) and the steps taken."""

    model: torch.nn.Module
    opt_state: OptState
    step: int = 0


def init_train_state(model, optimizer: Optimizer) -> TrainState:
    return TrainState(model=model, opt_state=optimizer.init(dict(model.named_parameters()), ema_sources(model)),
                      step=0)


@contextlib.contextmanager
def freeze_subtree(model, freeze: Optional[str]):
    """Locked-tower training: inside the context the ``freeze`` tower
    ("visual" or "text") records no autograd graph and gets no gradient;
    its ``requires_grad`` flags are restored on exit."""
    frozen = [p for n, p in model.named_parameters() if freeze and tower_of(n) == freeze and p.requires_grad]
    for p in frozen:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in frozen:
            p.requires_grad_(True)


def flat_chunker(images: torch.Tensor, texts: torch.Tensor, accum_steps: int):
    """Microbatch ``i`` of a [B, ...] batch as views of it (no copies)."""
    local_b = images.shape[0]
    if local_b % accum_steps:
        raise ValueError(f"batch {local_b} is not divisible by accum_steps {accum_steps}")
    mb = local_b // accum_steps

    def get_chunk(i):
        return images[i * mb:(i + 1) * mb], texts[i * mb:(i + 1) * mb]

    return get_chunk


def two_pass_accum_grads(model, accum_steps: int, get_chunk, micro_feats: Callable, feat_loss: Callable,
                         loss_param_keys=("logit_scale",)) -> torch.Tensor:
    """Exact (GradCache) gradient accumulation; the gradients land in the
    parameters' ``.grad``, and the loss is returned.

    Pass 1 runs each chunk forward without autograd and keeps only its
    features. The loss over the whole batch and its feature cotangents are
    computed once. Pass 2 replays each chunk under autograd and back-
    propagates its slice of the cotangents, so one chunk's activations are
    live at a time. ``micro_feats(images, texts)`` returns the chunk's
    (image, text) features; ``feat_loss(img, txt, loss_params)`` the loss
    from all features and the scalar parameters named in
    ``loss_param_keys``, whose gradients come only from the loss."""
    with torch.no_grad():
        feats = [micro_feats(*get_chunk(i)) for i in range(accum_steps)]
    f_img = torch.cat([f[0] for f in feats]).requires_grad_()
    f_txt = torch.cat([f[1] for f in feats]).requires_grad_()
    del feats
    loss_params = {k: getattr(model, k) for k in loss_param_keys if hasattr(model, k)}
    loss = feat_loss(f_img, f_txt, loss_params)
    loss.backward()
    mb = f_img.shape[0] // accum_steps
    for i in range(accum_steps):
        outs, cts = [], []
        for f, ct in zip(micro_feats(*get_chunk(i)), (f_img.grad, f_txt.grad)):
            if f.requires_grad:  # a frozen tower's features carry no graph
                outs.append(f)
                cts.append(ct[i * mb:(i + 1) * mb])
        if outs:
            torch.autograd.backward(outs, cts)
    return loss.detach()


def split_groups(model) -> dict:
    """The process groups of more than one rank that each parameter of
    ``model`` is split over, by name: the model group for a
    tensor-parallel slice, FSDP's data group for a ``DTensor`` shard, the
    stage group for a block of a pipeline stage (each stage rank holds other
    blocks, alike in structure); () for a leaf whole on every rank."""
    from clip_mixer_tpu_torch.parallel.pp import is_stage_block

    tp, pp = getattr(model, "tp_group", None), getattr(model, "pp_group", None)
    out = {}
    for n, p in model.named_parameters():
        groups = ()
        if tp is not None and group_size(tp) > 1 and port_tp_dim(n) is not None:
            groups += (tp,)
        if pp is not None and group_size(pp) > 1 and is_stage_block(n):
            groups += (pp,)
        if hasattr(p, "device_mesh") and p.device_mesh.size() > 1:
            groups += (p.device_mesh.get_group(),)
        out[n] = groups
    return out


def average_gradients(params, loss: torch.Tensor, group) -> torch.Tensor:
    """Average every parameter's ``.grad`` and ``loss`` over ``group``'s
    ranks, in place, in one all-reduce of one flat f32 bucket; returns the
    averaged loss. Parameters without a gradient (a frozen tower's, on
    every rank alike) are left out, and so are FSDP's shards, whose
    gradients FSDP's reduce-scatter has averaged."""
    grads = [p.grad for p in params.values() if p.grad is not None and not hasattr(p.grad, "device_mesh")]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.reshape(1).float()])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[offset].clone()


def make_train_step(cfg: CLIPConfig, tcfg: TrainConfig, optimizer: Optimizer, grad_through_gather: bool = False,
                    chunk_size: Optional[int] = None, accum_steps: int = 1, group=None):
    """Returns ``step(state, batch) -> (state, metrics)``.

    batch: {"images": uint8 [B, H, W, 3], "texts": int [B, context_length]},
    tensors or numpy arrays, moved to the model's device; across a
    ``group`` (data parallelism), this rank's rows of the global batch
    (``parallel/mesh.py::shard_batch``), every rank holding as many and the
    same replica (``mesh.replicate``). Metrics: ``loss`` (averaged over
    the ranks), ``grad_norm`` (before the clip, of the averaged gradients),
    ``logit_scale`` (its exp) and, for a model with one, ``logit_bias``.
    ``cfg`` is the model's configuration (the compute dtype and the
    resolution augmentation crops to); the fused-block route
    (``route_towers``) is the model's, not the config's.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_steps > 1 and cfg.is_resnet:
        raise NotImplementedError(
            "grad accumulation with BN batch stats (ResNet tower) is not supported: "
            "per-microbatch moments are not the full-batch moments"
        )
    dtype = compute_dtype(cfg.compute_dtype)
    keys = loss_param_keys(tcfg.loss)
    bn_eval = tcfg.freeze == "visual"

    rank, n_ranks = world(group)

    def loss_of(img, txt, scale, bias):
        return contrastive_loss(tcfg.loss, img, txt, scale, logit_bias=bias, group=group,
                                grad_through_gather=grad_through_gather, chunk_size=chunk_size)

    def loss_and_grads(model, images_u8, texts):
        """The loss (gradients in ``.grad``) and the BN batch moments."""
        if accum_steps == 1:
            with record_function("train_step/forward"):
                img, txt, scale, bn_stats = model.forward_train(normalize_images(images_u8, dtype), texts,
                                                                bn_eval=bn_eval, group=group)
                loss = loss_of(img, txt, scale, getattr(model, "logit_bias", None))
            with record_function("train_step/backward"):
                loss.backward()
            return loss.detach(), bn_stats

        def micro_feats(im_u8, tx):
            img, txt, _scale, _ = model.forward_train(normalize_images(im_u8, dtype), tx)
            return img, txt

        def feat_loss(fi, ft, loss_params):
            return loss_of(fi, ft, loss_params["logit_scale"].exp(), loss_params.get("logit_bias"))

        with record_function("train_step/gradcache"):
            return two_pass_accum_grads(model, accum_steps, flat_chunker(images_u8, texts, accum_steps),
                                        micro_feats, feat_loss, loss_param_keys=keys), {}

    def step(state: TrainState, batch) -> tuple:
        model = state.model
        dev = model.logit_scale.device
        images = torch.as_tensor(batch["images"]).to(dev, non_blocking=True)
        texts = torch.as_tensor(batch["texts"]).to(dev, non_blocking=True)
        images = maybe_augment(tcfg, cfg, state.step, images, rank, n_ranks)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        with freeze_subtree(model, tcfg.freeze):
            loss, bn_stats = loss_and_grads(model, images, texts)
        if group is not None:
            with record_function("train_step/all_reduce"):
                loss = average_gradients(params, loss, group)
        with record_function("train_step/update"):
            grads = {n: p.grad for n, p in params.items()}
            grad_norm = optimizer.update(params, grads, state.opt_state, split_groups(model))
            with torch.no_grad():
                model.logit_scale.clamp_(max=tcfg.logit_scale_max)
            if bn_stats:
                apply_bn_updates(model.visual, bn_stats)
            if tcfg.ema_decay:
                optimizer.update_ema(ema_sources(model), state.opt_state)
        state.step += 1
        metrics = {"loss": loss, "grad_norm": grad_norm, "logit_scale": model.logit_scale.detach().exp()}
        if hasattr(model, "logit_bias"):
            metrics["logit_bias"] = model.logit_bias.detach().clone()
        return state, metrics

    return step


def make_eval_forward(cfg: CLIPConfig, group=None):
    """(model, uint8 images, texts) -> (image features, text features,
    exp(logit_scale)), normalising in the step, without autograd. Across a
    ``group`` each rank encodes its rows of the batch (JAX's batch sharded
    over the data axis); the features come back gathered, in rank order."""
    dtype = compute_dtype(cfg.compute_dtype)

    @torch.no_grad()
    def fwd(model, images_u8, texts):
        dev = model.logit_scale.device
        images = normalize_images(torch.as_tensor(images_u8).to(dev), dtype)
        img, txt, scale = model(images, torch.as_tensor(texts).to(dev))
        if group is None:
            return img, txt, scale
        return gather_features(img, group, False), gather_features(txt, group, False), scale

    return fwd
