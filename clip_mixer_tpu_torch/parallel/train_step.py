"""The single-device train step: forward, contrastive loss, AdamW, clamp, EMA.

Counterpart of ``clip_mixer_tpu/parallel/train_step.py`` on one device.
A step runs, in order:

1. the augmentation hook (``TrainConfig.augment``), then the in-step
   normalisation of the uint8 batch to the model's compute dtype;
2. ``CLIP.forward_train``, the contrastive loss, and its backward; with
   ``accum_steps > 1``, the two-pass GradCache instead
   (:func:`two_pass_accum_grads`);
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

The model is ``torch`` state, so the step updates ``TrainState`` in place
and returns it with the metrics (0-d tensors on the model's device; nothing
in the step waits for the device). The step runs on the model's device: on
the card the kernel routes launch their kernels or raise. The multi-device
steps (DDP over NCCL, FSDP, pipeline) wait for the parallel layer (ROADMAP.md,
Slice F).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from clip_mixer_tpu_torch.config import CLIPConfig, TrainConfig
from clip_mixer_tpu_torch.device import compute_dtype
from clip_mixer_tpu_torch.models.resnet import apply_bn_updates
from clip_mixer_tpu_torch.ops.augment import maybe_augment
from clip_mixer_tpu_torch.ops.losses import contrastive_loss, loss_param_keys
from clip_mixer_tpu_torch.ops.preprocess import normalize_images
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


def make_train_step(cfg: CLIPConfig, tcfg: TrainConfig, optimizer: Optimizer, grad_through_gather: bool = False,
                    chunk_size: Optional[int] = None, accum_steps: int = 1):
    """Returns ``step(state, batch) -> (state, metrics)``.

    batch: {"images": uint8 [B, H, W, 3], "texts": int [B, context_length]},
    tensors or numpy arrays, moved to the model's device. Metrics: ``loss``,
    ``grad_norm`` (before the clip), ``logit_scale`` (its exp) and, for a
    model with one, ``logit_bias``. ``cfg`` is the model's configuration
    (the compute dtype and the resolution augmentation crops to); the
    fused-block route (``route_towers``) is the model's, not the config's.
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

    def loss_of(img, txt, scale, bias):
        return contrastive_loss(tcfg.loss, img, txt, scale, logit_bias=bias,
                                grad_through_gather=grad_through_gather, chunk_size=chunk_size)

    def loss_and_grads(model, images_u8, texts):
        """The loss (gradients in ``.grad``) and the BN batch moments."""
        if accum_steps == 1:
            with record_function("train_step/forward"):
                img, txt, scale, bn_stats = model.forward_train(normalize_images(images_u8, dtype), texts,
                                                                bn_eval=bn_eval)
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
        images = maybe_augment(tcfg, cfg, state.step, images)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        with freeze_subtree(model, tcfg.freeze):
            loss, bn_stats = loss_and_grads(model, images, texts)
        with record_function("train_step/update"):
            grads = {n: p.grad for n, p in params.items()}
            grad_norm = optimizer.update(params, grads, state.opt_state)
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


def make_eval_forward(cfg: CLIPConfig):
    """(model, uint8 images, texts) -> (image features, text features,
    exp(logit_scale)), normalising in the step, without autograd."""
    dtype = compute_dtype(cfg.compute_dtype)

    @torch.no_grad()
    def fwd(model, images_u8, texts):
        dev = model.logit_scale.device
        images = normalize_images(torch.as_tensor(images_u8).to(dev), dtype)
        return model(images, torch.as_tensor(texts).to(dev))

    return fwd
