"""Optimiser: global-norm clip, then AdamW with masked weight decay, then EMA.

Counterpart of ``clip_mixer_tpu/train/optimizer.py``'s optax chain, with its
numbers:

- the clip is optax's ``clip_by_global_norm``: g * max_norm / ||g|| when
  ||g|| >= max_norm, else g (``torch.nn.utils.clip_grad_norm_`` adds 1e-6
  to the norm and is not the same);
- Adam with bias correction and eps outside the square root, then weight
  decay decoupled from it, scaled by the scheduled lr, only on parameters
  with ``ndim >= 2`` (:func:`decay_mask`; the port's blocks are not stacked,
  so the JAX mask's correction for stacked layers has no counterpart here);
- with ``TrainConfig.freeze``, the frozen tower gets no moments and no
  decay; with ``TrainConfig.ema_decay``, the state carries an EMA that the
  train step updates after the step's fixups.

Parameters are the model's ``named_parameters()`` (state-dict keys, f32
masters); the update is in place with ``torch._foreach_*`` ops, the same
code on the card and on the CPU. A parameter split over ranks (an FSDP
``DTensor`` shard, a tensor-parallel slice) is updated through its local
tensor, so its moments and EMA are stored split alike, and the gradient
norm counts each split leaf once across its pieces (``splits``). A
ResNet's BatchNorm running statistics are buffers, not parameters: they
get no moments, no update and no decay, as in the JAX tree, where they are
leaves whose gradient is zero. The EMA
runs over the model's whole float state (:func:`ema_sources`: the
parameters and those running statistics), as the JAX ``update_ema`` runs
over the whole param tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from clip_mixer_tpu_torch.config import TrainConfig
from clip_mixer_tpu_torch.train.schedule import warmup_cosine

# The text tower's parameters sit on the CLIP module itself (the reference
# state-dict layout); these prefixes name them (``positional_embedding``:
# the transformer text tower's, under the JAX tree's "text").
TEXT_PREFIXES = ("token_embedding.", "positional_embedding", "transformer.", "ln_final.", "text_projection")


def tower_of(name: str) -> Optional[str]:
    """"visual", "text", or None (``logit_scale``, ``logit_bias``): the JAX
    tree's top-level key of a port parameter."""
    if name.startswith("visual."):
        return "visual"
    if name.startswith(TEXT_PREFIXES):
        return "text"
    return None


def ema_sources(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """What the EMA averages: every float tensor of ``model``'s state dict
    (the parameters and the persistent float buffers, i.e. the BatchNorm
    running statistics), by state-dict key."""
    return {k: v for k, v in model.state_dict(keep_vars=True).items() if v.is_floating_point()}


def local(t: torch.Tensor) -> torch.Tensor:
    """The part of ``t`` this rank holds: a ``DTensor``'s local shard (its
    storage, so in-place updates land in the parameter), any other tensor
    as it is."""
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def global_norm(gs, names, splits: Optional[Mapping[str, Sequence]] = None) -> torch.Tensor:
    """The norm of the gradients ``gs`` (local tensors, named ``names``) as
    one vector across the ranks: a leaf split over process groups
    (``splits[name]``, each of more than one rank) contributes the norm of
    its whole, its pieces' squared norms summed over those groups; a leaf
    whole on every rank counts once. Without splits it is the norm of the
    leaves' norms, as on one device."""
    norms = list(torch._foreach_norm(gs))
    by_groups = {}
    for i, n in enumerate(names):
        groups = tuple((splits or {}).get(n, ()))
        if groups:
            by_groups.setdefault(groups, []).append(i)
    for groups, idx in by_groups.items():
        sq = torch.stack([norms[i] for i in idx]).square()
        for g in groups:
            dist.all_reduce(sq, group=g)
        for j, i in enumerate(idx):
            norms[i] = sq[j].sqrt()
    return torch.linalg.vector_norm(torch.stack(norms))


def _bias_correction(beta: float, count: int) -> float:
    """1 - beta**count, in f32 as optax computes it."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(count))


def decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True (decay) for matrices, embeddings and convs; False for vectors,
    scalars, LN parameters, biases, ``logit_scale`` and ``logit_bias``."""
    return {n: p.ndim >= 2 for n, p in params.items()}


@dataclasses.dataclass
class OptState:
    """``count`` updates applied; Adam's moments of the trainable
    parameters; the EMA of every parameter and running statistic, or None."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    ema: Optional[Dict[str, torch.Tensor]] = None


class Optimizer:
    """The chain of ``make_optimizer`` for parameters keyed by name."""

    def __init__(self, tcfg: TrainConfig, total_steps: int):
        self.tcfg = tcfg
        self.schedule = warmup_cosine(
            tcfg.learning_rate, tcfg.learning_rate * tcfg.min_lr_ratio, tcfg.warmup_steps, total_steps
        )

    def trainable(self, name: str) -> bool:
        return self.tcfg.freeze is None or tower_of(name) != self.tcfg.freeze

    def init(self, params: Mapping[str, torch.Tensor],
             ema_from: Optional[Mapping[str, torch.Tensor]] = None) -> OptState:
        """The state for ``params``; the EMA (when on) starts as a copy of
        ``ema_from`` (:func:`ema_sources` of the model), ``params`` when None."""
        live = {n: local(p) for n, p in params.items() if self.trainable(n)}
        ema = None
        if self.tcfg.ema_decay:
            ema = {n: local(p).detach().clone() for n, p in (params if ema_from is None else ema_from).items()}
        return OptState(
            count=0,
            mu={n: torch.zeros_like(p, memory_format=torch.preserve_format) for n, p in live.items()},
            nu={n: torch.zeros_like(p, memory_format=torch.preserve_format) for n, p in live.items()},
            ema=ema,
        )

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, Optional[torch.Tensor]],
               state: OptState, splits: Optional[Mapping[str, Sequence]] = None) -> torch.Tensor:
        """One update of the trainable ``params`` in place from ``grads``
        (None reads as zeros), each through its local tensor; returns the
        global gradient norm before the clip (:func:`global_norm`, with
        ``splits`` naming the groups each split leaf is split over), a 0-d
        tensor on the parameters' device."""
        t = self.tcfg
        names = list(state.mu)
        ps = [local(params[n]) for n in names]
        gs = [local(grads[n]) if grads.get(n) is not None else torch.zeros_like(p) for n, p in zip(names, ps)]
        norm = global_norm(gs, names, splits)
        clip = torch.where(norm < t.grad_clip_norm, torch.ones_like(norm), t.grad_clip_norm / norm)
        gs = torch._foreach_mul(gs, clip)

        mus, nus = [state.mu[n] for n in names], [state.nu[n] for n in names]
        torch._foreach_mul_(mus, t.beta1)
        torch._foreach_add_(mus, gs, alpha=1.0 - t.beta1)
        torch._foreach_mul_(nus, t.beta2)
        torch._foreach_addcmul_(nus, gs, gs, value=1.0 - t.beta2)
        lr = self.schedule(state.count)  # the count before this update, as optax's
        state.count += 1
        den = torch._foreach_div(nus, _bias_correction(t.beta2, state.count))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, t.eps)
        upd = torch._foreach_div(mus, _bias_correction(t.beta1, state.count))
        torch._foreach_div_(upd, den)
        decay = decay_mask(dict(zip(names, ps)))
        decayed = [i for i, n in enumerate(names) if decay[n]]
        if decayed and t.weight_decay:
            torch._foreach_add_([upd[i] for i in decayed], [ps[i] for i in decayed], alpha=t.weight_decay)
        torch._foreach_add_(ps, upd, alpha=-lr)
        return norm

    @torch.no_grad()
    def update_ema(self, params: Mapping[str, torch.Tensor], state: OptState) -> None:
        """e = decay * e + (1 - decay) * p for every tensor the EMA holds
        (``params`` maps each of their keys, :func:`ema_sources`), after the
        step's fixups (the ``logit_scale`` clamp, the running-stat merge)."""
        names = list(state.ema)
        emas = [state.ema[n] for n in names]
        torch._foreach_mul_(emas, self.tcfg.ema_decay)
        torch._foreach_add_(emas, [local(params[n]) for n in names], alpha=1.0 - self.tcfg.ema_decay)


def make_optimizer(tcfg: TrainConfig, total_steps: int) -> Optimizer:
    return Optimizer(tcfg, total_steps)
