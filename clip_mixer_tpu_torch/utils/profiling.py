"""Profiling and step-time metering.

Counterpart of ``clip_mixer_tpu/utils/profiling.py``. :func:`trace` wraps
``torch.profiler`` in one documented place (a Chrome trace a step window,
TensorBoard-readable); :func:`slope_time` and :func:`chained_train_time`
time a loop of back-to-back steps by the slope between two chain lengths,
which cancels the fixed cost of starting and fetching a chain
(:func:`update_step` and :func:`chained` build the perf scripts' chains);
and :class:`StepTimer` is the imgs/s meter of the perf scripts.

On the card a chain is timed with CUDA events around it, on the CPU with
``time.perf_counter``: a chain's end is the device's, not the host's
dispatch. Numbers from the CPU are host times and are never a card's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, device: Optional[torch.device] = None):
    """Profile the block to ``log_dir/trace.json`` (a Chrome trace: CPU
    activity, and the card's kernels when ``device`` is a CUDA device); the
    profiler is yielded, so ``key_averages()`` reads it after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _chain_s(run: Callable[[int], object], n: int, device: Optional[torch.device]) -> float:
    """Seconds of ``run(n)``: CUDA events around it on the card, the host
    clock (after it returns) elsewhere."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(n)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    run(n)
    return time.perf_counter() - t0


def slope_time(run: Callable[[int], object], n1: int = 5, n2: int = 45,
               device: Optional[torch.device] = None, warmup: int = 2) -> float:
    """Seconds per iteration of ``run(n)``, an n-iteration chain (each
    iteration consuming the previous one's result), by the slope between an
    ``n2``- and an ``n1``-chain after a warm-up chain of ``warmup`` (0 for a
    chain that has just run): the difference cancels the chain's fixed
    costs. ``device``: where the chain runs (CUDA events time it there)."""
    if n2 <= n1:
        raise ValueError(f"n2 ({n2}) must exceed n1 ({n1})")
    if warmup:
        run(warmup)  # first launches, allocator growth, kernel builds
    d1 = _chain_s(run, n1, device)
    d2 = _chain_s(run, n2, device)
    return (d2 - d1) / (n2 - n1)


def chained_train_time(step: Callable, state, batch, n1: int = 3, n2: int = 13,
                       device: Optional[torch.device] = None, warmup: int = 2) -> float:
    """Seconds per train step (gradients, the optimiser update, the clamp)
    of ``step(state, batch) -> (state, metrics)`` (``parallel/train_step.py``
    or ``parallel/pp.py``'s), run back to back so the state threads through
    every iteration (each step starts from the parameters the previous one
    wrote; nothing is loop-invariant), timed by :func:`slope_time`. The
    steps train ``state`` in place: time a state kept for that."""

    def run(n):
        nonlocal state
        for _ in range(n):
            state, _metrics = step(state, batch)

    return slope_time(run, n1, n2, device, warmup)


def update_step(optimizer, logit_scale_max: float, loss_and_grads: Callable) -> Callable:
    """``step(state, batch) -> (state, {"loss"})`` for :func:`chained_train_time`
    from ``loss_and_grads(model, *batch) -> loss`` (its gradients left in
    the parameters' ``.grad``): the gradients, the optimiser update and the
    ``logit_scale`` clamp, the body of the JAX package's timed chain. Its
    perf scripts time a step this way when the step is theirs (the resize
    inside it, a remat policy's backward) rather than ``make_train_step``'s."""

    def step(state, batch):
        model = state.model
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss = loss_and_grads(model, *batch)
        optimizer.update(params, {n: p.grad for n, p in params.items()}, state.opt_state)
        with torch.no_grad():
            model.logit_scale.clamp_(max=logit_scale_max)
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


def chained(fn: Callable, images_u8: torch.Tensor) -> Callable[[int], torch.Tensor]:
    """``run(n)`` for :func:`slope_time`: ``fn`` on ``images_u8`` n times,
    each call's input the batch plus the previous call's result rounded to
    uint8 (a zero: the mean of its output times 1e-9), so every call waits
    for the one before it, as the JAX perf scripts' loop carry does."""

    @torch.no_grad()
    def run(n):
        carry = torch.zeros((), device=images_u8.device)
        for _ in range(n):
            carry = fn(images_u8 + carry.to(torch.uint8)).float().mean() * 1e-9
        return carry

    return run


class StepTimer:
    """Rolling steps/s and imgs/s/card meter: call :meth:`tick` once per
    completed (waited-on) step. Warm-up steps are left out, so first
    launches and kernel builds never count; ``n_chips`` is the world size of
    the process group (1 without one), as JAX's is the device count."""

    def __init__(self, global_batch_size: int, warmup_steps: int = 2):
        import torch.distributed as dist

        self.global_batch_size = global_batch_size
        self.warmup = warmup_steps
        self.n_chips = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        self._count = 0
        # warmup_steps=0: the construction time is the reference point
        self._t0: float = time.perf_counter()

    def tick(self) -> Optional[dict]:
        self._count += 1
        if self._count <= self.warmup:
            self._t0 = time.perf_counter()
            return None
        steps = self._count - self.warmup
        dt = time.perf_counter() - self._t0
        if dt <= 0:
            return None
        sps = steps / dt
        return {
            "steps_per_sec": sps,
            "imgs_per_sec": sps * self.global_batch_size,
            "imgs_per_sec_per_chip": sps * self.global_batch_size / self.n_chips,
        }
