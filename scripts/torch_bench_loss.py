#!/usr/bin/env python3
"""Measure the port's train step under each contrastive objective on the card.

The counterpart of ``scripts/bench_loss.py``.

Usage:
    python scripts/torch_bench_loss.py [--batch 1024] [--preset mixer-b32] [--device cuda]

InfoNCE (the reference objective, training/training.py:156-168) pays a
row+column softmax over the full batch; SigLIP (``ops/losses.siglip_loss``)
pays a pairwise sigmoid. On one card both reduce to a [B, B] logits block
against the towers' ~60 GFLOP/sample forward+backward, so the expected
delta is small. The interesting property is at scale (the ring keeps the
per-card working set [local_B, local_B] with n-1 neighbour hops instead of
an all-gather), which the CPU tests over gloo pin for correctness; this
script records the single-card cost.

The step is the JAX script's: seed-0 weights with remat on (SigLIP with
``logit_bias_init=-10``), the 256 -> 224 resize of the uint8 batch inside
the step (``make_batch_preprocess``, the ``"torch"`` front end, bf16), the
loss through ``ops/losses.contrastive_loss``, the optimiser update and the
``logit_scale`` clamp, timed as the slope between two chains of steps that
each start from the parameters the one before wrote
(``utils/profiling.chained_train_time``, CUDA events).

Prints one JSON line a loss, then the summary line with the JAX script's
keys plus ``power_limit``; ``device`` names the card. An out-of-memory
error is that loss's result (``{"error": ...}``); any other error stops
the run. Runs on the card unless ``--device`` names another device; TF32
is off.
"""

import argparse
import gc
import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clip_mixer_tpu_torch.config import PRESETS, TrainConfig  # noqa: E402
from clip_mixer_tpu_torch.device import card, no_tf32, resolve_device  # noqa: E402


def _arm_watchdog(seconds: float):
    """Hard deadline: a run that stalls (a wedged card, a hung launch) ends
    here with exit 124 and an error line; no partial JSON is worth waiting
    hours for. A daemon timer + os._exit is enough for a perf script."""

    def die():
        print(f'{{"error": "watchdog: no result within {seconds:.0f}s (a stalled card or host?)"}}', flush=True)
        os._exit(124)

    t = threading.Timer(seconds, die)
    t.daemon = True
    t.start()
    return t


def bench_inputs(b: int, context_length: int, device):
    """The JAX script's batch: uint8 [b, 256, 256, 3] images and token rows
    (SOT, seven ids, EOT), both from numpy's seed 0, on ``device``."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (b, 256, 256, 3), dtype=np.uint8)
    texts = np.zeros((b, context_length), np.int32)
    texts[:, 0] = 49406
    texts[:, 1:8] = rng.integers(1, 49000, (b, 7))
    texts[:, 8] = 49407
    return torch.from_numpy(imgs).to(device), torch.from_numpy(texts).to(device)


def loss_config(cfg, loss_kind):
    """The production train config (remat on); SigLIP's learnable bias."""
    return cfg.replace(remat=True, logit_bias_init=-10.0 if loss_kind == "siglip" else None)


def make_loss_and_grads(loss_kind: str, pre):
    """``(model, uint8 images, texts) -> loss``, its gradients in ``.grad``:
    the JAX script's ``loss_and_grads``, the resize ``pre`` inside it."""
    from clip_mixer_tpu_torch.ops.losses import contrastive_loss

    def loss_and_grads(model, imgs_u8, tk):
        img, txt, scale = model(pre(imgs_u8), tk)
        loss = contrastive_loss(loss_kind, img, txt, scale, logit_bias=getattr(model, "logit_bias", None))
        loss.backward()
        return loss.detach()

    return loss_and_grads


def free_card(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None, cfg=None, chain=(3, 13)) -> dict:
    """Both objectives' step times; returns the summary line. ``cfg`` (a
    ``CLIPConfig``) replaces the preset's and ``chain`` (the two chain
    lengths) cuts the timing, so tests and ``chip_smoke.py`` run small."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="mixer-b32")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--losses", nargs="*", default=["info_nce", "siglip"])
    p.add_argument("--deadline", type=float, default=1800.0,
                   help="hard exit(124) after this many seconds (stall guard)")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    no_tf32()
    watchdog = _arm_watchdog(args.deadline)
    try:
        return _run(args, device, PRESETS[args.preset] if cfg is None else cfg, chain)
    finally:
        watchdog.cancel()


def _run(args, device, base_cfg, chain) -> dict:
    from clip_mixer_tpu_torch.models.clip import CLIP
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer
    from clip_mixer_tpu_torch.utils.profiling import chained_train_time, update_step

    b = args.batch
    imgs, toks = bench_inputs(b, base_cfg.context_length, device)
    results = {}
    for loss_kind in args.losses:
        cfg = loss_config(base_cfg, loss_kind)
        tcfg = TrainConfig(loss=loss_kind)
        pre = make_batch_preprocess((256, 256), cfg.image_resolution, normalize=True, dtype=torch.bfloat16)
        try:
            model = CLIP(cfg, device=device, generator=torch.Generator().manual_seed(0))
            opt = make_optimizer(tcfg, total_steps=1000)
            step = update_step(opt, tcfg.logit_scale_max, make_loss_and_grads(loss_kind, pre))
            dt = chained_train_time(step, init_train_state(model, opt), (imgs, toks), *chain, device=device)
            results[loss_kind] = {"ms_per_step": round(dt * 1e3, 1), "imgs_per_sec": round(b / dt, 1)}
        except torch.OutOfMemoryError as e:
            results[loss_kind] = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
        model = step = None
        free_card(device)
        print(json.dumps({"loss": loss_kind, "batch": b, **results[loss_kind]}), flush=True)

    name, power = card(device)
    out = {"preset": args.preset, "batch": b, "device": name, "power_limit": power, "results": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
