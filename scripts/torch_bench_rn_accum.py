#!/usr/bin/env python3
"""Card measurements of the port: RN50 int8 serving, and the cost of gradient accumulation.

The counterpart of ``scripts/bench_rn_accum.py``. Two modes:

* ``rn`` (the default): RN50 from seed-0 weights, uint8 [256, 256, 256, 3]
  through the bf16 ``"torch"`` front end (256 -> 224) and ``encode_image``,
  beside the int8 tower (``ops/quant.py``: ``calibrate_resnet_tower`` on 64
  images, ``quantize_resnet_tower``, ``encode_image_rn_q``); images/s of
  each by the slope between chains of 5 and 25 calls, each call's input
  carrying the one before's result (``utils/profiling.chained``), and the
  least per-row cosine of int8 against bf16 over 64 images.
* ``accum``: full-width ``mixer-b32`` with remat through
  ``make_train_step(accum_steps=)`` at (accum, global batch) (1, 1024),
  (2, 2048) and (4, 4096) (``ACCUM_FAST=1``: the first and the last);
  ms a step as the slope between chains of 2 and 8 steps after one, and
  the last step's loss.

Prints the JAX script's lines, the last one with ``device`` (the card) and
``power_limit`` added. Runs on the card unless ``--device`` names another
device; TF32 is off.

Usage: python scripts/torch_bench_rn_accum.py [rn|accum] [--device cuda]
"""

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clip_mixer_tpu_torch.config import PRESETS, TrainConfig  # noqa: E402
from clip_mixer_tpu_torch.device import card, no_tf32, resolve_device  # noqa: E402

ACCUM_CONFIGS = ((1, 1024), (2, 2048), (4, 4096))
ACCUM_FAST_CONFIGS = ((1, 1024), (4, 4096))


def row_cosine_min(a: np.ndarray, b: np.ndarray) -> float:
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    return float(cos.min())


def rn_encoders(model, pre, calib_u8):
    """(bf16 encoder, int8 encoder), each uint8 images -> features through
    ``pre``; the int8 tower calibrated on ``pre(calib_u8)``."""
    from clip_mixer_tpu_torch.ops.quant import calibrate_resnet_tower, encode_image_rn_q, quantize_resnet_tower

    with torch.no_grad():
        qvis = quantize_resnet_tower(model, calibrate_resnet_tower(model, pre(calib_u8)))
    return (lambda u8: model.encode_image(pre(u8))), (lambda u8: encode_image_rn_q(qvis, pre(u8)))


def bench_rn(device, cfg=None, batch: int = 256) -> dict:
    from clip_mixer_tpu_torch.models.clip import CLIP
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
    from clip_mixer_tpu_torch.utils.profiling import chained, slope_time

    cfg = PRESETS["rn50"] if cfg is None else cfg
    model = CLIP(cfg, device=device, generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    pre = make_batch_preprocess((256, 256), cfg.image_resolution, normalize=True, dtype=torch.bfloat16)
    images = torch.from_numpy(rng.integers(0, 256, (batch, 256, 256, 3), dtype=np.uint8)).to(device)

    bf16, int8 = rn_encoders(model, pre, images[:64])
    bf16_ips = batch / slope_time(chained(bf16, images), 5, 25, device)
    int8_ips = batch / slope_time(chained(int8, images), 5, 25, device)
    with torch.no_grad():  # fidelity on the card
        f_bf = bf16(images[:64]).float().cpu().numpy()
        f_q = int8(images[:64]).float().cpu().numpy()
    out = {
        "model": "rn50 encode_image (preprocess incl.)",
        "batch": batch,
        "bf16_imgs_per_sec": round(bf16_ips, 1),
        "int8_imgs_per_sec": round(int8_ips, 1),
        "speedup": round(int8_ips / bf16_ips, 3),
        "cosine_min": row_cosine_min(f_bf, f_q),
    }
    out["device"], out["power_limit"] = card(device)
    print(json.dumps(out), flush=True)
    return out


def accum_batch(rng, cfg, total: int, device) -> dict:
    """uint8 images at the model's resolution (the step normalises, no
    resize) and token rows, drawn in the JAX script's order."""
    res = cfg.image_resolution
    images = rng.integers(0, 256, (total, res, res, 3), dtype=np.uint8)
    texts = np.zeros((total, cfg.context_length), np.int32)
    texts[:, 0] = 49406
    texts[:, 1:8] = rng.integers(1, 49000, (total, 7))
    texts[:, 8] = 49407
    return {"images": torch.from_numpy(images).to(device), "texts": torch.from_numpy(texts).to(device)}


def bench_accum(device, cfg=None, configs=None, chain=(2, 8)) -> dict:
    import gc

    from clip_mixer_tpu_torch.models.clip import CLIP
    from clip_mixer_tpu_torch.parallel import train_step
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer
    from clip_mixer_tpu_torch.utils.profiling import slope_time

    cfg = (PRESETS["mixer-b32"] if cfg is None else cfg).replace(remat=True)
    tcfg = TrainConfig()
    rng = np.random.default_rng(0)
    if configs is None:
        configs = ACCUM_FAST_CONFIGS if os.environ.get("ACCUM_FAST") == "1" else ACCUM_CONFIGS

    results = {}
    for accum, total in configs:
        opt = make_optimizer(tcfg, total_steps=1000)
        model = CLIP(cfg, device=device, generator=torch.Generator().manual_seed(0))
        state = train_step.init_train_state(model, opt)
        step = train_step.make_train_step(cfg, tcfg, opt, accum_steps=accum)
        batch = accum_batch(rng, cfg, total, device)
        last = {}

        def run(n):
            nonlocal state
            for _ in range(n):
                state, last["metrics"] = step(state, batch)

        per_step = slope_time(run, *chain, device, warmup=1)  # one step, then the two chains
        key = f"accum{accum}_batch{total}"
        results[key] = {
            "ms_per_step": round(per_step * 1e3, 1),
            "imgs_per_sec": round(total / per_step, 1),
            "loss": round(float(last["metrics"]["loss"]), 4),
        }
        print(json.dumps({key: results[key]}), flush=True)
        model = state = step = batch = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out = dict(results)
    out["device"], out["power_limit"] = card(device)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, cfg=None, batch: int = 256, configs=None, chain=(2, 8)) -> dict:
    """Run one mode; returns its last line. ``cfg`` replaces the mode's
    preset, ``batch`` the RN batch, ``configs`` the (accum, batch) pairs
    and ``chain`` the accum mode's two chain lengths, so tests and
    ``chip_smoke.py`` run small."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("which", nargs="?", default="rn", help="rn (the default); anything else: accum")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    no_tf32()
    if args.which == "rn":
        return bench_rn(device, cfg, batch)
    return bench_accum(device, cfg, configs, chain)


if __name__ == "__main__":
    main()
