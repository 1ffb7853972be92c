#!/usr/bin/env python3
"""Measure the sampling spread of the IMAGE int8 noise-floor gate statistic, on the port.

The counterpart of ``scripts/image_gate_stability.py``: full-width
Mixer-B/32 (the port's seed-0 weights), the bench classifier (64 ImageNet
classes x 4 templates, built in the float model), and for each front end
and each seed 1..``--seeds`` the front-end gate
(``evals/quant_gate.py::frontend_noise_floor_gate``, calibrated on the first
128 images, batches of 256) on ``synthetic_images(n, src_res, seed)``:

* the seed axis: independent image sets, the binomial noise of the flip
  counts themselves;
* the front-end axis: the planar int8 front end against the NHWC
  preprocess + ``encode_image_q``, on the same images.

It prints the JAX script's line for each (front end, seed) and for each
front end a summary: the flip counts pooled over the seeds (the best
estimate of the true flip ratio) and the spread of the per-seed ratios
(:func:`summarize`). Each image set is drawn once and serves both front
ends.

Runs on the CUDA card unless ``--device`` names another device; TF32 is
off on the card, as in ``chip_smoke.py``. ``--out`` writes the table with
the card's name and power limit (never the JAX package's
``IMAGE_GATE_STABILITY.json``).

Usage: python scripts/torch_image_gate_stability.py [--n 4096] [--seeds 5]
       [--front-ends planar nhwc] [--out IMAGE_GATE_STABILITY_TORCH.json]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from clip_mixer_tpu_torch.config import PRESETS  # noqa: E402
from clip_mixer_tpu_torch.device import card, no_tf32, resolve_device  # noqa: E402
from clip_mixer_tpu_torch.evals.prompts import IMAGENET_CLASSNAMES, PROMPT_TEMPLATES  # noqa: E402
from clip_mixer_tpu_torch.evals.quant_gate import (  # noqa: E402
    build_float_classifier,
    frontend_noise_floor_gate,
    synthetic_images,
)
from clip_mixer_tpu_torch.models.clip import CLIP  # noqa: E402

ROW_KEYS = ("flip_bf16_vs_f32", "flip_int8_vs_f32", "flip_ratio", "passed")


def classifier(model):
    """The bench classifier: 64 classes x 4 templates at the model's scale."""
    return build_float_classifier(model, IMAGENET_CLASSNAMES[:64], PROMPT_TEMPLATES[:4], batch_size=256)


def summarize(rows: list, n: int) -> dict:
    """A front end's summary over its per-seed gate rows of ``n`` images
    each: the JAX script's, key for key."""
    pooled_bf16 = sum(round(g["flip_bf16_vs_f32"] * n) for g in rows)
    pooled_int8 = sum(round(g["flip_int8_vs_f32"] * n) for g in rows)
    ratios = [g["flip_ratio"] for g in rows]
    return {
        "per_seed_ratios": [round(r, 3) for r in ratios],
        "ratio_min": round(min(ratios), 3),
        "ratio_max": round(max(ratios), 3),
        "spread": round(max(ratios) - min(ratios), 3),
        "pooled_flips_bf16": pooled_bf16,
        "pooled_flips_int8": pooled_int8,
        "pooled_n": n * len(rows),
        "pooled_ratio": round(pooled_int8 / max(pooled_bf16, 1), 3),
    }


def study(model, w, n: int, seeds: int, src_res: int, front_ends, draw=synthetic_images) -> dict:
    """{front end: {"rows", "summary"}}, printing the JAX script's lines;
    ``draw(n, res, seed)`` gives each image set, once for all front ends."""
    sets = {}
    out = {}
    for fe in front_ends:
        rows = []
        for seed in range(1, seeds + 1):
            if seed not in sets:
                sets[seed] = draw(n, src_res, seed)
            g = frontend_noise_floor_gate(model, sets[seed], w, calibrate_n=128, batch_size=256, front_end=fe)
            rows.append(g)
            print(json.dumps({"front_end": fe, "seed": seed, **{k: g[k] for k in ROW_KEYS}}), flush=True)
        summary = summarize(rows, n)
        out[fe] = {"rows": rows, "summary": summary}
        print(json.dumps({"front_end": fe, **summary}), flush=True)
    return out


def main(argv=None, preset: str = "mixer-b32", draw=synthetic_images) -> dict:
    """Run the study as the command line says; returns the record. ``preset``
    lets a test run a small model, ``draw`` serves the image sets."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=4096, help="images per gate run")
    p.add_argument("--seeds", type=int, default=5, help="independent image sets")
    p.add_argument("--src-res", type=int, default=256)
    p.add_argument("--front-ends", nargs="+", default=["planar", "nhwc"])
    p.add_argument("--out", default=None, help="also write the table as JSON")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)  # no card and no --device: raise before anything runs
    no_tf32()
    t0 = time.perf_counter()
    model = CLIP(PRESETS[preset], device=device, generator=torch.Generator().manual_seed(0)).eval()
    w = classifier(model)
    name, power = card(device)
    record = {"n": args.n, "seeds": args.seeds, "src_res": args.src_res, "preset": preset,
              "front_ends": study(model, w, args.n, args.seeds, args.src_res, args.front_ends, draw),
              "device": name, "power_limit": power, "tf32": False, "seconds": time.perf_counter() - t0}
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
