#!/usr/bin/env python3
"""Measure the run-to-run spread of the text int8 noise-floor gate statistic, on the port.

The counterpart of ``scripts/text_gate_stability.py``: the same protocol
(Mixer-B/32 at full width, fixed seeds) run ``--runs`` times in one
process. The texts are the JAX script's token array bit for bit (numpy
``default_rng(42)``: BOS, 7 random ids in [1, 49000), EOT); the retrieval
bank is 512 synthetic images (seed 2) through the model's f32 twin,
normalised and L2-normalised. Each run calibrates on the first 128 texts and
computes the f32, bf16 and int8 features in batches of 512. It prints the
JAX script's per-run lines and its summary line, whose ``stable`` is the JAX
bar: max - min flip ratio < 0.3 over the runs. The Mixer-B/32 text gate
fails in both packages, so a failed gate is a reading here, not a fault.

The weights are the port's seed-0 draw. Runs on the CUDA card unless
``--device`` names another device; TF32 is off on the card, as in
``chip_smoke.py``. ``--out`` also writes the runs and the summary, with the
card's name and power limit.

Usage: python scripts/torch_text_gate_stability.py [--runs 5] [--n-texts 4096]
       [--out TEXT_GATE_STABILITY_TORCH.json] [--device cpu]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from clip_mixer_tpu_torch.config import PRESETS  # noqa: E402
from clip_mixer_tpu_torch.device import card, no_tf32, resolve_device  # noqa: E402
from clip_mixer_tpu_torch.evals.quant_gate import (  # noqa: E402
    _batched_feats,
    float32_twin,
    synthetic_images,
    text_noise_floor_gate,
)
from clip_mixer_tpu_torch.models.clip import CLIP, l2_normalize  # noqa: E402
from clip_mixer_tpu_torch.ops.preprocess import normalize_images  # noqa: E402

BOS, EOT = 49406, 49407
ROW_KEYS = ("flip_bf16_vs_f32", "flip_int8_vs_f32", "flip_ratio", "passed")
STABLE_SPREAD = 0.3  # the JAX script's bar on max - min flip ratio


def gate_texts(n: int, context_length: int, seed: int = 42) -> np.ndarray:
    """The gate's token array [n, context_length] int32, the JAX script's."""
    rng = np.random.default_rng(seed)
    texts = np.zeros((n, context_length), np.int32)
    texts[:, 0] = BOS
    texts[:, 1:8] = rng.integers(1, 49000, (n, 7))
    texts[:, 8] = EOT
    return texts


def image_bank(model, n: int = 512, seed: int = 2, draw=synthetic_images) -> np.ndarray:
    """[n, embed_dim] f32: ``draw(n, resolution, seed)`` through ``model``'s
    f32 twin, normalised in f32, L2-normalised."""
    images = draw(n, model.cfg.image_resolution, seed)

    def encode(m, x):
        return l2_normalize(m.encode_image(normalize_images(x, dtype=torch.float32)))

    return _batched_feats(encode, float32_twin(model), images, n, model.device)


def study(model, texts: np.ndarray, bank: np.ndarray, runs: int) -> list:
    """``runs`` text gates on ``texts`` against ``bank`` [M, embed_dim],
    printing the JAX script's line for each."""
    rows = []
    for r in range(runs):
        g = text_noise_floor_gate(model, texts, bank.T, calibrate_n=128, batch_size=512)
        rows.append(g)
        print(json.dumps({"run": r, **{k: g[k] for k in ROW_KEYS}}), flush=True)
    return rows


def summarize(rows: list, n_texts: int) -> dict:
    """The JAX script's summary line of the runs ``rows``."""
    ratios = [g["flip_ratio"] for g in rows]
    return {
        "n_texts": n_texts,
        "runs": len(rows),
        "ratio_min": min(ratios),
        "ratio_max": max(ratios),
        "spread": max(ratios) - min(ratios),
        "stable": max(ratios) - min(ratios) < STABLE_SPREAD,
    }


def main(argv=None, preset: str = "mixer-b32", draw=synthetic_images) -> dict:
    """Run the study as the command line says; returns the record. ``preset``
    lets a test run a small model, ``draw`` serves the bank's images."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--n-texts", type=int, default=4096)
    p.add_argument("--bank", type=int, default=512)
    p.add_argument("--out", default=None, help="also write the runs and the summary as JSON")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)  # no card and no --device: raise before anything runs
    no_tf32()
    t0 = time.perf_counter()
    cfg = PRESETS[preset]
    model = CLIP(cfg, device=device, generator=torch.Generator().manual_seed(0)).eval()
    texts = gate_texts(args.n_texts, cfg.context_length)
    bank = image_bank(model, args.bank, draw=draw)
    rows = study(model, texts, bank, args.runs)
    summary = summarize(rows, args.n_texts)
    print(json.dumps(summary), flush=True)
    name, power = card(device)
    record = {"preset": preset, "n_texts": args.n_texts, "runs": args.runs, "bank": args.bank, "rows": rows,
              "summary": summary, "device": name, "power_limit": power, "tf32": False,
              "seconds": time.perf_counter() - t0}
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
