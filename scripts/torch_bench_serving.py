#!/usr/bin/env python3
"""Serving-path benchmark of the port: ``InferenceEngine`` on the card, no HTTP.

The counterpart of ``scripts/bench_serving.py``. It measures the serving
machinery end to end with pre-decoded uint8 arrays: padded fixed-shape
encoders, bucket selection, micro-batching under concurrency and the int8
swap. Seed-0 ``mixer-b32`` behind an engine with buckets (8, 32, 128); for
the bf16 mode, then for int8 after ``enable_int8(imgs, sample_texts=...)``:

* images/s at bucket 128, over 8 calls;
* the per-call cost read at bucket 8 (``*_call_overhead_ms``). On a local
  card this is the host's cost of a call (copies, dispatch, the fetch of
  the features), not a tunnel's round trip; ``*_rtt_corrected`` subtracts
  it from the bucket-128 call;
* 16 threads x 8 coalesced single-image requests: requests/s, p50 / p99;
* text, 64 prompts a call (tokenize + encode).

Prints one JSON line with the JAX script's keys, plus ``power_limit``;
``device`` names the card. Runs on the card unless ``--device`` names
another device; TF32 is off.

Usage: python scripts/torch_bench_serving.py [--device cuda]
"""

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clip_mixer_tpu_torch.config import PRESETS  # noqa: E402
from clip_mixer_tpu_torch.device import card, no_tf32, resolve_device  # noqa: E402

NOTE = (
    "a local card: every engine call copies its uint8 inputs (~19 MB at batch 128) to the card and "
    "its features back, so *_call_overhead_ms is the host's per-call cost read at bucket 8 (copies, "
    "dispatch, the fetch), not a tunnel's round trip, and *_rtt_corrected subtracts it. This script "
    "measures the serving machinery under concurrency; the encoders' device time is chip_smoke.py's "
    "tower timing."
)


def pct(v, q):
    return float(np.percentile(np.asarray(v), q))


def main(argv=None, preset: str = "mixer-b32") -> dict:
    """Run both modes and print the line; returns it. ``preset`` lets a
    test run a small model."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    no_tf32()

    from clip_mixer_tpu_torch.models.clip import CLIP
    from clip_mixer_tpu_torch.serving import InferenceEngine

    cfg = PRESETS[preset]
    model = CLIP(cfg, device=device, generator=torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, batch_buckets=(8, 32, 128))

    rng = np.random.default_rng(0)
    res = cfg.image_resolution
    imgs = rng.integers(0, 256, (128, res, res, 3), dtype=np.uint8)

    out = {}
    for mode in ("bf16", "int8"):
        if mode == "int8":
            engine.enable_int8(imgs, sample_texts=["a photo of a cat", "a dog"])
        # warm all buckets + the micro-batcher thread (its spin-up must not
        # land inside the first mode's timed coalesced loop)
        for b in (8, 32, 128):
            engine.encode_image_arrays(imgs[:b])
        engine.encode_image_arrays(imgs[:1], coalesce=True)

        reps = 8
        # per-call cost: bucket 8's device time is small, so its latency is
        # the host's cost of a call
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.encode_image_arrays(imgs[:8])
        rtt = (time.perf_counter() - t0) / reps

        # batch throughput (bucket 128), over several calls
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.encode_image_arrays(imgs)
        dt = time.perf_counter() - t0
        per_call = dt / reps
        out[f"{mode}_batch128_imgs_per_sec"] = round(reps * 128 / dt, 1)
        out[f"{mode}_call_overhead_ms"] = round(rtt * 1e3, 1)
        if per_call > rtt:
            out[f"{mode}_batch128_imgs_per_sec_rtt_corrected"] = round(128 / (per_call - rtt), 1)

        # coalesced single-image requests: 16 threads x 8 requests
        lat = []

        def worker():
            for i in range(8):
                t = time.perf_counter()
                engine.encode_image_arrays(imgs[i % 128:i % 128 + 1], coalesce=True)
                lat.append(time.perf_counter() - t)

        threads = [threading.Thread(target=worker) for _ in range(16)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        out[f"{mode}_coalesced_reqs_per_sec"] = round(128 / dt, 1)
        out[f"{mode}_coalesced_p50_ms"] = round(pct(lat, 50) * 1e3, 1)
        out[f"{mode}_coalesced_p99_ms"] = round(pct(lat, 99) * 1e3, 1)

        # text path (tokenize + encode), batch of 64 prompts
        prompts = [f"a photo of object number {i}" for i in range(64)]
        engine.encode_text(prompts)  # warm
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.encode_text(prompts)
        out[f"{mode}_text64_texts_per_sec"] = round(reps * 64 / (time.perf_counter() - t0), 1)

    out["note"] = NOTE
    out["device"], out["power_limit"] = card(device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
