"""Where the card's time goes in the transformer (ViT) towers: ``torch.profiler``
over one preset's vision and text towers at a bucket, bf16, random weights
from seed 0 (the towers' own chain: no kernel of ours runs in them).

    python scripts/torch_vit_profile.py [--preset vit-l14] [--batch 128] [--iters 5]

Prints one JSON line per tower: wall ms per call (CUDA events), the summed
device time of the kernels, the device's idle share, the device time by
kind of operation (the products; the softmax; the dtype casts; the rest,
elementwise and reductions: LayerNorm, QuickGELU, bias adds, the score
scale) and the kernels that took the most. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clip_mixer_tpu_torch import CLIP, PRESETS  # noqa: E402

# aten ops by kind; everything else counts as "elementwise"
KINDS = {
    "products": ("aten::mm", "aten::bmm", "aten::addmm", "aten::_int_mm"),
    "softmax": ("aten::_softmax",),
    "casts": ("aten::_to_copy", "aten::copy_"),
}


def _self_device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0))


def by_kind(prof_rows, iters: int) -> dict:
    """Self device ms a call by ``KINDS`` from ``key_averages()`` rows."""
    out = {k: 0.0 for k in (*KINDS, "elementwise")}
    for e in prof_rows:
        us = _self_device_us(e)
        if us <= 0 or not e.key.startswith("aten::"):
            continue
        kind = next((k for k, ops in KINDS.items() if e.key in ops), "elementwise")
        out[kind] += us / 1e3 / iters
    return out


def profile_tower(fn, iters: int, top: int, kinds=by_kind) -> dict:
    """``fn`` profiled over ``iters`` calls; ``kinds(key_averages(), iters)``
    sorts the device time by kind of op."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / iters
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / iters
    by_name = {}
    for e in kernels:
        c = by_name.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += e.time_range.elapsed_us()
    top_kernels = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,  # one stream: kernels do not overlap
        "device_ms_by_kind": kinds(prof.key_averages(), iters),
        "kernels": [{"name": n[:120], "calls": c // iters, "ms": us / 1e3 / iters} for n, (c, us) in top_kernels],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="vit-l14")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_vit_profile: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = PRESETS[args.preset]
    if not cfg.use_transformer or cfg.is_resnet:
        raise SystemExit(f"{args.preset} has no transformer towers")
    model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    for name, tower, T, W in (("vision", model.visual.transformer, cfg.vision_tokens, cfg.vision_width),
                              ("text", model.transformer, cfg.context_length, cfg.text_width)):
        x = torch.randn(args.batch, T, W, generator=g).to(device=dev, dtype=torch.bfloat16)

        def call():
            with torch.inference_mode():
                tower(x)

        out = profile_tower(call, args.iters, args.top)
        print(json.dumps({"preset": args.preset, "tower": name, "batch": args.batch,
                          "device": torch.cuda.get_device_name(0), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
