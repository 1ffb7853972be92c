"""Where the card's time goes in the image front end: ``torch.profiler`` over
preprocess -> ``encode_image`` at full width, the kernel path
(``backend="kernel"``, ``fused_mlp=True``) against the plain one
(``backend="torch"``, ``fused_mlp=False``), on the same random weights.

    python scripts/torch_profile_front_end.py [--batch 128] [--iters 5]

Prints one JSON line per path: wall ms per batch (CUDA events), the summed
device time of the kernels, the device's idle share, and the operations and
kernels that took the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clip_mixer_tpu_torch import CLIP, PRESETS  # noqa: E402
from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess  # noqa: E402


def _device_us(evt) -> float:
    return float(getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0))


def profile_path(model, pre, x, iters: int, top: int) -> dict:
    def run():
        with torch.inference_mode():
            model.encode_image(pre(x))

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            run()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / iters
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / iters
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, [0, 0.0])
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    top_kernels = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::") and _device_us(e) > 0]
    top_ops = sorted(ops, key=lambda e: -_device_us(e))[:top]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        # one stream, so kernels do not overlap: a negative share would mean a wrong measurement
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels": [{"name": n[:120], "calls": c // iters, "ms": us / 1e3 / iters} for n, (c, us) in top_kernels],
        "aten_ops": [{"op": e.key, "calls": e.count // iters, "device_ms": _device_us(e) / 1e3 / iters} for e in top_ops],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_front_end: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = PRESETS["mixer-b32"]
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (args.batch, 256, 256, 3), dtype=np.uint8)).to(dev)
    for name, fused, backend in (("kernel", True, "kernel"), ("plain", False, "torch")):
        model = CLIP(cfg.replace(fused_mlp=fused), device=dev, generator=torch.Generator().manual_seed(0))
        pre = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend=backend)
        out = profile_path(model, pre, x, args.iters, args.top)
        print(json.dumps({"path": name, "batch": args.batch, "device": torch.cuda.get_device_name(0), **out}), flush=True)
        del model
    return 0


if __name__ == "__main__":
    sys.exit(main())
