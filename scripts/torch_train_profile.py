"""Where the card's time goes in the port's train step: full-width Mixer-B/32,
bf16 compute, f32 masters, on each of the three routes (plain, ``fused_mlp``,
the fused-block route through ``route_towers``), from the same random weights
and a fixed uint8 batch.

    python scripts/torch_train_profile.py [--batch 256] [--iters 3] [--routes plain ...]
        [--accum-steps N] [--remat none|mlp_hidden|all_hidden]

Prints one JSON line per route: the step's wall ms (CUDA events around
``make_train_step``'s step), the summed device time of its kernels under
``torch.profiler``, the device's idle share, the kernels that took the most
device time, and the step's parts as its own ``record_function`` ranges
mark them (forward + loss and backward, or GradCache's two passes; the
optimiser update): for each, the device time of the kernels launched inside
it, from any thread, and its time on the host. Needs a CUDA device.
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
from clip_mixer_tpu_torch.config import TrainConfig  # noqa: E402
from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers  # noqa: E402
from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step  # noqa: E402
from clip_mixer_tpu_torch.train.optimizer import make_optimizer  # noqa: E402

ROUTES = ("plain", "fused_mlp", "fused_block")
# the step's own profiler ranges (parallel/train_step.py)
PARTS = ("train_step/forward", "train_step/backward", "train_step/gradcache", "train_step/update")


def batch_on(dev, cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, cfg.image_resolution, cfg.image_resolution, 3), dtype=np.uint8)
    texts = rng.integers(1, 49406, (B, cfg.context_length)).astype(np.int32)
    texts[:, 0], texts[:, 20] = 49406, 49407  # SOT, and EOT (the argmax id)
    texts[:, 21:] = 0
    return torch.from_numpy(images).to(dev), torch.from_numpy(texts).to(dev)


def part_times(events, iters) -> dict:
    """Per part of the step (its ``record_function`` range): the device time
    of the kernels launched inside it, from any thread (the backward's run
    on autograd's device thread: attributed by the host time at which their
    top-level event started), and the range's time on the host."""
    cpu = torch.autograd.DeviceType.CPU
    ranges = [e for e in events if e.name in PARTS and e.device_type == cpu]
    parts = {name: {"kernel_ms": 0.0, "host_ms": 0.0} for name in PARTS}
    for r in ranges:
        parts[r.name]["kernel_ms"] += r.device_time_total / 1e3 / iters
        parts[r.name]["host_ms"] += r.time_range.elapsed_us() / 1e3 / iters
    for e in events:
        if e.device_type != cpu or e.cpu_parent is not None or e.name in PARTS:
            continue
        for r in ranges:
            if e.thread != r.thread and r.time_range.start <= e.time_range.start < r.time_range.end:
                parts[r.name]["kernel_ms"] += e.device_time_total / 1e3 / iters
                break
    return {name.split("/")[1]: t for name, t in parts.items()}


def profile_route(route, dev, B, iters, top, accum_steps=1, remat=None) -> dict:
    cfg = PRESETS["mixer-b32"].replace(fused_mlp=route == "fused_mlp")
    if remat:
        cfg = cfg.replace(remat=True, remat_policy=remat)
    tcfg = TrainConfig()
    model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    if route == "fused_block":
        route_towers(model, True)
    opt = make_optimizer(tcfg, total_steps=100)
    state = init_train_state(model, opt)
    step = make_train_step(cfg, tcfg, opt, accum_steps=accum_steps)
    images, texts = batch_on(dev, cfg, B)
    batch = {"images": images, "texts": texts}
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            state, _ = step(state, batch)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / iters
    events = prof.events()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    # the step's ranges may also show as device-side spans: not kernels
    kernels = [e for e in events if e.device_type == cuda and e.name not in PARTS]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / iters
    by_name = {}
    for e in kernels:
        c = by_name.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += e.time_range.elapsed_us()
    top_kernels = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    parts = part_times(events, iters)
    return {
        "route": route,
        "B": B,
        "accum_steps": accum_steps,
        "remat_policy": remat,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        # one stream, so kernels do not overlap
        "idle_share": 1.0 - busy_ms / wall_ms,
        "parts": parts,
        "kernels": [{"name": n[:120], "calls": c // iters, "ms": us / 1e3 / iters} for n, (c, us) in top_kernels],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--routes", nargs="+", choices=ROUTES, default=list(ROUTES))
    ap.add_argument("--accum-steps", type=int, default=1, help="GradCache microbatches a step")
    ap.add_argument("--remat", choices=("none", "mlp_hidden", "all_hidden"), help="remat policy (default: no remat)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for route in args.routes:
        r = profile_route(route, dev, args.batch, args.iters, args.top, args.accum_steps, args.remat)
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
