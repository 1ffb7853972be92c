#!/usr/bin/env python3
"""Host -> card input-transfer bandwidth of the port (a bound on real-data training).

The counterpart of ``scripts/bench_transfer.py``. Every real-data train
step copies its uint8 batch from host memory to the card; on the card's
host that copy runs over PCIe, beside the step when the trainer prefetches
(``data/pipeline.py::device_prefetch``). This script measures how fast the
copy itself runs for a B = 2048 uint8 image batch at 224 px (308 MB, the
dress leg's shape), so a data-bound run can be told from a copy-bound one.

The headline ``value`` is the copy the port's trainer makes: the batch in
pinned (page-locked) host memory, copied with ``non_blocking=True``. The
pageable ``.to(device)`` of the same array stands beside it in ``detail``.
(JAX's script timed ``jax.device_put``, its trainer's own path.) Each rate
is the median of four transfers, each fenced by ``torch.cuda.synchronize()``
(a copy, unlike compute, cannot be chained on the card: the fence is the
edge), after a warm-up copy of 64 images. Run it while the card is
otherwise idle.

Prints one JSON line with the JAX script's keys; ``detail`` adds
``power_limit`` and the pageable rates, and ``device`` names the card.
Runs on the card unless ``--device`` names another device (elsewhere no
memory is pinned and both rates are the host's own copy).

Usage: python scripts/torch_bench_transfer.py [--device cuda]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clip_mixer_tpu_torch.device import card, resolve_device  # noqa: E402

SHAPE = (2048, 224, 224, 3)


def copy_rates(host: torch.Tensor, device, non_blocking: bool, n: int = 4) -> list:
    """MB/s of ``n`` copies of ``host`` to ``device``, each fenced, sorted."""
    cuda = device.type == "cuda"
    mb = host.numel() * host.element_size() / 1e6
    rates = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = host.to(device, non_blocking=non_blocking, copy=True)
        if cuda:
            torch.cuda.synchronize(device)
        rates.append(mb / (time.perf_counter() - t0))
        del out
    return sorted(rates)


def main(argv=None, shape=SHAPE) -> dict:
    """The transfer rates; returns the line. ``shape`` replaces the batch's,
    so a test runs small."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    batch = torch.from_numpy(np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8))
    mb = batch.numel() / 1e6
    pinned = batch.pin_memory() if dev.type == "cuda" else batch
    # warm-up (the allocator, the copy engines)
    pinned[:64].to(dev, non_blocking=True, copy=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rates = copy_rates(pinned, dev, non_blocking=True)
    pageable = copy_rates(batch, dev, non_blocking=False)
    mid = rates[len(rates) // 2]
    name, power = card(dev)
    out = {
        "metric": f"host->device uint8 transfer MB/s (B={shape[0]} image batch)",
        "value": round(mid, 1),
        "unit": "MB/s",
        "detail": {
            "runs_mb_per_s": [round(r, 1) for r in rates],
            "batch_mb": round(mb, 1),
            "device": name,
            "implied_imgs_per_sec_at_b2048": round(mid / mb * shape[0], 1),
            "power_limit": power,
            "copy": "pinned host memory, non_blocking=True (the trainer's device_prefetch)",
            "pageable_mb_per_s": round(pageable[len(pageable) // 2], 1),
            "pageable_runs_mb_per_s": [round(r, 1) for r in pageable],
        },
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
