#!/usr/bin/env python3
"""Host input-pipeline throughput of the port: ``TarShardSource`` decode at N workers.

The counterpart of ``scripts/bench_input.py``. It writes a local tar shard
of JPEGs (256 px, quality 90, the img2dataset output format,
generateDataset.sh:18) with the port's ``write_tar_shards``, then measures
end-to-end images/s (tar read + JPEG decode + resize to 224 + tokenize)
for the thread and process decode modes at 1, 2, 4 and 8 workers, on the
host that feeds the card.

PIL releases the GIL inside the JPEG decoder, so thread scaling should
track cores until the Python glue saturates one core; ``decode_mode=
"process"`` removes that ceiling. ``host_cores`` is ``os.cpu_count()``,
and ``note`` says how many cores this process may use, above which more
workers measure overhead, not scaling.

``BENCH_INPUT_N`` (default 512) sets the images. Prints one JSON line with
the JAX script's keys plus ``device`` (the card the host feeds) and
``power_limit``. Needs the card unless ``--device`` names another device.

Usage: python scripts/torch_bench_input.py [--device cuda]   (one JSON line)
"""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clip_mixer_tpu_torch.device import card, resolve_device  # noqa: E402

MODES = ("thread", "process")
WORKERS = (1, 2, 4, 8)


def usable_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        return os.cpu_count()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="the card the host feeds (default: cuda, which must exist)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from clip_mixer_tpu_torch.data.pipeline import TarShardSource, write_tar_shards

    n_images = int(os.environ.get("BENCH_INPUT_N", "512"))

    def jpeg_samples():
        # photo-like structured patterns (gradients/stripes/blobs: the
        # quant gate's deterministic set), not max-entropy noise: noise
        # JPEG-encodes to far larger files and overstates decode cost.
        from clip_mixer_tpu_torch.evals.quant_gate import synthetic_images

        imgs = synthetic_images(n_images, 256, seed=0)
        for i in range(n_images):
            yield imgs[i], f"a synthetic caption number {i} for throughput"

    results = {}
    with tempfile.TemporaryDirectory(prefix="bench_input_") as tmp:
        # quality 90 = the img2dataset output format (generateDataset.sh:18)
        paths = write_tar_shards(jpeg_samples(), tmp, samples_per_shard=n_images, quality=90)
        # at least 4 batches so one warm batch leaves >= 3 timed ones
        batch_size = min(256, max(16, n_images // 4))
        for mode in MODES:
            for workers in WORKERS:
                src = TarShardSource(paths, batch_size=batch_size, image_size=224,
                                     decode_workers=workers, decode_mode=mode)
                # Time within one generator, from the second batch on: each
                # iter_batches() call builds its own decode pool, so a
                # separate warm iterator would still leave the pool's
                # spin-up (spawned workers import the port) in the timed part.
                it = src.iter_batches(0)
                next(it)  # pool spin-up + page cache, untimed
                t0 = time.perf_counter()
                n = 0
                for b in it:
                    n += b["images"].shape[0]
                dt = time.perf_counter() - t0
                results[f"{mode}_{workers}w"] = round(n / dt, 1)

    cores = usable_cores()
    out = {
        "imgs_per_sec": results,
        "n_images": n_images,
        "host_cores": os.cpu_count(),
        "note": f"{cores} cores of the host that feeds {device} usable by this process: worker counts "
                f"above {cores} measure overhead, not scaling",
    }
    out["device"], out["power_limit"] = card(device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
