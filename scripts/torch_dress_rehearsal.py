"""Dress rehearsal of the reference's production training run, on the port.

The counterpart of ``scripts/dress_rehearsal.py``. The reference's headline
run is Mixer-B/32 at a global batch of 32,768 on webdataset shards, with
checkpoints and validation every 400 steps and resume from checkpoints
after a crash. This script runs that composition on one CUDA card against
the locally generated shard set (``scripts/torch_make_dress_dataset.py``):

  * ``python -m clip_mixer_tpu_torch.train_cli`` under the elastic
    supervisor (``scripts/torch_supervise.py``),
  * the global batch through exact GradCache accumulation (``--accum-steps``),
    with remat (``train_cli``'s default),
  * the decode-once disk cache (``--cache-data``): the run decodes each JPEG
    once, and a resumed process maps the cache instead of decoding again,
  * the retrieval validator on a held-out shard (``--val-data``),
  * a checkpoint cadence, and a hard crash (``--crash-after-steps``) that the
    supervisor must recover from checkpoints,

then distills ``outputs/<run>/runs/metrics.jsonl`` into ``--out``: the loss
curve, the retrieval series, the steady images/s, the restart count and the
resume boundary, with the card's name and power limit.

Every path is read in the working directory: the trainer writes
``outputs/<run-name>`` there, and ``--out`` (``TRAIN_DRESS_TORCH.json``) is
written there. Runs on the card unless ``--device`` names another device.

Usage:
  python scripts/torch_dress_rehearsal.py --steps 510 --accum 16 \\
      --data 'dress/0000[0-8].tar' --val-data dress/00009.tar
"""

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def read_metrics(run_dir: Path):
    series = {}
    path = Path(run_dir) / "runs" / "metrics.jsonl"
    if not path.exists():
        return series
    for line in path.read_text().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue  # truncated tail line from a crash
        series.setdefault(rec["name"], []).append((rec["step"], rec["value"]))
    return series


def thin(points, keep=60):
    if len(points) <= keep:
        return points
    stride = -(-len(points) // keep)  # ceil: never exceed ~keep points
    out = points[::stride]
    if out[-1] != points[-1]:
        out.append(points[-1])
    return out


def checkpoint_steps(run_dir: Path):
    """Step ids of the checkpoints the run left behind (``<step>/``
    directories; an unfinished ``<step>.tmp`` is not one): the resume
    boundary's evidence. A crash at step C with latest checkpoint K means the
    supervisor restarted from K and ran (C-K] again."""
    d = Path(run_dir) / "checkpoints"
    if not d.exists():
        return []
    return sorted(int(p.name) for p in d.iterdir() if p.name.isdigit())


def distill(series, wall, returncode, crash_after_steps=0, ckpt_steps=()):
    """Reduce a run's metric series to the rehearsal's record."""
    losses = series.get("Loss", [])
    ips = series.get("Throughput (imgs/s)", [])
    # trainer scalar names: "Retrieval I->T R@1" etc (evals/validators.py)
    retrieval = {k: thin(v, 30) for k, v in series.items()
                 if k.lower().startswith("retrieval")}
    steady = sorted(v for _, v in ips[len(ips) // 2:]) if ips else []
    return {
        "supervisor_exit": returncode,
        "wall_seconds": round(wall, 1),
        "steps_completed": losses[-1][0] if losses else 0,
        "loss_first": losses[0][1] if losses else None,
        "loss_last": losses[-1][1] if losses else None,
        "loss_curve": thin(losses, 80),
        "imgs_per_sec_median_steady": steady[len(steady) // 2] if steady else None,
        "imgs_per_sec_series": thin(ips, 40),
        "retrieval": retrieval,
        "checkpoint_steps": list(ckpt_steps),
        # with --crash-after-steps each launch dies after exactly N local
        # steps, so completed_steps // N is the number of crash->resume cycles
        "restarts": ((losses[-1][0] if losses else 0) // crash_after_steps
                     if crash_after_steps else 0),
    }


def write_result(out_path, result, leg=None):
    """Write the distilled run record; with ``leg``, merge under legs[leg]
    so the rehearsal's legs accumulate into one file."""
    out_path = Path(out_path)
    if leg:
        doc = {}
        if out_path.exists():
            try:
                doc = json.loads(out_path.read_text())
            except json.JSONDecodeError:
                doc = {}
        doc.setdefault("legs", {})[leg] = result
        out_path.write_text(json.dumps(doc, indent=2))
    else:
        out_path.write_text(json.dumps(result, indent=2))


def peak_mem_gb(series):
    """The largest allocator peak the trainer's processes recorded (its
    ``Peak memory (GB)`` rows, written on the card only), or None."""
    peaks = [v for _, v in series.get("Peak memory (GB)", [])]
    return max(peaks) if peaks else None


def main(argv=None, preset: str = "mixer-b32") -> int:
    """Run the rehearsal as the command line says and write its record.
    ``preset`` lets a test run the same composition at a small model."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="dress/0000[0-8].tar")
    p.add_argument("--val-data", default="dress/00009.tar")
    p.add_argument("--cache-dir", default="dress_cache")
    p.add_argument("--steps", type=int, default=510)
    p.add_argument("--global-batch", type=int, default=32768)  # training.py:56
    p.add_argument("--accum", type=int, default=16)
    p.add_argument("--checkpoint-every", type=int, default=400)  # training.py:197
    p.add_argument("--validate-every", type=int, default=100)
    p.add_argument("--crash-after-steps", type=int, default=450,
                   help="hard-crash each launch after N local steps (0 = off); "
                        "the supervisor resumes from the last checkpoint. Must "
                        "exceed --checkpoint-every: a crash BEFORE the first "
                        "checkpoint resumes from step 0 and re-crashes at the "
                        "same point — no progress, and the supervisor's "
                        "no-progress budget correctly aborts the run")
    p.add_argument("--run-name", default="dress")
    p.add_argument("--out", default="TRAIN_DRESS_TORCH.json")
    p.add_argument("--max-restarts", type=int, default=8)
    p.add_argument("--stall-timeout", type=float, default=1800.0,
                   help="the supervisor's hang detection: a child whose per-step "
                        "heartbeat is this many seconds old is killed and "
                        "restarted. It must exceed start-up (the cache fill, the "
                        "first steps) and a validation pass. 0 disables.")
    p.add_argument("--max-child-rss-gb", type=float, default=95.0,
                   help="the supervisor's RSS hygiene budget: past it the child "
                        "is stopped (its preemption checkpoint runs) and "
                        "restarted. A cached run's pages of the memmapped cache "
                        "count in its RSS, so keep the budget above the cache's "
                        "size. 0 disables.")
    p.add_argument("--leg", default=None, metavar="NAME",
                   help="record the result under legs[NAME] in --out, merging "
                        "with existing legs: the rehearsal runs as two legs, the "
                        "reference's global batch of 32,768 for the "
                        "composition, and a leg of 500 steps and more at a "
                        "smaller batch for the learning curve")
    p.add_argument("--n-samples", type=int, default=90000,
                   help="train samples in --data (sets steps/epoch)")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)

    from clip_mixer_tpu_torch.device import card, resolve_device

    device = resolve_device(args.device)  # no card and no --device: raise before anything runs
    run_dir = Path("outputs") / args.run_name
    # epochs is derived from the requested step count; the cache serves
    # floor(n_samples / batch) full batches per epoch
    steps_per_epoch = max(1, args.n_samples // args.global_batch)
    epochs = math.ceil(args.steps / steps_per_epoch)

    train_args = [
        "--preset", preset,
        "--data", args.data,
        "--cache-data", args.cache_dir,
        "--global-batch-size", str(args.global_batch),
        "--accum-steps", str(args.accum),
        "--epochs", str(epochs),
        "--checkpoint-every", str(args.checkpoint_every),
        "--validate-every", str(args.validate_every),
        "--no-validators",  # offline HF validators skip anyway; retrieval rides --val-data
        "--val-data", args.val_data,
        "--val-samples", "2048",
        "--run-name", args.run_name,
        "--verbose",
    ]
    if args.crash_after_steps:
        train_args += ["--crash-after-steps", str(args.crash_after_steps)]
    if args.device is not None:
        train_args += ["--device", args.device]

    sup_args = ["--max-restarts", str(args.max_restarts)]
    if args.stall_timeout:
        sup_args += ["--stall-timeout", str(args.stall_timeout)]
    if args.max_child_rss_gb and args.max_child_rss_gb > 0:
        sup_args += ["--max-child-rss-gb", str(args.max_child_rss_gb)]
    cmd = [sys.executable, str(REPO / "scripts" / "torch_supervise.py"),
           *sup_args, "--"] + train_args
    print("[dress] launching:", " ".join(cmd), flush=True)
    t0 = time.time()
    proc = subprocess.run(cmd)
    wall = time.time() - t0

    result = distill(read_metrics(run_dir), wall, proc.returncode,
                     crash_after_steps=args.crash_after_steps,
                     ckpt_steps=checkpoint_steps(run_dir))
    result["config"] = {
        "preset": preset,
        "global_batch_size": args.global_batch,
        "accum_steps": args.accum,
        "steps_requested": args.steps,
        "checkpoint_every": args.checkpoint_every,
        "validate_every": args.validate_every,
        "crash_after_steps": args.crash_after_steps,
        "data": args.data,
        "val_data": args.val_data,
    }
    result["peak_mem_gb"] = peak_mem_gb(read_metrics(run_dir))
    result["device"], result["power_limit"] = card(device)
    losses = result["loss_curve"]
    write_result(args.out, result, args.leg)
    print(json.dumps({k: result[k] for k in (
        "steps_completed", "loss_first", "loss_last",
        "imgs_per_sec_median_steady", "wall_seconds", "supervisor_exit", "device")}))
    return 0 if proc.returncode == 0 and losses else 1


if __name__ == "__main__":
    sys.exit(main())
