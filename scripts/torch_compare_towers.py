"""Mixer-vs-Transformer twin comparison on the card: the reference's core claim, on the port.

The counterpart of ``scripts/compare_towers.py``. The reference claims that
the Mixer variant trains ~25% faster than its Transformer twin, and draws
zero-shot and STS figures for both towers at equal step budgets. This
script measures, end to end on the card:

  1. **Train-step speed**: ``utils/profiling.py::chained_train_time`` over
     ``parallel/train_step.py::make_train_step`` on both presets at the
     same batch, with remat: the step resizes 256x256 uint8 images to the
     model's resolution (the bicubic resize as two products in f32, then the
     step's normalisation to bf16), runs the forward, InfoNCE, the backward,
     the AdamW update and the clamp. The presets differ ONLY in ``tower``
     (the mixer's token-mix MLP against multi-head attention); 111M against
     151M parameters.
  2. **Equal-budget learning curves**: both twins through
     ``python -m clip_mixer_tpu_torch.train_cli`` on the same locally
     generated shards (``scripts/torch_make_dress_dataset.py``), with the
     same seed, batch, steps and learning rate, the retrieval validator on
     a held-out shard: loss and I->T / T->I R@1 at equal steps.

Each training leg runs in a child process of its own. Every path is read in
the working directory: the legs write ``outputs/compare_<preset>_<steps>``
there, and ``--out`` (``COMPARE_TOWERS_TORCH.json``) is written there. Runs
on the card unless ``--device`` names another device.

Usage:
  python scripts/torch_compare_towers.py --steps 400 --batch 512 \\
      --data 'dress/0000[0-8].tar' --val-data dress/00009.tar
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from torch_dress_rehearsal import peak_mem_gb, read_metrics, thin  # noqa: E402 (the same distillation)

PRESET_TWINS = ("mixer-b32", "transformer-b32")
SOURCE_HW = (256, 256)  # the shards' images, resized in the timed step


def measure_step_times(batch: int, device=None, presets=PRESET_TWINS):
    """Device-bound full-train-step seconds for both twins: ``presets``
    lets a test measure small models under the twins' names."""
    import numpy as np
    import torch

    from clip_mixer_tpu_torch.config import PRESETS, TrainConfig
    from clip_mixer_tpu_torch.device import resolve_device
    from clip_mixer_tpu_torch.models.clip import CLIP
    from clip_mixer_tpu_torch.ops.preprocess import _cached_matrices, resize
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer
    from clip_mixer_tpu_torch.utils.profiling import chained_train_time

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (batch, *SOURCE_HW, 3), dtype=np.uint8)).to(dev)
    toks = torch.from_numpy(rng.integers(1, 49000, (batch, 77), dtype=np.int32)).to(dev)

    out = {}
    for name, preset in zip(PRESET_TWINS, presets):
        cfg = PRESETS[preset].replace(remat=True)
        rh, rw = (torch.from_numpy(m).to(dev) for m in _cached_matrices(*SOURCE_HW, cfg.image_resolution))
        model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        n_params = sum(p.numel() for p in model.parameters())
        tcfg = TrainConfig()
        opt = make_optimizer(tcfg, total_steps=1000)
        train_step = make_train_step(cfg, tcfg, opt)

        def step(state, b, rh=rh, rw=rw, train_step=train_step):
            # the resize in f32; the train step normalises to the compute dtype
            return train_step(state, {"images": resize(b["images"], rh, rw), "texts": b["texts"]})

        batch_in = {"images": imgs, "texts": toks[:, :cfg.context_length]}
        dt = chained_train_time(step, init_train_state(model, opt), batch_in, device=dev)
        out[name] = {
            "params": n_params,
            "sec_per_step": round(dt, 4),
            "imgs_per_sec": round(batch / dt, 1),
        }
        print(f"[compare] {name}: {n_params/1e6:.1f}M params, "
              f"{dt*1e3:.1f} ms/step, {batch/dt:.0f} imgs/s", flush=True)
        del model, train_step, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()  # the legs' processes share the card
    m, t = out["mixer-b32"], out["transformer-b32"]
    out["mixer_speedup"] = round(t["sec_per_step"] / m["sec_per_step"] - 1.0, 4)
    return out


def check_fresh_run_dir(preset: str, steps: int) -> str:
    """A distinct run dir per (preset, steps): an existing checkpoint dir
    would silently RESUME instead of training the leg from scratch. Called
    as a PREFLIGHT on every leg before any measurement or training — a
    stale second-leg dir must not surface hours into the run."""
    run_name = f"compare_{preset}_{steps}"
    if (Path("outputs") / run_name / "checkpoints").exists():
        raise SystemExit(
            f"outputs/{run_name} already has checkpoints — the leg would "
            "resume mid-run instead of training from scratch; remove the "
            "directory (or pick different --steps) and re-run"
        )
    return run_name


def train_leg(preset: str, args, run_name: str = None) -> dict:
    run_name = run_name or check_fresh_run_dir(preset, args.steps)
    cmd = [
        sys.executable, "-m", "clip_mixer_tpu_torch.train_cli",
        "--preset", args.presets.get(preset, preset),
        "--data", args.data,
        "--cache-data", args.cache_dir,
        "--global-batch-size", str(args.batch),
        "--epochs", str(-(-args.steps // args.steps_per_epoch)),
        "--steps-per-epoch", str(args.steps_per_epoch),
        "--checkpoint-every", str(args.steps),
        "--validate-every", str(args.validate_every),
        "--no-validators",
        "--val-data", args.val_data,
        "--val-samples", "2048",
        "--run-name", run_name,
        "--seed", str(args.seed),
        "--verbose",
    ]
    if args.device is not None:
        cmd += ["--device", args.device]
    env = dict(os.environ)  # the package from this checkout, without installation
    env["PYTHONPATH"] = os.pathsep.join(x for x in (str(REPO), env.get("PYTHONPATH")) if x)
    print("[compare] launching:", " ".join(cmd), flush=True)
    t0 = time.time()
    proc = subprocess.run(cmd, env=env)
    wall = time.time() - t0
    series = read_metrics(Path("outputs") / run_name)
    losses = series.get("Loss", [])
    return {
        "exit": proc.returncode,
        "wall_seconds": round(wall, 1),
        "steps_completed": losses[-1][0] if losses else 0,
        "loss_first": losses[0][1] if losses else None,
        "loss_last": losses[-1][1] if losses else None,
        "loss_curve": thin(losses, 60),
        "retrieval": {k: thin(v, 30) for k, v in series.items()
                      if k.lower().startswith("retrieval")},
        "peak_mem_gb": peak_mem_gb(series),
    }


def _maybe_equal_device_time(doc: dict) -> None:
    """When the artifact holds a transformer leg and a LONGER mixer leg,
    record the equal-device-time comparison (the honest restatement of the
    reference's "~25% faster to train": at matched device seconds the mixer
    has run more steps — what does that buy in loss/retrieval?)."""
    st = doc.get("step_time_at_curve_batch", doc.get("step_time", {}))
    curves = doc.get("curves", {})
    if not ("mixer-b32" in st and "transformer-b32" in st):
        return
    legs = {}
    for key, leg in curves.items():
        preset = key.split("@")[0]
        steps = leg.get("steps_completed") or 0
        if preset in st and steps:
            legs.setdefault(preset, []).append((steps, leg))
    if not ("mixer-b32" in legs and "transformer-b32" in legs):
        return
    t_steps, t_leg = max(legs["transformer-b32"], key=lambda sl: sl[0])
    t_dev = t_steps * st["transformer-b32"]["sec_per_step"]
    # mixer leg whose device time lands closest to the transformer's
    m_steps, m_leg = min(
        legs["mixer-b32"],
        key=lambda sl: abs(sl[0] * st["mixer-b32"]["sec_per_step"] - t_dev),
    )
    m_dev = m_steps * st["mixer-b32"]["sec_per_step"]

    def final_retrieval(leg):
        return {name: series[-1] for name, series in leg.get("retrieval", {}).items()
                if series}

    doc["equal_device_time"] = {
        "transformer": {"steps": t_steps, "device_seconds": round(t_dev, 1),
                        "loss": leg_loss(t_leg), "retrieval_final": final_retrieval(t_leg)},
        "mixer": {"steps": m_steps, "device_seconds": round(m_dev, 1),
                  "loss": leg_loss(m_leg), "retrieval_final": final_retrieval(m_leg)},
        "device_time_mismatch_pct": round(100 * abs(m_dev - t_dev) / t_dev, 2),
        "note": ("equal DEVICE time: each leg's steps times its tower's "
                 "measured seconds a step at the curve batch; "
                 "retrieval_final = [step, value] of each leg's last "
                 "validation pass"),
    }


def leg_loss(leg: dict):
    return leg.get("loss_last")


def main(argv=None, presets=None) -> int:
    """The comparison as the command line says. ``presets`` maps a twin's
    name to the preset trained and timed under it, so a test can run the
    same code at small models."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--steps-per-epoch", type=int, default=100)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--step-time-batch", type=int, default=1024)
    p.add_argument("--validate-every", type=int, default=100)
    p.add_argument("--data", default="dress/0000[0-8].tar")
    p.add_argument("--val-data", default="dress/00009.tar")
    p.add_argument("--cache-dir", default="dress_cache")
    p.add_argument("--seed", type=int, default=0,
                   help="passed to both train_cli legs (identical twins)")
    p.add_argument("--out", default="COMPARE_TOWERS_TORCH.json")
    p.add_argument("--skip-curves", action="store_true",
                   help="only the step-time measurement (no training legs)")
    p.add_argument("--match-steps-auto", action="store_true",
                   help="with --single-leg: set --steps to match the "
                        "existing transformer leg's device time at the "
                        "curve batch's measured sec/step")
    p.add_argument("--single-leg", default=None, choices=PRESET_TWINS,
                   help="run ONE extra training leg (e.g. the mixer at "
                        "more steps than the transformer's for the equal-"
                        "device-time comparison) and MERGE it into an "
                        "existing --out under curves['<preset>@<steps>'], "
                        "keeping the prior step_time/curves blocks")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)
    args.presets = dict(presets or {})

    from clip_mixer_tpu_torch.device import card, resolve_device

    device = resolve_device(args.device)  # no card and no --device: raise before anything runs
    timed = [args.presets.get(t, t) for t in PRESET_TWINS]

    if args.single_leg:
        out_path = Path(args.out)
        doc = json.loads(out_path.read_text()) if out_path.exists() else {}
        prior_batch = (doc.get("config", {}).get("batch_curves")
                       or doc.get("step_time_at_curve_batch", {}).get("batch"))
        if prior_batch is not None and prior_batch != args.batch:
            # sec/step measured at a different batch than the existing
            # curves trained at would silently poison equal_device_time
            print(f"[compare] --batch {args.batch} != the artifact's curve "
                  f"batch {prior_batch}; pass --batch {prior_batch}",
                  file=sys.stderr)
            return 1
        if args.match_steps_auto:
            t_steps = max(
                ((l.get("steps_completed") or 0)
                 for k, l in doc.get("curves", {}).items()
                 if k.split("@")[0] == "transformer-b32"),
                default=0)
            if not t_steps:
                # fail BEFORE the step-time measurement
                print("[compare] --match-steps-auto needs an existing "
                      "transformer-b32 curve leg in --out (run the main "
                      "comparison or --single-leg transformer-b32 first)",
                      file=sys.stderr)
                return 1
        if not args.match_steps_auto:
            check_fresh_run_dir(args.single_leg, args.steps)
        # device step time AT THE CURVE BATCH (the main block measures at
        # --step-time-batch 1024; the curves train at --batch 512 — the
        # equal-device-time seconds must use the 512 numbers)
        doc["step_time_at_curve_batch"] = measure_step_times(args.batch, device, timed)
        doc["step_time_at_curve_batch"]["batch"] = args.batch
        if args.match_steps_auto:
            # steps for this leg = the transformer leg's device seconds
            # divided by the mixer's measured sec/step AT THE CURVE BATCH,
            # rounded to whole epochs so train_cli runs exactly that many
            st = doc["step_time_at_curve_batch"]
            target = t_steps * (st["transformer-b32"]["sec_per_step"]
                                / st[args.single_leg]["sec_per_step"])
            args.steps = max(args.steps_per_epoch,
                             round(target / args.steps_per_epoch)
                             * args.steps_per_epoch)
            print(f"[compare] matched steps: {t_steps} transformer steps "
                  f"-> {args.steps} {args.single_leg} steps", flush=True)
        leg = train_leg(args.single_leg, args)
        # record the curve batch so later single-leg runs hit the guard
        # even when the artifact was never written by the two-leg path
        doc.setdefault("config", {}).setdefault("batch_curves", args.batch)
        key = f"{args.single_leg}@{args.steps}"
        doc.setdefault("curves", {})[key] = leg
        doc["curves"][key]["seed"] = args.seed
        doc["device"], doc["power_limit"] = card(device)
        _maybe_equal_device_time(doc)
        out_path.write_text(json.dumps(doc, indent=2))
        print(json.dumps({"leg": key, "exit": leg["exit"],
                          "steps_completed": leg["steps_completed"]}))
        return 0 if leg["exit"] == 0 and leg["steps_completed"] >= args.steps else 1

    doc = {"config": {
        "batch_curves": args.batch, "batch_step_time": args.step_time_batch,
        "steps": args.steps, "seed": args.seed,
        "data": args.data, "val_data": args.val_data,
        "reference_claim": "Mixer ~25% faster to train than the Transformer "
                           "twin (reference README.md:19); curves: "
                           "tests/clipFigures.py:40-43 stand-in on local "
                           "procedural shards",
    }}
    if args.presets:
        doc["config"]["presets"] = args.presets
    doc["device"], doc["power_limit"] = card(device)
    if not args.skip_curves:
        for p_ in PRESET_TWINS:
            check_fresh_run_dir(p_, args.steps)
    doc["step_time"] = measure_step_times(args.step_time_batch, device, timed)
    if not args.skip_curves:
        doc["curves"] = {p_: train_leg(p_, args) for p_ in PRESET_TWINS}
        _maybe_equal_device_time(doc)
    Path(args.out).write_text(json.dumps(doc, indent=2))
    print(json.dumps({"mixer_speedup": doc["step_time"]["mixer_speedup"]}))
    # The artifact is written above either way (partial evidence is still
    # evidence), but a broken leg must not exit 0 — CI/driver runs would
    # silently record a crashed or truncated comparison as a pass.
    bad = [name for name, leg in doc.get("curves", {}).items()
           if leg["exit"] != 0 or leg["steps_completed"] < args.steps]
    if bad:
        print(f"[compare] FAILED legs: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
