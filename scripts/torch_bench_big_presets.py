#!/usr/bin/env python3
"""Run the two largest presets of the port on the card: ``vit-l14-336`` and ``rn50x64``.

The counterpart of ``scripts/bench_big_presets.py``. For each preset, from
its seed-0 draw:

* bf16 inference and calibrated-int8 inference at ``--infer-batch``, each
  a loop-carried chain on the card (each iteration's input the uint8 batch
  plus the previous result's carry) timed by ``utils/profiling.py::slope_time``
  over chains of 2 and 8; the calibration on the first 128 images;
* the noise-floor gate (``evals/quant_gate.py::noise_floor_gate``, Wilson
  intervals included) on ``synthetic_images(--gate-n, res, seed=1)`` over
  64 ImageNet classes x 4 templates;
* one real train step (``parallel/train_step.py::make_train_step``, BN's
  train path included for the ResNet) at the batch the memory planner
  picks (``utils/memory.py::plan``: the largest power of two whose planned
  total fits 90% of ``--hbm-gib``, with accumulation where needed; remat
  on; no accumulation for the ResNet), then 3 timed steps;
* the planner's total beside the allocator's peak (``hbm``).

Only an out-of-memory error is caught in the train leg: it is recorded as
``oom`` beside the plan, the card is freed and the run goes on. Any other
error propagates.

One preset a process: ``--preset all`` (the default) runs the script again
in a child for each, so each allocator peak is the preset's own. Runs on
the card unless ``--device`` names another device; TF32 is off. Writes or
merges ``BIG_PRESETS_TORCH.json`` (never the JAX package's
``BIG_PRESETS.json``) with the card's name and power limit. ``--hbm-gib``
defaults to 80, an H100's memory.

Usage: python scripts/torch_bench_big_presets.py [--preset vit-l14-336]
"""

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from clip_mixer_tpu_torch.config import PRESETS, TrainConfig  # noqa: E402
from clip_mixer_tpu_torch.device import card, compute_dtype, no_tf32, resolve_device  # noqa: E402

PRESET_LIST = ("vit-l14-336", "rn50x64")
GIB = 1 << 30
TRAIN_NOTE = ("host clock around each step with the card synchronized before and after it: the step's time on a "
              "local card; the first step also builds the card's kernels and grows the allocator")


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def params_m(shapes) -> float:
    """Millions of values in the model state (the parameters and the float
    buffers: JAX's tree), from ``utils/memory.py::param_shapes``."""
    return round(sum(int(np.prod(shape)) for shape, _ in shapes.values()) / 1e6, 1)


def infer_legs(model, imgs, device) -> dict:
    """bf16 and calibrated-int8 inference of uint8 ``imgs`` [B, R, R, 3] on
    the card, chained and timed by slope; the int8 tower is calibrated on
    the first 128 images."""
    from clip_mixer_tpu_torch.ops.preprocess import normalize_images
    from clip_mixer_tpu_torch.ops.quant import image_quant_fns
    from clip_mixer_tpu_torch.utils.profiling import slope_time

    cfg = model.cfg
    dt = compute_dtype(cfg.compute_dtype)
    B = imgs.shape[0]

    def chained(encode, module):
        def run(n):
            carry = torch.zeros((), device=device)
            with torch.inference_mode():
                for _ in range(n):
                    x = normalize_images(imgs + carry.to(torch.uint8), dtype=dt)
                    carry = encode(module, x).float().mean() * 1e-9
            return carry
        return slope_time(run, 2, 8, device=device)

    out = {}
    t_bf16 = chained(lambda m, x: m.encode_image(x), model)
    out["bf16_infer"] = {"batch": B, "ms": round(t_bf16 * 1e3, 1), "imgs_per_sec": round(B / t_bf16, 1)}

    calibrate, quantize, encode_q = image_quant_fns(cfg)
    with torch.inference_mode():
        scales = calibrate(model, normalize_images(imgs[:min(B, 128)], dtype=dt))
    qvis = quantize(model, scales)
    t_int8 = chained(encode_q, qvis)
    out["int8_infer"] = {"batch": B, "ms": round(t_int8 * 1e3, 1), "imgs_per_sec": round(B / t_int8, 1),
                         "speedup_vs_bf16": round(t_bf16 / t_int8, 2)}
    return out


def int8_gate(model, gate_n: int, infer_batch: int) -> dict:
    """The noise-floor gate at n = ``gate_n``: the JAX script's protocol."""
    from clip_mixer_tpu_torch.evals.prompts import IMAGENET_CLASSNAMES, PROMPT_TEMPLATES
    from clip_mixer_tpu_torch.evals.quant_gate import build_float_classifier, noise_floor_gate, synthetic_images

    gate_imgs = synthetic_images(gate_n, model.cfg.image_resolution, seed=1)
    w = build_float_classifier(model, IMAGENET_CLASSNAMES[:64], PROMPT_TEMPLATES[:4], batch_size=64)
    b = min(infer_batch, 128)
    return noise_floor_gate(model, gate_imgs, w, calibrate_n=b, batch_size=b)


def train_plan(cfg, hbm_gib: float):
    """The planner's pick for ``cfg`` (remat on): (batch, accum, the plan,
    the record's ``train_plan``, the verdict when no plan fits or None)."""
    from clip_mixer_tpu_torch.utils.memory import jax_leaves, param_shapes, plan

    cfg = cfg.replace(remat=True)
    leaves = jax_leaves(param_shapes(cfg))
    budget = int(hbm_gib * GIB * 0.9)
    chosen = None
    for batch in (512, 256, 128, 64, 32, 16):
        for accum in (1, 2, 4, 8):
            if batch % accum:
                continue
            if cfg.is_resnet and accum > 1:
                continue  # BN batch stats forbid accumulation (parallel/train_step.py)
            pl = plan(cfg, "dp", 1, batch, accum_steps=accum, leaves=leaves)
            if pl.total_bytes <= budget:
                chosen = (batch, accum, pl)
                break
        if chosen:
            break
    verdict = None
    if chosen is None:
        # no single-card plan fits: probe the boundary at the smallest batch
        batch, accum = 8, 1
        pl = plan(cfg, "dp", 1, batch, accum_steps=accum, leaves=leaves)
        verdict = (f"no single-chip plan fits (B=8 planned {pl.total_bytes / GIB:.1f} GiB vs "
                   f"{budget / GIB:.1f} budget); attempting B=8 to test the boundary")
    else:
        batch, accum, pl = chosen
    record = {
        "batch": batch, "accum_steps": accum,
        "predicted_total_gib": round(pl.total_bytes / GIB, 2),
        "predicted_breakdown_gib": {
            "params": round(pl.params_bytes / GIB, 2),
            "opt": round(pl.opt_bytes / GIB, 2),
            "grads": round(pl.grad_bytes / GIB, 2),
            "activations": round(pl.act_bytes / GIB, 2),
        },
    }
    return batch, accum, pl, record, verdict


def train_leg(model, batch: int, accum: int, rng, device) -> dict:
    """One first step and 3 timed steps of ``make_train_step`` on ``model``
    (its config's remat) at ``batch`` x ``accum``; an out-of-memory error is
    recorded as ``oom`` and the card freed."""
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    cfg = model.cfg
    res = cfg.image_resolution
    tcfg = TrainConfig(global_batch_size=batch, accum_steps=accum)
    opt = make_optimizer(tcfg, total_steps=1000)
    step = make_train_step(cfg, tcfg, opt, accum_steps=accum)
    batch_data = {
        "images": torch.from_numpy(rng.integers(0, 256, (batch, res, res, 3), dtype=np.uint8)).to(device),
        "texts": torch.from_numpy(rng.integers(1, cfg.vocab_size - 2, (batch, cfg.context_length),
                                               dtype=np.int32)).to(device),
    }
    state = None
    try:
        state = init_train_state(model, opt)
        sync(device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch_data)
        loss0 = float(metrics["loss"])
        first = time.perf_counter() - t0
        times = []
        for _ in range(3):
            sync(device)
            t0 = time.perf_counter()
            state, metrics = step(state, batch_data)
            sync(device)
            times.append(time.perf_counter() - t0)
        return {
            "compile_plus_first_s": round(first, 1),
            "ms_per_step_dispatch_timed": round(min(times) * 1e3, 1),
            "imgs_per_sec_dispatch_timed": round(batch / min(times), 1),
            "loss_first": round(loss0, 3),
            "loss_finite": bool(np.isfinite(loss0)),
            "note": TRAIN_NOTE,
        }
    except torch.OutOfMemoryError as e:  # the planner's boundary on the card: a finding, recorded
        return {"error": f"{type(e).__name__}: {str(e)[:300]}", "oom": True}
    finally:
        del state, batch_data
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def run_one(preset: str, args, device, cfg=None) -> dict:
    """Every leg of one preset (``cfg``: a test's small config under that
    name)."""
    from clip_mixer_tpu_torch.models.clip import CLIP

    cfg = cfg or PRESETS[preset]
    out = {"preset": preset}
    t_start = time.time()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # one draw for every leg: the train leg's config (remat on), which the
    # inference and gate legs do not see (remat only acts while autograd records)
    model = CLIP(cfg.replace(remat=True), device=device, generator=torch.Generator().manual_seed(0)).eval()
    out["params_m"] = params_m({k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()
                                if v.is_floating_point()})

    res = cfg.image_resolution
    rng = np.random.default_rng(0)
    B = args.infer_batch
    imgs = torch.from_numpy(rng.integers(0, 256, (B, res, res, 3), dtype=np.uint8)).to(device)
    out.update(infer_legs(model, imgs, device))
    del imgs
    gc.collect()
    out["int8_gate"] = int8_gate(model, args.gate_n, B)

    batch, accum, pl, plan_record, verdict = train_plan(cfg, args.hbm_gib)
    if verdict:
        out["planner_verdict"] = verdict
    out["train_plan"] = plan_record
    gc.collect()
    peak_before = 0
    if cuda:
        torch.cuda.empty_cache()
        peak_before = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    out["train_step"] = train_leg(model.train(), batch, accum, rng, device)
    del model
    gc.collect()

    if cuda:
        train_peak = torch.cuda.max_memory_allocated(device)
        peak = max(peak_before, train_peak)
        out["hbm"] = {
            "predicted_gib": round(pl.total_bytes / GIB, 2),
            "actual_peak_gib": round(peak / GIB, 2),
            "planner_error_pct": round(100 * (pl.total_bytes - peak) / peak, 1),
            "train_peak_gib": round(train_peak / GIB, 2),
            "note": ("the allocator's peak (torch.cuda.max_memory_allocated) over the whole preset, the "
                     "inference and gate legs included; train_peak_gib over the train leg alone"),
        }
    else:
        out["hbm"] = {"actual": f"no allocator peak on {device.type}"}
    out["wall_seconds"] = round(time.time() - t_start, 1)
    return out


def write_record(path: Path, preset: str, result: dict) -> None:
    doc = {}
    if path.exists():
        try:
            doc = json.loads(path.read_text())
        except json.JSONDecodeError:
            doc = {}
    doc[preset] = result
    path.write_text(json.dumps(doc, indent=2))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="all", choices=("all",) + PRESET_LIST)
    p.add_argument("--infer-batch", type=int, default=64)
    p.add_argument("--gate-n", type=int, default=1024)
    p.add_argument("--hbm-gib", type=float, default=80.0, help="the card's memory (default: an H100's 80)")
    p.add_argument("--out", default="BIG_PRESETS_TORCH.json")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    return p.parse_args(argv)


def main(argv=None, cfg=None) -> int:
    """Run as the command line says. ``cfg``: a test's small config, run
    under ``--preset``'s name."""
    args = parse_args(argv)
    device = resolve_device(args.device)  # no card and no --device: raise before anything runs
    if args.preset == "all":
        rc = 0
        for preset in PRESET_LIST:
            cmd = [sys.executable, __file__, "--preset", preset, "--infer-batch", str(args.infer_batch),
                   "--gate-n", str(args.gate_n), "--hbm-gib", str(args.hbm_gib), "--out", args.out]
            r = subprocess.run(cmd + (["--device", args.device] if args.device else []))
            rc |= r.returncode
        return rc

    no_tf32()
    result = run_one(args.preset, args, device, cfg)
    result["device"], result["power_limit"] = card(device)
    write_record(Path(args.out), args.preset, result)
    print(json.dumps({args.preset: {
        "bf16_ips": result.get("bf16_infer", {}).get("imgs_per_sec"),
        "int8_ips": result.get("int8_infer", {}).get("imgs_per_sec"),
        "gate_passed": result.get("int8_gate", {}).get("passed"),
        "train_batch": result.get("train_plan", {}).get("batch"),
        "train_ok": result.get("train_step", {}).get("loss_finite"),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    import signal

    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))  # a preset's child killed too
    sys.exit(main())
