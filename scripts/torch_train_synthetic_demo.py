"""End-to-end training demo of the PyTorch port: full Mixer-B/32 on synthetic data.

The counterpart of ``scripts/train_synthetic_demo.py``. Trains the flagship
model (111M parameters, remat, the port's train step under its Trainer) on
the SyntheticSource's class-colored images, then zero-shot-classifies
held-out samples of the 16 synthetic classes with their caption prompts. A
converging CLIP drives the InfoNCE loss from ln(B) down and the zero-shot
accuracy from chance (6.25%) toward 100%: evidence that the whole
Trainer / step / metrics stack optimises on the card, beyond the CPU
overfit tests.

Prints one JSON line with the loss trajectory and the held-out accuracy,
under the keys of the JAX script's line; ``device`` is the card's name.
Runs on the CUDA card unless ``--device`` names another device.

Usage: python scripts/torch_train_synthetic_demo.py [--steps 150] [--batch 512]
           [--loss info_nce|siglip] [--device cpu]
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch


def main(argv=None, preset: str = "mixer-b32") -> dict:
    """Train ``preset`` (with remat) as the command line says and print the
    result line; returns it as a dict. ``preset`` lets a test run the same
    code at a small model."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--loss", default="info_nce", choices=["info_nce", "siglip"])
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)

    from clip_mixer_tpu_torch.config import PRESETS, SIGLIP_LOGIT_SCALE_MAX, TrainConfig
    from clip_mixer_tpu_torch.data.pipeline import SyntheticSource
    from clip_mixer_tpu_torch.device import resolve_device
    from clip_mixer_tpu_torch.evals.quant_gate import build_float_classifier
    from clip_mixer_tpu_torch.evals.zeroshot import make_image_classifier
    from clip_mixer_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    cfg = PRESETS[preset].replace(remat=True)
    if args.loss == "siglip":
        cfg = cfg.for_siglip()
    tcfg = TrainConfig(
        global_batch_size=args.batch,
        epochs=1,
        steps_per_epoch=args.steps,
        learning_rate=5e-4,
        warmup_steps=2,
        checkpoint_every_steps=args.steps,  # one final checkpoint
        loss=args.loss,
        logit_scale_max=SIGLIP_LOGIT_SCALE_MAX if args.loss == "siglip" else TrainConfig.logit_scale_max,
    )
    data = SyntheticSource(
        batch_size=args.batch,
        image_size=cfg.image_resolution,
        n_batches=args.steps,
        context_length=cfg.context_length,
    )
    run_dir = tempfile.mkdtemp(prefix="train_demo_")
    tr = Trainer(cfg, tcfg, data, run_dir, device=device, resume=False)
    tr.train()

    losses = [v for _, v in tr.writer.history["Loss"]]

    # Zero-shot eval on HELD-OUT synthetic samples (epoch 999: unseen noise
    # draws of the same classes) with the training captions as prompts.
    model = tr.state.model.eval()
    w = build_float_classifier(model, data.captions, ["{}"], batch_size=32)
    classify = make_image_classifier(model, w)
    eval_data = SyntheticSource(
        batch_size=256, image_size=cfg.image_resolution, n_batches=2,
        context_length=cfg.context_length,
    )
    correct = total = 0
    for batch in eval_data.iter_batches(epoch=999):
        # ground truth from PUBLIC data: each sample's caption tokens match
        # exactly one class caption (re-deriving the source's private draws
        # would silently break if its protocol ever changed)
        labels = (batch["texts"][:, None] == eval_data.tokens[None]).all(-1).argmax(-1)
        logits = classify(batch["images"])
        correct += int((logits.argmax(-1) == labels).sum())
        total += labels.shape[0]
    acc = correct / total

    n_params = sum(t.numel() for t in model.parameters())
    result = {
        "model": f"{preset} ({n_params / 1e6:.0f}M, remat)",
        "loss_kind": args.loss,
        "steps": len(losses),  # actual (a preemption may stop early)
        "global_batch": args.batch,
        "loss_first": round(losses[0], 4),
        "loss_min": round(min(losses), 4),
        "loss_last": round(losses[-1], 4),
        "loss_curve_every10": [round(v, 3) for v in losses[::10]],
        "zero_shot_acc_16class_heldout": round(acc, 4),
        "chance": round(1 / eval_data.n_classes, 4),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
