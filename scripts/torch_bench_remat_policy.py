#!/usr/bin/env python3
"""Measure the port's train step under each remat policy on the card.

The counterpart of ``scripts/bench_remat_policy.py``.

Usage:
    python scripts/torch_bench_remat_policy.py [--batch 1024] [--accum 1]
                                               [--preset mixer-b32] [--device cuda]

Full remat (``remat_policy="none"``) re-runs each block's forward inside the
backward: ~1/3 of the step's matmul FLOPs are recompute. ``"mlp_hidden"``
keeps the channel-MLP hidden pre-activations ([B, T, 4W] bf16 per block) so
the backward recomputes only LN/elementwise for the channel mix;
``"all_hidden"`` additionally keeps the token-mix hidden, so no product is
recomputed (``models/mixer.py::REMAT_KEEPS``, a selective checkpoint a
block). This script measures what that buys on the card at the benched
batch size.

The step is the JAX script's: seed-0 weights, the 256 -> 224 resize inside
the step, InfoNCE with its default gradient semantics (detached keys, the
reference's), the optimiser update and the clamp, timed by the slope
between two chains of steps (``utils/profiling.chained_train_time``, CUDA
events). With ``--accum > 1`` the gradients are the two-pass GradCache's
(``parallel/train_step.py::flat_chunker``, ``two_pass_accum_grads``) over
``forward_train``, as JAX's.

Prints one JSON line a policy, then the summary line with the JAX script's
keys plus ``power_limit``; ``device`` names the card. An out-of-memory
error is that policy's result (``{"error": ...}``, the card freed before
the next); any other error stops the run. Runs on the card unless
``--device`` names another device; TF32 is off.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clip_mixer_tpu_torch.config import PRESETS, TrainConfig  # noqa: E402
from clip_mixer_tpu_torch.device import card, no_tf32, resolve_device  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_bench_loss import bench_inputs, free_card  # noqa: E402


def make_loss_and_grads(pre, accum: int, b: int):
    """``(model, uint8 images, texts) -> loss``, its gradients in ``.grad``:
    the JAX script's two ``loss_and_grads``, plain InfoNCE at ``accum`` 1,
    the two-pass GradCache over ``accum`` microbatches above it."""
    from clip_mixer_tpu_torch.ops.losses import info_nce
    from clip_mixer_tpu_torch.parallel.train_step import flat_chunker, two_pass_accum_grads

    if accum > 1:
        def loss_and_grads(model, imgs_u8, tk):
            def micro_feats(im_u8, tx):
                img, txt, _s, _bn = model.forward_train(pre(im_u8), tx)
                return img, txt

            def feat_loss(fi, ft, loss_params):
                return info_nce(fi.reshape(b, -1), ft.reshape(b, -1), loss_params["logit_scale"].exp())

            return two_pass_accum_grads(model, accum, flat_chunker(imgs_u8, tk, accum), micro_feats, feat_loss)
    else:
        def loss_and_grads(model, imgs_u8, tk):
            img, txt, scale = model(pre(imgs_u8), tk)
            loss = info_nce(img, txt, scale)
            loss.backward()
            return loss.detach()

    return loss_and_grads


def main(argv=None, cfg=None, chain=(3, 13)) -> dict:
    """Each policy's step time; returns the summary line. ``cfg`` (a
    ``CLIPConfig``) replaces the preset's and ``chain`` (the two chain
    lengths) cuts the timing, so tests and ``chip_smoke.py`` run small."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="mixer-b32")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--policies", nargs="*", default=["none", "mlp_hidden", "all_hidden"])
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    no_tf32()

    from clip_mixer_tpu_torch.models.clip import CLIP
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer
    from clip_mixer_tpu_torch.utils.profiling import chained_train_time, update_step

    cfg = PRESETS[args.preset] if cfg is None else cfg
    tcfg = TrainConfig()
    b = args.batch
    pre = make_batch_preprocess((256, 256), cfg.image_resolution, normalize=True, dtype=torch.bfloat16)
    imgs, toks = bench_inputs(b, cfg.context_length, device)
    loss_and_grads = make_loss_and_grads(pre, args.accum, b)

    results = {}
    for policy in args.policies:
        # the policy is the towers' (a selective checkpoint a block), so each
        # policy gets its own model, drawn from the same seed as JAX's params
        rcfg = cfg.replace(remat=True, remat_policy=policy)
        try:
            model = CLIP(rcfg, device=device, generator=torch.Generator().manual_seed(0))
            opt = make_optimizer(tcfg, total_steps=1000)
            step = update_step(opt, tcfg.logit_scale_max, loss_and_grads)
            dt = chained_train_time(step, init_train_state(model, opt), (imgs, toks), *chain, device=device)
            results[policy] = {"ms_per_step": round(dt * 1e3, 1), "imgs_per_sec": round(b / dt, 1)}
        except torch.OutOfMemoryError as e:  # OOM at this batch/policy is a result, not a crash
            results[policy] = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
        model = step = None
        free_card(device)
        print(json.dumps({"policy": policy, "batch": b, "accum": args.accum, **results[policy]}), flush=True)

    name, power = card(device)
    out = {"preset": args.preset, "batch": b, "accum": args.accum, "device": name, "power_limit": power,
           "results": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
