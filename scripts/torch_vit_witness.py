#!/usr/bin/env python3
"""ViT-B/32's two open findings in the JAX package and in the port, on the same
full-width weights, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_vit_witness.py --part train --batch 64 --steps 8
    JAX_PLATFORMS=cpu python3 scripts/torch_vit_witness.py --part gate --depth 6 --n 4096

The weights are the port's seed-0 init of ``PRESETS["vit-b32"]`` (what
``chip_smoke.py`` phase 7 runs on the card) carried into the JAX package
through the reference state dict; ``--weights jax`` takes the JAX
package's ``init(key(0))`` carried into the port instead.

``--part train``: both packages' train steps at ``TrainConfig``'s defaults
(lr 5e-4, 2 warmup steps, the schedule over ``--steps``) on one fixed batch
(``chip_smoke.py::train_batch``, numpy seed 0), full depth and width, the
batch cut to ``--batch`` for the host; JAX's ``make_train_step`` on a
one-device mesh. Prints each package's losses and gradient norms a step
and ln(batch), the plateau of uniform logits.

``--part gate``: the int8 text noise-floor gate with the text tower cut to
``--depth`` blocks (the vision tower too; it only builds the bank): each
package calibrates on the first 128 of ``chip_smoke.py``'s gate captions
and computes its f32, bf16 and int8 text features; the bank is 512
synthetic images (seed 2) through the JAX f32 vision tower. Prints each
package's verdict on its own features, the per-row cosine of the port's
features against JAX's for each path and the calibrations' relative gap.

Compute is f32 for the train part by default (``--dtype``): the card's f32
run follows the bf16 path (``PERF.md``), and XLA's CPU bf16 is slow. Like
``scripts/torch_int8_text_gate_witness.py``, this script imports the JAX
package: it holds the port against it at a width the tests do not reach.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def weights(jax, jclip, pc, which):
    """(JAX params as numpy, the port CLIP) holding the same weights."""
    import torch

    from clip_mixer_tpu.models.convert import state_dict_to_params
    from clip_mixer_tpu_torch import CLIP, load_jax_params
    from clip_mixer_tpu.config import CLIPConfig as JaxConfig

    jc = JaxConfig(**{f: getattr(pc, f) for f in pc.__dataclass_fields__})
    if which == "jax":
        params = jax.tree.map(np.asarray, jclip.init(jax.random.key(0), jc))
        return params, load_jax_params(CLIP(pc, device="cpu"), params)
    model = CLIP(pc, device="cpu", generator=torch.Generator().manual_seed(0))
    params, _ = state_dict_to_params({k: v.float().numpy() for k, v in model.state_dict().items()})
    return jax.tree.map(np.asarray, params), model


def train_part(args, jax, jclip, pc) -> dict:
    import jax.numpy as jnp

    from chip_smoke import train_batch
    from clip_mixer_tpu.config import CLIPConfig as JaxConfig
    from clip_mixer_tpu.config import TrainConfig as JaxTrain
    from clip_mixer_tpu.parallel import train_step as jstep
    from clip_mixer_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from clip_mixer_tpu.train import optimizer as jopt
    from clip_mixer_tpu_torch.config import TrainConfig
    from clip_mixer_tpu_torch.parallel import train_step as tstep
    from clip_mixer_tpu_torch.train import optimizer as topt

    params, model = weights(jax, jclip, pc, args.weights)
    jc = JaxConfig(**{f: getattr(pc, f) for f in pc.__dataclass_fields__})
    batch = train_batch(pc, args.batch, seed=0)
    out = {"batch": args.batch, "steps": args.steps, "compute_dtype": pc.compute_dtype,
           "ln_batch": float(np.log(args.batch)), "learning_rate": TrainConfig().learning_rate,
           "warmup_steps": TrainConfig().warmup_steps}

    mesh = make_mesh(n_data=1, devices=jax.devices()[:1])
    opt = jopt.make_optimizer(JaxTrain(), total_steps=args.steps)
    state = replicate(mesh, jstep.init_train_state(jax.tree.map(jnp.asarray, params), opt))
    step = jstep.make_train_step(jc, JaxTrain(), mesh, opt)
    jm = []
    for _ in range(args.steps):
        state, m = step(state, shard_batch(mesh, batch))
        jm.append(jax.device_get(m))
    out["jax"] = {"losses": [float(m["loss"]) for m in jm], "grad_norms": [float(m["grad_norm"]) for m in jm]}
    del state, step

    topt_ = topt.make_optimizer(TrainConfig(), total_steps=args.steps)
    tstate, tstep_fn = tstep.init_train_state(model, topt_), tstep.make_train_step(pc, TrainConfig(), topt_)
    pm = []
    for _ in range(args.steps):
        tstate, m = tstep_fn(tstate, batch)
        pm.append({k: float(v) for k, v in m.items()})
    out["port"] = {"losses": [m["loss"] for m in pm], "grad_norms": [m["grad_norm"] for m in pm]}
    out["loss_rel_gap"] = [abs(p - j) / abs(j) for p, j in zip(out["port"]["losses"], out["jax"]["losses"])]
    return out


def gate_part(args, jax, jclip, pc) -> dict:
    import torch

    from chip_smoke import gate_captions
    from clip_mixer_tpu.config import CLIPConfig as JaxConfig
    from clip_mixer_tpu.evals import quant_gate as jgate
    from clip_mixer_tpu.ops import quant as jq
    from clip_mixer_tpu.ops.preprocess import normalize_images as jax_normalize
    from clip_mixer_tpu_torch.evals import quant_gate as tgate
    from clip_mixer_tpu_torch.models.clip import l2_normalize
    from clip_mixer_tpu_torch.ops import quant as tq
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    pc = pc.replace(vision_layers=args.depth, text_layers=args.depth, compute_dtype="bfloat16")
    params, model = weights(jax, jclip, pc, args.weights)
    model.eval()
    jc = JaxConfig(**{f: getattr(pc, f) for f in pc.__dataclass_fields__})
    jc32 = jc.replace(compute_dtype="float32")
    texts = tokenize(gate_captions()[: args.n], pc.context_length, truncate=True)
    bank_imgs = jgate.synthetic_images(512, pc.image_resolution, seed=2)
    bank_fn = jax.jit(lambda p, x: jclip.l2_normalize(jclip.encode_image(p, jc32, jax_normalize(x, dtype="float32"))))
    bank = jgate._batched_feats(bank_fn, params, bank_imgs, 64).T

    calibrate, quantize, encode_q = jq.text_quant_fns(jc)
    j_scales = calibrate(params, jc, jax.numpy.asarray(texts[:128]))
    j_q = quantize(params, jc, j_scales)
    jax_feats = {
        "f32": jgate._batched_feats(jax.jit(lambda p, t: jclip.l2_normalize(jclip.encode_text(p, jc32, t))),
                                    params, texts, args.batch),
        "bf16": jgate._batched_feats(jax.jit(lambda p, t: jclip.l2_normalize(jclip.encode_text(p, jc, t))),
                                     params, texts, args.batch),
        "int8": jgate._batched_feats(jax.jit(lambda p, t: jclip.l2_normalize(encode_q(p, jc, t))),
                                     j_q, texts, args.batch),
    }
    t_calibrate, t_quantize, t_encode = tq.text_quant_fns(pc)
    with torch.inference_mode():
        p_scales = t_calibrate(model, torch.from_numpy(np.ascontiguousarray(texts[:128])))
    enc = lambda m, t: l2_normalize(m.encode_text(t))  # noqa: E731
    port_feats = {
        "f32": tgate._batched_feats(enc, tgate.float32_twin(model), texts, args.batch, "cpu"),
        "bf16": tgate._batched_feats(enc, model, texts, args.batch, "cpu"),
        "int8": tgate._batched_feats(lambda q, t: l2_normalize(t_encode(q, t)), t_quantize(model, p_scales), texts,
                                     args.batch, "cpu"),
    }

    def verdict(feats, gate_module):
        top = {k: (100.0 * f @ bank).argmax(-1) for k, f in feats.items()}
        return gate_module._flip_verdict(top["f32"], top["bf16"], top["int8"], (feats["f32"] * feats["int8"]).sum(-1),
                                         2.5)

    return {
        "depth": args.depth, "n": args.n, "bank": 512,
        "jax_gate": verdict(jax_feats, jgate), "port_gate": verdict(port_feats, tgate),
        "scale_rel_diff_max": {k: float(np.max(np.abs(p_scales[k].double().numpy() / np.asarray(j_scales[k], np.float64)
                                                      - 1.0))) for k in p_scales},
        "cosine_port_vs_jax": {k: {"min": float((port_feats[k] * jax_feats[k]).sum(-1).min()),
                                   "mean": float((port_feats[k] * jax_feats[k]).sum(-1).mean())} for k in jax_feats},
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--part", choices=("train", "gate"), required=True)
    p.add_argument("--weights", choices=("port", "jax"), default="port")
    p.add_argument("--batch", type=int, default=64, help="train: the fixed batch; gate: the feature batch")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32", help="train part's compute dtype")
    p.add_argument("--depth", type=int, default=6, help="gate part: blocks in each tower (the preset has 12)")
    p.add_argument("--n", type=int, default=4096, help="gate part: captions")
    p.add_argument("--out", default=None, help="also write the JSON object here")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from clip_mixer_tpu.models import clip as jclip
    from clip_mixer_tpu_torch import PRESETS

    t0 = time.perf_counter()
    pc = PRESETS["vit-b32"].replace(compute_dtype=args.dtype)
    result = (train_part if args.part == "train" else gate_part)(args, jax, jclip, pc)
    result.update(part=args.part, weights=args.weights, s=time.perf_counter() - t0)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
