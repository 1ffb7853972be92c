#!/usr/bin/env python3
"""The int8 text noise-floor gate in the JAX package and in the port, on the
same weights, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_int8_text_gate_witness.py \
        --depth 6 --n 1024 --weights jax --texts tokens [--features FILE.npz] [--out FILE.json]

Mixer-B/32 at its full widths (text 512 over 77 tokens, vision 768) with
both towers cut to ``--depth`` blocks. The weights are the JAX package's
``init(key(0))`` carried into the port (``--weights jax``), or the port's
seed-0 init carried into the JAX package through the reference state dict
(``--weights port``). The texts are the JAX bench's gate set (``tokens``:
<sot>, 7 random ids from seed 42, <eot>) or ``chip_smoke.py``'s fixed gate
captions (``captions``); the bank is 512 synthetic images (seed 2) through
the JAX f32 vision tower. Each package calibrates its own scales on the
first 128 texts (as each gate does) and computes its f32, bf16 and int8
text features; the script prints each package's gate verdict on its own
features, the relative difference of the two calibrations, the per-row
cosine of the port's features against JAX's for each path, each path's
mean 1 - cosine to its package's f32, and the f32 top-1 margins.

``--features`` also writes the texts, the bank, both packages' features and
the port's scales to an ``.npz`` that ``scripts/torch_int8_gate_anatomy.py
--witness`` reads on the card (``--weights port`` only: the card rebuilds
the port's seed-0 weights). This is the one script of the port that imports
the JAX package: it holds the port against it, as the tests do, at a width
the tests do not reach.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--depth", type=int, default=6, help="blocks in each tower (the preset has 12)")
    p.add_argument("--n", type=int, default=1024, help="gate texts")
    p.add_argument("--weights", choices=("jax", "port"), default="jax")
    p.add_argument("--texts", choices=("tokens", "captions"), default="tokens")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--features", default=None, help="write the texts, bank and features here (.npz)")
    p.add_argument("--out", default=None, help="also write the JSON object here")
    args = p.parse_args()
    if args.features and args.weights != "port":
        p.error("--features needs --weights port (the card rebuilds the port's seed-0 weights)")

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from chip_smoke import gate_captions
    from clip_mixer_tpu.config import PRESETS as JAX_PRESETS
    from clip_mixer_tpu.evals import quant_gate as jgate
    from clip_mixer_tpu.models import clip as jclip
    from clip_mixer_tpu.models.convert import state_dict_to_params
    from clip_mixer_tpu.ops import quant as jq
    from clip_mixer_tpu.ops.preprocess import normalize_images as jax_normalize
    from clip_mixer_tpu_torch import CLIP, PRESETS, load_jax_params
    from clip_mixer_tpu_torch.evals import quant_gate as tgate
    from clip_mixer_tpu_torch.models.clip import l2_normalize
    from clip_mixer_tpu_torch.ops import quant as tq
    from clip_mixer_tpu_torch.text.tokenize import tokenize
    from torch_int8_gate_anatomy import gate_texts

    t0 = time.perf_counter()
    jc = JAX_PRESETS["mixer-b32"].replace(vision_layers=args.depth, text_layers=args.depth)
    jc32 = jc.replace(compute_dtype="float32")
    pc = dataclasses.replace(PRESETS["mixer-b32"], vision_layers=args.depth, text_layers=args.depth)
    if args.weights == "jax":
        params = jax.tree.map(np.asarray, jclip.init(jax.random.key(0), jc))
        model = load_jax_params(CLIP(pc, device="cpu"), params)
    else:
        model = CLIP(pc, device="cpu", generator=torch.Generator().manual_seed(0))
        params, _ = state_dict_to_params({k: v.float().numpy() for k, v in model.state_dict().items()})
        params = jax.tree.map(np.asarray, params)
    model.eval()
    if args.texts == "tokens":
        texts = gate_texts(args.n, seed=42, context_length=pc.context_length)
    else:
        texts = tokenize(gate_captions()[: args.n], pc.context_length, truncate=True)

    bank_imgs = jgate.synthetic_images(512, pc.image_resolution, seed=2)
    bank_fn = jax.jit(lambda p, x: jclip.l2_normalize(jclip.encode_image(p, jc32, jax_normalize(x, dtype="float32"))))
    bank = jgate._batched_feats(bank_fn, params, bank_imgs, 64).T

    calibrate, quantize, encode_q = jq.text_quant_fns(jc)
    j_scales = jax.jit(lambda p, t: calibrate(p, jc, t))(params, jnp.asarray(texts[:128]))
    j_q = jax.jit(lambda p, s: quantize(p, jc, s))(params, j_scales)
    jax_feats = {
        "f32": jgate._batched_feats(jax.jit(lambda p, t: jclip.l2_normalize(jclip.encode_text(p, jc32, t))),
                                    params, texts, args.batch),
        "bf16": jgate._batched_feats(jax.jit(lambda p, t: jclip.l2_normalize(jclip.encode_text(p, jc, t))),
                                     params, texts, args.batch),
        "int8": jgate._batched_feats(jax.jit(lambda p, t: jclip.l2_normalize(encode_q(p, jc, t))),
                                     j_q, texts, args.batch),
    }
    with torch.inference_mode():
        p_scales = tq.calibrate_text_tower(model, torch.from_numpy(np.ascontiguousarray(texts[:128])))
    enc = lambda m, t: l2_normalize(m.encode_text(t))  # noqa: E731
    port_feats = {
        "f32": tgate._batched_feats(enc, tgate.float32_twin(model), texts, args.batch, "cpu"),
        "bf16": tgate._batched_feats(enc, model, texts, args.batch, "cpu"),
        "int8": tgate._batched_feats(lambda q, t: l2_normalize(tq.encode_text_q(q, t)),
                                     tq.quantize_text_tower(model, p_scales), texts, args.batch, "cpu"),
    }

    def verdict(feats, gate_module):
        top = {k: (100.0 * f @ bank).argmax(-1) for k, f in feats.items()}
        cos = (feats["f32"] * feats["int8"]).sum(-1)
        return gate_module._flip_verdict(top["f32"], top["bf16"], top["int8"], cos, 2.5)

    logits = np.sort(100.0 * jax_feats["f32"] @ bank, -1)
    margin = logits[:, -1] - logits[:, -2]
    result = {
        "depth": args.depth, "n": args.n, "weights": args.weights, "texts": args.texts, "bank": 512,
        "jax_gate": verdict(jax_feats, jgate), "port_gate": verdict(port_feats, tgate),
        "scale_rel_diff_max": {k: float(np.max(np.abs(p_scales[k].double().numpy() / np.asarray(j_scales[k], np.float64)
                                                      - 1.0))) for k in p_scales},
        "cosine_port_vs_jax": {k: {"min": float((port_feats[k] * jax_feats[k]).sum(-1).min()),
                                   "mean": float((port_feats[k] * jax_feats[k]).sum(-1).mean())} for k in jax_feats},
        "one_minus_cosine_to_f32_mean": {
            pkg: {k: float(1.0 - (f[k] * f["f32"]).sum(-1).mean()) for k in ("bf16", "int8")}
            for pkg, f in (("jax", jax_feats), ("port", port_feats))
        },
        "margin_f32_jax": {q: float(np.quantile(margin, v)) for q, v in (("p05", 0.05), ("p50", 0.5), ("p95", 0.95))},
    }
    result["s"] = time.perf_counter() - t0
    if args.features:
        np.savez(args.features, texts=texts, bank=bank, depth=args.depth,
                 **{f"jax_{k}": v for k, v in jax_feats.items()}, **{f"port_cpu_{k}": v for k, v in port_feats.items()},
                 **{f"scale_{k}": v.numpy() for k, v in p_scales.items()})
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
