#!/usr/bin/env python3
"""Where the int8 noise-floor gates' flips come from, on one CUDA card.

    python3 scripts/torch_int8_gate_anatomy.py [--n 4096] [--out FILE.json]

Full-width Mixer-B/32 (bf16, random weights from seed 0), the gates'
protocols of ``chip_smoke.py`` phase 6: the text gate (``--n`` of its fixed
captions, and as many of the JAX bench's random-token texts, retrieving
their top-1 from a 512-image f32 bank) and the image gate
(``--n`` model-sized synthetic images against a 64-class prompt
classifier). For each numeric variant, its top-1 flips against f32, its
agreement with bf16 and its per-row cosine with f32:

* ``bf16``: the model's own bf16 path;
* ``int8``: ``ops/quant.py`` as served (static scales, calibrated on the
  first 128 inputs);
* ``int8_dynamic``: per-row activation scales;
* ``int8_f32``: the int8 towers on an f32-compute copy of the model (the
  quantisation error alone);
* ``int8_f32_chain``: bf16, but each block's dequantise -> bias ->
  QuickGELU -> requantise -> dequantise -> bias -> residual in f32, rounded
  to bf16 once (what a fused epilogue would compute);

and the f32 top-1 margins (the top-1 minus the top-2 logit), with the
text gate's verdict on each set. Then the int8 vision tower at bucket 128
under ``torch.profiler``: device time by kernel, against the bf16 plain
tower; ``torch._int_mm`` at the channel-mix shapes with the weight stored
[in, out] and as the transposed view of [out, in] (the quant modules'
layout), beside a bf16 ``torch.matmul``.

``--depths 2,4,6,8,12`` adds the text gate (both sets) at each depth, the
towers cut to that many blocks of the seed-0 init. ``--witness FILE.npz``
(written on the CPU by ``scripts/torch_int8_text_gate_witness.py
--weights port --features``) rebuilds that depth's seed-0 model on the
card and holds the card's f32, bf16 and int8 text features per row against
the JAX package's and the port's CPU features on the same texts, with the
gate's verdict against the file's bank. ``--parts`` picks the sections
(default all but ``depths`` and ``witness``). Prints one JSON object (and
writes it to ``--out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import GATE_CLASSES, GATE_TEMPLATES, gate_captions  # noqa: E402
from clip_mixer_tpu_torch import CLIP, PRESETS  # noqa: E402
from clip_mixer_tpu_torch.evals import quant_gate as gates  # noqa: E402
from clip_mixer_tpu_torch.models.clip import l2_normalize  # noqa: E402
from clip_mixer_tpu_torch.models.layers import layer_norm, quick_gelu, token_mix_branch  # noqa: E402
from clip_mixer_tpu_torch.ops import quant as tq  # noqa: E402
from clip_mixer_tpu_torch.ops.preprocess import normalize_images  # noqa: E402
from clip_mixer_tpu_torch.text.tokenize import tokenize  # noqa: E402


def gate_texts(n, seed, context_length=77):
    """The JAX bench's text-gate set: <sot>, 7 random token ids, <eot>."""
    rng = np.random.default_rng(seed)
    texts = np.zeros((n, context_length), np.int32)
    texts[:, 0] = 49406
    texts[:, 1:8] = rng.integers(1, 49000, (n, 7))
    texts[:, 8] = 49407
    return texts


def f32_chain_forward(self, x, s_in=None, s_hidden=None):
    """QuantMixerBlock.forward with the channel mix's elementwise chain in f32."""
    dt = x.dtype
    ln1, tm, ln2 = self.layerNorm1, self.token_mix_seq, self.layerNorm2
    x = x + token_mix_branch(x, ln1.weight, ln1.bias, tm.lin1.weight, tm.lin1.bias, tm.lin2.weight, tm.lin2.bias)
    y = layer_norm(x, ln2.weight, ln2.bias)
    lead, k = y.shape[:-1], y.shape[-1]
    acc = torch._int_mm(tq.quantize_activation(y.reshape(-1, k).float(), s_in), self.w_in_q.t())
    h = quick_gelu(acc.float() * s_in * self.w_in_scale + self.b_in.float())
    acc = torch._int_mm(tq.quantize_activation(h, s_hidden), self.w_out_q.t())
    out = acc.float() * s_hidden * self.w_out_scale + self.b_out.float()
    return (x.float() + out.reshape(*lead, -1)).to(dt)


def feats(fn, module, inputs, batch, dev):
    out = []
    with torch.inference_mode():
        for i in range(0, inputs.shape[0], batch):
            x = torch.from_numpy(np.ascontiguousarray(inputs[i : i + batch])).to(dev)
            out.append(fn(module, x).float().cpu().numpy())
    return np.concatenate(out)


def summary(f32, variants, head):
    """head: the [D, M] matrix the top-1 is taken against."""
    logits = 100.0 * f32 @ head
    top = np.sort(logits, -1)
    t32 = logits.argmax(-1)
    t16 = (100.0 * variants["bf16"] @ head).argmax(-1)
    margin = top[:, -1] - top[:, -2]
    out = {"margin_f32": {q: float(np.quantile(margin, p)) for q, p in (("p05", 0.05), ("p50", 0.5), ("p95", 0.95))}}
    for name, f in variants.items():
        t = (100.0 * f @ head).argmax(-1)
        cos = (f * f32).sum(-1)
        out[name] = {
            "flips_vs_f32": int((t != t32).sum()),
            "agreement_with_bf16": float((t == t16).mean()),
            "cosine_vs_f32": {"min": float(cos.min()), "p01": float(np.quantile(cos, 0.01)),
                              "mean": float(cos.mean())},
            "one_minus_cosine_mean": float(1.0 - cos.mean()),
        }
    return out


def text_variants(model, f32, texts, bank, dev):
    """The text gate's numeric variants on ``texts`` against ``bank``."""
    enc_t = lambda m, t: l2_normalize(m.encode_text(t))  # noqa: E731
    enc_tq = lambda q, t: l2_normalize(tq.encode_text_q(q, t))  # noqa: E731
    calib_t = torch.from_numpy(texts[:128]).to(dev)
    t_scales = tq.calibrate_text_tower(model, calib_t)
    t_scales32 = tq.calibrate_text_tower(f32, calib_t)
    base = feats(enc_t, f32, texts, 512, dev)
    variants = {
        "bf16": feats(enc_t, model, texts, 512, dev),
        "int8": feats(enc_tq, tq.quantize_text_tower(model, t_scales), texts, 512, dev),
        "int8_dynamic": feats(enc_tq, tq.quantize_text_tower(model), texts, 512, dev),
        "int8_f32": feats(enc_tq, tq.quantize_text_tower(f32, t_scales32), texts, 512, dev),
    }
    plain_forward = tq.QuantMixerBlock.forward
    tq.QuantMixerBlock.forward = f32_chain_forward
    try:
        variants["int8_f32_chain"] = feats(enc_tq, tq.quantize_text_tower(model, t_scales), texts, 512, dev)
    finally:
        tq.QuantMixerBlock.forward = plain_forward
    out = summary(base, variants, bank)
    out["gate"] = verdict(base, variants["bf16"], variants["int8"], bank)
    out["a_scales"] = {k: v.cpu().numpy().tolist() for k, v in t_scales.items()}
    return out


def verdict(f32, bf16, int8, head):
    """The noise-floor gate's verdict on these features (``_flip_verdict``)."""
    top = [(100.0 * f @ head).argmax(-1) for f in (f32, bf16, int8)]
    return gates._flip_verdict(*top, (f32 * int8).sum(-1), 2.5)


def f32_bank(f32, cfg, dev):
    """The text gate's bank: 512 synthetic images (seed 2) through the f32 twin."""
    imgs = gates.synthetic_images(512, cfg.image_resolution, seed=2)
    return feats(lambda m, x: l2_normalize(m.encode_image(normalize_images(x, dtype=torch.float32))), f32,
                 imgs, 256, dev).T


def gate_sets(cfg, n):
    return {"text_captions": tokenize(gate_captions()[:n], cfg.context_length, truncate=True),
            "text_random_tokens": gate_texts(n, seed=42, context_length=cfg.context_length)}


def depth_sweep(cfg, depths, n, dev):
    """The text gate (both sets) with the towers cut to each depth."""
    rows = {}
    for depth in depths:
        c = dataclasses.replace(cfg, vision_layers=depth, text_layers=depth)
        model = CLIP(c, device=dev, generator=torch.Generator().manual_seed(0)).eval()
        bank = f32_bank(gates.float32_twin(model), c, dev)
        for label, texts in gate_sets(c, n).items():
            g = gates.text_noise_floor_gate(model, texts, bank, calibrate_n=128, batch_size=512)
            rows[f"{label}_depth{depth}"] = {k: g[k] for k in ("n", "flips_bf16", "flips_int8", "flip_ratio",
                                                               "flip_ratio_ci_low", "flip_ratio_ci_high",
                                                               "min_cosine_int8_vs_f32", "passed")}
        del model
    return rows


def witness(cfg, path, dev):
    """The card's text features against the CPU's (both packages) on the
    texts, bank and depth of ``scripts/torch_int8_text_gate_witness.py``'s
    file."""
    w = np.load(path)
    depth = int(w["depth"])
    c = dataclasses.replace(cfg, vision_layers=depth, text_layers=depth)
    model = CLIP(c, device=dev, generator=torch.Generator().manual_seed(0)).eval()
    texts, bank = w["texts"], w["bank"]
    scales = tq.calibrate_text_tower(model, torch.from_numpy(texts[:128]).to(dev))
    enc_t = lambda m, t: l2_normalize(m.encode_text(t))  # noqa: E731
    card = {"f32": feats(enc_t, gates.float32_twin(model), texts, 512, dev),
            "bf16": feats(enc_t, model, texts, 512, dev),
            "int8": feats(lambda q, t: l2_normalize(tq.encode_text_q(q, t)), tq.quantize_text_tower(model, scales),
                          texts, 512, dev)}
    out = {"depth": depth, "n": int(texts.shape[0]),
           "scale_rel_diff_max_vs_cpu": {k: float(np.max(np.abs(v.double().cpu().numpy() / w[f"scale_{k}"] - 1.0)))
                                         for k, v in scales.items()},
           "gate_card": verdict(card["f32"], card["bf16"], card["int8"], bank),
           "gate_jax_cpu": verdict(w["jax_f32"], w["jax_bf16"], w["jax_int8"], bank),
           "gate_port_cpu": verdict(w["port_cpu_f32"], w["port_cpu_bf16"], w["port_cpu_int8"], bank)}
    for k, f in card.items():
        for other in ("jax", "port_cpu"):
            cos = (f * w[f"{other}_{k}"]).sum(-1)
            out[f"cosine_card_vs_{other}_{k}"] = {"min": float(cos.min()), "mean": float(cos.mean())}
    return out


def int_mm_layouts(dev):
    """``torch._int_mm`` at the channel-mix shapes with the weight as the
    transposed view of [out, in] and as an [in, out] buffer, beside a bf16
    ``torch.matmul`` of the same shape, in turns."""
    from chip_smoke import INT8_INT_MM_SHAPES, INT8_PEAK_OPS_PER_S, cuda_ms

    g = torch.Generator().manual_seed(10)
    rows = {}
    for label, (M, K, N) in INT8_INT_MM_SHAPES.items():
        a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8).to(dev)
        w_in_out = w.t().contiguous()
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        ways = {
            "out_in_view_ms": lambda: torch._int_mm(a, w.t()),
            "in_out_ms": lambda: torch._int_mm(a, w_in_out),
            "bf16_matmul_ms": lambda: torch.matmul(ab, wb.t()),
        }
        times = {k: [] for k in ways}
        for k in [*ways, *reversed(ways)]:
            times[k].append(cuda_ms(ways[k], iters=20))
        row = {k: sum(v) / len(v) for k, v in times.items()}
        for k in ways:
            row[k.replace("_ms", "_tops")] = 2.0 * M * K * N / (row[k] * 1e-3) / 1e12
        row["int8_bound_ms"] = 2.0 * M * K * N / INT8_PEAK_OPS_PER_S * 1e3
        row["shape"] = [M, K, N]
        rows[label] = row
    return rows


PARTS = ("text", "image", "profile", "int_mm", "depths", "witness")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--out", default=None, help="also write the JSON object here")
    p.add_argument("--preset", default="mixer-b32")
    p.add_argument("--device", default="cuda", help="cpu only to rehearse the script at a small preset")
    p.add_argument("--parts", default="text,image,profile,int_mm", help=f"comma-separated, of {','.join(PARTS)}")
    p.add_argument("--depths", default="2,4,6,8,12", help="the depth sweep's depths")
    p.add_argument("--witness", default=None, help="the .npz of scripts/torch_int8_text_gate_witness.py")
    args = p.parse_args()
    parts = set(args.parts.split(","))
    if not parts <= set(PARTS) or ("witness" in parts) != bool(args.witness):
        p.error(f"--parts takes {PARTS}; 'witness' goes with --witness FILE")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    cfg = PRESETS[args.preset]
    result = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu", "preset": args.preset,
              "n": args.n}
    with torch.inference_mode():
        if "witness" in parts:
            result["witness"] = witness(cfg, args.witness, dev)
        if "depths" in parts:
            result["depths"] = depth_sweep(cfg, [int(d) for d in args.depths.split(",")], args.n, dev)
    if parts & {"text", "image", "profile"}:
        model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0)).eval()
        f32 = gates.float32_twin(model)
    if "text" in parts:
        bank = f32_bank(f32, cfg, dev)
        for label, texts in gate_sets(cfg, args.n).items():
            result[label] = text_variants(model, f32, texts, bank, dev)

    if parts & {"image", "profile"}:
        # the image gate's protocol
        imgs = gates.synthetic_images(args.n, cfg.image_resolution, seed=3)
        calib_i = normalize_images(torch.from_numpy(imgs[:128]).to(dev), dtype=torch.bfloat16)
        scales = tq.calibrate_vision_tower(model, calib_i)
    if "image" in parts:
        classifier = gates.build_float_classifier(model, GATE_CLASSES, GATE_TEMPLATES)
        scales32 = tq.calibrate_vision_tower(f32, calib_i.float())
        enc_i = lambda m, x: l2_normalize(m.encode_image(normalize_images(x, dtype=compute_dt(m))))  # noqa: E731
        enc_iq = lambda q, x: l2_normalize(tq.encode_image_q(q, normalize_images(x, dtype=compute_dt(q))))  # noqa: E731
        base = feats(enc_i, f32, imgs, 256, dev)
        variants = {
            "bf16": feats(enc_i, model, imgs, 256, dev),
            "int8": feats(enc_iq, tq.quantize_vision_tower(model, scales), imgs, 256, dev),
            "int8_dynamic": feats(enc_iq, tq.quantize_vision_tower(model), imgs, 256, dev),
            "int8_f32": feats(enc_iq, tq.quantize_vision_tower(f32, scales32), imgs, 256, dev),
        }
        plain_forward = tq.QuantMixerBlock.forward
        tq.QuantMixerBlock.forward = f32_chain_forward
        try:
            variants["int8_f32_chain"] = feats(enc_iq, tq.quantize_vision_tower(model, scales), imgs, 256, dev)
        finally:
            tq.QuantMixerBlock.forward = plain_forward
        result["image"] = summary(base, variants, classifier)
    if "profile" in parts and dev.type == "cuda":
        qvis = tq.quantize_vision_tower(model, scales)
        x = torch.randn(128, cfg.vision_tokens, cfg.vision_width, generator=torch.Generator().manual_seed(1))
        x = x.to(dev, torch.bfloat16)
        result["profile_vision_b128"] = {"int8": profile(lambda: qvis.run_blocks(x)),
                                         "bf16_plain": profile(lambda: model.visual.transformer(x))}
    if "int_mm" in parts and dev.type == "cuda":
        result["int_mm"] = int_mm_layouts(dev)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


def profile(fn, calls=5, top=14):
    """Device time by kernel over ``calls`` calls of ``fn`` (after two warm
    ones): the total, the share of the wall time, the top kernels."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch.inference_mode():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
    wall_ms = start.elapsed_time(end) / calls
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / calls
    return {
        "wall_ms_per_call": wall_ms,
        "device_busy_ms_per_call": busy_ms,
        "kernels": [{"name": e.key[:90], "ms_per_call": e.self_device_time_total / 1e3 / calls,
                     "launches_per_call": e.count / calls} for e in rows[:top]],
        "launches_per_call": sum(e.count for e in rows) / calls,
    }


def compute_dt(module):
    from clip_mixer_tpu_torch.device import compute_dtype

    return compute_dtype(module.cfg.compute_dtype)


if __name__ == "__main__":
    sys.exit(main())
