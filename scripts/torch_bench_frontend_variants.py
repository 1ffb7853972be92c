#!/usr/bin/env python3
"""Measure the port's int8-serving front-end variants on the card.

The counterpart of ``scripts/bench_frontend_variants.py``. Two structural
costs of the plain front end (``ops/preprocess.make_batch_preprocess``):

1. the resize einsums compute in f32 (uint8 -> f32 cast);
2. the second einsum ``pw,bowc->bopc`` contracts w with the output
   channel axis c = 3 last, a product whose N = 3 fills few lanes.

Variants measured here (all end to end: uint8 [B, 256, 256, 3] -> int8
Mixer-B/32 vision features, ``ops/quant.py``'s tower, seed-0 weights,
static scales calibrated on 128 images), each a module-level function:

  v0  shipped: f32 einsum resize -> bf16 -> patchify -> static-quant int8
  v1  same graph, resize products on bf16 values (uint8 -> bf16 is exact
      for 0..255), summed in f32, the first rounded to bf16 between them
  v2  channel-planar front end (``ops/quant.make_planar_front_end``, what
      the port ships): uint8 channel planes [B, 3, H, W], both resizes
      clean [*, 256] @ [256, 224] products, normalise + static patch-scale
      quantise at the output, patchify as an int8 relayout; the tower
      takes the c-major patches (``encode_image_q_patches``, the
      ``patch_q_planar`` rows)
  v3  v2 with the resize products in int8 (``ops/quant.int_mm``): the
      input shifted by -128 (exact), weights quantised a row, the
      intermediate requantised once (PIL's inter-pass uint8 rounding's
      analogue, reference clip.py:76-87)
  v4  v2 with the NHWC -> planar transpose folded into the first
      product's output layout (``oh,bhwc->bcow``)

Each variant's ``cos_vs_f32`` is the mean per-row cosine of its features
against the f32 front end and the f32 tower (``float32_twin``). Its time is
the median of 3 slopes between chains of 5 and 45 calls, each call's input
carrying the one before's result (``utils/profiling.chained``, CUDA
events). Accuracy is not decided here: a winner goes through the
noise-floor gate (``evals/quant_gate.py``) before shipping.

Prints one JSON line a variant, then the JAX script's summary line with
``device`` (the card) and ``power_limit``. Runs on the card unless
``--device`` names another device; TF32 is off.

Usage: python scripts/torch_bench_frontend_variants.py [--device cuda]
"""

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clip_mixer_tpu_torch.config import PRESETS  # noqa: E402
from clip_mixer_tpu_torch.device import card, no_tf32, resolve_device  # noqa: E402
from clip_mixer_tpu_torch.ops import quant  # noqa: E402
from clip_mixer_tpu_torch.ops.preprocess import _cached_matrices, norm_constants  # noqa: E402

S1 = np.float32(160.0 / 127.0)  # v3: |y1 - 128| bound, the bicubic overshoot included


def qrows(w: np.ndarray):
    """v3's resize weights: int8 a row, the row scales, and the per-row
    correction 128 * s * sum(q) for the -128 shift of the input."""
    s = np.maximum(np.abs(w).max(axis=1) / 127.0, 1e-8)
    q = np.clip(np.round(w / s[:, None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32), (128.0 * s * q.sum(axis=1)).astype(np.float32)


def front_end_constants(cfg, input_hw, s_patch, device) -> SimpleNamespace:
    """Every variant's constants on ``device``: the resize matrices as bf16
    values in f32, v3's int8 rows, the normalisation, the patch scale."""
    h, w = input_hw
    rh_np, rw_np = _cached_matrices(h, w, cfg.image_resolution)
    mean, std_inv = norm_constants(device)
    rhq, sh, corr_h = qrows(rh_np)
    rwq, sw, corr_w = qrows(rw_np)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    return SimpleNamespace(
        rh32=t(rh_np, torch.bfloat16).float(), rw32=t(rw_np, torch.bfloat16).float(),
        mean=mean, std_inv=std_inv, mean4=mean.reshape(1, 3, 1, 1), std_inv4=std_inv.reshape(1, 3, 1, 1),
        rhq_t=t(rhq).t(), sh=t(sh), corr_h=t(corr_h), rwq_t=t(rwq).t(), sw=t(sw), corr_w=t(corr_w),
        s1=torch.tensor(S1, device=device), s_patch=s_patch, p=cfg.vision_patch_size,
        planar=quant.make_planar_front_end(cfg, input_hw, s_patch),
    )


def pre_bf16(u8: torch.Tensor, k) -> torch.Tensor:
    """v1: the shipped einsum graph on bf16 values, summed in f32."""
    x = u8.to(torch.bfloat16).float()
    x = torch.einsum("oh,bhwc->bowc", k.rh32, x).to(torch.bfloat16)
    x = torch.einsum("pw,bowc->bopc", k.rw32, x.float())
    return ((x - k.mean) * k.std_inv).to(torch.bfloat16)


def planar_patches_int8(x_pl: torch.Tensor, k) -> torch.Tensor:
    """[B, 3, n, n] f32 (normalised) -> int8 [B, g*g, 3*p*p] c-major."""
    B, _, n, _ = x_pl.shape
    p = k.p
    g = n // p
    xq = quant.quantize_activation(x_pl, k.s_patch).reshape(B, 3, g, p, g, p)
    return xq.permute(0, 2, 4, 1, 3, 5).reshape(B, g * g, 3 * p * p)  # [B, gh, gw, c, ph, pw]


def pre_planar_bf16(u8: torch.Tensor, k) -> torch.Tensor:
    """v2: the shipped planar front end."""
    return k.planar(u8)


def pre_planar_int8(u8: torch.Tensor, k) -> torch.Tensor:
    """v3: both resize products int8 x int8 -> int32: [B*3*W, H] x [H, n]
    (the input's planes with W leading), then [B*3*n, W] x [W, n]."""
    B, H, W, _ = u8.shape
    n = k.rhq_t.shape[1]
    xs = (u8.to(torch.int16) - 128).to(torch.int8).permute(0, 3, 2, 1).contiguous()  # [B, 3, W, H]
    acc = quant.int_mm(xs.reshape(-1, H), k.rhq_t).reshape(B, 3, W, n)
    y1 = acc.float() * k.sh + k.corr_h
    y1q = quant.quantize_activation(y1 - 128.0, k.s1)  # PIL's inter-pass uint8 round trip, in int8
    acc2 = quant.int_mm(y1q.transpose(2, 3).contiguous().reshape(-1, W), k.rwq_t).reshape(B, 3, n, n)
    y2 = (acc2.float() * k.s1) * k.sw + k.corr_w
    return planar_patches_int8((y2 - k.mean4) * k.std_inv4, k)


def pre_planar_bf16_notranspose(u8: torch.Tensor, k) -> torch.Tensor:
    """v4: v2 with the NHWC -> planar transpose folded into the first
    product's output layout."""
    x = u8.to(torch.bfloat16).float()
    x = torch.einsum("oh,bhwc->bcow", k.rh32, x).to(torch.bfloat16)
    x = torch.einsum("pw,kcow->kcop", k.rw32, x.float())
    return planar_patches_int8((x - k.mean4) * k.std_inv4, k)


def variants(qvis, pre, k) -> dict:
    """name -> uint8 images -> int8 tower features."""
    return {
        "v0_shipped": lambda u8: quant.encode_image_q(qvis, pre(u8)),
        "v1_bf16_resize": lambda u8: quant.encode_image_q(qvis, pre_bf16(u8, k)),
        "v2_planar_bf16": lambda u8: quant.encode_image_q_patches(qvis, pre_planar_bf16(u8, k)),
        "v3_planar_int8": lambda u8: quant.encode_image_q_patches(qvis, pre_planar_int8(u8, k)),
        "v4_planar_fused_transpose": lambda u8: quant.encode_image_q_patches(qvis, pre_planar_bf16_notranspose(u8, k)),
    }


def main(argv=None, cfg=None, batch: int = 512, chain=(5, 45), runs: int = 3) -> dict:
    """Every variant's time and fidelity; returns the summary line.
    ``cfg`` replaces ``mixer-b32``, and ``batch``, ``chain`` (the two chain
    lengths) and ``runs`` cut the work, so tests and ``chip_smoke.py`` run
    small."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    no_tf32()

    from clip_mixer_tpu_torch.evals.quant_gate import float32_twin
    from clip_mixer_tpu_torch.models.clip import CLIP, l2_normalize
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
    from clip_mixer_tpu_torch.utils.profiling import chained, slope_time

    cfg = PRESETS["mixer-b32"] if cfg is None else cfg
    B = batch
    model = CLIP(cfg, device=device, generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8)).to(device)

    pre = make_batch_preprocess((256, 256), cfg.image_resolution, normalize=True, dtype=torch.bfloat16)
    with torch.no_grad():
        scales = quant.calibrate_vision_tower(model, pre(images[:128]))
    qvis = quant.quantize_vision_tower(model, scales)
    k = front_end_constants(cfg, (256, 256), scales["patch"], device)

    # feature fidelity vs the all-f32 reference front end + f32 tower
    pre32 = make_batch_preprocess((256, 256), cfg.image_resolution, normalize=True, dtype=torch.float32)
    twin = float32_twin(model)
    with torch.no_grad():
        ref = l2_normalize(twin.encode_image(pre32(images))).cpu().numpy()
    del twin

    out = {}
    for name, fn in variants(qvis, pre, k).items():
        with torch.no_grad():
            feats = fn(images).float().cpu().numpy()
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        cos = float((feats * ref).sum(-1).mean())
        # median of the runs: the variants' deltas are close to one chain's noise
        ts = sorted(slope_time(chained(fn, images), chain[0], chain[1], device) for _ in range(runs))
        t = ts[len(ts) // 2]
        out[name] = {"ms_per_batch": round(t * 1e3, 2),
                     "ms_runs": [round(x * 1e3, 2) for x in ts],
                     "imgs_per_sec": round(B / t, 1),
                     "cos_vs_f32": round(cos, 6)}
        print(json.dumps({name: out[name]}), flush=True)

    name, power = card(device)
    summary = {"batch": B, "results": out, "device": name, "power_limit": power}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
