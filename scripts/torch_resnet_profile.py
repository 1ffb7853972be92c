"""Where the card's time goes in the ResNet vision tower: ``torch.profiler``
over one RN preset's bf16 vision tower (and, with ``--int8``, its int8
tower) at a bucket, random weights from seed 0 with every BN site drawn
from a numpy seed as ``chip_smoke.py`` phase 8 draws them.

    python scripts/torch_resnet_profile.py [--preset rn50] [--batch 128] [--iters 5] [--int8]

Prints one JSON line per tower: wall ms per call (CUDA events), the summed
device time of the kernels, the device's idle share and the device time
by kind of operation (by aten op, so a kind is approximate): the
convolutions (cuDNN; ``_int_mm`` in int8), the BatchNorm passes (f32
subtract, multiplies, bias add; in int8 the dequantise's multiply and add;
the bottlenecks' residual adds count here too), the casts, the pools (the
window sums and every division: the pools' by k^2 and, in int8, the
quantise's by the scale), ReLU, the int8 quantise's round and clamp and
the im2col copies (stack, pad), the attention pool (its products, softmax
and mean token), and the kernels that took the most. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from clip_mixer_tpu_torch import PRESETS  # noqa: E402
from torch_vit_profile import profile_tower  # noqa: E402

# aten ops by kind; everything else counts as "other"
RN_KINDS = {
    "convs": ("aten::cudnn_convolution", "aten::_convolution", "aten::convolution", "aten::_int_mm"),
    "bn_passes": ("aten::sub", "aten::mul", "aten::add", "aten::rsqrt"),
    "casts": ("aten::_to_copy", "aten::copy_"),
    "pools": ("aten::sum", "aten::div"),
    "relu": ("aten::relu", "aten::clamp_min"),
    "quantise_im2col": ("aten::round", "aten::clamp", "aten::stack", "aten::constant_pad_nd", "aten::cat"),
    "attention_pool": ("aten::mm", "aten::bmm", "aten::addmm", "aten::_softmax", "aten::mean"),
}


def by_kind(prof_rows, iters: int) -> dict:
    """Self device ms a call by ``RN_KINDS`` from ``key_averages()`` rows."""
    out = {k: 0.0 for k in (*RN_KINDS, "other")}
    for e in prof_rows:
        us = float(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0))
        if us <= 0 or not e.key.startswith("aten::"):
            continue
        kind = next((k for k, ops in RN_KINDS.items() if e.key in ops), "other")
        out[kind] += us / 1e3 / iters
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="rn50")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--int8", action="store_true", help="also the int8 tower, calibrated on the profiled batch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_resnet_profile: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke

    from clip_mixer_tpu_torch.ops import quant as tq

    dev = torch.device("cuda")
    cfg = PRESETS[args.preset]
    if not cfg.is_resnet:
        raise SystemExit(f"{args.preset} has no ResNet tower")
    model = chip_smoke.rn_model(dev, cfg).eval()
    r = cfg.image_resolution
    x = torch.randn(args.batch, r, r, 3, generator=torch.Generator().manual_seed(1)).to(device=dev,
                                                                                        dtype=torch.bfloat16)
    towers = {"vision_bf16": lambda: model.visual(x)}
    if args.int8:
        with torch.inference_mode():
            qvis = tq.quantize_resnet_tower(model, tq.calibrate_resnet_tower(model, x))
        towers["vision_int8"] = lambda: tq.encode_image_rn_q(qvis, x)
    for name, fn in towers.items():
        def call():
            with torch.inference_mode():
                fn()

        out = profile_tower(call, args.iters, args.top, kinds=by_kind)
        print(json.dumps({"preset": args.preset, "tower": name, "batch": args.batch,
                          "device": torch.cuda.get_device_name(0), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
