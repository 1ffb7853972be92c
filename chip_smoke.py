#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:

1. Build every ``clip_mixer_tpu_torch/csrc/*.cu`` with ``nvcc`` (one process
   per source, all started together) and hold each kernel against its plain
   PyTorch version on the card at the shapes the serving paths give it
   (``ln_mlp``, ``preprocess`` at B = 128, 8 and 1 and at other input
   shapes, odd widths too, in bf16 and f32, and ``fused_mixer_block_tbd`` at both
   towers' buckets 128 and 8, a B no batch tile divides, and f32), and each of
   ``ln_mlp``'s three bf16 stages (LN pass, GEMM 1 with QuickGELU, GEMM 2
   with the residual) against its plain version, and the bf16 block's
   first launch alone (``token_mix``: z and y2 = LN_ch(z)) against
   ``token_mix_plain`` in both layouts, its three launches composed against
   the fused call; one backward in f32 and one in bf16 (x in bf16, the
   parameters f32 masters) through ``mixer_block_fused`` and through
   ``ln_mlp`` against autograd of the model's unfused chain; then a small f32 model with the fused channel mix, and the
   same model with its towers through ``mixer_tower_fused``, on the card
   against the CPU.
2. The main path, with every launch counter set to 0 first: a full-width
   Mixer-B/32 (bf16, ``fused_mlp=True``, random weights from seed 0) behind
   an ``InferenceEngine`` that takes 256x256 uint8 images, warmed up, then
   serving text, image and similarity requests through the engine API and
   ``/healthz`` + ``/encode_text`` through the HTTP server on 127.0.0.1; then
   the bench front end, ``make_batch_preprocess(backend="kernel")`` ->
   ``encode_image`` at batch 128. Each call's launches are checked, and the
   features against the same weights with the plain channel mix
   (``fused_mlp=False``): cosine >= 0.999.
2b. The fused-block path, with every launch counter set to 0 first: the
   same Mixer-B/32 with ``fused_mlp=False`` and both towers' ``forward``
   bound to ``mixer_tower_fused`` (the model's own ``encode_image`` /
   ``encode_text`` run unchanged), warmed up, then ``encode_text`` of 5 and
   40 captions, ``encode_image_arrays`` of 7 and 100 images and the kernel
   front end at batch 128: 12 block launches per tower call and none of
   ``ln_mlp``; features against the plain towers: cosine >= 0.999.
3. Time each kernel and its plain version with CUDA events (``preprocess``
   warm, on the same inputs, and cold, on inputs rotated over more than
   twice the 50 MB L2, at B = 128 and 8; ``ln_mlp``
   and the bf16 block also stage by stage, each beside the model's own bf16
   chain for the same function, ``torch_chain_ms``: the non-fused channel
   mix, and ``MixerBlock.forward``), and each tower at bucket 128 three
   ways: through ``mixer_tower_fused``, with ``fused_mlp=True``, and plain.

Standard output ends with a JSON line per phase result, the kernels line,
the card's name and power limit, and last ``{"ok": true, "device": ...}``.
Without a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

import copy
import functools
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# operations/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

BF16_REL_TOL = 1e-2  # relative Frobenius error: bf16 keeps 8 significant bits
# ln_mlp bf16 is held on its branch, out - x, not on out: the residual is
# about 90% of the output's norm and would hide a dropped bias. Sound runs
# differ from the plain version by about 1e-3 of the branch (rare rounding
# flips of h and of the output); one that drops b_in or b_out differs by
# 4e-2 or more. Each run checks that the plain version with b_out zeroed
# fails the check.
LN_MLP_BRANCH_TOL = 5e-3
LN_MLP_F32_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_pallas_kernels.py:57
# ln_mlp's bf16 stages y = LN(x) and h = QuickGELU(y W_in^T + b_in), each
# against its plain version on the same input: the same bf16 rounding of f32
# values that differ only in summation order, so sound runs differ by about
# 1e-4 (rare one-ulp flips). The third stage is held on its branch, as
# ln_mlp is (LN_MLP_BRANCH_TOL).
LN_MLP_STAGE_TOL = 1e-3
PREPROCESS_F32_ATOL = 1e-4  # banded vs dense f32 sums: summation order only
L2_BYTES = 50 * 2**20  # an H100's L2 cache
COSINE_MIN = 0.999

LN_MLP_CASES = [  # (label, R, W, H, dtype): the towers at buckets 128 and 8, ragged R, 128-wide tiles, f32
    ("vision", 128 * 50, 768, 3072, torch.bfloat16),
    ("text", 128 * 77, 512, 2048, torch.bfloat16),
    ("vision_b8", 8 * 50, 768, 3072, torch.bfloat16),
    ("ragged", 3 * 77, 512, 2048, torch.bfloat16),
    ("narrow", 151, 384, 1536, torch.bfloat16),  # W % 256 != 0: GEMM 2 on 128-column tiles
    ("f32", 8 * 50, 768, 3072, torch.float32),
]
PREPROCESS_CASES = [  # (label, input_hw, n_px, B, dtype): the bench front end, small B, other input shapes
    ("bf16", (256, 256), 224, 128, torch.bfloat16),
    ("f32", (256, 256), 224, 128, torch.float32),
    ("b8_bf16", (256, 256), 224, 8, torch.bfloat16),
    ("b8_f32", (256, 256), 224, 8, torch.float32),
    ("b1_bf16", (256, 256), 224, 1, torch.bfloat16),
    ("b1_f32", (256, 256), 224, 1, torch.float32),
    ("480x640_bf16", (480, 640), 224, 8, torch.bfloat16),
    ("480x640_f32", (480, 640), 224, 8, torch.float32),
    ("480x640_b1_f32", (480, 640), 224, 1, torch.float32),
    ("300x200_bf16", (300, 200), 224, 8, torch.bfloat16),
    ("300x200_f32", (300, 200), 224, 8, torch.float32),
    ("300x200_b1_bf16", (300, 200), 224, 1, torch.bfloat16),
    ("90x131_f32", (90, 131), 64, 3, torch.float32),  # W % 4 != 0: the kernel's byte loads
]
PREPROCESS_TIMED = ("bf16", "b8_bf16", "f32")  # timed warm and cold in phase 3
BLOCK_CASES = [  # (label, B, T, D, dtype): both towers at buckets 128 and 8, a B no batch tile divides, f32
    ("vision", 128, 50, 768, torch.bfloat16),
    ("text", 128, 77, 512, torch.bfloat16),
    ("vision_b8", 8, 50, 768, torch.bfloat16),
    ("text_b12", 12, 77, 512, torch.bfloat16),
    ("f32", 8, 50, 768, torch.float32),
]
# The residual branches' last biases: a kernel that drops either must fail
# the bf16 branch check.
BLOCK_PLANTED = ("token_mix_seq.lin2.bias", "channel_mix_seq.lin4.bias")
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)  # tests/test_pallas_kernels.py:121

TEXTS = [
    f"a {adj} photo of a {noun}"
    for adj in ("blurry", "bright", "dark", "close-up", "black and white")
    for noun in ("cat", "dog", "bicycle", "mountain lake", "red car", "bowl of soup", "city street", "person")
]  # 40 captions


def require(ok: bool, what) -> None:
    """Fail the run (exit 1) when a check does not hold."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def branch_err(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> float:
    """Relative Frobenius error of the residual branch ``out - x``."""
    return rel_err(got.float() - x.float(), want.float() - x.float())


def max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cycling(fn, inputs, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, each on
    the next of ``inputs`` in turn."""
    turn = iter(range(10**9))
    return cuda_ms(lambda: fn(inputs[next(turn) % len(inputs)]), iters)


def bound(n_bytes: float, n_ops: float, dtype: torch.dtype):
    """(least ms on the card, what bounds it) against the published peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- phase 1: kernels against their plain versions -------------------------


def ln_mlp_args(R, W, H, dtype, device, seed):
    """Inputs at the model's init scales, cast to ``dtype`` as the model does."""
    g = torch.Generator().manual_seed(seed)
    ts = (
        torch.randn(R, W, generator=g) * 2.0,
        1.0 + 0.1 * torch.randn(W, generator=g),
        0.1 * torch.randn(W, generator=g),
        (torch.rand(H, W, generator=g) * 2 - 1) * W**-0.5,
        (torch.rand(H, generator=g) * 2 - 1) * W**-0.5,
        (torch.rand(W, H, generator=g) * 2 - 1) * H**-0.5,
        (torch.rand(W, generator=g) * 2 - 1) * H**-0.5,
    )
    return [t.to(device=device, dtype=dtype).contiguous() for t in ts]


def ln_mlp_cost(R, W, H, dtype):
    e = torch.finfo(dtype).bits // 8
    n_bytes = e * (2 * R * W + 2 * W * H + 3 * W + H)  # x in, out, w_in, w_out, vectors
    return n_bytes, 4 * R * W * H  # two products of 2*R*W*H


def check_ln_mlp_stages(label, args, fused):
    """Each bf16 stage of ``ln_mlp`` alone against its plain version on the
    same input, and the three composed against the fused call (the same
    launches, so the same bits). Returns the errors and the stages' inputs."""
    from clip_mixer_tpu_torch.ops.kernels import ln_mlp as kln

    x, ln_w, ln_b, w_in, b_in, w_out, b_out = args
    y = kln.ln_rows(x, ln_w, ln_b)
    h = kln.linear_gelu(y, w_in, b_in)
    out = kln.linear_residual(h, w_out, b_out, x)
    torch.cuda.synchronize()
    errs = {
        "ln_rows": rel_err(y, kln.ln_rows_plain(x, ln_w, ln_b)),
        "linear_gelu": rel_err(h, kln.linear_gelu_plain(y, w_in, b_in)),
        "linear_residual_branch": branch_err(out, kln.linear_residual_plain(h, w_out, b_out, x), x),
    }
    for name, err in errs.items():
        tol = LN_MLP_BRANCH_TOL if name.endswith("branch") else LN_MLP_STAGE_TOL
        require(err <= tol, f"ln_mlp {label} stage {name}: relative error {err} > {tol}")
    require(torch.equal(out, fused), f"ln_mlp {label}: its stages composed differ from the fused call")
    return errs, (y, h)


def check_ln_mlp(dev):
    from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp, ln_mlp_plain

    results = {}
    for label, R, W, H, dtype in LN_MLP_CASES:
        args = ln_mlp_args(R, W, H, dtype, dev, seed=R)
        got = ln_mlp(*args)
        torch.cuda.synchronize()
        want = ln_mlp_plain(*args)
        err, rel = max_abs(got, want), branch_err(got, want, args[0])
        case = dict(R=R, W=W, H=H, dtype=str(dtype), max_abs_err=err, rel_err=rel)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **LN_MLP_F32_TOL)
            case["tol"] = "allclose atol 2e-4 rtol 1e-3 (f32 sums in another order)"
        else:
            require(rel <= LN_MLP_BRANCH_TOL, f"ln_mlp {label}: branch error {rel} > {LN_MLP_BRANCH_TOL}")
            no_b_out = ln_mlp_plain(*args[:6], torch.zeros_like(args[6]))
            case["planted_fault_err"] = branch_err(no_b_out, want, args[0])
            require(case["planted_fault_err"] > LN_MLP_BRANCH_TOL, f"ln_mlp {label}: the check passes b_out = 0")
            case["tol"] = f"branch (out - x) relative Frobenius <= {LN_MLP_BRANCH_TOL} (bf16, same rounding points)"
            case["stage_err"], stage_inputs = check_ln_mlp_stages(label, args, got)
            case["stage_tol"] = (f"relative Frobenius <= {LN_MLP_STAGE_TOL} (y, h), branch <= {LN_MLP_BRANCH_TOL} "
                                 "(out); stages composed == fused call")
            case["stage_inputs"] = stage_inputs
        results[label] = dict(case, args=args)
        log(f"ln_mlp {label} R={R} W={W} H={H} {dtype}: max_abs {err:.3g} branch rel {rel:.3g} "
            f"stages {case.get('stage_err')} ok")
    return results


def preprocess_cost(bands, B, dtype):
    h, w = bands.input_hw
    n = bands.n_px
    e = torch.finfo(dtype).bits // 8
    n_bytes = B * h * w * 3 + B * n * n * 3 * e + 4 * (bands.rh_taps.numel() + bands.rw_taps.numel() + 2 * n + 6)
    # the banded sums: every non-zero tap of R_h over a W*3 row, of R_w over
    # an n*3 row (a multiply and an add each), then the normalisation
    nnz_h = int((bands.rh != 0).sum())
    nnz_w = int((bands.rw != 0).sum())
    n_ops = B * (2 * nnz_h * w * 3 + 2 * nnz_w * n * 3 + 2 * n * n * 3)
    return n_bytes, n_ops


def dropped_tap(bands):
    """``bands`` with the middle tap of every R_w row zeroed in its dense
    matrix: the plain version of a kernel that drops a tap column."""
    import dataclasses

    rw = bands.rw.clone()
    rows = torch.arange(rw.shape[0], device=rw.device)
    rw[rows, bands.rw_start.long() + bands.rw_taps.shape[1] // 2] = 0.0
    return dataclasses.replace(bands, rw=rw)


def check_preprocess(dev):
    from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre

    g = torch.Generator().manual_seed(1)
    results = {}
    for label, hw, n, B, dtype in PREPROCESS_CASES:
        bands = kpre.ResizeBands.build(hw, n, dev)
        imgs = torch.randint(0, 256, (B, *hw, 3), dtype=torch.uint8, generator=g).to(dev)
        got = kpre.preprocess(imgs, bands, dtype)
        torch.cuda.synchronize()
        want = kpre.preprocess_plain(imgs, bands, dtype)
        err, rel = max_abs(got, want), rel_err(got, want)
        case = dict(input_hw=hw, n_px=n, B=B, dtype=str(dtype), max_abs_err=err, rel_err=rel)
        plan, _ = kpre._plan(bands, B)
        case["plan"] = dict(rows=plan.rows, group=plan.group, n_bands=plan.n_bands, warp_pixels=plan.warp_pixels,
                            smem_bytes=plan.smem_bytes, ctas_per_sm=plan.ctas_per_sm, grid=plan.grid)
        if dtype == torch.float32:
            require(err <= PREPROCESS_F32_ATOL, f"preprocess {label}: max abs error {err} > {PREPROCESS_F32_ATOL}")
            case["tol"] = f"max abs <= {PREPROCESS_F32_ATOL} (f32, banded vs dense summation)"
            fault = max_abs(got, kpre.preprocess_plain(imgs, dropped_tap(bands), dtype))
            require(fault > PREPROCESS_F32_ATOL, f"preprocess {label}: the check passes a dropped R_w tap")
            case["planted_fault_err"] = fault
        else:
            require(rel <= BF16_REL_TOL, f"preprocess {label}: relative error {rel} > {BF16_REL_TOL}")
            case["tol"] = f"relative Frobenius <= {BF16_REL_TOL} (bf16 store)"
        if label in PREPROCESS_TIMED:
            case.update(imgs=imgs, bands=bands)
        results[label] = case
        log(f"preprocess {label} B={B} {hw}->{n} {dtype}: max_abs {err:.3g} rel {rel:.3g} "
            f"plan {case['plan']} ok")
    empty = kpre.preprocess(torch.zeros((0, 256, 256, 3), dtype=torch.uint8, device=dev), results["bf16"]["bands"])
    require(empty.shape == (0, 224, 224, 3), f"preprocess B=0: shape {tuple(empty.shape)}")
    return results


def block_case(label, B, T, D, dtype, dev, seed):
    """A MixerBlock at its tower's init scales (LN parameters perturbed so
    the affine counts), in ``dtype`` on ``dev``, and x [T, B, D]."""
    from clip_mixer_tpu_torch.models.mixer import MixerBlock, init_mixer_block

    g = torch.Generator().manual_seed(seed)
    block = MixerBlock(D, T)
    init_mixer_block(block, text_tower=label.startswith("text"), n_layers=12, generator=g)
    with torch.no_grad():
        for ln in (block.layerNorm1, block.layerNorm2):
            ln.weight.add_(0.1 * torch.randn(D, generator=g))
            ln.bias.add_(0.1 * torch.randn(D, generator=g))
    x = torch.randn(T, B, D, generator=g)
    return block.to(device=dev, dtype=dtype), x.to(device=dev, dtype=dtype)


def token_mix_cost(B, T, D, U, dtype):
    """Bytes (x read, z and y2 written, the token weights and vectors) and
    operations of the block's first launch alone."""
    e = torch.finfo(dtype).bits // 8
    return e * (3 * B * T * D + 2 * T * U + 4 * D + U + T), 2 * B * D * 2 * T * U


def block_cost(B, T, D, U, H, dtype):
    """Bytes and operations the JAX CostEstimate counts (block_kernel.py:181-185)."""
    e = torch.finfo(dtype).bits // 8
    n_bytes = e * (2 * B * T * D + 2 * T * U + 2 * D * H + 5 * D + U + T + H)  # x, out, weights, vectors
    return n_bytes, 2 * B * D * 2 * T * U + 2 * B * T * 2 * D * H


def check_mixer_block(dev):
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import fused_mixer_block_tbd, mixer_block_plain

    results = {}
    for label, B, T, D, dtype in BLOCK_CASES:
        block, x = block_case(label, B, T, D, dtype, dev, seed=B * T)
        block.requires_grad_(False)
        got = fused_mixer_block_tbd(block, x)
        torch.cuda.synchronize()
        want = mixer_block_plain(block, x)
        err, rel = max_abs(got, want), branch_err(got, want, x)
        case = dict(B=B, T=T, D=D, U=4 * T, H=4 * D, dtype=str(dtype), max_abs_err=err, rel_err=rel)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **LN_MLP_F32_TOL)
            case["tol"] = "allclose atol 2e-4 rtol 1e-3 (f32 sums in another order)"
        else:
            require(rel <= LN_MLP_BRANCH_TOL, f"fused_mixer_block {label}: branch error {rel} > {LN_MLP_BRANCH_TOL}")
            case["planted_fault_err"] = {}
            for bias in BLOCK_PLANTED:
                faulty = copy.deepcopy(block)
                faulty.get_parameter(bias).zero_()
                fault = branch_err(mixer_block_plain(faulty, x), want, x)
                require(fault > LN_MLP_BRANCH_TOL, f"fused_mixer_block {label}: the check passes {bias} = 0")
                case["planted_fault_err"][bias] = fault
            case["tol"] = f"branch (out - x) relative Frobenius <= {LN_MLP_BRANCH_TOL} (bf16, same rounding points)"
        results[label] = dict(case, block=block, x=x)
        log(f"fused_mixer_block {label} B={B} T={T} D={D} {dtype}: max_abs {err:.3g} branch rel {rel:.3g} ok")
    return results


def rows(t: torch.Tensor) -> torch.Tensor:
    """A [T, B, D] tensor in either of the block's layouts as its [B*T, D]
    rows in memory order, the rows the block's GEMMs take."""
    return t.as_strided((t.shape[0] * t.shape[1], t.shape[2]), (t.shape[2], 1))


def check_token_mix(block_cases):
    """The bf16 block's first launch alone (``token_mix``) against
    ``token_mix_plain`` at every bf16 block shape, in both layouts: z on its
    branch z - x (the plain version without b2 must fail that check), y2
    against LN_ch of the kernel's own z; and the block's three launches
    (``token_mix``, then ``ln_mlp``'s two GEMM stages) composed against the
    fused call, bit for bit. Keeps the tower layout's stage outputs for the
    timing."""
    from clip_mixer_tpu_torch.ops.kernels import ln_mlp as kln
    from clip_mixer_tpu_torch.ops.kernels import mixer_block as kmb

    for label, case in block_cases.items():
        block, x = case["block"], case["x"]
        if x.dtype != torch.bfloat16:
            continue
        p = kmb.block_params(block, x.dtype)
        errs = {}
        for layout, xl in (("TBD", x), ("BTD view", x.transpose(0, 1).contiguous().transpose(0, 1))):
            z, y2 = kmb.token_mix(xl, *p[:8])
            torch.cuda.synchronize()
            want, _ = kmb.token_mix_plain(xl, *p[:8])
            no_b2, _ = kmb.token_mix_plain(xl, *p[:5], torch.zeros_like(p[5]), *p[6:8])
            e = dict(z_branch=branch_err(z, want, xl), planted_b2=branch_err(no_b2, want, xl),
                     y2=rel_err(y2, kln.ln_rows_plain(z, p[6], p[7])))
            what = f"token_mix {label} {layout}"
            require(e["z_branch"] <= LN_MLP_BRANCH_TOL, f"{what}: z branch error {e['z_branch']} > {LN_MLP_BRANCH_TOL}")
            require(e["planted_b2"] > LN_MLP_BRANCH_TOL, f"{what}: the check passes b2 = 0")
            require(e["y2"] <= LN_MLP_STAGE_TOL, f"{what}: y2 error {e['y2']} > {LN_MLP_STAGE_TOL}")
            h = kln.linear_gelu(rows(y2), p[8], p[9])
            out = kln.linear_residual(h, p[10], p[11], rows(z))
            require(torch.equal(out, rows(kmb.fused_mixer_block_tbd(block, xl))),
                    f"{what}: the block's three launches composed differ from the fused call")
            errs[layout] = e
        case["token_stage_err"] = errs
        case["token_stage_tol"] = (f"z branch (z - x) relative Frobenius <= {LN_MLP_BRANCH_TOL}, y2 against LN_ch of "
                                   f"the kernel's z <= {LN_MLP_STAGE_TOL}; the three launches composed == fused call")
        case["stage_inputs"] = (xl, z, y2, h)  # the tower's layout, the last one checked
        log(f"token_mix {label}: {errs} ok")


def check_gradients(dev):
    """One backward through each kernel's autograd wrapper, in f32 and in
    bf16 (x in bf16, the parameters f32 masters), against autograd of the
    model's unfused chain: the block's own forward (``fused_mlp=False``) and
    ``channel_mlp``."""
    from clip_mixer_tpu_torch.models.layers import channel_mlp
    from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import fused_mixer_block_tbd, mixer_block_fused

    g = torch.Generator().manual_seed(7)
    for dtype, tol in ((torch.float32, GRAD_TOL), (torch.bfloat16, dict(atol=1e-2, rtol=1e-2))):
        block, x = block_case("vision", 8, 50, 768, torch.float32, dev, seed=5)
        x = x.to(dtype).requires_grad_()
        x_ln, *p_ln = ln_mlp_args(400, 768, 3072, torch.float32, dev, seed=6)
        x_ln = x_ln.to(dtype).requires_grad_()
        p_ln = [t.requires_grad_() for t in p_ln]
        for name, wrapper, fused, plain, inputs in (
            ("mixer_block_fused", fused_mixer_block_tbd, lambda: mixer_block_fused(block, x),
             lambda: block(x.transpose(0, 1)).transpose(0, 1), [x, *block.parameters()]),
            ("ln_mlp", ln_mlp, lambda: ln_mlp(x_ln, *p_ln), lambda: channel_mlp(x_ln, *p_ln), [x_ln, *p_ln]),
        ):
            before = wrapper.launches
            out = fused()
            require(wrapper.launches == before + 1, f"{name}: the forward did not launch the kernel")
            grad = torch.randn(out.shape, generator=g).to(device=dev, dtype=dtype)
            got = torch.autograd.grad(out, inputs, grad)
            want = torch.autograd.grad(plain(), inputs, grad)
            for a, b in zip(got, want):
                require(a.dtype == b.dtype, f"{name} {dtype}: gradient dtype {a.dtype}, expected {b.dtype}")
                torch.testing.assert_close(a, b, **tol)
            log(f"{name} {dtype} backward: {len(inputs)} gradients match autograd of the unfused chain")


def route_towers(model, fused: bool):
    """Bind (or unbind) both towers' forward to ``mixer_tower_fused``; the
    model's state-dict keys and config do not change."""
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import mixer_tower_fused

    for tower in (model.visual.transformer, model.transformer):
        if fused:
            tower.forward = functools.partial(mixer_tower_fused, tower)
        else:
            del tower.forward


def check_small_model(dev):
    """A two-layer f32 model with the fused channel mix, then with its towers
    through ``mixer_tower_fused``: card against CPU."""
    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    res = PRESETS["mixer-debug"].image_resolution
    images = torch.randn(4, res, res, 3, generator=torch.Generator().manual_seed(4))
    for what, over, fused_towers in (("fused channel mix", dict(fused_mlp=True), False), ("fused towers", {}, True)):
        cfg = PRESETS["mixer-debug"].replace(**over)
        models = {d: CLIP(cfg, device=d, generator=torch.Generator().manual_seed(3)) for d in ("cpu", dev)}
        for m in models.values():
            if fused_towers:
                route_towers(m, True)
        text = torch.from_numpy(tokenize(TEXTS[:4], cfg.context_length, truncate=True))
        with torch.inference_mode():
            out = {d: (m.encode_image(images.to(d)).cpu(), m.encode_text(text.to(d)).cpu()) for d, m in models.items()}
        for got, want in zip(out[dev], out["cpu"]):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
        log(f"mixer-debug f32 model, {what}: card matches CPU")


# ---- phase 2: the main path -------------------------------------------------


class Counters:
    def __init__(self):
        from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre
        from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp
        from clip_mixer_tpu_torch.ops.kernels.mixer_block import fused_mixer_block_tbd

        self.wrappers = {"ln_mlp": ln_mlp, "preprocess": kpre.preprocess, "fused_mixer_block": fused_mixer_block_tbd}

    def reset(self):
        for w in self.wrappers.values():
            w.launches = 0

    def read(self):
        return {n: w.launches for n, w in self.wrappers.items()}


def expect(counters, before, what, **deltas):
    now = counters.read()
    for name, d in deltas.items():
        got = now[name] - before[name]
        require(got == d, f"{what}: {name} launched {got} times, expected {d}")
    return now


def check_features(feats, n, embed_dim, what):
    require(feats.shape == (n, embed_dim), f"{what}: shape {feats.shape}")
    require(np.isfinite(feats).all(), f"{what}: non-finite features")
    norms = np.linalg.norm(feats, axis=-1)
    require(np.allclose(norms, 1.0, atol=1e-2), f"{what}: norms {norms.min()}..{norms.max()}")


def min_cosine(a, b):
    return float((a * b).sum(-1).min())


def http_requests(engine, texts):
    from clip_mixer_tpu_torch.serving import serve

    server = serve(engine, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        require(health["status"] == "ok" and health["device"] == str(engine.device), health)
        req = urllib.request.Request(
            f"{base}/encode_text", data=json.dumps({"texts": texts}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            feats = np.asarray(json.loads(r.read())["features"], np.float32)
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    return health, feats


def main_path(dev, counters):
    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
    from clip_mixer_tpu_torch.serving import InferenceEngine

    cfg = PRESETS["mixer-b32"].replace(fused_mlp=True)
    per_tower = {"image": cfg.vision_layers, "text": cfg.text_layers}
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (128, 256, 256, 3), dtype=np.uint8)
    summary = {}

    model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, input_hw=(256, 256))
    counters.reset()
    c = counters.read()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    summary["warmup_s"] = time.perf_counter() - t0
    c = expect(counters, c, "warmup", ln_mlp=len(engine.buckets) * (per_tower["image"] + per_tower["text"]))

    feats = {}
    for n in (1, 5, 40):
        t0 = time.perf_counter()
        feats[f"text{n}"] = engine.encode_text(TEXTS[:n])
        summary[f"encode_text_{n}_ms"] = (time.perf_counter() - t0) * 1e3
        check_features(feats[f"text{n}"], n, cfg.embed_dim, f"encode_text({n})")
        c = expect(counters, c, f"encode_text({n})", ln_mlp=per_tower["text"], preprocess=0)
    for n in (1, 7, 100):
        t0 = time.perf_counter()
        feats[f"image{n}"] = engine.encode_image_arrays(images[:n])
        summary[f"encode_image_{n}_ms"] = (time.perf_counter() - t0) * 1e3
        check_features(feats[f"image{n}"], n, cfg.embed_dim, f"encode_image_arrays({n})")
        c = expect(counters, c, f"encode_image_arrays({n})", ln_mlp=per_tower["image"], preprocess=0)
    sims = engine.similarity(images[:3], TEXTS[:4])
    require(sims.shape == (3, 4) and np.isfinite(sims).all(), sims)
    np.testing.assert_allclose(sims, 100.0 * feats["image7"][:3] @ feats["text5"][:4].T, atol=1e-3)
    c = expect(counters, c, "similarity", ln_mlp=per_tower["image"] + per_tower["text"])

    health, http_feats = http_requests(engine, TEXTS[:2])
    np.testing.assert_allclose(http_feats, feats["text5"][:2], atol=1e-6)
    c = expect(counters, c, "HTTP /encode_text", ln_mlp=per_tower["text"])
    summary["healthz"] = health

    # the bench front end: the preprocess kernel -> encode_image at batch 128
    pre_kernel = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="kernel")
    x = torch.from_numpy(images).to(dev)
    with torch.inference_mode():
        front = model.encode_image(pre_kernel(x)).float()
    torch.cuda.synchronize()
    c = expect(counters, c, "front end", ln_mlp=per_tower["image"], preprocess=1)
    launches = counters.read()
    log(f"main path launches: {launches}")
    require(launches["fused_mixer_block"] == 0, "the fused_mlp path launched the whole-block kernel")

    # reference: the same weights with the plain channel mix, and the "torch" front end
    ref_model = CLIP(cfg.replace(fused_mlp=False), device=dev, generator=torch.Generator().manual_seed(0))
    ref = InferenceEngine(ref_model, input_hw=(256, 256))
    cos = {
        "text40": min_cosine(feats["text40"], ref.encode_text(TEXTS[:40])),
        "image100": min_cosine(feats["image100"], ref.encode_image_arrays(images[:100])),
    }
    pre_torch = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="torch")
    with torch.inference_mode():
        front_ref = ref_model.encode_image(pre_torch(x)).float()
    front_cos = torch.nn.functional.cosine_similarity(front, front_ref, dim=-1)
    cos["front_end128"] = float(front_cos.min())
    require(counters.read() == launches, "the plain reference launched a kernel")
    for k, v in cos.items():
        require(v >= COSINE_MIN, f"{k}: fused vs plain cosine {v} < {COSINE_MIN}")
    summary["min_cosine_vs_plain"] = cos
    log(f"fused vs plain channel mix, min cosine: {cos}")

    # the front end's time at batch 128, kernels against the plain model and "torch" preprocess
    def run(m, pre):
        with torch.inference_mode():
            m.encode_image(pre(x))

    summary["front_end128_ms"] = cuda_ms(lambda: run(model, pre_kernel), iters=10)
    summary["front_end128_plain_ms"] = cuda_ms(lambda: run(ref_model, pre_torch), iters=10)
    summary["launches"] = launches
    del ref_model, ref, model, engine
    return summary, launches


# ---- phase 2b: the fused-block path ------------------------------------------


def fused_block_path(dev, counters):
    """Full-width Mixer-B/32 bf16 served with both towers through
    ``mixer_tower_fused``; returns (summary, launches, the model)."""
    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
    from clip_mixer_tpu_torch.serving import InferenceEngine

    cfg = PRESETS["mixer-b32"]
    require(not cfg.fused_mlp, "the fused-block path runs the plain channel mix's config")
    per_tower = {"image": cfg.vision_layers, "text": cfg.text_layers}
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (128, 256, 256, 3), dtype=np.uint8)
    summary = {}

    model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, input_hw=(256, 256))
    route_towers(model, True)
    counters.reset()
    c = counters.read()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    summary["warmup_s"] = time.perf_counter() - t0
    c = expect(counters, c, "warmup", fused_mixer_block=len(engine.buckets) * (per_tower["image"] + per_tower["text"]),
               ln_mlp=0)

    feats = {}
    for n in (5, 40):
        t0 = time.perf_counter()
        feats[f"text{n}"] = engine.encode_text(TEXTS[:n])
        summary[f"encode_text_{n}_ms"] = (time.perf_counter() - t0) * 1e3
        check_features(feats[f"text{n}"], n, cfg.embed_dim, f"fused towers: encode_text({n})")
        c = expect(counters, c, f"fused towers: encode_text({n})", fused_mixer_block=per_tower["text"], ln_mlp=0)
    for n in (7, 100):
        t0 = time.perf_counter()
        feats[f"image{n}"] = engine.encode_image_arrays(images[:n])
        summary[f"encode_image_{n}_ms"] = (time.perf_counter() - t0) * 1e3
        check_features(feats[f"image{n}"], n, cfg.embed_dim, f"fused towers: encode_image_arrays({n})")
        c = expect(counters, c, f"fused towers: encode_image_arrays({n})", fused_mixer_block=per_tower["image"],
                   ln_mlp=0, preprocess=0)

    pre_kernel = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="kernel")
    with torch.inference_mode():
        pixels = pre_kernel(torch.from_numpy(images).to(dev))
        front = model.encode_image(pixels).float()
    torch.cuda.synchronize()
    c = expect(counters, c, "fused towers: front end", fused_mixer_block=per_tower["image"], ln_mlp=0, preprocess=1)
    launches = counters.read()
    log(f"fused-block path launches: {launches}")

    # reference: the same model and inputs with the plain towers
    route_towers(model, False)
    with torch.inference_mode():
        front_ref = model.encode_image(pixels).float()
    cos = {
        "text40": min_cosine(feats["text40"], engine.encode_text(TEXTS[:40])),
        "image100": min_cosine(feats["image100"], engine.encode_image_arrays(images[:100])),
        "front_end128": float(torch.nn.functional.cosine_similarity(front, front_ref, dim=-1).min()),
    }
    require(counters.read() == launches, "the plain towers launched a kernel")
    for k, v in cos.items():
        require(v >= COSINE_MIN, f"{k}: fused towers vs plain cosine {v} < {COSINE_MIN}")
    summary["min_cosine_vs_plain"] = cos
    summary["launches"] = launches
    log(f"fused towers vs plain towers, min cosine: {cos}")
    del engine
    return summary, launches, model


# ---- phase 3: timing ----------------------------------------------------------


def torch_chain(x, ln_w, ln_b, w_in, b_in, w_out, b_out):
    """The model's non-fused channel mix (``MixerBlock.forward`` with
    ``fused_mlp=False``) on weights already in ``x.dtype``: a yardstick for
    ``ln_mlp`` that the port never calls."""
    from clip_mixer_tpu_torch.models.layers import layer_norm, quick_gelu

    y = layer_norm(x, ln_w, ln_b)
    h = quick_gelu(y @ w_in.t() + b_in)
    return x + (h @ w_out.t() + b_out)


def time_towers(model, dev):
    """Each tower at bucket 128, bf16: through ``mixer_tower_fused``, through
    ``fused_mlp=True`` (``ln_mlp``), and plain; in turns A B C C B A, each
    the mean of 10 back-to-back calls."""
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import mixer_tower_fused

    cfg = model.cfg
    g = torch.Generator().manual_seed(8)
    rows = {}
    for name, tower, T, D in (("vision", model.visual.transformer, cfg.vision_tokens, cfg.vision_width),
                              ("text", model.transformer, cfg.context_length, cfg.text_width)):
        x = torch.randn(128, T, D, generator=g).to(device=dev, dtype=torch.bfloat16)

        ways = {
            "fused_block_ms": lambda: mixer_tower_fused(tower, x),
            "fused_mlp_ms": lambda: tower(x),  # with every block's fused_mlp set
            "plain_ms": lambda: tower(x),
        }
        times = {k: [] for k in ways}
        with torch.inference_mode():
            for k in [*ways, *reversed(ways)]:
                for block in tower.mixBlocks:
                    block.fused_mlp = k == "fused_mlp_ms"
                times[k].append(cuda_ms(ways[k], iters=10))
        rows[name] = {k: sum(v) / len(v) for k, v in times.items()}
        rows[name]["each_run_ms"] = times
        log(f"tower {name} at bucket 128: {rows[name]}")
    return rows



def time_kernels(ln_cases, pre_cases, block_cases, launches):
    from clip_mixer_tpu_torch.ops.kernels import ln_mlp as kln
    from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre
    from clip_mixer_tpu_torch.ops.kernels import mixer_block as kmb
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import fused_mixer_block_tbd, mixer_block_plain

    table = []
    for kernel, cases, main_label in (
        ("ln_mlp", ln_cases, "vision"), ("preprocess", pre_cases, "bf16"), ("fused_mixer_block", block_cases, "vision"),
    ):
        timed = {}
        for label, case in cases.items():
            if kernel == "fused_mixer_block":
                block, x = case.pop("block"), case.pop("x")
                ms = cuda_ms(lambda: fused_mixer_block_tbd(block, x), iters=20)
                plain_ms = cuda_ms(lambda: mixer_block_plain(block, x), iters=5)
                if "stage_inputs" in case:  # bf16: three launches, each timed alone
                    (xl, z, y2, h), p = case.pop("stage_inputs"), kmb.block_params(block, x.dtype)
                    case["stage_ms"] = {
                        "token_mix": cuda_ms(lambda: kmb.token_mix(xl, *p[:8]), iters=20),
                        "linear_gelu": cuda_ms(lambda: kln.linear_gelu(rows(y2), p[8], p[9]), iters=20),
                        "linear_residual": cuda_ms(lambda: kln.linear_residual(h, p[10], p[11], rows(z)), iters=20),
                    }
                    t_bytes, t_ops = token_mix_cost(case["B"], case["T"], case["D"], case["U"], x.dtype)
                    case["token_mix_bound_ms"], case["token_mix_bound_by"] = bound(t_bytes, t_ops, x.dtype)
                    # the model's own bf16 block (fused_mlp=False) on the same [B, T, D] input
                    x_btd = x.transpose(0, 1).contiguous()
                    with torch.inference_mode():
                        case["torch_chain_ms"] = cuda_ms(lambda: block(x_btd), iters=20)
                n_bytes, n_ops = block_cost(case["B"], case["T"], case["D"], case["U"], case["H"], x.dtype)
                dtype = x.dtype
            elif kernel == "ln_mlp":
                args = case.pop("args")
                ms = cuda_ms(lambda: kln.ln_mlp(*args), iters=20)
                plain_ms = cuda_ms(lambda: kln.ln_mlp_plain(*args), iters=5)
                if "stage_inputs" in case:  # bf16: three launches, each timed alone
                    (y, h), (x, ln_w, ln_b, w_in, b_in, w_out, b_out) = case.pop("stage_inputs"), args
                    case["stage_ms"] = {
                        "ln_rows": cuda_ms(lambda: kln.ln_rows(x, ln_w, ln_b), iters=20),
                        "linear_gelu": cuda_ms(lambda: kln.linear_gelu(y, w_in, b_in), iters=20),
                        "linear_residual": cuda_ms(lambda: kln.linear_residual(h, w_out, b_out, x), iters=20),
                    }
                    case["torch_chain_ms"] = cuda_ms(lambda: torch_chain(*args), iters=20)
                n_bytes, n_ops = ln_mlp_cost(case["R"], case["W"], case["H"], args[0].dtype)
                dtype = args[0].dtype
            else:
                if "imgs" not in case:  # checked, not timed
                    timed[label] = case
                    continue
                imgs, bands = case.pop("imgs"), case.pop("bands")
                dtype = torch.bfloat16 if case["dtype"] == str(torch.bfloat16) else torch.float32
                ms = cuda_ms(lambda: kpre.preprocess(imgs, bands, dtype), iters=20)
                # cold: fresh batches, more than twice the L2 in all, in turn
                rot = [torch.randint_like(imgs, 0, 256) for _ in range(max(4, -(-2 * L2_BYTES // imgs.numel())))]
                case["ms_cold"] = cuda_ms_cycling(lambda v: kpre.preprocess(v, bands, dtype), rot, iters=2 * len(rot))
                case["cold_batches"] = len(rot)
                del rot
                plain_ms = cuda_ms(lambda: kpre.preprocess_plain(imgs, bands, dtype), iters=5)
                n_bytes, n_ops = preprocess_cost(bands, case["B"], dtype)
                # the preprocess arithmetic is f32 whatever it stores
                dtype = torch.float32
            bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
            timed[label] = dict(case, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                bytes=n_bytes, operations=n_ops)
            log(f"{kernel} {label}: {ms:.4f} ms{' (cold ' + format(case['ms_cold'], '.4f') + ')' if 'ms_cold' in case else ''}"
                f" (plain {plain_ms:.4f}, bound {bound_ms:.4f} by {bound_by}"
                + (f", torch chain {case['torch_chain_ms']:.4f}, stages {case['stage_ms']}" if "stage_ms" in case else "")
                + ")")
        main = timed.pop(main_label)
        source = {
            "ln_mlp": "clip_mixer_tpu_torch/csrc/ln_mlp.cu",
            "preprocess": "clip_mixer_tpu_torch/csrc/preprocess.cu",
            "fused_mixer_block": "clip_mixer_tpu_torch/csrc/mixer_block.cu",
        }
        replaces = {
            "ln_mlp": "clip_mixer_tpu/ops/pallas/mlp_kernel.py:61",
            "preprocess": "clip_mixer_tpu/ops/pallas/preprocess_kernel.py:72",
            "fused_mixer_block": "clip_mixer_tpu/ops/pallas/block_kernel.py:127",
        }
        table.append({
            "name": kernel,
            "route": "cuda",
            "source": source[kernel],
            "replaces": replaces[kernel],
            "launches": launches[kernel],
            "shape": main_label,
            **main,
            # no single PyTorch call computes the same function (a fused
            # LN + two-layer MLP; a cropped antialiased bicubic resize of
            # uint8 NHWC with CLIP normalisation; a whole mixer block)
            "library_ms": None,
            "other_cases": timed,
        })
    return table


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from clip_mixer_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build(_build.all_sources())
    build_s = time.perf_counter() - t0
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "wgmma", "setmaxnreg")) or "error" in line.lower():
                log(f"ptxas {name}: {line.strip()}")
    log(f"built {_build.all_sources()} in {build_s:.1f} s")

    ln_cases = check_ln_mlp(dev)
    pre_cases = check_preprocess(dev)
    block_cases = check_mixer_block(dev)
    check_token_mix(block_cases)
    check_gradients(dev)
    check_small_model(dev)
    torch.cuda.synchronize()

    counters = Counters()
    summary, launches = main_path(dev, counters)
    for name in ("ln_mlp", "preprocess"):
        require(launches[name] > 0, f"the main path never launched {name}")
    summary["build_s"] = build_s
    emit({"main_path": summary})

    block_summary, block_launches, model = fused_block_path(dev, counters)
    for name in ("fused_mixer_block", "preprocess"):
        require(block_launches[name] > 0, f"the fused-block path never launched {name}")
    emit({"fused_block_path": block_summary})

    emit({"towers_bucket128_ms": time_towers(model, dev)})
    del model
    # each kernel's launches on the path that carries it
    path_launches = {"ln_mlp": launches["ln_mlp"], "preprocess": launches["preprocess"],
                     "fused_mixer_block": block_launches["fused_mixer_block"]}
    emit({"kernels": time_kernels(ln_cases, pre_cases, block_cases, path_launches)})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
