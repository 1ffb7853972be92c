"""Where the bf16 ``ln_mlp``'s time goes: its three launches timed one by one.

    python scripts/torch_ln_mlp_anatomy.py

In bf16, ``ln_mlp`` is three kernels on one stream (``csrc/ln_mlp.cu``): the
LN pass (y = LN(x) into a scratch), GEMM 1 with the QuickGELU epilogue
(h = QuickGELU(y W_in^T + b_in) into a second scratch) and GEMM 2 with the
residual epilogue (out = x + h W_out^T + b_out); both GEMMs are
``csrc/gemm_sm90.cuh``'s wgmma + TMA kernel. This script calls each stage's
C entry, and the whole call's, back to back on preallocated buffers (no
Python wrapper between launches), and prints one JSON line per shape (the
towers at bucket 128, and the vision tower at bucket 8) with the mean ms of
each, each GEMM's achieved TFLOP/s, the LN pass's GB/s, and the card's name
and power limit.

The GEMM takes 128-wide output tiles where 256-wide ones would not make two
waves of blocks on the card (``gemm_sm90.cuh``'s ``gemm``). To show what that
rule buys, the script also builds ``ln_mlp.cu`` with the rule cut to
"256-wide wherever N % 256 == 0" (by exact text; a cut that no longer
matches stops the script) and times both GEMMs of that build too
(``fixed_width_*``).

Needs a CUDA device and ``nvcc``; the package's library is built into
``build/kernels/``, the variant into ``build/anatomy/``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clip_mixer_tpu_torch.ops.kernels import _build  # noqa: E402
from clip_mixer_tpu_torch.ops.kernels import ln_mlp as kln  # noqa: E402

SHAPES = [("vision", 128 * 50, 768, 3072), ("text", 128 * 77, 512, 2048), ("vision_b8", 8 * 50, 768, 3072)]


_RULE = "const bool wide = N % 256 == 0 && (long long)((M + BM - 1) / BM) * (N / 256) >= 2LL * sms;"


def fixed_width_lib() -> ctypes.CDLL:
    """``ln_mlp.cu`` built with 256-wide tiles wherever N % 256 == 0."""
    header = (_build.CSRC_DIR / "gemm_sm90.cuh").read_text()
    if _RULE not in header:
        raise RuntimeError(f"gemm_sm90.cuh no longer contains {_RULE!r}: update the fixed-width variant")
    out = _build.BUILD_DIR.parent / "anatomy" / "fixed_width"
    out.mkdir(parents=True, exist_ok=True)
    for name in ("ln_mlp.cu", "channel_mix.cuh"):
        shutil.copy(_build.CSRC_DIR / name, out / name)
    (out / "gemm_sm90.cuh").write_text(header.replace(_RULE, "const bool wide = N % 256 == 0;"))
    lib = out / "libln_mlp.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / "ln_mlp.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the fixed-width variant:\n{proc.stdout}{proc.stderr}")
    variant = ctypes.CDLL(str(lib))
    for name, argtypes in kln._ARGTYPES.items():
        getattr(variant, name).argtypes = argtypes
    return variant


def cuda_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after two."""
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("ln_mlp_anatomy: no CUDA device is available", file=sys.stderr)
        return 1
    lib, fixed = kln._lib(), fixed_width_lib()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    stream = torch.cuda.current_stream().cuda_stream
    for label, R, W, H in SHAPES:
        g = torch.Generator().manual_seed(R)
        shapes = [(R, W), (W,), (W,), (H, W), (H,), (W, H), (W,)]
        x, lw, lb, wi, bi, wo, bo = [(0.05 * torch.randn(s, generator=g)).to("cuda", torch.bfloat16) for s in shapes]
        y, h, out = torch.empty_like(x), torch.empty((R, H), device="cuda", dtype=torch.bfloat16), torch.empty_like(x)
        p = {k: t.data_ptr() for k, t in dict(x=x, lw=lw, lb=lb, wi=wi, bi=bi, wo=wo, bo=bo, y=y, h=h, out=out).items()}
        calls = {
            "ln_rows": lambda: lib.ln_mlp_ln_rows(p["x"], p["lw"], p["lb"], p["y"], R, W, stream),
            "linear_gelu": lambda: lib.ln_mlp_linear_gelu(p["y"], p["wi"], p["bi"], p["h"], R, H, W, stream),
            "linear_residual": lambda: lib.ln_mlp_linear_residual(p["h"], p["wo"], p["bo"], p["x"], p["out"],
                                                                  R, W, H, stream),
            "ln_mlp": lambda: lib.ln_mlp_bf16(p["x"], p["lw"], p["lb"], p["wi"], p["bi"], p["wo"], p["bo"],
                                              p["out"], p["y"], p["h"], R, W, H, stream),
            "fixed_width_linear_gelu": lambda: fixed.ln_mlp_linear_gelu(p["y"], p["wi"], p["bi"], p["h"], R, H, W,
                                                                        stream),
            "fixed_width_linear_residual": lambda: fixed.ln_mlp_linear_residual(
                p["h"], p["wo"], p["bo"], p["x"], p["out"], R, W, H, stream),
        }
        row = {"shape": label, "R": R, "W": W, "H": H, "device": card}
        for name, fn in calls.items():
            _build.check(fn(), name)
            row[f"{name}_ms"] = cuda_ms(fn)
        row["stages_sum_ms"] = row["ln_rows_ms"] + row["linear_gelu_ms"] + row["linear_residual_ms"]
        gemm_flop = 2 * R * W * H
        row["linear_gelu_tflops"] = gemm_flop / row["linear_gelu_ms"] / 1e9
        row["linear_residual_tflops"] = gemm_flop / row["linear_residual_ms"] / 1e9
        row["ln_rows_gbps"] = (2 * R * W * 2 + 2 * W * 2) / row["ln_rows_ms"] / 1e6  # x in, y out, affine
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
