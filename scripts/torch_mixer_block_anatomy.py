"""Where the bf16 whole block's time goes: its three launches timed one by one,
and the token kernel against timing-only variants of its own source.

    python scripts/torch_mixer_block_anatomy.py

In bf16 a mixer block is three kernels on one stream (``csrc/mixer_block.cu``):
the token kernel (z = x + the token MLP into ``out``, and y2 = LN_ch(z) into a
scratch), GEMM 1 with the QuickGELU epilogue (h = QuickGELU(y2 W3^T + b3) into
a second scratch) and GEMM 2 with the residual epilogue (out = z + h W4^T + b4,
in place); both GEMMs are ``csrc/gemm_sm90.cuh``'s wgmma + TMA kernel. This
script calls each stage's C entry, and the whole block's, back to back on
preallocated buffers (no Python wrapper between launches), with x as the
tower holds it ([B, T, D], read through its [T, B, D] strides).

The variants cut ``mixer_block.cu`` by exact text (a cut that no longer
matches stops the script with an error naming it) and are timed through the
token kernel's C entry; their outputs are garbage, only their times mean
anything:

- ``empty``: the kernel returns at once (a launch of its shape).
- ``stage_only``: it returns after staging x and the token weights and
  taking LN_tok's statistics.
- ``no_gelu``: QuickGELU is the identity.
- ``no_p2``: the second, register-A product is removed.
- ``p2_twice``: the second product is issued twice.
- ``three_wg``: three warpgroups a block instead of four.

It prints one JSON line per shape (both towers at bucket 128, and the vision
tower at bucket 8) with the mean ms of each launch and variant, the token
kernel's GB/s (x read, z and y2 written) and its bound, each GEMM's achieved
TFLOP/s, and the card's name and power limit.

Needs a CUDA device and ``nvcc``; the package's library is built into
``build/kernels/``, the variants into ``build/anatomy_block/``.
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
from clip_mixer_tpu_torch.ops.kernels import mixer_block as kmb  # noqa: E402

SHAPES = [("vision", 128, 50, 768), ("text", 128, 77, 512), ("vision_b8", 8, 50, 768)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12

_ENTRY = "  extern __shared__ unsigned char smem_raw[];\n  unsigned char* smem = smem_raw"
_STATS_END = "  __syncthreads();\n\n  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128;"
_GELU = "float quick_gelu_fast(float h) { return __fdividef(h, 1.0f + __expf(-1.702f * h)); }"
_P2 = """      for (int k = 0; k < UC / 16; ++k)
        wgmma_rs<TP>(zacc, a[k], w2_desc + 2 * cm_lbo(TP) * (n0 / 16 + k), n0 > 0 || k > 0);"""
# variant: ((text, replacement), ...); each text occurs once in mixer_block.cu
_CUTS = {
    "empty": ((_ENTRY, "  return;\n" + _ENTRY),),
    "stage_only": ((_STATS_END, _STATS_END.replace("__syncthreads();\n", "__syncthreads();\n  return;\n", 1)),),
    "no_gelu": ((_GELU, "float quick_gelu_fast(float h) { return h; }"),),
    "no_p2": ((_P2, ""),),
    "p2_twice": ((_P2, _P2 + "\n" + _P2),),
    "three_wg": (("constexpr int TM_WG = 4;", "constexpr int TM_WG = 3;"),),
}


def build_variants():
    """The token kernel's C entry of each variant, built side by side."""
    src = (_build.CSRC_DIR / "mixer_block.cu").read_text()
    out = _build.BUILD_DIR.parent / "anatomy_block"
    procs = {}
    for name, cuts in _CUTS.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise RuntimeError(f"mixer_block.cu no longer contains {old!r} once: update the {name} variant")
            text = text.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        (d / "mixer_block.cu").write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "libmixer_block.so"), str(d / "mixer_block.cu")]
        procs[name] = (d / "libmixer_block.so", subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                                 text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        fn = ctypes.CDLL(str(lib)).mixer_block_token_mix
        fn.argtypes = kmb._ARGTYPES["mixer_block_token_mix"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


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
        print("mixer_block_anatomy: no CUDA device is available", file=sys.stderr)
        return 1
    lib, variants = kmb._lib(), build_variants()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    stream = torch.cuda.current_stream().cuda_stream
    for label, B, T, D in SHAPES:
        U, H, R = 4 * T, 4 * D, B * T
        g = torch.Generator().manual_seed(R)
        shapes = [(D,), (D,), (U, T), (U,), (T, U), (T,), (D,), (D,), (H, D), (H,), (D, H), (D,)]
        params = [(0.05 * torch.randn(s, generator=g)).to("cuda", torch.bfloat16) for s in shapes]
        x = torch.randn(B, T, D, generator=g).to("cuda", torch.bfloat16)
        out = torch.empty_like(x)
        y2 = torch.empty((R, D), device="cuda", dtype=torch.bfloat16)
        h = torch.empty((R, H), device="cuda", dtype=torch.bfloat16)
        p = [t.data_ptr() for t in params]
        ts, ss = D, T * D  # the [T, B, D] view of a contiguous [B, T, D]
        calls = {
            "token_mix": lambda: lib.mixer_block_token_mix(x.data_ptr(), out.data_ptr(), y2.data_ptr(), ts, ss, B, T, U,
                                                           D, *p[:8], stream),
            "linear_gelu": lambda: lib.mixer_block_linear_gelu(y2.data_ptr(), p[8], p[9], h.data_ptr(), R, H, D, stream),
            "linear_residual": lambda: lib.mixer_block_linear_residual(h.data_ptr(), p[10], p[11], out.data_ptr(),
                                                                       R, D, H, stream),
            "block": lambda: lib.mixer_block_bf16(x.data_ptr(), out.data_ptr(), ts, ss, B, T, U, D, H, *p,
                                                  y2.data_ptr(), h.data_ptr(), stream),
        }
        row = {"shape": label, "B": B, "T": T, "D": D, "U": U, "H": H, "device": card}
        for name, fn in calls.items():
            _build.check(fn(), name)
            row[f"{name}_ms"] = cuda_ms(fn)
        token_args = [x.data_ptr(), out.data_ptr(), y2.data_ptr(), ts, ss, B, T, U, D, *p[:8], stream]
        row["token_mix_variants_ms"] = {}
        for name, fn in variants.items():
            _build.check(fn(*token_args), f"token_mix {name}")
            row["token_mix_variants_ms"][name] = cuda_ms(lambda: fn(*token_args))
        row["stages_sum_ms"] = row["token_mix_ms"] + row["linear_gelu_ms"] + row["linear_residual_ms"]
        token_bytes = 2 * (3 * R * D + 2 * T * U + 4 * D + U + T)  # x in, z and y2 out, token weights, vectors
        token_ops = 2 * B * D * 2 * T * U
        row["token_mix_gbps"] = token_bytes / row["token_mix_ms"] / 1e6
        row["token_mix_bound_ms"] = max(token_bytes / HBM_BYTES_PER_S, token_ops / BF16_OPS_PER_S) * 1e3
        gemm_flop = 2 * R * D * H
        row["linear_gelu_tflops"] = gemm_flop / row["linear_gelu_ms"] / 1e9
        row["linear_residual_tflops"] = gemm_flop / row["linear_residual_ms"] / 1e9
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
