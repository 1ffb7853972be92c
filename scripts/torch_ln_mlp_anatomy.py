"""Where the bf16 ``ln_mlp`` kernel's time goes: the kernel against three
timing-only variants of its own source, built side by side.

    python scripts/torch_ln_mlp_anatomy.py

The variants cut lines out of ``ln_mlp.cu`` by exact text; a cut that no
longer matches the source stops the script with an error naming it.

- ``load_only``: the MMAs removed; the weight tiles still stream through
  the cp.async ring (the L2 -> shared memory cost).
- ``mma_only``: the cp.async copies removed; the MMAs run on whatever the
  ring holds (the in-SM cost: fragment loads, MMAs, barriers).
- ``no_sync``: the per-tile wait and barrier removed.

At these shapes the launcher picks 64-row blocks (32-row ones would not fit
in one wave on an H100).

The variants' outputs are garbage; only their times mean anything. Prints one
JSON line per shape (the towers at bucket 128) with the mean ms of each
build. Needs a CUDA device and ``nvcc``; builds into ``build/anatomy/``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clip_mixer_tpu_torch.ops.kernels import _build  # noqa: E402

_MMAS = (
    "wmma::mma_sync(hacc[i], a, b, hacc[i]);",
    "wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);",
)
_COPY = 'asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s), "l"(gmem));'
_SYNC = "cp_async_wait<S - 2>();\n      __syncthreads();"
SHAPES = [("vision", 128 * 50, 768, 3072), ("text", 128 * 77, 512, 2048)]


def variant_source(name: str, src: str) -> str:
    cuts = {"full": (), "load_only": _MMAS, "mma_only": (_COPY,), "no_sync": (_SYNC,)}[name]
    for cut in cuts:
        if cut not in src:
            raise RuntimeError(f"ln_mlp.cu no longer contains {cut!r}: update the {name} variant")
        src = src.replace(cut, ";")
    return src


def build_variants(names):
    out_dir = _build.BUILD_DIR.parent / "anatomy"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC_DIR / "ln_mlp.cu").read_text()
    procs = {}
    for n in names:
        cu = out_dir / f"{n}.cu"
        cu.write_text(variant_source(n, src))
        lib = out_dir / f"lib{n}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[n] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for n, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {n} variant:\n{log}")
        libs[n] = ctypes.CDLL(str(lib))
        libs[n].ln_mlp_bf16.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return libs


def cuda_ms(fn, iters: int = 20) -> float:
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
    names = ["full", "load_only", "mma_only", "no_sync"]
    libs = build_variants(names)
    for label, R, W, H in SHAPES:
        g = torch.Generator().manual_seed(R)
        shapes = [(R, W), (W,), (W,), (H, W), (H,), (W, H), (W,)]
        args = [(0.05 * torch.randn(s, generator=g)).to("cuda", torch.bfloat16) for s in shapes]
        out = torch.empty_like(args[0])
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() for a in args] + [out.data_ptr()]
        row = {"shape": label, "R": R, "W": W, "H": H, "device": torch.cuda.get_device_name(0)}
        for n in names:
            fn = libs[n].ln_mlp_bf16
            _build.check(fn(*ptrs, R, W, H, stream), f"ln_mlp {n}")
            row[f"{n}_ms"] = cuda_ms(lambda: fn(*ptrs, R, W, H, stream))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
