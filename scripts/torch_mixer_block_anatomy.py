"""Where the bf16 whole-block kernel's time goes: the kernel against
timing-only variants of its own source, built side by side.

    python scripts/torch_mixer_block_anatomy.py

The variants cut ``mixer_block.cu`` by exact text; a cut that no longer
matches the source stops the script with an error naming it.

- ``token_only``: the kernel returns after the token half (z stored).
- ``stage_only``: the kernel returns after staging the token weights in
  shared memory and taking the rows' LN statistics.
- ``token_no_mma``: ``token_only`` with the token half's MMAs removed.
- ``channel_only``: the token half's column loop is skipped (the token
  weights are still staged and the row statistics taken); the channel mix
  runs on whatever ``out`` holds.

The variants' outputs are garbage; only their times mean anything. Prints one
JSON line per shape (both towers at bucket 128, vision at bucket 8) with the
mean ms of each build, and the card's name and power limit. Needs a CUDA
device and ``nvcc``; builds into ``build/anatomy_block/``.
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
from clip_mixer_tpu_torch.ops.kernels.mixer_block import _ARGTYPES  # noqa: E402

# variant: ((text, replacement, times the text occurs), ...)
_RETURN_AFTER_TOKENS = ("channel_mix_bf16<NF, RTM>(zb", "return;\n  channel_mix_bf16<NF, RTM>(zb", 1)
_CUTS = {
    "full": (),
    "token_only": (_RETURN_AFTER_TOKENS,),
    "stage_only": (("  const int r = lane / 2, cc", "  return;\n  const int r = lane / 2, cc", 1),),
    "token_no_mma": (_RETURN_AFTER_TOKENS, ("wmma::mma_sync(acc, a, b, acc);", ";", 2)),
    "channel_only": (("for (int d0 = 0; d0 < D; d0 += DC) {", "for (int d0 = 0; d0 < 0; d0 += DC) {", 1),),
}
SHAPES = [("vision", 128, 50, 768), ("text", 128, 77, 512), ("vision_b8", 8, 50, 768)]


def variant_source(name: str, src: str) -> str:
    for old, new, times in _CUTS[name]:
        if src.count(old) != times:
            raise RuntimeError(f"mixer_block.cu no longer contains {old!r} {times} times: update the {name} variant")
        src = src.replace(old, new)
    return src


def build_variants():
    out_dir = _build.BUILD_DIR.parent / "anatomy_block"
    src = (_build.CSRC_DIR / "mixer_block.cu").read_text()
    header = (_build.CSRC_DIR / "channel_mix.cuh").read_text()
    procs = {}
    for n in _CUTS:
        d = out_dir / n
        d.mkdir(parents=True, exist_ok=True)
        (d / "mixer_block.cu").write_text(variant_source(n, src))
        (d / "channel_mix.cuh").write_text(header)
        lib = d / "libmixer_block.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / "mixer_block.cu")]
        procs[n] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for n, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {n} variant:\n{log}")
        fn = ctypes.CDLL(str(lib)).mixer_block_bf16
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        fns[n] = fn
    return fns


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
        print("mixer_block_anatomy: no CUDA device is available", file=sys.stderr)
        return 1
    fns = build_variants()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for label, B, T, D in SHAPES:
        U, H = 4 * T, 4 * D
        g = torch.Generator().manual_seed(B * T)
        shapes = [(D,), (D,), (U, T), (U,), (T, U), (T,), (D,), (D,), (H, D), (H,), (D, H), (D,)]
        params = [(0.05 * torch.randn(s, generator=g)).to("cuda", torch.bfloat16) for s in shapes]
        x = torch.randn(T, B, D, generator=g).to("cuda", torch.bfloat16)
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        args = [x.data_ptr(), out.data_ptr(), x.stride(0), x.stride(1), B, T, U, D, H,
                *(p.data_ptr() for p in params), stream]
        row = {"shape": label, "B": B, "T": T, "D": D, "device": smi}
        for n, fn in fns.items():
            _build.check(fn(*args), f"mixer_block {n}")
            row[f"{n}_ms"] = cuda_ms(lambda: fn(*args))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
