"""Where the preprocess kernel's time goes: the wrapper timed warm and cold,
and the kernel against timing-only variants of its own source.

    python scripts/torch_preprocess_anatomy.py                 # this tree, with the variants
    python scripts/torch_preprocess_anatomy.py --root DIR --no-variants   # another tree's package

Times ``ops/kernels/preprocess.py::preprocess`` (the package found under
``--root``, default this repository) on uint8 256x256 images -> 224, at
B = 128 in bf16 and f32 and at B = 8 in bf16, with CUDA events: warm (20
calls on the same inputs) and cold (calls cycling through fresh batches that
hold more than twice the 50 MB L2 in all). Only the wrapper's Python API is
used, so ``--root`` may name another version of the package (an unpacked
``git archive`` of a parent commit), built into its own ``build/kernels/``.

The variants cut ``csrc/preprocess.cu`` by exact text (a cut that no longer
matches stops the script with an error naming it) and are timed cold at B =
128, bf16, through the kernel's C entry with the wrapper's own plan; their
outputs are garbage, only their times mean anything:

- ``copy_only``: the units' input copies and waits, no pass (the memory
  reads alone, with the barriers);
- ``no_copy``: the passes on whatever the stages hold, no input copy;
- ``no_vertical``: the vertical sums left out;
- ``no_horizontal``: the horizontal sums and the output stores left out;
- ``taps_at_run_time``: the kernel without its five-tap specialisation, the
  tap counts read at run time (its output is right: the same sums in the
  same order).

It prints one JSON line: the times, the bytes bound, and the card's name and
power limit. Needs a CUDA device and ``nvcc``; the variants build into
``build/anatomy_preprocess/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20

_H = "      if (ph >= 1 && lane < a.PW) {"
_V = "      // vertical pass of q = ph: four pixels (12 bytes) of a row a thread\n      if (ph < nq) {"
_C = "  unsigned char* buf = stage + (start & 15);\n"
_K = "  if (KH == 5 && KW == 5) return (int)launch_as<T, true, 5>(a, smem, grid, s);\n"


def _off(marker: str) -> tuple:
    return marker, marker.rsplit("if (", 1)[0] + "if (false) {"


VARIANTS = {
    "copy_only": [_off(_H), _off(_V)],
    "no_copy": [(_C, _C + "  if (threadIdx.x == 0) mbar_arrive(bar);\n  if (n > 0) return;\n")],
    "no_vertical": [_off(_V)],
    "no_horizontal": [_off(_H)],
    "taps_at_run_time": [(_K, "")],
}


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

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


def cycling(fn, inputs, iters: int) -> float:
    turn = iter(range(10**9))
    return cuda_ms(lambda: fn(inputs[next(turn) % len(inputs)]), iters)


def fresh_batches(imgs):
    import torch

    return [torch.randint_like(imgs, 0, 256) for _ in range(max(4, -(-2 * L2_BYTES // imgs.numel())))]


def build_variants(nvcc_flags, nvcc) -> dict:
    src = (REPO / "clip_mixer_tpu_torch" / "csrc" / "preprocess.cu").read_text()
    out_dir = REPO / "build" / "anatomy_preprocess"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, cuts in VARIANTS.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: its cut no longer matches csrc/preprocess.cu exactly once")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        cmd = [nvcc, *nvcc_flags, "-I", str(REPO / "clip_mixer_tpu_torch" / "csrc"), "-o", str(lib), str(cu)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO), help="the tree whose clip_mixer_tpu_torch is timed")
    ap.add_argument("--no-variants", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_preprocess_anatomy: no CUDA device", file=sys.stderr)
        return 1
    from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre

    dev = torch.device("cuda")
    bands = kpre.ResizeBands.build((256, 256), 224, dev)
    g = torch.Generator().manual_seed(0)
    res = {"root": os.path.abspath(args.root), "package": os.path.dirname(kpre.__file__)}
    for label, B, dtype in (("b128_bf16", 128, torch.bfloat16), ("b128_f32", 128, torch.float32),
                            ("b8_bf16", 8, torch.bfloat16)):
        imgs = torch.randint(0, 256, (B, 256, 256, 3), dtype=torch.uint8, generator=g).to(dev)
        rot = fresh_batches(imgs)
        e = torch.finfo(dtype).bits // 8
        res[label] = {
            "warm_ms": cuda_ms(lambda: kpre.preprocess(imgs, bands, dtype), iters=20),
            "cold_ms": cycling(lambda v: kpre.preprocess(v, bands, dtype), rot, iters=2 * len(rot)),
            "bytes_bound_ms": (B * 256 * 256 * 3 + B * 224 * 224 * 3 * e) / HBM_BYTES_PER_S * 1e3,
        }
        del rot
    if not args.no_variants:
        from clip_mixer_tpu_torch.ops.kernels import _build

        libs = {"full": kpre._lib(), **build_variants(_build.NVCC_FLAGS, _build.nvcc_path())}
        imgs = torch.randint(0, 256, (128, 256, 256, 3), dtype=torch.uint8, generator=g).to(dev)
        rot = fresh_batches(imgs)
        plan, table = kpre._plan(bands, 128)
        out = torch.empty((128, 224, 224, 3), dtype=torch.bfloat16, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def entry(lib):
            fn = lib.preprocess_u8_bf16
            fn.argtypes = kpre._ARGTYPES
            fn.restype = ctypes.c_int

            def call(v):
                rc = fn(v.data_ptr(), bands.rh_taps.data_ptr(), bands.rh_start.data_ptr(), bands.rh_taps.shape[1],
                        bands.rw_taps.data_ptr(), bands.rw_start.data_ptr(), bands.rw_taps.shape[1],
                        bands.norm.data_ptr(), table.data_ptr(), out.data_ptr(), 128, 256, 256, 224, plan.rows,
                        plan.group, plan.n_bands, plan.stage_bytes, plan.warp_pixels, plan.smem_bytes, plan.grid,
                        stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")
            return call

        res["variants_cold_ms_b128_bf16"] = {
            name: cycling(entry(lib), rot, iters=2 * len(rot)) for name, lib in libs.items()
        }
        res["plan_b128_bf16"] = dict(rows=plan.rows, group=plan.group, n_bands=plan.n_bands,
                                     warp_pixels=plan.warp_pixels, smem_bytes=plan.smem_bytes,
                                     ctas_per_sm=plan.ctas_per_sm, grid=plan.grid)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    res["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
