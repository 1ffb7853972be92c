"""Preflight of the port: fast, hang-proof go / no-go checks before a run.

  1. tokenizer: the vocabulary loads and a probe string tokenizes
  2. the C++ fast tokenizer builds and loads (the serving engine and the
     data sources use it; there is no fallback, so a failed build is a FAIL)
  3. the CUDA kernels build with nvcc from ``csrc/`` (the card's path runs
     them and nothing falls back: a FAIL on the card; on ``--device cpu``,
     whose path runs their plain versions, a warning)
  4. the device: probed in a SUBPROCESS under a hard timeout, so a wedged
     card reports FAIL instead of hanging the preflight; names the card
  5. the build directory (kernels, tokenizer) is writable
  6. --data: the shard glob matches, its first shard opens, a sample decodes
  7. --preset/--devices/--global-batch: a parallelism plan fits --hbm-gib
     (``utils/memory.suggest``)
  8. --full: a 2-step CPU training run on ``mixer-debug`` (trainer,
     checkpoint, export)

Usage:
    python scripts/torch_preflight.py [--device cuda] [--data '/data/shards/*.tar']
                                      [--preset mixer-b32 --devices 8
                                       --global-batch 8192 --hbm-gib 80]
                                      [--device-timeout 60] [--full]

Exit code: the number of FAILed checks (0 = go).
"""

import argparse
import glob
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

_RESULTS = []


def report(name: str, ok, detail: str = ""):
    status = {True: "PASS", False: "FAIL", None: "warn"}[ok]
    _RESULTS.append((name, ok))
    print(f"[{status}] {name}" + (f": {detail}" if detail else ""), flush=True)


def check_tokenizer():
    try:
        from clip_mixer_tpu_torch.text import get_tokenizer, tokenize

        tok = get_tokenizer()
        arr = tokenize(["a photo of a cat"])
        assert arr.shape[0] == 1 and arr[0, 0] == tok.sot_id
        report("tokenizer + vocab asset", True, f"vocab {tok.vocab_size}")
    except Exception as e:
        report("tokenizer + vocab asset", False, repr(e))


def check_fast_tokenizer():
    try:
        from clip_mixer_tpu_torch.text import fast

        t0 = time.perf_counter()
        fast.build()
        ids = fast.fast_tokenize(["a photo of a cat"])
        assert ids.shape == (1, 77)
        report("C++ fast tokenizer", True, f"built and loaded in {time.perf_counter() - t0:.1f} s")
    except Exception as e:
        report("C++ fast tokenizer", False, f"does not build (no fallback): {e!r}"[:600])


def check_kernels(device: str):
    from clip_mixer_tpu_torch.ops.kernels import _build

    names = _build.all_sources()
    if not device.startswith("cuda"):
        report("CUDA kernels (nvcc)", None, f"not built: the {device} path runs the plain versions of {names}")
        return
    try:
        t0 = time.perf_counter()
        _build.build(names)
        report("CUDA kernels (nvcc)", True, f"{names} built in {time.perf_counter() - t0:.1f} s into "
                                            f"{_build.BUILD_DIR}")
    except Exception as e:
        report("CUDA kernels (nvcc)", False, f"the card's path needs them and nothing falls back: {e!r}"[:800])


_PROBE = """
import sys, torch
dev = sys.argv[1]
if dev.startswith("cuda"):
    n = torch.cuda.device_count()
    if n == 0:
        sys.exit("no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    print(f"{n} x {torch.cuda.get_device_name(0)} (sm_{cap[0]}{cap[1]}), torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
else:
    print(f"{dev}: torch {torch.__version__}, {torch.get_num_threads()} threads")
"""


def check_device(device: str, timeout_s: int):
    try:
        proc = subprocess.run([sys.executable, "-c", _PROBE, device], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        report("device", False, f"the probe hung past {timeout_s}s (a wedged card?)")
        return
    out = proc.stdout.decode(errors="replace").strip().splitlines()
    if proc.returncode == 0 and out:
        report("device", True, out[-1])
    else:
        report("device", False, f"rc={proc.returncode}: {proc.stderr.decode(errors='replace').strip()[-300:]}")


def check_build_dir():
    path = REPO / "build"
    try:
        path.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=path, prefix=".preflight"):
            pass
        report("build dir", True, str(path))
    except OSError as e:
        report("build dir", False, f"{path}: {e}")


def check_data(pattern: str):
    shards = sorted(glob.glob(pattern))
    if not shards:
        report("data shards", False, f"no shards match {pattern}")
        return
    try:
        from clip_mixer_tpu_torch.data.pipeline import TarShardSource

        src = TarShardSource(shards[:1], batch_size=1, image_size=64, context_length=77)
        batch = next(iter(src.iter_batches(0)))
        report("data shards", True, f"{len(shards)} shard(s); first sample decodes to {batch['images'].shape[1:]}")
    except Exception as e:
        report("data shards", False, f"first shard unreadable: {e!r}")


def check_capacity(preset: str, devices: int, global_batch: int, hbm_gib: float, remat: bool = True):
    try:
        from clip_mixer_tpu_torch.config import PRESETS
        from clip_mixer_tpu_torch.utils.memory import suggest

        # priced at the remat mode the run uses (train_cli: on unless --no-remat)
        best, _ = suggest(PRESETS[preset].replace(remat=remat), devices, global_batch,
                          hbm_bytes=int(hbm_gib * (1 << 30)))
        if best is None:
            report("capacity plan", False,
                   f"nothing fits {hbm_gib:g} GiB/card: see scripts/torch_memory_plan.py --suggest")
        else:
            report("capacity plan", True, f"{best.mode} fits: {best.total_bytes / (1 << 30):.2f} GiB/card")
    except Exception as e:
        report("capacity plan", False, repr(e))


def check_train_smoke():
    try:
        from clip_mixer_tpu_torch.config import PRESETS, TrainConfig
        from clip_mixer_tpu_torch.data.pipeline import SyntheticSource
        from clip_mixer_tpu_torch.train.trainer import Trainer

        cfg = PRESETS["mixer-debug"]
        tcfg = TrainConfig(global_batch_size=4, epochs=1, learning_rate=1e-3, warmup_steps=1,
                           checkpoint_every_steps=2)
        run = os.path.join(tempfile.mkdtemp(prefix="preflight_"), "run")
        data = SyntheticSource(batch_size=4, image_size=cfg.image_resolution, n_batches=2,
                               context_length=cfg.context_length)
        Trainer(cfg, tcfg, data, run, device="cpu").train()
        assert os.path.exists(os.path.join(run, "export", "config.json"))
        report("CPU train smoke", True, "2 steps + checkpoint + export")
    except Exception as e:
        report("CPU train smoke", False, repr(e))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="the device the run trains on (cuda, or cpu)")
    p.add_argument("--data", default=None, help="shard glob to validate")
    p.add_argument("--preset", default=None, help="preset for the capacity check")
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--global-batch", type=int, default=8192)
    p.add_argument("--hbm-gib", type=float, default=80.0, help="memory a card (H100: 80)")
    p.add_argument("--no-remat", action="store_true", help="price a train_cli --no-remat run")
    p.add_argument("--device-timeout", type=int, default=60)
    p.add_argument("--full", action="store_true", help="add the CPU training smoke")
    args = p.parse_args(argv)

    check_tokenizer()
    check_fast_tokenizer()
    check_kernels(args.device)
    check_device(args.device, args.device_timeout)
    check_build_dir()
    if args.data:
        check_data(args.data)
    if args.preset:
        check_capacity(args.preset, args.devices, args.global_batch, args.hbm_gib, remat=not args.no_remat)
    if args.full:
        check_train_smoke()

    failures = sum(1 for _, ok in _RESULTS if ok is False)
    print(("NO-GO" if failures else "GO") + f": {failures} failed check(s)", flush=True)
    return failures


if __name__ == "__main__":
    sys.exit(main())
