#!/usr/bin/env python3
"""Measured serving benchmark of the port: the real HTTP server driven by concurrent clients.

The counterpart of ``scripts/serving_bench.py``, end to end:

* every leg starts the REAL server CLI (``python -m clip_mixer_tpu_torch.serving``)
  as a child process on the card and drives it with the stdlib client
  (``clip_mixer_tpu_torch.client.ServingClient``) from concurrent threads;
* request payloads are JPEG bytes from the dress shards that ``--data``
  matches (server-side PIL decode + resize, the reference clip.py:76-87
  preprocess), captions from the same shards, topped up with synthetic
  JPEGs and captions to the counts the suite slices;
* legs: live bf16, live int8 (calibration artifact), frozen bf16 and
  frozen int8 (``aot.load_servable`` through the CLI's frozen auto-detect),
  then the raw in-process engine without HTTP
  (``scripts/torch_bench_serving.py``, in a child), and cold-start probes
  (time to ``/healthz`` and the first requests, live against frozen);
* per endpoint: client-observed p50 / p99 latency and items/s under
  concurrency, beside the server's own ``/metrics`` snapshot.

The preparation (skipped by ``--skip-prep``) saves the seed-0 ``mixer-b32``
with ``api.save_pretrained``, calibrates it over 512 shard images
(``scripts/torch_calibrate_int8.py``) and freezes it twice
(``scripts/torch_export_servable.py``, bf16 and int8), under
``outputs/serving_bench`` in the working directory, where the logs go too.

Every child runs in the caller's process group and is stopped when the
script ends, SIGTERM included: no server outlives it. Runs on the card
unless ``--device`` names another device; writes ``SERVING_BENCH_TORCH.json``
(never the JAX package's ``SERVING_BENCH.json``) with the card's name and
power limit.

Usage: python scripts/torch_serving_bench.py            # full
       python scripts/torch_serving_bench.py --quick    # half the request counts
"""

import argparse
import atexit
import glob
import io
import json
import os
import signal
import socket
import subprocess
import sys
import tarfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from clip_mixer_tpu_torch.client import ServingClient  # noqa: E402 (stdlib + numpy)

ASSETS = Path("outputs") / "serving_bench"  # under the working directory
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
_CHILDREN = []  # every server started, stopped at exit if it still runs


def sh(cmd, log_name, timeout=1800):
    """Run a preparation child to completion, logging to ASSETS."""
    log = ASSETS / f"{log_name}.log"
    with open(log, "w") as f:
        print(f"[prep] {' '.join(map(str, cmd))}", flush=True)
        subprocess.run([str(c) for c in cmd], env=ENV, stdout=f, stderr=subprocess.STDOUT, timeout=timeout,
                       check=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def load_payloads(n_imgs=512, n_caps=256, data="dress/*.tar"):
    """JPEG bytes + captions from the shards ``data`` matches, topped up
    with synthetic JPEGs and captions to the exact counts."""
    jpegs, caps = [], []
    for shard in sorted(glob.glob(data)):
        if len(jpegs) >= n_imgs and len(caps) >= n_caps:
            break
        try:
            with tarfile.open(shard) as tf:
                for m in tf:
                    if m.name.endswith(".jpg") and len(jpegs) < n_imgs:
                        jpegs.append(tf.extractfile(m).read())
                    elif m.name.endswith(".txt") and len(caps) < n_caps:
                        caps.append(tf.extractfile(m).read().decode())
                    if len(jpegs) >= n_imgs and len(caps) >= n_caps:
                        break
        except (OSError, tarfile.TarError):
            continue
    n_real = len(jpegs)
    if len(jpegs) < n_imgs or len(caps) < n_caps:
        # top up to the exact counts: run_suite slices fixed windows, so a
        # short shard would otherwise post empty batches
        from PIL import Image

        rng = np.random.default_rng(0)
        while len(jpegs) < n_imgs:
            arr = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, "JPEG")
            jpegs.append(buf.getvalue())
        while len(caps) < n_caps:
            caps.append(f"a photo of object number {len(caps)}")
    return jpegs, caps, n_real


class Server:
    """One serving CLI child; stopped on leaving its ``with`` block."""

    def __init__(self, extra_args, log_name, startup_deadline=1200):
        self.port = free_port()
        self.log = open(ASSETS / f"{log_name}.log", "w")
        cmd = [sys.executable, "-m", "clip_mixer_tpu_torch.serving", "--port", str(self.port)] + [
            str(a) for a in extra_args]
        print(f"[serve] {' '.join(cmd)}", flush=True)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, env=ENV, stdout=self.log, stderr=subprocess.STDOUT)
        _CHILDREN.append(self.proc)
        self.client = ServingClient(f"http://127.0.0.1:{self.port}", timeout=600.0, retries=0)
        try:
            deadline = time.time() + startup_deadline
            while True:
                if self.proc.poll() is not None:
                    raise RuntimeError(f"server died at startup, see {self.log.name}")
                try:
                    self.healthz = self.client.healthz()
                    break
                except Exception:
                    if time.time() > deadline:
                        raise RuntimeError(f"server not healthy in {startup_deadline}s")
                    time.sleep(0.25)
        except BaseException:
            self.stop()
            raise
        self.startup_seconds = time.perf_counter() - self.t0

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def stop_children():
    """Kill and reap every server child still running."""
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def hammer(fn, work_items, n_threads):
    """Run fn(item) over work_items from n_threads; return (latencies,
    wall, errors). Latencies only of successful requests."""
    lat, errs = [], []
    lock = threading.Lock()
    it = iter(work_items)

    def worker():
        while True:
            with lock:
                item = next(it, None)
            if item is None:
                return
            t0 = time.perf_counter()
            try:
                fn(item)
            except Exception as e:  # recorded, not fatal: partial evidence
                with lock:
                    errs.append(repr(e))
                continue
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return lat, time.perf_counter() - t0, errs


def stats(lat, wall, items_per_req, errs):
    if not lat:
        return {"error": f"all requests failed: {errs[:2]}"}
    out = {
        "requests": len(lat),
        "concurrent_wall_s": round(wall, 2),
        "items_per_sec": round(len(lat) * items_per_req / wall, 1),
        "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 1),
        "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 1),
    }
    if errs:
        out["errors"] = len(errs)
    return out


def run_suite(srv, jpegs, caps, quick=False):
    """The per-leg endpoint suite; ``srv`` has ``client``,
    ``startup_seconds`` and ``healthz``."""
    c = srv.client
    k = 2 if quick else 1
    out = {"startup_seconds": round(srv.startup_seconds, 1), "healthz": srv.healthz}

    def img_req(n):
        def go(i):
            c.encode_image_files(jpegs[(i * n) % 256:(i * n) % 256 + n])
        return go

    # one untimed request per shape: first calls and the micro-batcher's start out of band
    c.encode_image_files(jpegs[:32])
    c.encode_image_files(jpegs[:128])
    c.encode_image_files(jpegs[:1])
    c.encode_text(caps[:64])

    lat, wall, errs = hammer(img_req(32), range(16 // k), 4)
    out["encode_image_b32"] = stats(lat, wall, 32, errs)
    lat, wall, errs = hammer(img_req(128), range(8 // k), 2)
    out["encode_image_b128"] = stats(lat, wall, 128, errs)
    lat, wall, errs = hammer(img_req(1), range(128 // k), 8)
    out["encode_image_b1_coalesced_8clients"] = stats(lat, wall, 1, errs)

    def text_req(i):
        c.encode_text(caps[(i * 64) % 192:(i * 64) % 192 + 64])
    lat, wall, errs = hammer(text_req, range(12 // k), 4)
    out["encode_text_b64"] = stats(lat, wall, 64, errs)

    def cls_req(i):
        c.classify(jpegs[(i * 32) % 256:(i * 32) % 256 + 32], top_k=5)
    try:
        c.classify(jpegs[:32], top_k=5)  # warm / availability probe
        lat, wall, errs = hammer(cls_req, range(8 // k), 2)
        out["classify_b32_top5"] = stats(lat, wall, 32, errs)
    except Exception as e:
        out["classify_b32_top5"] = {"skipped": repr(e)}

    # retrieval: index 512 images (untimed), then text->image retrieve
    try:
        for i in range(0, 512, 128):
            c.index(jpegs[i:i + 128], [f"img{j}" for j in range(i, i + 128)])

        def ret_req(i):
            c.retrieve(caps[(i * 8) % 248:(i * 8) % 248 + 8], top_k=5)
        c.retrieve(caps[:8], top_k=5)
        lat, wall, errs = hammer(ret_req, range(16 // k), 4)
        out["retrieve_b8_top5"] = stats(lat, wall, 8, errs)
    except Exception as e:
        out["retrieve_b8_top5"] = {"skipped": repr(e)}

    def sim_req(i):
        c.similarity(jpegs[(i * 8) % 256:(i * 8) % 256 + 8], caps[:8])
    c.similarity(jpegs[:8], caps[:8])
    lat, wall, errs = hammer(sim_req, range(6 // k), 2)
    out["similarity_8x8"] = stats(lat, wall, 8, errs)

    out["server_metrics"] = c.metrics()
    return out


def cold_probe(model_arg, log_name, jpegs, device_args):
    """Start WITHOUT --warmup; time /healthz and the first encode requests
    (the first-call tail live serving pays)."""
    with Server(["--model", model_arg, *device_args], log_name) as srv:
        t0 = time.perf_counter()
        srv.client.encode_image_files(jpegs[:32])
        first_b32 = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv.client.encode_image_files(jpegs[:32])
        warm_b32 = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv.client.encode_image_files(jpegs[:1])
        first_b1 = time.perf_counter() - t0
        return {
            "startup_to_healthz_s": round(srv.startup_seconds, 1),
            "first_request_b32_s": round(first_b32, 2),
            "second_request_b32_s": round(warm_b32, 2),
            "first_request_b1_s": round(first_b1, 2),
        }


SAVE_MODEL = ("import sys, torch; from clip_mixer_tpu_torch import CLIP, PRESETS; "
              "from clip_mixer_tpu_torch.api import save_pretrained; cfg = PRESETS[sys.argv[1]]; "
              "save_pretrained(CLIP(cfg, device='cpu', generator=torch.Generator().manual_seed(0)), cfg, sys.argv[2])")


# the raw baseline at another preset than its default (a test's small model): main(argv, preset=)
RAW_RUNNER = "import runpy, sys; runpy.run_path(sys.argv[1])['main'](sys.argv[3:], preset=sys.argv[2])"


def prepare(preset, data, device_args, model, calib, frozen, frozen_int8, names):
    """The seed-0 model saved, calibrated over 512 shard images (synthetic
    ones when ``data`` matches no shard), frozen in bf16 and int8."""
    sh([sys.executable, "-c", SAVE_MODEL, preset, model], "prep_model")
    data_args = ["--data", data] if glob.glob(data) else []
    sh([sys.executable, REPO / "scripts" / "torch_calibrate_int8.py", "--model", model, *data_args, "--n", "512",
        "--out", calib, *device_args], "prep_calib")
    sh([sys.executable, REPO / "scripts" / "torch_export_servable.py", "--model", model, "--out", frozen,
        *device_args], "prep_frozen")
    sh([sys.executable, REPO / "scripts" / "torch_export_servable.py", "--model", model, "--int8", calib,
        "--out", frozen_int8, *device_args], "prep_frozen_int8")
    names.write_text("".join(f"class number {i}\n" for i in range(100)))


def main(argv=None, preset: str = "mixer-b32") -> int:
    """Run the bench as the command line says. ``preset`` lets a test run a
    small model."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--skip-prep", action="store_true", help="reuse existing outputs/serving_bench assets")
    p.add_argument("--out", default="SERVING_BENCH_TORCH.json")
    p.add_argument("--data", default="dress/*.tar", help="tar-shard glob of the JPEG payloads and captions")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)

    from clip_mixer_tpu_torch.device import card, resolve_device

    device = resolve_device(args.device)  # no card and no --device: raise before anything starts
    device_args = ["--device", args.device] if args.device else []
    atexit.register(stop_children)

    ASSETS.mkdir(parents=True, exist_ok=True)
    jpegs, caps, n_real_jpegs = load_payloads(data=args.data)

    model = ASSETS / "model"
    calib = ASSETS / "calib.npz"
    frozen = ASSETS / "frozen"
    frozen_int8 = ASSETS / "frozen_int8"
    names = ASSETS / "classnames.txt"
    if not args.skip_prep:
        prepare(preset, args.data, device_args, model, calib, frozen, frozen_int8, names)

    name, power = card(device)
    doc = {"config": {
        "model": f"{preset} (random-init seed 0, identical across legs)",
        "payloads": (f"256px JPEGs, {n_real_jpegs}/{len(jpegs)} from the dress shards (synthetic top-up for "
                     "the rest; server-side PIL decode+resize)"),
        "quick": bool(args.quick),
        "environment_note": (
            "a card local to the host: no tunnel; each request's JPEG decode, resize, base64 and JSON run on "
            "the host's CPU cores, which the client threads and the server share"),
    }, "device": name, "power_limit": power}

    # cold start: time to /healthz and the first requests, live against frozen
    doc["cold_start"] = {
        "live_bf16": cold_probe(str(model), "cold_live", jpegs, device_args),
        "frozen_bf16": cold_probe(str(frozen), "cold_frozen", jpegs, device_args),
        "note": ("live serving runs the model's eager PyTorch (nothing compiled; its first requests pay the "
                 "card's first launches and the allocator's growth); frozen serving loads the recorded "
                 "torch.export programs at start-up"),
    }

    legs = {
        "live_bf16": ["--model", model, "--warmup", "--classifier", names],
        "live_int8": ["--model", model, "--int8", calib, "--warmup", "--classifier", names],
        "frozen_bf16": ["--model", frozen, "--warmup", "--classifier", names],
        "frozen_int8": ["--model", frozen_int8, "--warmup", "--classifier", names],
    }
    for leg, extra in legs.items():
        with Server([*extra, *device_args], f"leg_{leg}") as srv:
            doc[leg] = run_suite(srv, jpegs, caps, quick=args.quick)
        Path(args.out).write_text(json.dumps(doc, indent=2))  # checkpoint

    # the raw in-process engine: the micro-batching baseline without HTTP.
    # A failure here keeps the HTTP legs above, recorded as an error.
    raw = REPO / "scripts" / "torch_bench_serving.py"
    raw_cmd = [sys.executable, raw] if preset == "mixer-b32" else [sys.executable, "-c", RAW_RUNNER, raw, preset]
    try:
        sh([*raw_cmd, *device_args], "raw_engine", timeout=3600)
        raw_tail = (ASSETS / "raw_engine.log").read_text().strip().splitlines()
        doc["raw_engine_no_http"] = json.loads(raw_tail[-1])
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, json.JSONDecodeError, IndexError,
            OSError) as e:
        doc["raw_engine_no_http"] = {"error": f"torch_bench_serving.py failed: {type(e).__name__}: {e}"}

    Path(args.out).write_text(json.dumps(doc, indent=2))
    print(json.dumps({
        leg: {
            "img_b128_ips": doc[leg].get("encode_image_b128", {}).get("items_per_sec"),
            "b1_coalesced_rps": doc[leg].get("encode_image_b1_coalesced_8clients", {}).get("items_per_sec"),
            "startup_s": doc[leg].get("startup_seconds"),
        }
        for leg in legs
    }), flush=True)
    return 0


if __name__ == "__main__":
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))  # through atexit's stop
    sys.exit(main())
