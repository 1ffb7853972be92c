#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:

1. Build every ``clip_mixer_tpu_torch/csrc/*.cu`` with ``nvcc`` (one process
   per source, all started together) and hold each kernel against its plain
   PyTorch version on the card at the shapes the serving path gives it; then
   a small f32 model with the fused channel mix, on the card against the
   same model on the CPU.
2. The main path, with every launch counter set to 0 first: a full-width
   Mixer-B/32 (bf16, ``fused_mlp=True``, random weights from seed 0) behind
   an ``InferenceEngine`` that takes 256x256 uint8 images, warmed up, then
   serving text, image and similarity requests through the engine API and
   ``/healthz`` + ``/encode_text`` through the HTTP server on 127.0.0.1; then
   the bench front end, ``make_batch_preprocess(backend="kernel")`` ->
   ``encode_image`` at batch 128. Each call's launches are checked, and the
   features against the same weights with the plain channel mix
   (``fused_mlp=False``): cosine >= 0.999.
3. Time each kernel and its plain version with CUDA events.

Standard output ends with a JSON line per phase result, the kernels line,
the card's name and power limit, and last ``{"ok": true, "device": ...}``.
Without a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

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
PREPROCESS_F32_ATOL = 1e-4  # banded vs dense f32 sums: summation order only
COSINE_MIN = 0.999

LN_MLP_CASES = [  # (label, R, W, H, dtype): the towers at buckets 128 and 8, a ragged R, f32
    ("vision", 128 * 50, 768, 3072, torch.bfloat16),
    ("text", 128 * 77, 512, 2048, torch.bfloat16),
    ("vision_b8", 8 * 50, 768, 3072, torch.bfloat16),
    ("ragged", 3 * 77, 512, 2048, torch.bfloat16),
    ("f32", 8 * 50, 768, 3072, torch.float32),
]
PREPROCESS_CASES = [("bf16", 128, torch.bfloat16), ("f32", 128, torch.float32)]

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
        results[label] = dict(case, args=args)
        log(f"ln_mlp {label} R={R} W={W} H={H} {dtype}: max_abs {err:.3g} branch rel {rel:.3g} ok")
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


def check_preprocess(dev):
    from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre

    bands = kpre.ResizeBands.build((256, 256), 224, dev)
    g = torch.Generator().manual_seed(1)
    results = {}
    for label, B, dtype in PREPROCESS_CASES:
        imgs = torch.randint(0, 256, (B, 256, 256, 3), dtype=torch.uint8, generator=g).to(dev)
        got = kpre.preprocess(imgs, bands, dtype)
        torch.cuda.synchronize()
        want = kpre.preprocess_plain(imgs, bands, dtype)
        err, rel = max_abs(got, want), rel_err(got, want)
        if dtype == torch.float32:
            require(err <= PREPROCESS_F32_ATOL, f"preprocess f32: max abs error {err} > {PREPROCESS_F32_ATOL}")
            tol = f"max abs <= {PREPROCESS_F32_ATOL} (f32, banded vs dense summation)"
        else:
            require(rel <= BF16_REL_TOL, f"preprocess bf16: relative error {rel} > {BF16_REL_TOL}")
            tol = f"relative Frobenius <= {BF16_REL_TOL} (bf16 store)"
        results[label] = dict(B=B, dtype=str(dtype), max_abs_err=err, rel_err=rel, tol=tol, imgs=imgs, bands=bands)
        log(f"preprocess {label} B={B} 256->224 {dtype}: max_abs {err:.3g} rel {rel:.3g} ok")
    return results


def check_small_model(dev):
    """A two-layer f32 model with the fused channel mix: card against CPU."""
    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    cfg = PRESETS["mixer-debug"].replace(fused_mlp=True)
    models = {d: CLIP(cfg, device=d, generator=torch.Generator().manual_seed(3)) for d in ("cpu", dev)}
    g = torch.Generator().manual_seed(4)
    images = torch.randn(4, cfg.image_resolution, cfg.image_resolution, 3, generator=g)
    text = torch.from_numpy(tokenize(TEXTS[:4], cfg.context_length, truncate=True))
    with torch.inference_mode():
        out = {d: (m.encode_image(images.to(d)).cpu(), m.encode_text(text.to(d)).cpu()) for d, m in models.items()}
    for got, want in zip(out[dev], out["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
    log("mixer-debug f32 fused model: card matches CPU")


# ---- phase 2: the main path -------------------------------------------------


class Counters:
    def __init__(self):
        from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre
        from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp

        self.wrappers = {"ln_mlp": ln_mlp, "preprocess": kpre.preprocess}

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


# ---- phase 3: timing ----------------------------------------------------------


def time_kernels(ln_cases, pre_cases, launches):
    from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre
    from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp, ln_mlp_plain

    rows = []
    for kernel, cases, main_label in (("ln_mlp", ln_cases, "vision"), ("preprocess", pre_cases, "bf16")):
        timed = {}
        for label, case in cases.items():
            if kernel == "ln_mlp":
                args = case.pop("args")
                ms = cuda_ms(lambda: ln_mlp(*args), iters=20)
                plain_ms = cuda_ms(lambda: ln_mlp_plain(*args), iters=5)
                n_bytes, n_ops = ln_mlp_cost(case["R"], case["W"], case["H"], args[0].dtype)
                dtype = args[0].dtype
            else:
                imgs, bands = case.pop("imgs"), case.pop("bands")
                dtype = torch.bfloat16 if case["dtype"] == str(torch.bfloat16) else torch.float32
                ms = cuda_ms(lambda: kpre.preprocess(imgs, bands, dtype), iters=20)
                plain_ms = cuda_ms(lambda: kpre.preprocess_plain(imgs, bands, dtype), iters=5)
                n_bytes, n_ops = preprocess_cost(bands, case["B"], dtype)
                # the preprocess arithmetic is f32 whatever it stores
                dtype = torch.float32
            bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
            timed[label] = dict(case, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                bytes=n_bytes, operations=n_ops)
            log(f"{kernel} {label}: {ms:.4f} ms (plain {plain_ms:.4f}, bound {bound_ms:.4f} by {bound_by})")
        main = timed.pop(main_label)
        source = {"ln_mlp": "clip_mixer_tpu_torch/csrc/ln_mlp.cu", "preprocess": "clip_mixer_tpu_torch/csrc/preprocess.cu"}
        replaces = {
            "ln_mlp": "clip_mixer_tpu/ops/pallas/mlp_kernel.py:61",
            "preprocess": "clip_mixer_tpu/ops/pallas/preprocess_kernel.py:72",
        }
        rows.append({
            "name": kernel,
            "route": "cuda",
            "source": source[kernel],
            "replaces": replaces[kernel],
            "launches": launches[kernel],
            "shape": main_label,
            **main,
            # no single PyTorch call computes the same function (a fused
            # LN + two-layer MLP; a cropped antialiased bicubic resize of
            # uint8 NHWC with CLIP normalisation)
            "library_ms": None,
            "other_cases": timed,
        })
    return rows


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
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"ptxas {name}: {line.strip()}")
    log(f"built {_build.all_sources()} in {build_s:.1f} s")

    ln_cases = check_ln_mlp(dev)
    pre_cases = check_preprocess(dev)
    check_small_model(dev)
    torch.cuda.synchronize()

    counters = Counters()
    summary, launches = main_path(dev, counters)
    for name, n in launches.items():
        require(n > 0, f"the main path never launched {name}")
    summary["build_s"] = build_s
    emit({"main_path": summary})

    rows = time_kernels(ln_cases, pre_cases, launches)
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
