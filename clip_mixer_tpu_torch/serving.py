"""Inference serving: bucketed encoders, micro-batching and HTTP endpoints.

Counterpart of the float, single-device part of ``clip_mixer_tpu/serving.py``:

* :class:`InferenceEngine` pads each request batch with zeros to a batch
  bucket (8, 32, 128 by default) and runs the model's encoders on its device;
* :class:`MicroBatcher` merges concurrent single-item requests into one batch;
* :func:`serve` is a ThreadingHTTPServer with GET /healthz, GET /metrics and
  POST /encode_text {"texts": [...]}, /encode_image {"images_b64": [...]}
  and /similarity {"images_b64": [...], "texts": [...]}.

The int8 path, multi-device engines, frozen programs, classification and the
retrieval index are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.device import compute_dtype
from clip_mixer_tpu_torch.models.clip import CLIP, l2_normalize
from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess, normalize_images, preprocess_pil
from clip_mixer_tpu_torch.text.tokenize import tokenize


def encoder_fns(cfg: CLIPConfig, input_hw=None):
    """(image_fn, text_fn), each ``fn(model, batch)`` -> L2-normalised
    features. The image side takes uint8 NHWC: model-sized when ``input_hw``
    is None (normalised only), else at ``input_hw`` and resized on the device
    by the ``"torch"`` preprocess."""
    dt = compute_dtype(cfg.compute_dtype)
    if input_hw is None:
        def to_model_inputs(images_u8):
            return normalize_images(images_u8, dtype=dt)
    else:
        to_model_inputs = make_batch_preprocess(tuple(input_hw), cfg.image_resolution, normalize=True, dtype=dt)

    def image_fn(model, images_u8):
        return l2_normalize(model.encode_image(to_model_inputs(images_u8)))

    def text_fn(model, tokens):
        return l2_normalize(model.encode_text(tokens))

    return image_fn, text_fn


def softmax_probs(logits: np.ndarray) -> np.ndarray:
    """Row-stable softmax."""
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


class InferenceEngine:
    """Fixed-bucket encoders over a :class:`CLIP` on its device.

    ``input_hw``: accept uint8 at this source resolution and resize on the
    device; None = images arrive model-sized."""

    def __init__(self, model: CLIP, batch_buckets: Sequence[int] = (8, 32, 128), input_hw=None):
        self.model = model.eval()
        self.cfg = model.cfg
        self.device = model.device
        self.input_hw = None if input_hw is None else tuple(input_hw)
        self.buckets = sorted(batch_buckets)
        image_fn, text_fn = encoder_fns(self.cfg, input_hw=self.input_hw)
        self._text_fn = text_fn
        self._image_fn = image_fn
        self.path_kinds = {"image": "float", "text": "float"}
        self.__batcher: Optional[MicroBatcher] = None
        self._batcher_lock = threading.Lock()

    @property
    def _image_batcher(self) -> "MicroBatcher":
        with self._batcher_lock:
            if self.__batcher is None:
                self.__batcher = MicroBatcher(self._run_image, max_batch=self.buckets[-1])
            return self.__batcher

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _run_padded(self, fn, arr: np.ndarray) -> np.ndarray:
        n = arr.shape[0]
        if n == 0:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        out: List[np.ndarray] = []
        i = 0
        while i < n:
            take = min(n - i, self.buckets[-1])
            b = self._bucket(take)
            chunk = arr[i : i + take]
            if take < b:
                chunk = np.concatenate([chunk, np.zeros((b - take,) + arr.shape[1:], arr.dtype)])
            with torch.inference_mode():
                feats = fn(self.model, torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device))
                out.append(feats.float().cpu().numpy()[:take])
            i += take
        return np.concatenate(out)

    def _run_image(self, images_u8: np.ndarray) -> np.ndarray:
        return self._run_padded(self._image_fn, images_u8)

    def encode_text(self, texts: Sequence[str]) -> np.ndarray:
        tokens = tokenize(list(texts), self.cfg.context_length, truncate=True)
        return self._run_padded(self._text_fn, tokens)

    def encode_image_arrays(self, images_u8: np.ndarray, coalesce: bool = False) -> np.ndarray:
        """coalesce=True routes single-image requests through the
        micro-batcher so concurrent callers share one device batch."""
        if coalesce and images_u8.shape[0] == 1:
            return self._image_batcher.submit(images_u8[0])[None]
        return self._run_image(images_u8)

    def warmup(self) -> None:
        """Run every batch bucket on both towers once."""
        R, ctx = self.cfg.image_resolution, self.cfg.context_length
        ih, iw = self.input_hw if self.input_hw is not None else (R, R)
        for b in self.buckets:
            self._run_padded(self._image_fn, np.zeros((b, ih, iw, 3), np.uint8))
            self._run_padded(self._text_fn, np.zeros((b, ctx), np.int32))

    def decode_and_preprocess(self, blobs: Sequence[bytes]) -> np.ndarray:
        """Encoded images -> uint8 NHWC. Imports PIL only when called."""
        from PIL import Image

        if self.input_hw is not None:
            # device-resize engine: blobs must already be at the configured
            # source resolution, so the image is resampled exactly once.
            ih, iw = self.input_hw
            out = []
            for b in blobs:
                img = Image.open(io.BytesIO(b)).convert("RGB")
                if img.size != (iw, ih):
                    raise ValueError(
                        f"engine is configured for {ih}x{iw} source images "
                        f"(device-side resize); got {img.size[1]}x{img.size[0]}."
                    )
                out.append(np.asarray(img, np.uint8))
            return np.stack(out)
        out = [preprocess_pil(Image.open(io.BytesIO(b)), self.cfg.image_resolution) for b in blobs]
        return np.stack(out)

    def similarity(self, images_u8: np.ndarray, texts: Sequence[str]) -> np.ndarray:
        """logits_per_image [n_images, n_texts] = 100 * cosine."""
        img = self.encode_image_arrays(images_u8)
        txt = self.encode_text(texts)
        return 100.0 * img @ txt.T


class MicroBatcher:
    """Coalesce concurrent single-item requests into one batch."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray], max_batch: int = 128, max_wait_ms: float = 5.0):
        self._fn = fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item: np.ndarray) -> np.ndarray:
        done = threading.Event()
        holder: dict = {}
        self._q.put((item, done, holder))
        done.wait()
        if "error" in holder:
            raise holder["error"]
        return holder["result"]

    def _loop(self):
        while True:
            item, done, holder = self._q.get()
            batch = [(item, done, holder)]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                results = self._fn(np.stack([b[0] for b in batch]))
                for (_, d, h), r in zip(batch, results):
                    h["result"] = r
                    d.set()
            except Exception as e:  # handed to every waiting request
                for _, d, h in batch:
                    h["error"] = e
                    d.set()


# Largest accepted request body.
MAX_BODY_BYTES = 256 * 1024 * 1024

_TIMED = ("/encode_text", "/encode_image", "/similarity")


class ServerStats:
    """Thread-safe per-endpoint request counters and latency quantiles over
    a bounded window: the GET /metrics payload."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.window = window
        self._lat: dict = {}
        self._count: dict = {}
        self._errors: dict = {}

    def record(self, endpoint: str, seconds: float, ok: bool) -> None:
        with self._lock:
            self._count[endpoint] = self._count.get(endpoint, 0) + 1
            if not ok:
                self._errors[endpoint] = self._errors.get(endpoint, 0) + 1
            self._lat.setdefault(endpoint, deque(maxlen=self.window)).append(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for ep, n in self._count.items():
                lat = sorted(self._lat.get(ep, ()))

                def q(p):
                    return round(1e3 * lat[min(len(lat) - 1, int(p * len(lat)))], 3)

                out[ep] = {
                    "count": n,
                    "errors": self._errors.get(ep, 0),
                    "window": len(lat),
                    "p50_ms": q(0.50) if lat else None,
                    "p99_ms": q(0.99) if lat else None,
                    "max_ms": round(1e3 * lat[-1], 3) if lat else None,
                }
            return out


def make_handler(engine: InferenceEngine, stats: Optional[ServerStats] = None):
    stats = stats or ServerStats()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, payload: dict):
            # recorded before the body is written, so a client that polls
            # /metrics right after its response sees this request
            t0 = getattr(self, "_t0", None)
            self._t0 = None
            if t0 is not None and self.path in _TIMED:
                stats.record(self.path, time.perf_counter() - t0, ok=code == 200)
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(
                    200,
                    {
                        "status": "ok",
                        "model": engine.cfg.tower,
                        "embed_dim": engine.cfg.embed_dim,
                        "image_resolution": engine.cfg.image_resolution,
                        "input_hw": engine.input_hw,
                        "buckets": list(engine.buckets),
                        "paths": dict(engine.path_kinds),
                        "device": str(engine.device),
                    },
                )
            elif self.path == "/metrics":
                self._reply(200, {"endpoints": stats.snapshot()})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            self._t0 = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length < 0 or length > MAX_BODY_BYTES:
                    self.close_connection = True
                    self._reply(413, {"error": f"request body {length} bytes exceeds {MAX_BODY_BYTES}"})
                    return
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/encode_text":
                    feats = engine.encode_text(req["texts"])
                    self._reply(200, {"features": feats.tolist()})
                elif self.path == "/encode_image":
                    blobs = [base64.b64decode(b) for b in req["images_b64"]]
                    feats = engine.encode_image_arrays(engine.decode_and_preprocess(blobs), coalesce=True)
                    self._reply(200, {"features": feats.tolist()})
                elif self.path == "/similarity":
                    blobs = [base64.b64decode(b) for b in req["images_b64"]]
                    logits = engine.similarity(engine.decode_and_preprocess(blobs), req["texts"])
                    self._reply(200, {"logits_per_image": logits.tolist(), "probs": softmax_probs(logits).tolist()})
                else:
                    self._reply(404, {"error": "unknown path"})
            except (KeyError, TypeError, ValueError, json.JSONDecodeError, OSError) as e:
                # OSError covers PIL's UnidentifiedImageError on non-image bytes
                self._reply(400, {"error": f"bad request: {e}"})
            except Exception as e:  # the server keeps running; the client gets the fault
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(engine: InferenceEngine, host: str = "0.0.0.0", port: int = 8000) -> ThreadingHTTPServer:
    """Build the HTTP server (call ``.serve_forever()`` on it, and
    ``.shutdown()`` then ``.server_close()`` to stop it)."""
    return ThreadingHTTPServer((host, port), make_handler(engine))
