"""Inference serving: bucketed encoders, micro-batching and HTTP endpoints.

Counterpart of ``clip_mixer_tpu/serving.py``:

* :class:`InferenceEngine` pads each request batch with zeros to a batch
  bucket (8, 32, 128 by default) and runs the model's encoders on its device
  or, given ``devices``, on one replica per device (each padded batch split
  into equal chunks, one per replica),
  in float or, after :meth:`InferenceEngine.enable_int8`, through the
  calibrated W8A8 towers of ``ops/quant.py``; it holds a zero-shot
  classifier head and a text-to-image retrieval index, on the host or, from
  ``DEVICE_BANK_MIN_ROWS`` rows, on the device;
* :class:`MicroBatcher` merges concurrent single-item requests into one batch;
* :func:`serve` is a ThreadingHTTPServer with GET /healthz, GET /metrics and
  POST /encode_text {"texts": [...]}, /encode_image {"images_b64": [...]}
  (each a PNG, a JPEG or a ``.npy`` uint8 array),
  /similarity {"images_b64": [...], "texts": [...]}, /classify
  {"images_b64": [...], "top_k": k}, /index {"images_b64": [...], "ids":
  [...]} and /retrieve {"texts": [...], "top_k": k};
* :func:`main`, the command line (``python -m clip_mixer_tpu_torch.serving
  --model <name or path>``), serves on the card unless ``--device`` names
  another, and serves a directory holding ``servable/manifest.json``
  (``aot.export_servable``, ``scripts/torch_release.py``) through its
  recorded programs unless ``--no-frozen`` is given; :func:`build_server`
  builds its server and engine without serving, and
  ``clip_mixer_tpu_torch/client.py`` is its client.

``--all-devices`` serves one engine over every visible card
(:func:`local_mesh`), as the JAX CLI serves one over every local chip.
"""

from __future__ import annotations

import argparse
import base64
import copy
import io
import json
import os
import queue
import threading
import time
import warnings
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from clip_mixer_tpu_torch.api import load
from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.device import compute_dtype, resolve_device
from clip_mixer_tpu_torch.models.clip import CLIP, l2_normalize
from clip_mixer_tpu_torch.ops import quant_io
from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess, normalize_images, preprocess_pil
from clip_mixer_tpu_torch.ops.quant import (
    encode_image_q_patches,
    image_quant_fns,
    make_planar_front_end,
    text_quant_fns,
    tower_kind,
)
from clip_mixer_tpu_torch.text.fast import fast_tokenize


def encoder_fns(cfg: CLIPConfig, int8: bool = False, input_hw=None):
    """(image_fn, text_fn), each ``fn(module, batch)`` -> L2-normalised
    features; ``module`` is the float :class:`CLIP` or, with ``int8``, the
    tower's quant module (``QuantVisionTower`` / ``QuantTextTower``).

    The image side takes uint8 NHWC: model-sized when ``input_hw`` is None
    (normalised only), else at ``input_hw`` and resized on the device by the
    ``"torch"`` preprocess. An int8 engine of Mixer towers with ``input_hw``
    takes the planar front end instead (resize -> int8 patches at the
    tower's calibrated patch scale); a ViT or ResNet int8 engine keeps the
    float front end, as the JAX package's."""
    dt = compute_dtype(cfg.compute_dtype)
    if input_hw is None:
        def to_model_inputs(images_u8):
            return normalize_images(images_u8, dtype=dt)
    else:
        to_model_inputs = make_batch_preprocess(tuple(input_hw), cfg.image_resolution, normalize=True, dtype=dt)

    if not int8:
        def image_fn(model, images_u8):
            return l2_normalize(model.encode_image(to_model_inputs(images_u8)))

        def text_fn(model, tokens):
            return l2_normalize(model.encode_text(tokens))

        return image_fn, text_fn

    encode_image = image_quant_fns(cfg)[2]
    encode_text = text_quant_fns(cfg)[2]
    if input_hw is not None and tower_kind(cfg, text=False) == "mixer":
        front = make_planar_front_end(cfg, tuple(input_hw))

        def image_fn(qvis, images_u8):
            return l2_normalize(encode_image_q_patches(qvis, front(images_u8, patch_scale=qvis.a_patch)))
    else:
        def image_fn(qvis, images_u8):
            return l2_normalize(encode_image(qvis, to_model_inputs(images_u8)))

    def text_fn(qtext, tokens):
        return l2_normalize(encode_text(qtext, tokens))

    return image_fn, text_fn


def local_mesh() -> Optional[List[torch.device]]:
    """The ``--all-devices`` serving layout: every visible card, or None on
    a host with fewer than two. The one constructor of the serving CLI and
    ``scripts/torch_embed_dataset.py``: a bank's features equal the
    served ones only when both run on the same layout."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)] if n > 1 else None


def visible_devices(device=None) -> List[torch.device]:
    """Every device of ``device``'s type this process sees (the cards, or
    the one CPU): what the export scripts' ``--all-devices`` records."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _indexed(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def replica(model: CLIP, device: torch.device) -> CLIP:
    """``model`` itself on its own device, else a copy of it (its tower
    route included) on ``device``."""
    if torch.device(model.device) == torch.device(device):
        return model
    return copy.deepcopy(model).to(device)


def split_over(fns: Sequence[Callable], devices: Sequence[torch.device]) -> Callable:
    """A replicated path's ``fn(modules, batch)``: ``batch`` (a multiple of
    ``len(devices)`` rows) in equal chunks, chunk i through ``fns[i]`` on
    ``modules[i]`` on ``devices[i]``; every chunk is launched before any
    result is read, and the features come back in order on the first
    device."""

    def fn(modules, batch):
        chunks = batch.chunk(len(devices))
        outs = [f(m, c.to(d, non_blocking=True)) for f, m, c, d in zip(fns, modules, chunks, devices)]
        return torch.cat([o.to(devices[0]) for o in outs])

    return fn


def softmax_probs(logits: np.ndarray) -> np.ndarray:
    """Row-stable softmax."""
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _topk(row: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest entries, sorted descending: an O(N)
    selection, then a sort of the k. k must be >= 1."""
    if k < 1:
        raise ValueError(f"top_k must be >= 1, got {k}")
    k = min(k, len(row))
    idx = np.argpartition(-row, k - 1)[:k]
    return idx[np.argsort(-row[idx])]


def _numpy_tree(scales):
    """A calibration's scale tree (dicts and lists of tensors) with f32
    numpy leaves (an artifact's)."""
    if isinstance(scales, dict):
        return {k: _numpy_tree(v) for k, v in scales.items()}
    if isinstance(scales, (list, tuple)):
        return [_numpy_tree(v) for v in scales]
    return scales.float().cpu().numpy()


_NPY_MAGIC = b"\x93NUMPY"


class NotLoadedError(RuntimeError):
    """A request needs a classifier or an index the engine does not hold
    (HTTP 409)."""


class InferenceEngine:
    """Fixed-bucket encoders over a :class:`CLIP` on its device.

    ``input_hw``: accept uint8 at this source resolution and resize on the
    device; None = images arrive model-sized. Each tower's path is an
    ``(fn, module)`` pair, swapped in one attribute write (so a live server's
    threads never see a fn and a module that do not belong together);
    ``path_kinds`` says which numeric path each tower serves.

    ``devices``: serve on one replica of ``model`` per device (JAX's
    ``mesh=``: parameters replicated, the batch split). The buckets are
    rounded up to multiples of the device count; a path's module is then
    the list of the replicas' modules and its fn splits each padded batch
    over them (:func:`split_over`); a device bank's rows are split over the
    devices too."""

    # Banks at or above this row count live on the device and their
    # similarity runs there; below it host numpy saves the round trip.
    DEVICE_BANK_MIN_ROWS = 16384

    def __init__(self, model: CLIP, batch_buckets: Sequence[int] = (8, 32, 128), input_hw=None,
                 devices: Optional[Sequence] = None):
        self.devices = None if devices is None else [_indexed(d) for d in devices]
        if self.devices is not None:
            if not self.devices:
                raise ValueError("devices= names no device")
            n = len(self.devices)
            batch_buckets = {-(-b // n) * n for b in batch_buckets}  # each bucket splits evenly
            self.replicas = [replica(model, d).eval() for d in self.devices]
        else:
            self.replicas = [model.eval()]
        self.model = self.replicas[0]
        self.cfg = model.cfg
        self.device = self.model.device
        self.input_hw = None if input_hw is None else tuple(input_hw)
        self.buckets = sorted(batch_buckets)
        image_fn, text_fn = encoder_fns(self.cfg, input_hw=self.input_hw)
        self._image_path = self.path([image_fn], self.replicas)
        self._text_path = self.path([text_fn], self.replicas)
        self.path_kinds = {"image": "float", "text": "float"}
        self.frozen = False  # aot.load_servable: the paths run recorded programs
        self._classifier: Optional[np.ndarray] = None
        self._classnames: Optional[List[str]] = None
        self._index = None  # (L2-normalised features [N, D], ids): numpy, or a tensor on the device
        self.__batcher: Optional[MicroBatcher] = None
        self._batcher_lock = threading.Lock()

    def path(self, fns: Sequence[Callable], modules: Sequence) -> tuple:
        """A tower's ``(fn, module)`` from one fn (or one a device) and one
        module a replica: on one device the pair itself, else the split."""
        if self.devices is None:
            return fns[0], modules[0]
        fns = list(fns) * len(self.devices) if len(fns) == 1 else list(fns)
        return split_over(fns, self.devices), list(modules)

    @property
    def _image_batcher(self) -> "MicroBatcher":
        with self._batcher_lock:
            if self.__batcher is None:
                self.__batcher = MicroBatcher(self._run_image, max_batch=self.buckets[-1])
            return self.__batcher

    def enable_int8(
        self,
        sample_images_u8: Optional[np.ndarray] = None,
        sample_texts: Optional[Sequence[str]] = None,
        *,
        calibration: Optional[str] = None,
        save_calibration: Optional[str] = None,
    ) -> None:
        """Switch each tower that has activation scales to the calibrated
        W8A8 path (``ops/quant.py``; Mixer, ViT or ResNet towers).

        Scales come from ``calibration``, a ``.npz`` artifact written by
        ``save_calibration=`` here or by the JAX package (its architecture
        fingerprint is checked), and are measured on ``sample_images_u8``
        ([N, H, W, 3] at the engine's input resolution) / ``sample_texts``
        for a tower the artifact lacks.

        No accuracy gate is checked here: quantise a tower only once its
        noise-floor gate (``evals/quant_gate.py``) passed on these weights.
        At random-init Mixer-B/32 weights the text tower fails its gate
        (``PERF.md``), so pass ``sample_texts=None`` to keep text in bf16."""
        cfg, dev = self.cfg, self.device
        dt = compute_dtype(cfg.compute_dtype)
        scales = t_scales = None
        if calibration is not None:
            art = quant_io.load_calibration(calibration)
            quant_io.check_cfg(art["cfg"], cfg)
            scales, t_scales = art["image_scales"], art["text_scales"]

        calibrate, quantize, _ = image_quant_fns(cfg)
        t_calibrate, t_quantize, _ = text_quant_fns(cfg)
        with torch.inference_mode():
            if scales is None and sample_images_u8 is not None:
                x = torch.from_numpy(np.ascontiguousarray(sample_images_u8)).to(dev)
                if self.input_hw is not None:  # the resize the serving path will run
                    pre = make_batch_preprocess(self.input_hw, cfg.image_resolution, normalize=True, dtype=dt)
                    sample = pre(x)
                else:
                    sample = normalize_images(x, dtype=dt)
                scales = _numpy_tree(calibrate(self.model, sample))
            if t_scales is None and sample_texts:
                tokens = fast_tokenize(list(sample_texts), cfg.context_length, truncate=True)
                t_scales = _numpy_tree(t_calibrate(self.model, torch.from_numpy(tokens).to(dev)))
        if scales is None and t_scales is None:
            raise ValueError(
                "enable_int8 has no scales for either tower: pass "
                "sample_images_u8 / sample_texts or a calibration= artifact"
            )
        if save_calibration is not None:
            quant_io.save_calibration(save_calibration, cfg, image_scales=scales, text_scales=t_scales)

        image_fn_q, text_fn_q = encoder_fns(cfg, int8=True, input_hw=self.input_hw)
        if scales is not None:  # every replica quantised with the same scales
            self._image_path = self.path([image_fn_q], [quantize(m, scales) for m in self.replicas])
            self.path_kinds["image"] = "int8"
            self.frozen = False  # live now, even on a load_servable engine
        if t_scales is not None:
            self._text_path = self.path([text_fn_q], [t_quantize(m, t_scales) for m in self.replicas])
            self.path_kinds["text"] = "int8"
            self.frozen = False

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _run_padded(self, path, arr: np.ndarray) -> np.ndarray:
        fn, module = path  # one read of the (fn, module) pair
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
                x = torch.from_numpy(np.ascontiguousarray(chunk))
                feats = fn(module, x if self.devices is not None else x.to(self.device))  # split_over moves it
                out.append(feats.float().cpu().numpy()[:take])
            i += take
        return np.concatenate(out)

    def _run_image(self, images_u8: np.ndarray) -> np.ndarray:
        return self._run_padded(self._image_path, images_u8)

    def encode_text(self, texts: Sequence[str]) -> np.ndarray:
        tokens = fast_tokenize(list(texts), self.cfg.context_length, truncate=True)
        return self._run_padded(self._text_path, tokens)

    def encode_image_arrays(self, images_u8: np.ndarray, coalesce: bool = False) -> np.ndarray:
        """coalesce=True routes single-image requests through the
        micro-batcher so concurrent callers share one device batch."""
        if coalesce and images_u8.shape[0] == 1:
            return self._image_batcher.submit(images_u8[0])[None]
        return self._run_image(images_u8)

    def warmup(self) -> None:
        """Run every batch bucket on both towers once, and the device bank's
        similarity when one is loaded."""
        R, ctx = self.cfg.image_resolution, self.cfg.context_length
        ih, iw = self.input_hw if self.input_hw is not None else (R, R)
        for b in self.buckets:
            self._run_padded(self._image_path, np.zeros((b, ih, iw, 3), np.uint8))
            self._run_padded(self._text_path, np.zeros((b, ctx), np.int32))
        index = self._index
        if index is not None and _on_device(index[0]):
            self._device_sims(np.zeros((self.buckets[-1], self.cfg.embed_dim), np.float32), index[0])

    def decode_and_preprocess(self, blobs: Sequence[bytes]) -> np.ndarray:
        """Encoded images -> uint8 NHWC. A blob is a PNG or JPEG (decoded by
        PIL, imported only then) or a ``.npy`` uint8 [H, W, 3] array (no PIL
        needed), which must already be at the engine's input resolution.
        A device-resize engine (``input_hw``) takes every image at exactly
        that resolution, so it is resampled once."""
        R = self.cfg.image_resolution
        hw = self.input_hw if self.input_hw is not None else (R, R)
        out = []
        for b in blobs:
            if b[:6] == _NPY_MAGIC:
                img = np.load(io.BytesIO(b), allow_pickle=False)
                if img.dtype != np.uint8 or img.shape != (*hw, 3):
                    raise ValueError(f"a .npy image must be uint8 {hw[0]}x{hw[1]}x3, got {img.dtype} {img.shape}")
                out.append(img)
                continue
            from PIL import Image

            img = Image.open(io.BytesIO(b))
            if self.input_hw is None:
                out.append(preprocess_pil(img, R))
                continue
            img = img.convert("RGB")
            if img.size != (hw[1], hw[0]):
                raise ValueError(
                    f"engine is configured for {hw[0]}x{hw[1]} source images "
                    f"(device-side resize); got {img.size[1]}x{img.size[0]}."
                )
            out.append(np.asarray(img, np.uint8))
        return np.stack(out)

    def load_classifier(self, classnames: Sequence[str], templates: Sequence[str]) -> None:
        """Prompt-ensemble zero-shot head, norm(mean(norm(encode(prompts))))
        per class, built through the engine's own text path, so it has the
        numerics the images will be encoded with (int8 included)."""
        prompts = [t.format(c) for c in classnames for t in templates]
        feats = self.encode_text(prompts)  # [C*T, D], L2-normalised
        class_emb = feats.reshape(len(classnames), len(templates), -1).mean(axis=1)
        class_emb /= np.maximum(np.linalg.norm(class_emb, axis=-1, keepdims=True), 1e-8)
        self._classifier = class_emb.T.astype(np.float32)
        self._classnames = list(classnames)

    def classify(self, images_u8: np.ndarray, top_k: int = 5) -> List[List[dict]]:
        if self._classifier is None:
            raise NotLoadedError("no classifier loaded; call load_classifier first")
        feats = self.encode_image_arrays(images_u8)
        probs = softmax_probs(100.0 * feats @ self._classifier)
        return [
            [{"label": self._classnames[i], "prob": float(row[i])} for i in _topk(row, top_k)]
            for row in probs
        ]

    def similarity(self, images_u8: np.ndarray, texts: Sequence[str]) -> np.ndarray:
        """logits_per_image [n_images, n_texts] = 100 * cosine."""
        img = self.encode_image_arrays(images_u8)
        txt = self.encode_text(texts)
        return 100.0 * img @ txt.T

    # ---- the retrieval index

    def load_index(self, features: np.ndarray, ids: Sequence[str], device: Optional[bool] = None) -> None:
        """Install a retrieval index: ``features`` [N, embed_dim] (L2-normalised
        here) with one id per row, in one attribute write.

        ``device``: keep the bank on the engine's device and take the
        similarity there; None = from ``DEVICE_BANK_MIN_ROWS`` rows. On a
        multi-device engine the bank's rows are padded with zeros to a
        multiple of the device count and split over the devices (a list of
        shards); :meth:`retrieve` slices the similarities back to the true N."""
        feats = np.asarray(features, np.float32)
        if feats.ndim != 2 or feats.shape[0] != len(ids):
            raise ValueError(f"index shape {feats.shape} does not match {len(ids)} ids")
        if feats.shape[1] != self.cfg.embed_dim:
            raise ValueError(
                f"index feature dim {feats.shape[1]} does not match this model's embed_dim {self.cfg.embed_dim}"
            )
        feats = feats / np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-8)
        if device is None:
            device = feats.shape[0] >= self.DEVICE_BANK_MIN_ROWS
        if not device:
            bank = feats
        elif self.devices is None:
            bank = torch.from_numpy(feats).to(self.device)
        else:
            n = len(self.devices)
            pad = (-feats.shape[0]) % n
            padded = np.concatenate([feats, np.zeros((pad, feats.shape[1]), np.float32)]) if pad else feats
            bank = [torch.from_numpy(s).to(d) for s, d in zip(np.split(padded, n), self.devices)]
        self._index = (bank, list(ids))

    def _device_sims(self, q: np.ndarray, bank) -> np.ndarray:
        """[Q, D] queries against the device bank (a tensor, or one shard a
        device), the queries padded to the engine's batch buckets; the
        [Q, N] similarities (N padded on a split bank) come back to the host."""
        shards = bank if isinstance(bank, list) else [bank]
        out = []
        i, n = 0, q.shape[0]
        while i < n:
            take = min(n - i, self.buckets[-1])
            chunk = np.zeros((self._bucket(take), q.shape[1]), np.float32)
            chunk[:take] = q[i : i + take]
            with torch.inference_mode():
                x = torch.from_numpy(chunk)
                parts = [torch.matmul(x.to(s.device), s.t()) for s in shards]  # each device scans its shard
                out.append(torch.cat([p.cpu() for p in parts], dim=1)[:take].numpy())
            i += take
        return np.concatenate(out)

    def load_index_file(self, path: str) -> None:
        """Install a bank ``.npz`` (``features`` [N, embed_dim], ``ids`` [N],
        and a ``__meta__`` provenance entry, as the JAX package's
        ``scripts/embed_dataset.py`` writes it): a bank of another
        architecture is refused; one embedded on another image path or
        input resolution warns."""
        quant_io.require_local_file(path, "retrieval bank")
        with np.load(path) as z:
            if "__meta__" in z:
                meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
                quant_io.check_cfg(meta["cfg"], self.cfg)
                if meta.get("path") != self.path_kinds["image"]:
                    warnings.warn(
                        f"retrieval bank was embedded on the {meta.get('path')!r} image path but this engine "
                        f"serves {self.path_kinds['image']!r}; scores will carry the cross-path numerics gap",
                        stacklevel=2,
                    )
                bank_hw = meta.get("input_hw")
                eng_hw = None if self.input_hw is None else list(self.input_hw)
                if bank_hw != eng_hw:
                    warnings.warn(
                        f"retrieval bank was embedded with input_hw={bank_hw} but this engine serves "
                        f"input_hw={eng_hw}; the resize numerics differ (host PIL vs device matmul)",
                        stacklevel=2,
                    )
            else:
                warnings.warn(
                    f"retrieval bank {path} carries no provenance metadata; "
                    "cannot verify it was embedded with this model",
                    stacklevel=2,
                )
            self.load_index(z["features"], [str(s) for s in z["ids"]])

    def index_images(self, images_u8: np.ndarray, ids: Sequence[str]) -> None:
        """Build the index by encoding ``images_u8`` on the engine's current image path."""
        self.load_index(self.encode_image_arrays(images_u8), ids)

    def retrieve(self, texts: Sequence[str], top_k: int = 5) -> List[List[dict]]:
        """Top-k index entries per query text by cosine similarity, taken
        where the bank lives (host numpy, or the device)."""
        index = self._index
        if index is None:
            raise NotLoadedError("no index loaded; call load_index or index_images first")
        feats, ids = index  # one read
        q = self.encode_text(texts)
        sims = self._device_sims(q, feats)[:, :len(ids)] if _on_device(feats) else q @ feats.T
        return [[{"id": ids[i], "score": float(row[i])} for i in _topk(row, top_k)] for row in sims]


def _on_device(bank) -> bool:
    """Whether a bank lives on the device(s): a tensor, or a list of shards."""
    return isinstance(bank, (torch.Tensor, list))


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

_TIMED = ("/encode_text", "/encode_image", "/classify", "/retrieve", "/index", "/similarity")


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
                        "frozen": engine.frozen,
                        "device": str(engine.device),
                        "devices": len(engine.replicas),
                        "index_size": 0 if engine._index is None else len(engine._index[1]),
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
                elif self.path == "/classify":
                    blobs = [base64.b64decode(b) for b in req["images_b64"]]
                    results = engine.classify(engine.decode_and_preprocess(blobs), top_k=int(req.get("top_k", 5)))
                    self._reply(200, {"results": results})
                elif self.path == "/similarity":
                    blobs = [base64.b64decode(b) for b in req["images_b64"]]
                    logits = engine.similarity(engine.decode_and_preprocess(blobs), req["texts"])
                    self._reply(200, {"logits_per_image": logits.tolist(), "probs": softmax_probs(logits).tolist()})
                elif self.path == "/retrieve":
                    results = engine.retrieve(req["texts"], top_k=int(req.get("top_k", 5)))
                    self._reply(200, {"results": results})
                elif self.path == "/index":
                    blobs = [base64.b64decode(b) for b in req["images_b64"]]
                    engine.index_images(engine.decode_and_preprocess(blobs), req["ids"])
                    self._reply(200, {"indexed": len(req["ids"])})
                else:
                    self._reply(404, {"error": "unknown path"})
            except (KeyError, TypeError, ValueError, json.JSONDecodeError, OSError) as e:
                # OSError covers PIL's UnidentifiedImageError on non-image bytes
                self._reply(400, {"error": f"bad request: {e}"})
            except NotLoadedError as e:
                self._reply(409, {"error": str(e)})
            except Exception as e:  # the server keeps running; the client gets the fault
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(engine: InferenceEngine, host: str = "0.0.0.0", port: int = 8000) -> ThreadingHTTPServer:
    """Build the HTTP server (call ``.serve_forever()`` on it, and
    ``.shutdown()`` then ``.server_close()`` to stop it)."""
    return ThreadingHTTPServer((host, port), make_handler(engine))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Serve a CLIP model of the port over HTTP (clip_mixer_tpu_torch.serving).")
    p.add_argument("--model", required=True,
                   help="preset, OpenAI name, torch .pt / .safetensors, Accelerate dir or port export dir")
    p.add_argument("--port", type=int, default=8000, help="0 binds a free port")
    p.add_argument("--classifier", default=None, help="'imagenet' or a file with one classname per line")
    p.add_argument("--all-devices", action="store_true",
                   help="one engine over every visible card (serving.local_mesh); a no-op on a one-card host")
    p.add_argument("--int8", default=None, metavar="CALIB_NPZ",
                   help="serve the W8A8 path of the towers a calibration artifact holds "
                        "(scripts/torch_calibrate_int8.py)")
    p.add_argument("--warmup", action="store_true",
                   help="run every batch bucket on both towers before accepting traffic")
    p.add_argument("--index", default=None, metavar="BANK_NPZ",
                   help="serve text->image retrieval over a feature bank (scripts/torch_embed_dataset.py)")
    p.add_argument("--input-size", type=int, default=None, metavar="N",
                   help="accept NxN source images and resize them on the device; clients must send "
                        "exactly that resolution")
    p.add_argument("--no-frozen", action="store_true",
                   help="ignore recorded servable/ programs in --model and serve the live model instead "
                        "(an export_servable or release directory is served frozen by default)")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    return p.parse_args(argv)


def build_server(argv=None):
    """The CLI's ``(server, engine)``, not yet serving: the recorded
    programs of a frozen directory (``aot.load_servable``), or the model
    from ``api.load`` with int8 from an artifact; then the index, the warmup
    (after the index, so a device bank's similarity runs too) and the
    classifier, in the JAX CLI's order."""
    from clip_mixer_tpu_torch import aot

    args = parse_args(argv)
    frozen_dir = os.path.isfile(os.path.join(args.model, "servable", "manifest.json"))
    if frozen_dir and not args.no_frozen:
        # load_servable rebuilds the recorded device layout itself
        for flag, name in ((args.int8, "--int8"), (args.all_devices, "--all-devices"),
                           (args.input_size, "--input-size")):
            if flag:
                raise SystemExit(f"{name} would re-trace the encoders, discarding the recorded programs in "
                                 f"{args.model}; pass --no-frozen to serve the live model with it")
        engine = aot.load_servable(args.model, device=args.device)
        print(f"frozen programs loaded from {args.model}/servable", flush=True)
    else:
        model, _, _ = load(args.model, device=args.device)
        if frozen_dir:  # the live model on the route its programs were recorded on
            aot.apply_route(model, aot.read_manifest(args.model).get("route", "plain"))
        engine = InferenceEngine(model, input_hw=(args.input_size, args.input_size) if args.input_size else None,
                                 devices=local_mesh() if args.all_devices and model.device.type == "cuda" else None)
        if args.int8:
            engine.enable_int8(calibration=args.int8)
    if args.index:
        engine.load_index_file(args.index)
        print(f"retrieval index loaded: {len(engine._index[1])} entries", flush=True)
    if args.warmup:
        print("warming up all batch buckets...", flush=True)
        engine.warmup()
    if args.classifier:
        from clip_mixer_tpu_torch.evals.prompts import IMAGENET_CLASSNAMES, PROMPT_TEMPLATES

        if args.classifier == "imagenet":
            names = IMAGENET_CLASSNAMES
        else:
            with open(args.classifier) as f:
                names = [line.strip() for line in f if line.strip()]
        engine.load_classifier(names, PROMPT_TEMPLATES)
    return serve(engine, port=args.port), engine


def main(argv=None) -> None:
    server, engine = build_server(argv)
    print(f"serving on :{server.server_address[1]} ({engine.cfg.tower}, {engine.device}, "
          f"paths {engine.path_kinds}, frozen={engine.frozen})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
