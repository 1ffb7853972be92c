"""Dependency-free client for the port's serving API.

The port's own copy of ``clip_mixer_tpu/client.py`` (stdlib + numpy; the
port imports nothing of the JAX package). It talks to any server started
with ``python -m clip_mixer_tpu_torch.serving`` or ``serve(engine)``, and
to the JAX package's server alike (the wire format is the same)::

    from clip_mixer_tpu_torch.client import ServingClient
    c = ServingClient("http://host:8000")
    text_emb = c.encode_text(["a dog", "a cat"])        # np.float32 [N, D]
    img_emb = c.encode_image_files(["a.jpg", "b.npy"])  # raw bytes accepted too
    hits = c.retrieve(["sunset over water"], top_k=5)   # [{"id", "score"}]
    c.healthz()                                         # provenance dict

Transient failures (5xx and socket errors) retry with backoff; a 4xx is the
caller's fault and raises :class:`ServingError` at once.
"""

from __future__ import annotations

import base64
import json
import time
import urllib.error
import urllib.request
from typing import List, Optional, Sequence, Union

import numpy as np


class ServingError(RuntimeError):
    """Non-retryable server response (4xx or exhausted retries)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class ServingClient:
    def __init__(
        self,
        base_url: str,
        timeout: float = 60.0,
        retries: int = 2,
        backoff_s: float = 0.5,
    ):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = retries
        self.backoff_s = backoff_s

    # ---- transport ------------------------------------------------------

    # mirrors serving.MAX_BODY_BYTES (not imported: the client stays
    # stdlib + numpy only, and serving imports torch)
    MAX_BODY_BYTES = 256 * 1024 * 1024

    def _request(self, path: str, payload: Optional[dict] = None) -> dict:
        data = None if payload is None else json.dumps(payload).encode()
        if data is not None and len(data) > self.MAX_BODY_BYTES:
            # the server refuses these with 413 and may reset the socket
            # mid-upload, which would look retryable — fail fast instead of
            # re-uploading a doomed payload
            raise ServingError(
                413, f"request body {len(data)} bytes exceeds {self.MAX_BODY_BYTES}"
            )
        last: Exception = ServingError(0, "no attempt ran")
        for attempt in range(self.retries + 1):
            req = urllib.request.Request(
                self.base_url + path,
                data=data,
                headers={"Content-Type": "application/json"} if data else {},
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                body = e.read()
                try:
                    parsed = json.loads(body)
                    # a proxy's error body may be valid JSON but not an
                    # object (e.g. "Bad Gateway")
                    msg = (
                        parsed.get("error", body.decode(errors="replace"))
                        if isinstance(parsed, dict)
                        else body.decode(errors="replace")
                    )
                except json.JSONDecodeError:
                    msg = body.decode(errors="replace")
                if e.code < 500:  # caller bug — retrying cannot help
                    raise ServingError(e.code, msg) from None
                last = ServingError(e.code, msg)
            except (urllib.error.URLError, TimeoutError, OSError) as e:
                last = e
            if attempt < self.retries:
                time.sleep(self.backoff_s * (2**attempt))
        if isinstance(last, ServingError):
            raise last
        raise ServingError(0, f"server unreachable after {self.retries + 1} attempts: {last}")

    # ---- endpoints ------------------------------------------------------

    def healthz(self) -> dict:
        return self._request("/healthz")

    def metrics(self) -> dict:
        return self._request("/metrics")["endpoints"]

    def encode_text(self, texts: Sequence[str]) -> np.ndarray:
        out = self._request("/encode_text", {"texts": list(texts)})
        return np.asarray(out["features"], np.float32)

    @staticmethod
    def _b64(images: Sequence[Union[str, bytes]]) -> List[str]:
        blobs = []
        for im in images:
            if isinstance(im, (bytes, bytearray)):
                blobs.append(bytes(im))
            else:
                with open(im, "rb") as f:
                    blobs.append(f.read())
        return [base64.b64encode(b).decode() for b in blobs]

    def encode_image_files(self, images: Sequence[Union[str, bytes]]) -> np.ndarray:
        """images: file paths or raw encoded bytes (PNG, JPEG or a ``.npy``
        uint8 array)."""
        out = self._request("/encode_image", {"images_b64": self._b64(images)})
        return np.asarray(out["features"], np.float32)

    def classify(self, images: Sequence[Union[str, bytes]], top_k: int = 5) -> List[List[dict]]:
        out = self._request(
            "/classify", {"images_b64": self._b64(images), "top_k": int(top_k)}
        )
        return out["results"]

    def index(self, images: Sequence[Union[str, bytes]], ids: Sequence[str]) -> int:
        out = self._request(
            "/index", {"images_b64": self._b64(images), "ids": list(ids)}
        )
        return int(out["indexed"])

    def retrieve(self, texts: Sequence[str], top_k: int = 5) -> List[List[dict]]:
        out = self._request("/retrieve", {"texts": list(texts), "top_k": int(top_k)})
        return out["results"]

    def similarity(self, images: Sequence[Union[str, bytes]], texts: Sequence[str]) -> dict:
        """{"logits_per_image", "probs"} as np.float32 arrays [n_img, n_txt]
        — the reference README demo over HTTP."""
        out = self._request(
            "/similarity", {"images_b64": self._b64(images), "texts": list(texts)}
        )
        return {k: np.asarray(v, np.float32) for k, v in out.items()}
