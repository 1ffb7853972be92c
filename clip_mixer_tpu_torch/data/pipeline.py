"""Training data: the synthetic source, the host-RAM cache and the prefetches.

Counterpart of the ``SyntheticSource`` / ``CacheSource`` / ``prefetch`` part
of ``clip_mixer_tpu/data/pipeline.py``. A source yields :class:`Batch` es of
numpy arrays, ``{"images": uint8 [B, H, W, 3], "texts": int32 [B, ctx]}``;
batch ``b`` of epoch ``e`` is a pure function of the source's arguments and
``(e, b)``, so a resumed run fast-forwards by batch index (``start_batch``)
and sees the bytes it would have seen. For the same arguments the batches
are bit for bit the JAX sources'.

:func:`prefetch` runs a source in a background thread, bounded, so host data
work overlaps the device (with :func:`pinned` inside it on CUDA, the
pinning copy too); :func:`device_prefetch` then moves each batch to the
training device: on CUDA on a side stream, so the copy of batch ``i + 1``
overlaps step ``i``.

The tar, file-list and mixture sources (the JAX ``--data`` path) are not
ported yet (ROADMAP.md, Queue 1 item 10b).
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
from collections import deque
from typing import Iterator, Optional

import numpy as np
import torch

from clip_mixer_tpu_torch.text.tokenize import tokenize

CAPTION_NAMES = (
    "red square", "green circle", "blue triangle", "yellow star",
    "purple hexagon", "orange diamond", "cyan spiral", "magenta cross",
    "black arrow", "white ring", "brown leaf", "pink heart",
    "gray cloud", "teal wave", "gold crown", "silver moon",
)


class Batch(dict):
    """{"images": uint8 [B, H, W, 3], "texts": int32 [B, context_length]}."""


class DataSource:
    """Protocol: iter_batches(epoch, start_batch) -> Iterator[Batch]."""

    def iter_batches(self, epoch: int, start_batch: int = 0) -> Iterator[Batch]:
        raise NotImplementedError

    @property
    def batches_per_epoch(self) -> Optional[int]:
        return None


class SyntheticSource(DataSource):
    """Class-coloured noise images with matching captions, so a model can
    learn the alignment: batch ``b`` of epoch ``e`` draws its classes and
    noise from ``numpy.random.default_rng((seed, e, b))``."""

    def __init__(
        self,
        batch_size: int,
        image_size: int = 224,
        n_batches: int = 100,
        n_classes: int = 16,
        context_length: int = 77,
        seed: int = 0,
    ):
        if n_classes > len(CAPTION_NAMES):
            raise ValueError(f"n_classes <= {len(CAPTION_NAMES)} (have {len(CAPTION_NAMES)} caption names)")
        self.batch_size = batch_size
        self.image_size = image_size
        self.n_batches = n_batches
        self.n_classes = n_classes
        self.context_length = context_length
        self.seed = seed
        self.captions = [f"a photo of a {n}." for n in CAPTION_NAMES[:n_classes]]
        self.tokens = tokenize(self.captions, context_length, truncate=True)
        self.colors = np.random.default_rng(seed).integers(30, 226, (n_classes, 3)).astype(np.int16)

    @property
    def batches_per_epoch(self) -> Optional[int]:
        return self.n_batches

    def iter_batches(self, epoch: int, start_batch: int = 0) -> Iterator[Batch]:
        for b in range(start_batch, self.n_batches):
            rng = np.random.default_rng((self.seed, epoch, b))
            classes = rng.integers(0, self.n_classes, self.batch_size)
            noise = rng.integers(-30, 30, (self.batch_size, self.image_size, self.image_size, 3))
            images = np.clip(self.colors[classes][:, None, None] + noise, 0, 255).astype(np.uint8)
            yield Batch(images=images, texts=self.tokens[classes])


def _concat_consuming(chunks: list) -> np.ndarray:
    """``np.concatenate(chunks)`` at ~1x peak memory: the result is
    preallocated and each chunk is dropped once copied."""
    n = sum(c.shape[0] for c in chunks)
    out = np.empty((n,) + chunks[0].shape[1:], chunks[0].dtype)
    while chunks:
        c = chunks.pop()
        out[n - c.shape[0]:n] = c
        n -= c.shape[0]
    return out


class CacheSource(DataSource):
    """Decode once, then serve every epoch from host RAM.

    The first use materialises what the inner source yields for epoch 0
    into two host arrays (images and token rows), refusing to grow past
    ``max_bytes``. Each epoch is a fresh permutation of all samples from
    ``default_rng((seed, epoch, 3))``; within a batch the samples are in
    ascending order (the contrastive losses are equivariant to it, and a
    sorted gather is far faster). Batch ``b`` of epoch ``e`` stays a pure
    function of ``(seed, e, b)``.

    ``cache_dir`` makes the cache disk-backed: memmapped ``.npy`` files keyed
    by :meth:`_fingerprint`, written through a temporary file and
    ``os.replace``, so an interrupted fill is never taken for a cache and a
    later process (a resumed run, a second experiment) skips the fill.
    """

    def __init__(self, inner: DataSource, seed: int = 0, max_bytes: int = 64 << 30,
                 cache_dir: Optional[str] = None):
        if cache_dir is not None and "://" in str(cache_dir):
            # the cache is memmapped, and os.path would create a local "./gs:/"
            raise ValueError(
                f"cache_dir must be a local directory, got {cache_dir!r}; "
                "point --cache-data at local SSD (the cache is memmapped)"
            )
        self.inner = inner
        self.seed = seed
        self.max_bytes = max_bytes
        self.cache_dir = cache_dir
        self.batch_size = inner.batch_size
        self._images: Optional[np.ndarray] = None
        self._texts: Optional[np.ndarray] = None

    def _fingerprint(self) -> str:
        """Identity of the filled cache: the inner source's shard files
        (path, size, mtime), its captions where it keeps them outside the
        shards, and the decode geometry. A source that reads no files (a
        :class:`SyntheticSource`) is known by its captions and the arguments
        it draws from, which the JAX fingerprint leaves out: two such
        sources with other seeds must not share a cache."""
        h = hashlib.sha256()
        shards = getattr(self.inner, "shards", [])
        entries = getattr(self.inner, "entries", [])
        for p in shards:
            try:
                st = os.stat(p)
                h.update(f"{p}:{st.st_size}:{st.st_mtime_ns};".encode())
            except OSError:
                h.update(f"{p}:?;".encode())
        for _, caption in entries:
            h.update(caption.encode())
            h.update(b"\x00")
        if not shards and not entries:
            for caption in getattr(self.inner, "captions", []):
                h.update(caption.encode())
                h.update(b"\x00")
            drawn = [getattr(self.inner, k, None) for k in ("seed", "n_batches", "batch_size")]
            h.update(f"drawn={drawn};".encode())
        h.update(f"res={getattr(self.inner, 'image_size', 0)};"
                 f"ctx={getattr(self.inner, 'context_length', 0)}".encode())
        return h.hexdigest()[:16]

    def _fill(self) -> None:
        if self.cache_dir is not None:
            fp = self._fingerprint()
            img_path = os.path.join(self.cache_dir, f"images-{fp}.npy")
            txt_path = os.path.join(self.cache_dir, f"texts-{fp}.npy")
            if os.path.exists(img_path) and os.path.exists(txt_path):
                self._images = np.load(img_path, mmap_mode="r")
                self._texts = np.load(txt_path, mmap_mode="r")
                return
        imgs, txts, total = [], [], 0
        # the fill must see every sample: the cache batches anew
        inner_drop_last = getattr(self.inner, "drop_last", None)
        if inner_drop_last is not None:
            self.inner.drop_last = False
        try:
            for batch in self.inner.iter_batches(epoch=0):
                imgs.append(batch["images"])
                txts.append(batch["texts"])
                total += batch["images"].nbytes + batch["texts"].nbytes
                if total > self.max_bytes:
                    raise MemoryError(
                        f"CacheSource: cache would exceed max_bytes={self.max_bytes}; "
                        "stream from the inner source instead or raise the budget"
                    )
        finally:
            if inner_drop_last is not None:
                self.inner.drop_last = inner_drop_last
        if not imgs:
            raise ValueError("CacheSource: inner source yielded no batches")
        self._images = _concat_consuming(imgs)
        self._texts = _concat_consuming(txts)
        if self.cache_dir is not None:
            os.makedirs(self.cache_dir, exist_ok=True)
            for path, arr in ((img_path, self._images), (txt_path, self._texts)):
                tmp = f"{path}.tmp{os.getpid()}.npy"
                with open(tmp, "wb") as f:
                    np.save(f, arr)
                os.replace(tmp, path)

    @property
    def n_samples(self) -> int:
        if self._images is None:
            self._fill()
        return self._images.shape[0]

    @property
    def batches_per_epoch(self) -> Optional[int]:
        return self.n_samples // self.batch_size

    def iter_batches(self, epoch: int, start_batch: int = 0) -> Iterator[Batch]:
        n = self.n_samples
        order = np.random.default_rng((self.seed, epoch, 3)).permutation(n)
        for b in range(start_batch, n // self.batch_size):
            idx = np.sort(order[b * self.batch_size:(b + 1) * self.batch_size])
            yield Batch(images=self._images[idx], texts=self._texts[idx])


def prefetch(iterator: Iterator[Batch], depth: int = 2,
             stop: Optional[threading.Event] = None) -> Iterator[Batch]:
    """Run ``iterator`` in a background thread, ``depth`` items ahead.

    An error in the iterator is raised to the consumer. ``stop``: once set,
    a consumer blocked on the queue stops waiting and the generator ends
    (items already queued are yielded first); the trainer passes its
    preemption flag, so a SIGTERM interrupts a stalled data wait. The worker
    gives up when the consumer goes away."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    worker_stop = threading.Event()

    def put(item) -> bool:
        while not worker_stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            if stop is None:
                item = q.get()
            else:
                try:
                    item = q.get(timeout=0.5)
                except queue.Empty:
                    if stop.is_set():
                        return
                    continue
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        worker_stop.set()


def _ready(batch: dict, copied: "torch.cuda.Event", device: torch.device) -> Batch:
    """A batch copied on the side stream, made safe to use on the current one."""
    stream = torch.cuda.current_stream(device)
    stream.wait_event(copied)
    for t in batch.values():
        t.record_stream(stream)  # the allocator must not reuse it before this stream is done
    return Batch(batch)


def pinned(batches: Iterator[dict]) -> Iterator[Batch]:
    """Host batches of arrays -> :class:`Batch` es of tensors in pinned
    memory. Run it inside :func:`prefetch`, so the pinning copy happens in
    the background thread and not on the step's thread."""
    for b in batches:
        yield Batch({k: torch.as_tensor(v).pin_memory() for k, v in b.items()})


def device_prefetch(batches: Iterator[dict], device, depth: int = 1) -> Iterator[Batch]:
    """Host batches -> :class:`Batch` es of tensors on ``device``.

    On CUDA each batch is copied with ``non_blocking=True`` on a side stream
    (pinned first, unless it is already: see :func:`pinned`), and the copies
    of the next ``depth`` batches are issued before a batch is yielded; the
    consumer's stream waits on the batch's copy event, so the copy of the
    next batch overlaps the step on this one. Elsewhere the arrays become
    tensors without a copy."""
    device = torch.device(device)
    if device.type != "cuda":
        for b in batches:
            yield Batch({k: torch.as_tensor(v) for k, v in b.items()})
        return
    side = torch.cuda.Stream(device)
    ahead: deque = deque()
    for b in batches:
        host = {k: torch.as_tensor(v) for k, v in b.items()}
        host = {k: t if t.is_pinned() else t.pin_memory() for k, t in host.items()}
        with torch.cuda.stream(side):
            on_dev = {k: t.to(device, non_blocking=True) for k, t in host.items()}
            copied = torch.cuda.Event()
            copied.record(side)
        ahead.append((on_dev, copied))
        if len(ahead) > depth:
            yield _ready(*ahead.popleft(), device)
    while ahead:
        yield _ready(*ahead.popleft(), device)
