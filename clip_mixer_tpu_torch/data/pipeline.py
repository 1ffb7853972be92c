"""Training data: the synthetic, tar, file-list and mixture sources, the host-RAM cache and the prefetches.

Counterpart of ``clip_mixer_tpu/data/pipeline.py``. A source yields :class:`Batch` es of
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

The tar, file-list and mixture sources behind ``--data`` decode JPEG and
PNG records with Pillow, imported only then; they also take ``.npy``
records holding the uint8 [image_size, image_size, 3] array itself, read
with ``numpy.load`` (a deviation from the JAX package, for hosts without
Pillow).
"""

from __future__ import annotations

import glob
import hashlib
import io
import os
import queue
import sys
import tarfile
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

# captions go through the C++ tokenizer, as in the JAX sources
from clip_mixer_tpu_torch.text.fast import fast_tokenize as tokenize

CAPTION_NAMES = (
    "red square", "green circle", "blue triangle", "yellow star",
    "purple hexagon", "orange diamond", "cyan spiral", "magenta cross",
    "black arrow", "white ring", "brown leaf", "pink heart",
    "gray cloud", "teal wave", "gold crown", "silver moon",
)


IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".npy")

# (image bytes, caption, whether the bytes are an .npy array)
Sample = Tuple[bytes, str, bool]


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


def _decode_one(img_bytes: bytes, image_size: int, is_npy: bool) -> np.ndarray:
    """One record -> HWC uint8 [image_size, image_size, 3]. An ``.npy``
    record must hold that array and is read with ``numpy.load``; a JPEG or
    PNG goes through Pillow (short-side bicubic, centre crop), whose absence
    is an ``ImportError`` naming it, never a decode error."""
    if is_npy:
        image = np.load(io.BytesIO(img_bytes), allow_pickle=False)
        if image.dtype != np.uint8 or image.shape != (image_size, image_size, 3):
            raise ValueError(f".npy record holds {image.dtype} {image.shape}, "
                             f"not uint8 {(image_size, image_size, 3)}")
        return image
    if not img_bytes:
        raise ValueError("empty image record")
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding .jpg/.jpeg/.png records needs Pillow (PIL), which is not installed: "
                          "install Pillow, or store the images as uint8 .npy arrays") from e
    from clip_mixer_tpu_torch.ops.preprocess import preprocess_pil

    with Image.open(io.BytesIO(img_bytes)) as im:
        return preprocess_pil(im, image_size)


class _DecodeError:
    """A record that failed to decode (picklable across the process pool);
    the consumer raises or substitutes it."""

    def __init__(self, msg: str):
        self.msg = msg


def _decode_checked(img_bytes: bytes, caption: str, image_size: int, is_npy: bool):
    try:
        return _decode_one(img_bytes, image_size, is_npy), caption
    except ImportError:  # a missing decoder is the host's fault, not the record's
        raise
    except Exception as e:  # a corrupt or truncated record
        return _DecodeError(repr(e))


def _decode_chunk(args):
    """Decode a chunk of samples: one process-pool task, so the IPC cost is
    spread over many images."""
    samples, image_size = args
    return [_decode_checked(b, c, image_size, npy) for b, c, npy in samples]


class _RetryingStream(io.RawIOBase):
    """Sequential reader over a remote object (any fsspec scheme: gs://,
    s3://, file://, memory://) that retries a failed read a bounded number
    of times: it reopens the object and seeks back to the byte offset
    already consumed, so no sample is skipped or read twice and resume by
    count still holds."""

    def __init__(self, path: str, retries: int = 4, backoff: float = 0.5, open_fn=None):
        if open_fn is None:
            import fsspec

            open_fn = lambda: fsspec.open(path, "rb").open()  # noqa: E731
        self._open_fn = open_fn
        self._path = path
        self._retries = retries
        self._backoff = backoff
        self._pos = 0
        self._f = None
        self._reopen()

    def _reopen(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except Exception:  # the connection being replaced may be dead already
                pass
        self._f = self._open_fn()
        if self._pos:
            self._f.seek(self._pos)

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        delay = self._backoff
        for attempt in range(self._retries + 1):
            try:
                data = self._f.read(len(b))
                n = len(data)
                b[:n] = data
                self._pos += n
                return n
            except Exception:
                if attempt == self._retries:
                    raise
                time.sleep(delay)
                delay *= 2
                try:
                    self._reopen()
                except Exception:  # the next attempt reopens again
                    pass
        raise AssertionError("unreachable")

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except Exception:  # closing a dead connection
                pass
        super().close()


def open_shard_stream(path: str, readahead_bytes: int = 16 << 20):
    """Readahead-buffered, retrying byte stream over a remote shard."""
    return io.BufferedReader(_RetryingStream(path), buffer_size=readahead_bytes)


def expand_shard_pattern(pattern: str) -> List[str]:
    """Glob a shard pattern, local or remote (any fsspec scheme; fsspec is
    imported only for a ``://`` pattern)."""
    if "://" in pattern:
        import fsspec

        fs, _, paths = fsspec.get_fs_token_paths(pattern)
        return [fs.unstrip_protocol(p) for p in paths]
    return sorted(glob.glob(pattern))


class TarShardSource(DataSource):
    """Webdataset tar shards, local or remote (``gs://``, ``s3://``, ...
    through fsspec, streamed with readahead and bounded retry).

    A shard holds ``{key}.jpg`` (or ``.jpeg``, ``.png``, ``.npy``) +
    ``{key}.txt`` pairs, the img2dataset layout. Images are decoded on the
    host to HWC uint8 at ``image_size`` (:func:`_decode_one`), captions are
    tokenized with truncation. Shard order is a permutation seeded by
    ``(seed, epoch)``, samples keep their order within a shard, and
    ``start_batch`` fast-forwards by count without decoding, so batch ``b``
    of epoch ``e`` is a pure function of the arguments. Host ``h`` of
    ``n_hosts`` reads every ``n_hosts``-th shard from ``h``, every host the
    same count (trailing shards beyond a multiple are dropped): a host that
    ran out first would leave the others waiting in a collective.

    ``decode_mode``: ``"thread"`` (Pillow releases the GIL while it
    decodes) or ``"process"`` (a spawned pool, fed in chunks).
    ``shuffle_buffer``: a streaming reservoir of that many raw samples
    seeded by ``(seed, epoch, 2)``: once full, each new sample evicts a
    random resident one (0 or 1: off). ``on_decode_error``: ``"raise"``
    fails on the first undecodable record; ``"substitute"`` replaces it by
    the nearest good sample of its batch and counts it in
    ``decode_errors``, which keeps batch boundaries on raw sample counts (a
    batch with no good sample is dropped and counted).
    """

    def __init__(
        self,
        shard_paths: Sequence[str],
        batch_size: int,
        image_size: int = 224,
        context_length: int = 77,
        seed: int = 0,
        n_hosts: int = 1,
        host_index: int = 0,
        decode_workers: int = 8,
        decode_mode: str = "thread",
        drop_last: bool = True,
        shuffle_buffer: int = 0,
        on_decode_error: str = "raise",
    ):
        if decode_mode not in ("thread", "process"):
            raise ValueError(f"decode_mode must be thread|process, got {decode_mode!r}")
        if on_decode_error not in ("raise", "substitute"):
            raise ValueError(f"on_decode_error must be raise|substitute, got {on_decode_error!r}")
        all_shards = sorted(shard_paths)
        if n_hosts > 1:
            per = len(all_shards) // n_hosts
            if per == 0:
                raise ValueError(f"{len(all_shards)} shards cannot feed {n_hosts} hosts")
            self.shards = all_shards[host_index::n_hosts][:per]
        else:
            self.shards = all_shards
        self.batch_size = batch_size
        self.image_size = image_size
        self.context_length = context_length
        self.seed = seed
        self.decode_workers = decode_workers
        self.decode_mode = decode_mode
        self.drop_last = drop_last
        self.shuffle_buffer = shuffle_buffer
        self.on_decode_error = on_decode_error
        self.decode_errors = 0

    def _iter_samples(self, epoch: int) -> Iterator[Sample]:
        it = self._iter_shard_samples(epoch)
        if self.shuffle_buffer <= 1:
            return it
        return self._shuffled(it, epoch)

    def _shuffled(self, it: Iterator[Sample], epoch: int) -> Iterator[Sample]:
        """The bounded streaming shuffle; the tail is drained Fisher-Yates."""
        rng = np.random.default_rng((self.seed, epoch, 2))
        buf: List[Sample] = []
        for sample in it:
            buf.append(sample)
            if len(buf) >= self.shuffle_buffer:
                i = int(rng.integers(0, len(buf)))
                buf[i], buf[-1] = buf[-1], buf[i]
                yield buf.pop()
        for j in range(len(buf) - 1, 0, -1):
            k = int(rng.integers(0, j + 1))
            buf[j], buf[k] = buf[k], buf[j]
        yield from buf

    def _iter_shard_samples(self, epoch: int) -> Iterator[Sample]:
        order = np.random.default_rng((self.seed, epoch)).permutation(len(self.shards))
        for si in order:
            path = self.shards[si]
            if "://" in path:
                # a sequential tar stream ("r|*") over the retrying reader
                with open_shard_stream(path) as fobj, tarfile.open(fileobj=fobj, mode="r|*") as tar:
                    yield from self._iter_tar_members(tar)
            else:
                with tarfile.open(path, "r") as tar:
                    yield from self._iter_tar_members(tar)

    @staticmethod
    def _iter_tar_members(tar) -> Iterator[Sample]:
        pending: Dict[str, dict] = {}
        for info in tar:
            if not info.isfile():
                continue
            key, ext = os.path.splitext(os.path.basename(info.name))
            if ext not in IMAGE_EXTS + (".txt",):
                continue
            entry = pending.setdefault(key, {})
            if ext == ".txt":
                entry["txt"] = tar.extractfile(info).read()
            else:
                entry["img"], entry["npy"] = tar.extractfile(info).read(), ext == ".npy"
            if "img" in entry and "txt" in entry:
                yield entry["img"], entry["txt"].decode("utf-8", "replace"), entry["npy"]
                del pending[key]

    def _decode(self, sample: Sample):
        img_bytes, caption, is_npy = sample
        return _decode_checked(img_bytes, caption, self.image_size, is_npy)

    def _decode_batch(self, pool, raw):
        if self.decode_mode == "process":
            n = max(1, len(raw) // self.decode_workers)
            chunks = [(raw[i : i + n], self.image_size) for i in range(0, len(raw), n)]
            out: list = []
            for part in pool.map(_decode_chunk, chunks):
                out.extend(part)
        else:
            out = list(pool.map(self._decode, raw))
        bad = [i for i, d in enumerate(out) if isinstance(d, _DecodeError)]
        if not bad:
            return out
        if self.on_decode_error == "raise":
            raise RuntimeError(
                f"{len(bad)}/{len(out)} samples failed to decode "
                f"(first: {out[bad[0]].msg}); pass on_decode_error='substitute' "
                "to train through corrupt records"
            )
        if len(bad) == len(out):
            # nothing to substitute from: the batch is dropped (the raw
            # counts advanced, so resume stays aligned)
            self.decode_errors += len(bad)
            print(f"TarShardSource: dropped a batch of {len(out)} samples — "
                  f"ALL failed to decode (first: {out[bad[0]].msg})", file=sys.stderr)
            return None
        good = [i for i in range(len(out)) if not isinstance(out[i], _DecodeError)]
        for i in bad:
            out[i] = out[min(good, key=lambda g: abs(g - i))]
        first_errors = self.decode_errors == 0
        self.decode_errors += len(bad)
        if first_errors:
            print(f"TarShardSource: substituted {len(bad)} undecodable sample(s) "
                  "with in-batch neighbors (counted in .decode_errors; "
                  "further substitutions are silent)", file=sys.stderr)
        return out

    def iter_batches(self, epoch: int, start_batch: int = 0) -> Iterator[Batch]:
        if self.decode_mode == "process":
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            # spawn: forking a process that runs threads is unsafe
            pool = ProcessPoolExecutor(self.decode_workers, mp_context=multiprocessing.get_context("spawn"))
        else:
            pool = ThreadPoolExecutor(self.decode_workers)
        try:
            it = self._iter_samples(epoch)
            skip = start_batch * self.batch_size
            while True:
                raw = []
                for sample in it:
                    if skip > 0:  # fast-forward without decoding
                        skip -= 1
                        continue
                    raw.append(sample)
                    if len(raw) == self.batch_size:
                        break
                if len(raw) < self.batch_size and (self.drop_last or not raw):
                    return
                decoded = self._decode_batch(pool, raw)
                if decoded is None:
                    continue
                images = np.stack([d[0] for d in decoded])
                texts = tokenize([d[1] for d in decoded], self.context_length, truncate=True)
                yield Batch(images=images, texts=texts)
        finally:
            pool.shutdown(wait=False)


class FileListSource(TarShardSource):
    """(image file, caption) pairs from a list, a CSV/TSV manifest
    (:meth:`from_csv`) or an image folder (:meth:`from_folder`): training
    on the files one has, without packing shards first.

    All of :class:`TarShardSource` holds but the sample order: with the
    whole list in memory each epoch is a full permutation seeded by
    ``(seed, epoch)`` (``shuffle_buffer`` is accepted and adds nothing).
    Hosts split the entries round-robin at equal counts. An unreadable file
    is a decode error under ``on_decode_error="substitute"``.
    """

    def __init__(self, entries: Sequence[Tuple[str, str]], batch_size: int, **kwargs):
        entries = [(str(p), str(c)) for p, c in entries]
        if not entries:
            raise ValueError("FileListSource needs at least one (path, caption) entry")
        n_hosts = int(kwargs.pop("n_hosts", 1))
        host_index = int(kwargs.pop("host_index", 0))
        if n_hosts > 1:
            per = len(entries) // n_hosts
            if per == 0:
                raise ValueError(f"{len(entries)} entries cannot feed {n_hosts} hosts")
            entries = entries[host_index::n_hosts][:per]
        self.entries = entries
        super().__init__([p for p, _ in entries], batch_size, **kwargs)

    @property
    def batches_per_epoch(self) -> Optional[int]:
        full, rem = divmod(len(self.entries), self.batch_size)
        return full + (1 if rem and not self.drop_last else 0)

    def _iter_shard_samples(self, epoch: int) -> Iterator[Sample]:
        order = np.random.default_rng((self.seed, epoch)).permutation(len(self.entries))
        for i in order:
            path, caption = self.entries[i]
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                if self.on_decode_error != "substitute":
                    raise
                data = b""  # keeps the slot: the batch substitutes it
            yield data, caption, path.lower().endswith(".npy")

    _HEADER_PATH = ("filepath", "file", "image", "image_path", "img_path", "path", "url")
    _HEADER_CAPTION = ("caption", "text", "title", "label")

    @classmethod
    def from_csv(cls, manifest_path: str, batch_size: int, image_root: Optional[str] = None,
                 delimiter: Optional[str] = None, **kwargs) -> "FileListSource":
        """A manifest of (image path, caption) rows.

        * ``delimiter``: tab for ``.tsv``, else comma, unless given.
        * The first row is a header iff one of its cells is a path column
          name (filepath/file/image/...) and none names an existing file;
          the caption column is then found by name (caption/text/title/label),
          else the first other column. A first row without such a name whose
          path cell neither looks like a path nor resolves is refused.
        * Remote entries (``http(s)://``) are refused: this source opens
          local files only.
        * Relative paths resolve against ``image_root`` (default: the
          manifest's directory).
        """
        import csv

        if delimiter is None:
            delimiter = "\t" if manifest_path.lower().endswith(".tsv") else ","
        root = image_root if image_root is not None else os.path.dirname(os.path.abspath(manifest_path))

        def resolve(cell):
            cell = cell.strip()
            return cell if os.path.isabs(cell) else os.path.join(root, cell)

        entries: List[Tuple[str, str]] = []
        with open(manifest_path, newline="", encoding="utf-8") as f:
            path_col, caption_col = 0, 1
            for lineno, row in enumerate(csv.reader(f, delimiter=delimiter)):
                if not row or (len(row) == 1 and not row[0].strip()):
                    continue
                if lineno == 0:
                    names = [c.strip().lower() for c in row]
                    path_hits = [j for j, n in enumerate(names) if n in cls._HEADER_PATH]
                    # a header names columns: none of its cells is a file
                    if path_hits and not any(os.path.isfile(resolve(c)) for c in row):
                        path_col = path_hits[0]
                        caption_col = next((j for j, n in enumerate(names) if n in cls._HEADER_CAPTION),
                                           0 if path_col != 0 else 1)
                        continue
                    cell = row[path_col].strip() if len(row) > path_col else ""
                    looks_like_path = ("/" in cell or os.sep in cell
                                       or cell.lower().endswith((".jpg", ".jpeg", ".png", ".webp", ".bmp",
                                                                 ".gif", ".tif", ".tiff", ".npy")))
                    if cell and "://" not in cell and not looks_like_path and not os.path.exists(resolve(cell)):
                        raise ValueError(
                            f"{manifest_path}:1: first row is not a recognised "
                            f"header ({'/'.join(cls._HEADER_PATH)}) and its path "
                            f"cell does not resolve to a file ({resolve(cell)}); "
                            "rename the header columns or fix image_root"
                        )
                if len(row) <= max(path_col, caption_col):
                    raise ValueError(f"{manifest_path}:{lineno + 1}: need at least "
                                     f"{max(path_col, caption_col) + 1} columns, got {len(row)}")
                p = row[path_col].strip()
                if p.startswith(("http://", "https://")):
                    raise ValueError(
                        f"{manifest_path}:{lineno + 1}: remote URLs are not "
                        "supported by FileListSource (it opens local paths "
                        "only): download the images first, or pack local files "
                        "with scripts/torch_pack_dataset.py"
                    )
                entries.append((resolve(p), row[caption_col]))
        return cls(entries, batch_size, **kwargs)

    @classmethod
    def from_folder(cls, root: str, batch_size: int, caption_from: str = "txt", **kwargs) -> "FileListSource":
        """Every ``.jpg`` / ``.jpeg`` / ``.png`` / ``.npy`` under ``root``,
        recursively and sorted (so the list, and resume, are deterministic).
        ``caption_from``: ``"txt"``, the sidecar ``<stem>.txt`` (a missing
        one is an error); ``"dirname"``, ``"a photo of a <parent dir>."``;
        ``"stem"``, the file name's stem; in the last two ``_`` and ``-``
        read as spaces."""
        if caption_from not in ("txt", "dirname", "stem"):
            raise ValueError(f"caption_from must be txt|dirname|stem, got {caption_from!r}")
        images: List[str] = []
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for name in sorted(filenames):
                if os.path.splitext(name)[1].lower() in IMAGE_EXTS:
                    images.append(os.path.join(dirpath, name))
        if not images:
            raise ValueError(f"no {'/'.join(IMAGE_EXTS)} images under {root}")
        entries: List[Tuple[str, str]] = []
        for path in images:
            if caption_from == "txt":
                sidecar = os.path.splitext(path)[0] + ".txt"
                if not os.path.exists(sidecar):
                    raise FileNotFoundError(f"{path}: no sidecar caption {os.path.basename(sidecar)} "
                                            "(use caption_from='dirname' or 'stem' for caption-less trees)")
                with open(sidecar, encoding="utf-8", errors="replace") as f:
                    caption = f.read().strip()
            elif caption_from == "dirname":
                label = os.path.basename(os.path.dirname(path)).replace("_", " ").replace("-", " ")
                caption = f"a photo of a {label}."
            else:
                caption = os.path.splitext(os.path.basename(path))[0].replace("_", " ").replace("-", " ")
            entries.append((path, caption))
        return cls(entries, batch_size, **kwargs)


class MixtureSource(TarShardSource):
    """A weighted mixture of tar-shard corpora, blended sample by sample:
    each sample slot comes from component ``i`` with probability
    ``weights[i]`` (normalised; uniform by default), on a schedule seeded by
    ``(seed, epoch, 3)``.

    Each component is a full :class:`TarShardSource` (its own shard
    permutation, reservoir and host split); the caller's ``shuffle_buffer``
    is a budget split among them by weight (at least 2 each). A component
    that runs out restarts on another shard order, so the stream never
    ends: set ``steps_per_epoch``. The stream is a pure function of
    ``(seed, epoch)``, so resume by count holds.
    """

    def __init__(self, components: Sequence[Sequence[str]], batch_size: int,
                 weights: Optional[Sequence[float]] = None, **kwargs):
        if not components or any(not c for c in components):
            raise ValueError("every mixture component needs at least one shard")
        if weights is None:
            weights = [1.0] * len(components)
        if len(weights) != len(components) or any(w <= 0 for w in weights):
            raise ValueError(f"need {len(components)} positive weights, got {weights}")
        self.weights = np.asarray(weights, np.float64) / np.sum(weights)
        total_buf = int(kwargs.get("shuffle_buffer", 0) or 0)
        self.children = []
        for paths, w in zip(components, self.weights):
            child_kwargs = dict(kwargs)
            if total_buf > 1:
                child_kwargs["shuffle_buffer"] = max(2, int(round(total_buf * w)))
            self.children.append(TarShardSource(paths, batch_size, **child_kwargs))
        # the children split by host; the blend must not split again
        parent_kwargs = dict(kwargs, n_hosts=1, host_index=0)
        super().__init__([p for paths in components for p in paths], batch_size, **parent_kwargs)

    def _iter_samples(self, epoch: int) -> Iterator[Sample]:
        rng = np.random.default_rng((self.seed, epoch, 3))
        n = len(self.children)
        repeats = [0] * n
        iters = [c._iter_samples(epoch) for c in self.children]

        def take(i):
            try:
                return next(iters[i])
            except StopIteration:
                # restart on another shard order, under an epoch key clear of real ones
                repeats[i] += 1
                iters[i] = self.children[i]._iter_samples(epoch + 1_000_003 * repeats[i])
                try:
                    return next(iters[i])
                except StopIteration:
                    raise RuntimeError(f"mixture component {i} yielded no samples "
                                       f"({len(self.children[i].shards)} shards)") from None

        while True:
            for i in rng.choice(n, size=4096, p=self.weights):
                yield take(int(i))


def _add_member(tar, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def _write_shards(samples: Iterator[Tuple[str, bytes, str]], out_dir: str, samples_per_shard: int) -> List[str]:
    """(image extension, image bytes, caption) -> ``{i:09d}{ext}`` +
    ``{i:09d}.txt`` members in ``out_dir/{shard:05d}.tar``."""
    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    tar = None
    try:
        for i, (ext, img, caption) in enumerate(samples):
            if i % samples_per_shard == 0:
                if tar is not None:
                    tar.close()
                paths.append(os.path.join(out_dir, f"{len(paths):05d}.tar"))
                tar = tarfile.open(paths[-1], "w")
            _add_member(tar, f"{i:09d}{ext}", img)
            _add_member(tar, f"{i:09d}.txt", caption.encode())
    finally:
        if tar is not None:
            tar.close()
    return paths


def write_tar_shards_from_files(entries: Sequence[Tuple[str, str]], out_dir: str,
                                samples_per_shard: int = 10000) -> List[str]:
    """Pack (image file, caption) entries into webdataset tar shards by raw
    byte copy (no decode, pixels untouched): from a
    :class:`FileListSource`'s entries to the sequential-read layout of
    large runs (``scripts/torch_pack_dataset.py``). Takes ``.jpg``,
    ``.jpeg``, ``.png`` and ``.npy`` files."""

    def samples():
        for src_path, caption in entries:
            ext = os.path.splitext(src_path)[1].lower()
            if ext not in IMAGE_EXTS:
                raise ValueError(f"{src_path}: only {'/'.join(IMAGE_EXTS)} can be packed")
            with open(src_path, "rb") as f:
                yield ext, f.read(), caption

    return _write_shards(samples(), out_dir, samples_per_shard)


def write_tar_shards(samples: Iterator[Tuple[np.ndarray, str]], out_dir: str, samples_per_shard: int = 10000,
                     quality: int = 95) -> List[str]:
    """Pack (HWC uint8 image, caption) pairs into webdataset tar shards,
    each image JPEG-encoded by Pillow at ``quality``."""
    from PIL import Image

    def encoded():
        for image, caption in samples:
            buf = io.BytesIO()
            Image.fromarray(image).save(buf, "JPEG", quality=quality)
            yield ".jpg", buf.getvalue(), caption

    return _write_shards(encoded(), out_dir, samples_per_shard)


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
