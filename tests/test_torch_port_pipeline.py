"""The port's training data (``clip_mixer_tpu_torch/data/pipeline.py``) against the JAX package's.

For the same arguments, every batch of ``SyntheticSource`` and of
``CacheSource`` (in memory and disk-backed) is bit for bit the JAX source's,
from any start batch. Then the cache's fingerprint and budget, ``prefetch``
(order, errors, a stop that ends a blocked wait) and ``device_prefetch`` on
the CPU (the same tensors, without a copy).
"""

import threading
import time

import numpy as np
import pytest
import torch

from clip_mixer_tpu.data import pipeline as jpipe

from clip_mixer_tpu_torch.data import pipeline as tpipe

SOURCES = [
    dict(batch_size=4, image_size=16, n_batches=3, context_length=16),
    dict(batch_size=5, image_size=24, n_batches=2, n_classes=5, context_length=77, seed=7),
]


def _assert_same(jax_batches, port_batches):
    jax_batches, port_batches = list(jax_batches), list(port_batches)
    assert len(jax_batches) == len(port_batches) > 0
    for j, t in zip(jax_batches, port_batches):
        assert set(j) == set(t) == {"images", "texts"}
        for k in j:
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape
            np.testing.assert_array_equal(j[k], t[k])


@pytest.mark.parametrize("kw", SOURCES, ids=["small", "seeded"])
def test_synthetic_source_is_the_jax_source(kw):
    jsrc, tsrc = jpipe.SyntheticSource(**kw), tpipe.SyntheticSource(**kw)
    assert tsrc.batches_per_epoch == jsrc.batches_per_epoch
    np.testing.assert_array_equal(tsrc.tokens, jsrc.tokens)
    for epoch, start in ((0, 0), (1, 0), (1, 1)):
        _assert_same(jsrc.iter_batches(epoch, start), tsrc.iter_batches(epoch, start))


@pytest.mark.parametrize("disk", [False, True], ids=["memory", "disk"])
def test_cache_source_is_the_jax_cache(tmp_path, disk):
    kw = dict(batch_size=4, image_size=16, n_batches=5, context_length=16, seed=2)
    jdir, tdir = (str(tmp_path / "jax"), str(tmp_path / "port")) if disk else (None, None)
    jc = jpipe.CacheSource(jpipe.SyntheticSource(**kw), seed=11, cache_dir=jdir)
    tc = tpipe.CacheSource(tpipe.SyntheticSource(**kw), seed=11, cache_dir=tdir)
    assert tc.n_samples == jc.n_samples == 20 and tc.batches_per_epoch == jc.batches_per_epoch == 5
    for epoch, start in ((0, 0), (1, 0), (2, 3)):
        _assert_same(jc.iter_batches(epoch, start), tc.iter_batches(epoch, start))
    if disk:
        # a later process serves the memmapped files and never fills
        inner = tpipe.SyntheticSource(**kw)
        inner.iter_batches = lambda *a, **k: (_ for _ in ()).throw(AssertionError("filled again"))
        again = tpipe.CacheSource(inner, seed=11, cache_dir=tdir)
        _assert_same(jc.iter_batches(1), again.iter_batches(1))
        assert isinstance(again._images, np.memmap)
        assert not [p for p in (tmp_path / "port").iterdir() if ".tmp" in p.name]


class _FileList(tpipe.DataSource):
    """A file-list-shaped inner source: captions outside any shard."""

    def __init__(self, entries):
        self.entries = entries
        self.batch_size, self.image_size, self.context_length = 4, 16, 16


def test_fingerprint_follows_captions_and_draws(tmp_path):
    def fp(inner):
        return tpipe.CacheSource(inner)._fingerprint()

    a = fp(_FileList([("x.jpg", "a cat"), ("y.jpg", "a dog")]))
    assert a == fp(_FileList([("x.jpg", "a cat"), ("y.jpg", "a dog")]))
    assert a != fp(_FileList([("x.jpg", "a cat"), ("y.jpg", "a dot")]))
    kw = dict(batch_size=4, image_size=16, n_batches=2, context_length=16)
    s = fp(tpipe.SyntheticSource(**kw))
    assert s == fp(tpipe.SyntheticSource(**kw))
    for other in (dict(seed=1), dict(n_classes=3), dict(n_batches=3), dict(image_size=24)):
        assert s != fp(tpipe.SyntheticSource(**{**kw, **other})), other


def test_cache_refuses_remote_dirs_and_overflow(tmp_path):
    src = tpipe.SyntheticSource(batch_size=4, image_size=16, n_batches=3, context_length=16)
    with pytest.raises(ValueError, match="local directory"):
        tpipe.CacheSource(src, cache_dir="gs://bucket/cache")
    with pytest.raises(MemoryError, match="max_bytes"):
        tpipe.CacheSource(src, max_bytes=4 * 16 * 16 * 3).n_samples


def test_prefetch_keeps_order_and_raises_errors():
    src = tpipe.SyntheticSource(batch_size=2, image_size=16, n_batches=5, context_length=16)
    direct = list(src.iter_batches(0))
    fetched = list(tpipe.prefetch(src.iter_batches(0), depth=2))
    _assert_same(direct, fetched)

    def failing():
        yield from src.iter_batches(0, 3)
        raise OSError("shard read failed")

    got = []
    with pytest.raises(OSError, match="shard read failed"):
        for b in tpipe.prefetch(failing(), depth=1):
            got.append(b)
    assert len(got) == 2


def test_prefetch_stop_ends_a_blocked_wait():
    release = threading.Event()

    def stalls():
        yield {"n": 0}
        release.wait(60)  # a stalled read
        yield {"n": 1}

    stop = threading.Event()
    threading.Timer(0.3, stop.set).start()
    t0 = time.monotonic()
    got = list(tpipe.prefetch(stalls(), stop=stop))
    release.set()
    assert [b["n"] for b in got] == [0]
    assert time.monotonic() - t0 < 10


def test_device_prefetch_on_the_cpu_gives_the_same_tensors():
    src = tpipe.SyntheticSource(batch_size=3, image_size=16, n_batches=4, context_length=16)
    host = list(src.iter_batches(0))
    got = list(tpipe.device_prefetch(iter(host), "cpu", depth=2))
    assert len(got) == len(host)
    for h, d in zip(host, got):
        assert isinstance(d, tpipe.Batch)
        for k in h:
            assert d[k].device == torch.device("cpu")
            np.testing.assert_array_equal(d[k].numpy(), h[k])
            assert d[k].data_ptr() == h[k].ctypes.data  # no copy
