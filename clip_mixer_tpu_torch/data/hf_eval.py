"""Evaluation datasets over HuggingFace ``datasets``, on the host.

Counterpart of ``clip_mixer_tpu/data/hf_eval.py``: STS pairs with the
sick / mteb column names made one (sentences lowercased and stripped), SST-2
(sentence, label) pairs and MNIST batches through the host preprocess.

Every loader is gated for hosts without egress: a dataset that cannot be
loaded raises :class:`DatasetUnavailable`, which the validators catch to
skip. ``datasets`` is imported only inside :func:`_load`; where it is not
installed (the H100 host has none) the load is a ``DatasetUnavailable`` too.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

STS_SETS = ["sick", "mteb/sts16-sts", "mteb/sts15-sts", "mteb/sts14-sts", "mteb/sts13-sts", "mteb/sts12-sts"]


class DatasetUnavailable(RuntimeError):
    pass


_REACHABLE: dict = {}  # one probe per (process, host)


def explicitly_offline() -> bool:
    """``CLIP_MIXER_OFFLINE=1`` or ``HF_HUB_OFFLINE=1``: the user said there is no network."""
    return os.environ.get("CLIP_MIXER_OFFLINE") == "1" or os.environ.get("HF_HUB_OFFLINE") == "1"


def host_reachable(host: str, timeout: float = 5.0) -> bool:
    """One DNS probe of ``host`` per process. A host without egress fails
    resolution in milliseconds, where the hub client would retry five
    times with backoff (~30 s) for each dataset on each validation pass.
    ``getaddrinfo`` ignores socket timeouts, so the probe runs in a daemon
    thread joined with a deadline: a resolver that does not answer counts
    as unreachable. Behind a proxy (which resolves names itself) the answer
    is yes without a probe. Explicitly offline (:func:`explicitly_offline`)
    the answer is no without a probe, so such a host sends no query at all
    (the JAX probe runs regardless)."""
    if explicitly_offline():
        return False
    if host not in _REACHABLE:
        import socket
        import threading

        if any(os.environ.get(k) for k in ("HTTPS_PROXY", "https_proxy", "HTTP_PROXY", "http_proxy",
                                           "ALL_PROXY", "all_proxy")):
            _REACHABLE[host] = True
            return True

        result = []

        def probe():
            try:
                socket.getaddrinfo(host, 443)
                result.append(True)
            except OSError:
                result.append(False)

        t = threading.Thread(target=probe, daemon=True)
        t.start()
        t.join(timeout)
        _REACHABLE[host] = bool(result and result[0])
    return _REACHABLE[host]


def _hub_reachable(timeout: float = 5.0) -> bool:
    return host_reachable("huggingface.co", timeout)


def _load(name: str, split: str):
    # Offline, said (env) or found (the DNS probe), the hub client is kept
    # from its retry ladder; offline mode still serves the local arrow cache.
    explicit = explicitly_offline()
    if explicit or not _hub_reachable():
        if explicit:
            # only an explicit setting is handed to child processes: a
            # resolver's passing failure must not reach every later one
            os.environ["HF_HUB_OFFLINE"] = "1"
            os.environ["HF_DATASETS_OFFLINE"] = "1"
        try:
            # the variables are read at import: set the live config too
            import datasets as _datasets

            _datasets.config.HF_DATASETS_OFFLINE = True
            _datasets.config.HF_HUB_OFFLINE = True
            return _datasets.load_dataset(name)[split]
        except Exception as e:
            raise DatasetUnavailable(f"offline and {name} not cached: {e}") from e
    try:
        from datasets import load_dataset

        return load_dataset(name)[split]
    except Exception as e:  # offline, missing dataset, no `datasets`
        raise DatasetUnavailable(f"could not load {name}:{split}: {e}") from e


def sts_pairs(selected_set: str, split: str = "test") -> List[Tuple[str, str, float]]:
    """(sentence_a, sentence_b, gold_score) triples."""
    ds = _load(selected_set, split)
    if selected_set == "sick":
        cols = ("sentence_A", "sentence_B", "relatedness_score")
    else:
        cols = ("sentence1", "sentence2", "score")
    a_col, b_col, s_col = cols
    return [(row[a_col].lower().strip(), row[b_col].lower().strip(), float(row[s_col])) for row in ds]


def sst2_split(split: str) -> List[Tuple[str, int]]:
    """(sentence, label) pairs."""
    ds = _load("sst2", split)
    return [(row["sentence"].lower().strip(), int(row["label"])) for row in ds]


def mnist_batches(split: str, batch_size: int, n_px: int = 224) -> Iterator[Tuple]:
    """(uint8 [B, n_px, n_px, 3], int targets [B]) through the host
    preprocess (``ops/preprocess.py::preprocess_pil``)."""
    import numpy as np

    from clip_mixer_tpu_torch.ops.preprocess import preprocess_pil

    ds = _load("mnist", split)
    images, targets = [], []
    for row in ds:
        images.append(preprocess_pil(row["image"], n_px))
        targets.append(int(row["label"]))
        if len(images) == batch_size:
            yield np.stack(images), np.asarray(targets)
            images, targets = [], []
    if images:
        yield np.stack(images), np.asarray(targets)
