#!/usr/bin/env python3
"""Tokenizer throughput of the port: the C++ core vs the Python BPE vs the reference oracle.

The counterpart of ``scripts/bench_tokenizer.py``. Three legs over the same
caption batch, all with the identity-ftfy stub so the normalisation work is
identical:

  oracle  the reference ``SimpleTokenizer`` (``simple_tokenizer.py`` under
          ``--reference``, upstream's ``training/clip/simple_tokenizer.py``),
          its own ``encode()`` loop per caption, as ``clip.tokenize`` drives it;
  python  ``clip_mixer_tpu_torch.text.tokenize`` (the Python ``ClipBPE``);
  cpp     ``clip_mixer_tpu_torch.text.fast.fast_tokenize`` (``fast_bpe.cpp``
          through ctypes), timed cold (a fresh merge cache) and warm (the
          cache populated: the steady state of a long training feed).

Captions come from the ``.txt`` members of local tar shards (``--shards``,
default ``dress/*.tar`` under the working directory, where
``scripts/torch_make_dress_dataset.py`` writes them) when present, else
from a deterministic synthetic caption generator; a second leg uses
mostly-unique words. Both caption sets are the JAX script's, bit for bit.

Where ``--reference`` holds no ``simple_tokenizer.py`` (the upstream repo
is not checked out beside the port), the record says so: the
oracle's times and the speedups against it are ``null`` and ``oracle``
gives the reason; the Python and C++ legs still run and must give the same
tokens. (JAX's script stops with an ``ImportError`` there.)

Writes ``TOKENIZER_BENCH_TORCH.json`` (never JAX's ``TOKENIZER_BENCH.json``)
and prints the JAX script's summary line. Runs beside the card unless
``--device`` names another device: the record names the card's host.

Usage: python scripts/torch_bench_tokenizer.py [--n 32768] [--reference DIR] [--device cuda]
"""

import argparse
import importlib.util
import json
import sys
import tarfile
import time
import types
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from clip_mixer_tpu_torch.device import card, resolve_device  # noqa: E402

# JAX's REFERENCE_CLIP, under the working directory
REFERENCE_CLIP = "reference/training/clip"


def install_ftfy_stub():
    """Identity ftfy (as tests/conftest.py's): every leg skips mojibake
    repair, keeping the comparison apples-to-apples."""
    if "ftfy" not in sys.modules:
        stub = types.ModuleType("ftfy")
        stub.fix_text = lambda s: s
        sys.modules["ftfy"] = stub


def load_captions(n: int, shard_glob: str) -> tuple:
    """n captions: real .txt members from local tar shards if present,
    else deterministic synthetic captions."""
    caps = []
    if Path(shard_glob).is_absolute():
        shards = sorted(Path("/").glob(shard_glob.lstrip("/")))
    else:  # relative globs resolve against the cwd, like every other CLI
        shards = sorted(Path(".").glob(shard_glob))
    for shard in shards:
        try:
            with tarfile.open(shard) as tf:
                for m in tf:
                    if m.name.endswith(".txt"):
                        caps.append(tf.extractfile(m).read().decode("utf-8"))
                        if len(caps) >= n:
                            return caps, f"tar:{shard_glob}"
        except (OSError, tarfile.TarError):
            continue
    if caps:
        # repeat to length (still distinct work per caption for the BPE loop)
        reps = -(-n // len(caps))
        return (caps * reps)[:n], f"tar:{shard_glob} (repeated x{reps})"
    rng = np.random.default_rng(0)
    words = [
        "photo", "of", "a", "the", "small", "large", "red", "blue", "dog",
        "cat", "mountain", "city", "street", "vintage", "close-up", "person",
        "riding", "holding", "wooden", "table", "bright", "sunset", "ocean",
        "painting", "sketch", "illustration", "detailed", "background",
    ]
    caps = [
        " ".join(rng.choice(words, size=rng.integers(4, 16)).tolist()) + "."
        for _ in range(n)
    ]
    return caps, "synthetic"


def diverse_captions(n: int) -> list:
    """Worst-case-for-caching captions: mostly-unique random words (mixed
    case + punctuation), so nearly every word runs the full merge loop,
    the regime where the C++ core's advantage is largest."""
    rng = np.random.default_rng(7)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    caps = []
    for _ in range(n):
        k = int(rng.integers(5, 14))
        words = []
        for _ in range(k):
            w = "".join(rng.choice(letters, size=int(rng.integers(3, 12))))
            if rng.random() < 0.15:
                w = w.capitalize()
            if rng.random() < 0.1:
                w += rng.choice([",", "!", "?", "'s"])
            words.append(w)
        caps.append(" ".join(words) + ".")
    return caps


def load_oracle(reference: str):
    """(the reference ``SimpleTokenizer``, None), or (None, the reason)
    when ``reference`` holds no ``simple_tokenizer.py``. A module that is
    there but fails to import raises."""
    path = Path(reference) / "simple_tokenizer.py"
    if not path.is_file():
        return None, f"absent: no simple_tokenizer.py under {reference}"
    sys.path.insert(0, str(path.parent))  # as JAX's script: the module's siblings import
    spec = importlib.util.spec_from_file_location("simple_tokenizer", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.SimpleTokenizer(), None


def _ratio(a, b):
    return None if a is None or b is None else round(a / b, 2)


def bench_one(caps: list, source: str, oracle) -> dict:
    """Time the legs over one caption set. Every implementation memoizes
    per word, so each leg starts from a cleared cache: the fresh feed
    process's number; the C++ leg also reports the warm steady state.
    ``oracle`` None: its leg is left out and its keys are null."""
    from clip_mixer_tpu_torch.text import fast
    from clip_mixer_tpu_torch.text.bpe import get_tokenizer
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    n = len(caps)
    t_oracle = oracle_ids = None
    if oracle is not None:
        # the reference's initial cache state (simple_tokenizer.py:77)
        oracle.cache = {t: t for t in ("<|startoftext|>", "<|endoftext|>")}
        t0 = time.perf_counter()
        oracle_ids = [oracle.encode(c) for c in caps]
        t_oracle = time.perf_counter() - t0

    get_tokenizer().clear_cache()
    t0 = time.perf_counter()
    py_out = tokenize(caps, truncate=True)
    t_python = time.perf_counter() - t0

    # cold = fresh merge cache (a fresh feed process), warm = steady state
    fast.clear_cache()
    t0 = time.perf_counter()
    cpp_out = fast.fast_tokenize(caps, truncate=True)
    t_cpp_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpp_out2 = fast.fast_tokenize(caps, truncate=True)
    t_cpp_warm = time.perf_counter() - t0

    # the measurement's own cross-check on the exact batch (the golden tests cover the corpus)
    if not ((py_out == cpp_out).all() and (cpp_out == cpp_out2).all()):
        raise RuntimeError("the Python and C++ tokenizers disagree on the bench batch")
    if oracle_ids is not None:
        sot, eot = 49406, 49407
        for i in range(0, n, max(1, n // 64)):  # spot-check vs the oracle
            ids = [sot] + oracle_ids[i][:75] + [eot]
            ids = ids[:77]
            if len(ids) == 77:
                ids[-1] = eot
            ref = np.zeros(77, np.int32)
            ref[: len(ids)] = ids
            if not (py_out[i] == ref).all():
                raise RuntimeError(f"mismatch vs oracle at {i}")

    return {
        "n_captions": n,
        "caption_source": source,
        "oracle_cps": None if t_oracle is None else round(n / t_oracle, 1),
        "python_cps": round(n / t_python, 1),
        "cpp_cold_cps": round(n / t_cpp_cold, 1),
        "cpp_warm_cps": round(n / t_cpp_warm, 1),
        "seconds": {
            "oracle": None if t_oracle is None else round(t_oracle, 3),
            "python": round(t_python, 3),
            "cpp_cold": round(t_cpp_cold, 3),
            "cpp_warm": round(t_cpp_warm, 3),
        },
        "speedup_cpp_cold_vs_python": round(t_python / t_cpp_cold, 2),
        "speedup_cpp_warm_vs_python": round(t_python / t_cpp_warm, 2),
        "speedup_cpp_cold_vs_oracle": _ratio(t_oracle, t_cpp_cold),
        "speedup_python_vs_oracle": _ratio(t_oracle, t_python),
    }


def main(argv=None) -> dict:
    """Both legs; writes the record and returns it."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=32768, help="caption batch size")
    p.add_argument("--shards", default="dress/*.tar")
    p.add_argument("--reference", default=REFERENCE_CLIP, help="the directory of the reference simple_tokenizer.py")
    p.add_argument("--out", default=str(REPO / "TOKENIZER_BENCH_TORCH.json"))
    p.add_argument("--device", default=None, help="the card beside which it runs (default: cuda, which must exist)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    install_ftfy_stub()

    from clip_mixer_tpu_torch.text import fast

    if not fast.is_available():
        raise RuntimeError("the C++ tokenizer must build for this bench")
    # Load (and if needed compile) the shared library outside the timed
    # region; the one throwaway word it caches is cleared per leg.
    fast.fast_tokenize(["warmup"], truncate=True)

    oracle, absent = load_oracle(args.reference)
    real_caps, real_source = load_captions(args.n, args.shards)
    doc = {
        "legs": {
            # natural-ish templated captions: heavy word repetition, every
            # implementation's cache-friendly case
            "real_captions": bench_one(real_caps, real_source, oracle),
            # mostly-unique words: the merge loop dominates
            "diverse_captions": bench_one(diverse_captions(args.n), "synthetic-diverse", oracle),
        },
        "oracle": args.reference if absent is None else absent,
    }
    doc["device"], doc["power_limit"] = card(device)
    Path(args.out).write_text(json.dumps(doc, indent=2))
    summary = {
        leg: {
            "cpp_cold_cps": d["cpp_cold_cps"],
            "x_vs_python": d["speedup_cpp_cold_vs_python"],
            "x_vs_oracle": d["speedup_cpp_cold_vs_oracle"],
        }
        for leg, d in doc["legs"].items()
    }
    print(json.dumps(summary), flush=True)
    return doc


if __name__ == "__main__":
    main()
