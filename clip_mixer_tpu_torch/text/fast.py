"""The C++ BPE tokenizer (``fast_bpe.cpp``): build, bind and call.

Counterpart of ``clip_mixer_tpu/text/fast.py``, with :func:`fast_tokenize`
under the contract of the port's ``text.tokenize.tokenize``: the same
tokens for every input, the same shapes and the same too-long error.

At first use ``g++ -O2 -std=c++17 -shared -fPIC`` builds the library into
``build/tokenizer/`` at the repository root (beside the kernels'
``build/kernels/``), under a temporary name that is then renamed; a library
newer than its source is reused. The scanner's tables (letter, number and
gap bitsets and the one-byte fold of each codepoint) are built from
``text/bpe.py``'s own classifiers and cached there too, so the two
tokenizers agree by construction on every codepoint, where the JAX
package's C++ scanner, whose masks come from ``regex`` without its
case-insensitive flag, does not (U+0345, and U+017F in a contraction).

There is no fallback: when the library cannot be built, :func:`fast_tokenize`
raises with the compiler's output. A caller that wants the Python tokenizer
calls ``tokenize``.

Normalisation (ftfy, HTML unescape, whitespace, lowercase) stays in Python;
the C++ side takes the pre-tokenizer scan, the merge loop and the cache.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import unicodedata
from pathlib import Path
from typing import Dict, Sequence, Union

import numpy as np

from clip_mixer_tpu_torch.text import bpe
from clip_mixer_tpu_torch.text.bpe import get_tokenizer, normalize_text

SOURCE = Path(__file__).resolve().with_name("fast_bpe.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tokenizer"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
_N_CP = 0x110000
_lock = threading.Lock()


def _lib_path() -> Path:
    return BUILD_DIR / "libfast_bpe.so"


def build() -> Path:
    """The library, compiled first when it is missing or older than its
    source. Raises RuntimeError with the compiler's output when ``g++``
    fails or is missing."""
    with _lock:
        lib = _lib_path()
        if lib.exists() and lib.stat().st_mtime >= SOURCE.stat().st_mtime:
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"libfast_bpe.so.{os.getpid()}.tmp"
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"the fast tokenizer cannot be built: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"the fast tokenizer failed to build: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        return lib


def _tables_path() -> Path:
    """The tables' cache, keyed by the Unicode version and ``bpe.py``."""
    digest = hashlib.sha256(Path(bpe.__file__).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"unicode_tables_{unicodedata.unidata_version}_{digest}.npz"


def build_tables() -> Dict[str, np.ndarray]:
    """Bitsets over all codepoints for ``bpe._is_letter``, ``_is_number``
    and ``_is_gap``, and ``fold`` [0x110000] uint8: the ASCII code of
    ``ch.lower()`` with U+017F folded to ``s`` where that is one ASCII
    character, else 0 (how ``bpe.pretokenize`` compares a literal's later
    characters). Surrogates stay 0: they never reach the scanner."""
    path = _tables_path()
    if path.exists():
        with np.load(path) as z:
            return {k: z[k] for k in ("letter", "number", "gap", "fold")}
    flags = {k: np.zeros(_N_CP, bool) for k in ("letter", "number", "gap")}
    fold = np.zeros(_N_CP, np.uint8)
    for cp in range(_N_CP):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        ch = chr(cp)
        flags["letter"][cp] = bpe._is_letter(ch)
        flags["number"][cp] = bpe._is_number(ch)
        flags["gap"][cp] = bpe._is_gap(ch)
        f = ch.lower().translate(bpe._FOLD)
        if len(f) == 1 and ord(f) < 128:
            fold[cp] = ord(f)
    tables = {k: np.packbits(v, bitorder="little") for k, v in flags.items()}
    tables["fold"] = fold
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp.npz")
    np.savez_compressed(tmp, **tables)
    os.replace(tmp, path)
    return tables


class _FastBPE:
    def __init__(self):
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bpe_create.restype = P
        lib.bpe_create.argtypes = [P, P, I, P, P, P, P, P, P, P, ctypes.c_int32, ctypes.c_int32]
        lib.bpe_clear_cache.restype = None
        lib.bpe_clear_cache.argtypes = [P]
        lib.bpe_encode_batch.restype = I
        lib.bpe_encode_batch.argtypes = [P, ctypes.c_char_p, P, I, I, I, P]
        self._lib = lib

        py = get_tokenizer()
        sym = bpe.byte_symbol_table()
        init_nonfinal = np.asarray([py.token_to_id[sym[b]] for b in range(256)], np.int32)
        init_final = np.asarray([py.token_to_id[sym[b] + "</w>"] for b in range(256)], np.int32)
        n = len(py.rank)
        merges = np.zeros((3, n), np.int32)  # (id(a), id(b), id(a + b)) in rank order
        for (a, b), r in py.rank.items():
            merges[:, r] = py.token_to_id[a], py.token_to_id[b], py.token_to_id[a + b]
        t = build_tables()

        def ptr(arr):
            return arr.ctypes.data_as(P)

        # bpe_create copies every table
        self._handle = lib.bpe_create(
            ptr(init_nonfinal), ptr(init_final), n, ptr(merges[0]), ptr(merges[1]), ptr(merges[2]),
            ptr(t["letter"]), ptr(t["number"]), ptr(t["gap"]), ptr(t["fold"]), py.sot_id, py.eot_id,
        )

    def encode_batch(self, texts: Sequence[str], context_length: int, truncate: bool) -> np.ndarray:
        normalized = [normalize_text(t).encode("utf-8") for t in texts]
        offsets = np.zeros(len(normalized) + 1, np.int64)
        np.cumsum([len(b) for b in normalized], out=offsets[1:])
        out = np.zeros((len(normalized), context_length), np.int32)
        rc = self._lib.bpe_encode_batch(
            self._handle, b"".join(normalized), offsets.ctypes.data_as(ctypes.c_void_p), len(normalized),
            context_length, int(truncate), out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc >= 0:
            raise RuntimeError(f"Input {texts[rc]} is too long for context length {context_length}")
        return out


@functools.lru_cache()
def _instance() -> _FastBPE:
    return _FastBPE()


def is_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _instance()
    except (OSError, RuntimeError):
        return False
    return True


def clear_cache() -> None:
    """Drop the C++ per-word memo (cold timings, memory hygiene)."""
    inst = _instance()
    inst._lib.bpe_clear_cache(inst._handle)


def fast_tokenize(
    texts: Union[str, Sequence[str]], context_length: int = 77, truncate: bool = False
) -> np.ndarray:
    """``tokenize`` through the C++ core: int32 [N, context_length]."""
    if isinstance(texts, str):
        texts = [texts]
    return _instance().encode_batch(list(texts), context_length, truncate)
