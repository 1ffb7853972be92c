"""The port's C++ tokenizer (clip_mixer_tpu_torch/text/fast.py) against the
Python tokenizers of both packages, and the port's own vocab copy.

The C++ scanner's tables come from the port's Python classifiers, so the
port's two tokenizers agree on every codepoint. Where the JAX package's C++
tokenizer leaves its own Python contract (U+0345; U+017F inside a
contraction) the port follows the Python one, which is the reference's."""

import hashlib
import os
import shutil
import subprocess
import sys
import unicodedata
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from clip_mixer_tpu.text import tokenize as jax_tokenize
from clip_mixer_tpu.text.fast import fast_tokenize as jax_fast_tokenize
from clip_mixer_tpu_torch.text import bpe, fast
from clip_mixer_tpu_torch.text.fast import fast_tokenize
from clip_mixer_tpu_torch.text.tokenize import tokenize

REPO = Path(__file__).resolve().parents[1]

# tests/test_fast_tokenizer.py's corpus
CORPUS = [
    "a photo of a cat",
    "A Photo   of\ta DOG!!",
    "it's can't we're I've i'm they'll she'd",
    "12345 67 8",
    "naïve café résumé",
    "日本語のテキスト",
    "emoji 🚀🔥 test",
    "x",
    "",
    "&amp;amp; &lt;tag&gt;",
    "punctuation... --- ???!!",
    "don''t '' 'x ''s",
    "!!'s mid-run contraction swallow",
    "<|startoftext|> embedded <|endoftext|>",
    "!!<|endoftext|> swallowed special",
    "a" * 300,
    "the quick brown fox jumps over the lazy dog",
    "ｆｕｌｌｗｉｄｔｈ",
    "tab\tand\nnewline  collapse",
    "mixed 'll'd're endings",
    "прекрасный день сегодня",
    "数字123と文字",
]

# where the JAX C++ tokenizer leaves the Python contract
DEVIATIONS = ["aͅb", "it'ſ ok", "xͅͅ!"]

# characters the scanner treats specially, drawn often by the fuzz
EDGES = [0x27, 0x3C, 0x7C, 0x20, 0x17F, 0x345, 0x130, 0x212A, 0x3A3, 0x1C, 0x85, 0xA0, 0x3000]


def all_planes_strings(n, seed):
    """``n`` strings of 1-24 codepoints: ASCII, the edge characters above,
    the literals' spellings with U+017F, and codepoints drawn uniformly from
    every plane (surrogates excluded)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(1, 25))):
            r = rng.random()
            if r < 0.3:
                parts.append(chr(int(rng.integers(0x20, 0x7F))))
            elif r < 0.45:
                parts.append(chr(int(rng.choice(EDGES))))
            elif r < 0.5:
                parts.append(str(rng.choice(["'ſ", "'ſt", "<|ſtartoftext|>", "<|endoftext|>", "'LL", "'ſ'"])))
            else:
                cp = int(rng.integers(0, 0x110000 - 0x800))
                parts.append(chr(cp + 0x800 if cp >= 0xD800 else cp))
        out.append("".join(parts))
    return out


def test_vocab_copy_is_the_jax_file():
    port = Path(bpe.default_vocab_path())
    jax_file = REPO / "clip_mixer_tpu" / "text" / "vocab" / "bpe_simple_vocab_16e6.txt.gz"
    assert port.parent == REPO / "clip_mixer_tpu_torch" / "text" / "vocab"
    assert hashlib.sha256(port.read_bytes()).hexdigest() == hashlib.sha256(jax_file.read_bytes()).hexdigest()


def test_port_tokenizes_without_the_jax_package(tmp_path):
    """A copy of the port alone (no ``clip_mixer_tpu/`` beside it) loads its
    merge table from its own tree and tokenizes as here."""
    shutil.copytree(REPO / "clip_mixer_tpu_torch", tmp_path / "clip_mixer_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import importlib.util, sys\n"
        "assert importlib.util.find_spec('clip_mixer_tpu') is None\n"
        "from clip_mixer_tpu_torch.text import bpe, tokenize\n"
        "print(bpe.default_vocab_path())\n"
        "print(' '.join(map(str, tokenize(sys.argv[1])[0][:8])))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code, CORPUS[2]], cwd=tmp_path, env=env,
                         capture_output=True, text=True, check=True, timeout=120).stdout.splitlines()
    assert out[0].startswith(str(tmp_path / "clip_mixer_tpu_torch"))
    assert out[1] == " ".join(map(str, tokenize(CORPUS[2])[0][:8]))


def test_matches_jax_python_tokenizer_on_the_corpus():
    np.testing.assert_array_equal(fast_tokenize(CORPUS, truncate=True), jax_tokenize(CORPUS, truncate=True))


def test_fuzz_all_planes_matches_port_python_tokenizer():
    texts = all_planes_strings(3000, seed=14)
    np.testing.assert_array_equal(fast_tokenize(texts, truncate=True), tokenize(texts, truncate=True))


def test_single_string_and_shapes():
    out = fast_tokenize("hello world")
    assert out.shape == (1, 77) and out.dtype == np.int32
    np.testing.assert_array_equal(out, tokenize("hello world"))
    assert fast_tokenize([]).shape == (0, 77)


def test_too_long_raises():
    text = "word " * 200
    with pytest.raises(RuntimeError, match="too long for context length 77"):
        fast_tokenize(["ok", text])
    with pytest.raises(RuntimeError) as py_err:
        tokenize(["ok", text])
    with pytest.raises(RuntimeError) as fast_err:
        fast_tokenize(["ok", text])
    assert str(fast_err.value) == str(py_err.value)
    np.testing.assert_array_equal(fast_tokenize(text, truncate=True), tokenize(text, truncate=True))


@pytest.mark.parametrize("ctx", [16, 77, 128])
def test_context_length_variants(ctx):
    np.testing.assert_array_equal(fast_tokenize(CORPUS, context_length=ctx, truncate=True),
                                  tokenize(CORPUS, context_length=ctx, truncate=True))


def test_concurrent_tokenize_thread_safe():
    """Eight threads at once, on words fresh each round (cache inserts) and
    shared ones (cache hits), against the serial Python tokens."""
    for rep in range(3):
        texts = [f"shared words cat dog plus unique{rep}x{i} token{rep * 100 + i * 7}" for i in range(64)]
        expected = tokenize(texts)
        with ThreadPoolExecutor(8) as ex:
            outs = list(ex.map(lambda t: fast_tokenize([t])[0], texts))
        np.testing.assert_array_equal(np.stack(outs), expected)


def test_clear_cache_keeps_tokens():
    want = fast_tokenize(CORPUS, truncate=True)
    fast.clear_cache()
    np.testing.assert_array_equal(fast_tokenize(CORPUS, truncate=True), want)


def test_deviations_from_the_jax_cpp_tokenizer():
    """U+0345 is a gap and U+017F folds to 's' inside a contraction, as the
    JAX Python tokenizer has it; the JAX C++ tokenizer differs on each."""
    np.testing.assert_array_equal(fast_tokenize(DEVIATIONS), jax_tokenize(DEVIATIONS))
    for text in DEVIATIONS:
        assert not np.array_equal(jax_fast_tokenize(text), jax_tokenize(text)), text


@pytest.mark.parametrize("cp", [0x0C5C, 0xA7CB])
def test_unassigned_codepoint_alike_in_both_port_tokenizers(cp):
    """A codepoint that ``unicodedata`` leaves unassigned (``Cn``) is no
    letter to either port tokenizer, whatever the JAX package's ``regex``
    classes it as (newer Unicode data makes these two letters)."""
    ch = chr(cp)
    texts = [f"a{ch}b", f"1{ch}2", f"{ch}{ch} x{ch}"]
    np.testing.assert_array_equal(fast_tokenize(texts), tokenize(texts))
    assert bpe._is_letter(ch) == (unicodedata.category(ch)[0] == "L")
    if unicodedata.category(ch) == "Cn":
        assert bpe.pretokenize(f"a{ch}b") == ["a", ch, "b"]


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/g++"])
def test_failing_build_raises_and_never_falls_back(tmp_path, monkeypatch, cxx):
    monkeypatch.setattr(fast, "BUILD_DIR", tmp_path / "tokenizer")
    monkeypatch.setenv("CXX", cxx)
    fast._instance.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="fast tokenizer"):
            fast_tokenize("a photo of a cat")
        assert fast.is_available() is False
        assert not (tmp_path / "tokenizer" / "libfast_bpe.so").exists()
    finally:
        fast._instance.cache_clear()


def test_tables_come_from_the_port_classifiers():
    t = fast.build_tables()
    bits = {k: np.unpackbits(t[k], bitorder="little").astype(bool) for k in ("letter", "number", "gap")}
    for cp in (0x41, 0x61, 0x31, 0x20, 0x345, 0x17F, 0x1C, 0x85, 0x0C5C, 0x4E00, 0x1F680):
        ch = chr(cp)
        assert bits["letter"][cp] == bpe._is_letter(ch)
        assert bits["number"][cp] == bpe._is_number(ch)
        assert bits["gap"][cp] == bpe._is_gap(ch)
    assert t["fold"][0x17F] == ord("s") and t["fold"][ord("T")] == ord("t") and t["fold"][0x130] == 0
