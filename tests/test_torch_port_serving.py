"""The port's tokenizer, serving engine, HTTP server and import boundary
against the JAX package, on the CPU.

The tokenizer is held to ``clip_mixer_tpu.text`` id for id (its hand-written
pre-tokenizer to the ``regex`` pattern it replaces); the engine to the JAX
``InferenceEngine`` on the same weights, moved by ``load_jax_params``, at the
f32 tolerance of ``test_torch_parity.py`` (atol 5e-5 / rtol 1e-3).
"""

import json
import subprocess
import sys
import threading
import unicodedata
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from clip_mixer_tpu.config import CLIPConfig as JaxConfig
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.serving import InferenceEngine as JaxEngine
from clip_mixer_tpu.text import bpe as jbpe
from clip_mixer_tpu.text.tokenize import tokenize as jax_tokenize

from clip_mixer_tpu_torch import CLIP, CLIPConfig, load_jax_params, resolve_device
from clip_mixer_tpu_torch.serving import InferenceEngine, MicroBatcher, ServerStats, serve, softmax_probs
from clip_mixer_tpu_torch.text import bpe as tbpe
from clip_mixer_tpu_torch.text.tokenize import tokenize

REPO = Path(__file__).resolve().parents[1]
ATOL, RTOL = 5e-5, 1e-3

CORPUS = [
    "a photo of a cat",
    "A Photo   of\ta DOG!!",
    "it's can't we're I've i'm they'll she'd IT'S THEY'LL",
    "12345 67 8 ٣٤ ½ Ⅻ",
    "naïve café résumé",
    "日本語のテキスト",
    "emoji 🚀🔥 test",
    "",
    "&amp;amp; &lt;tag&gt;",
    "punctuation... --- ???!!",
    "a" * 300,
    "ｆｕｌｌｗｉｄｔｈ",
    "tab\tand\nnewline    collapse\x1c\x1f",
    "<|startoftext|>hi<|endoftext|> <|ENDOFTEXT|>",
    "ſtraße 'ſ İstanbul ǅ",
    "ypogegrammeni aͅb 'xͅ !ͅ?",
    "combining é ä कि",
]

CFG = dict(
    embed_dim=16,
    image_resolution=32,
    vision_layers=1,
    vision_width=32,
    vision_patch_size=16,
    context_length=77,
    vocab_size=49408,
    text_width=32,
    text_heads=1,
    text_layers=2,
    tower="mixer",
    compute_dtype="float32",
)


def _fuzz(n, seed):
    """Mixed-script strings: the pools of test_tokenizer.py plus combining
    marks, other scripts' digits and letters, and Unicode white space."""
    rng = np.random.default_rng(seed)
    pools = [
        (0x20, 0x7F), (0xA0, 0x100), (0x300, 0x370), (0x370, 0x400), (0x400, 0x500),
        (0x600, 0x700), (0x900, 0x980), (0x2000, 0x2070), (0x2150, 0x2190), (0x3040, 0x3100),
        (0x4E00, 0x4F00), (0xFF00, 0xFF70), (0x1D400, 0x1D500), (0x1F300, 0x1F600),
    ]
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(1, 40))):
            lo, hi = pools[int(rng.integers(0, len(pools)))]
            parts.append(chr(int(rng.integers(lo, hi))))
            if rng.random() < 0.3:
                parts.append(" \t\n'"[int(rng.integers(0, 4))])
        out.append("".join(parts))
    return out


# ---- tokenizer ----------------------------------------------------------


@pytest.mark.parametrize("texts", [CORPUS, _fuzz(300, seed=123)], ids=["corpus", "fuzz300"])
def test_tokenize_matches_jax(texts):
    np.testing.assert_array_equal(tokenize(texts, truncate=True), jax_tokenize(texts, truncate=True))
    tok, jtok = tbpe.get_tokenizer(), jbpe.get_tokenizer()
    for t in texts:
        assert tok.encode(t) == jtok.encode(t), repr(t)


def test_pretokenizer_matches_regex_on_every_assigned_code_point():
    """Each code point Python's unicodedata assigns, inside letter, digit,
    contraction and punctuation contexts. (Code points assigned only in a
    later Unicode version than unicodedata's are outside the port's reach.)"""
    chars = [chr(c) for c in range(0x110000) if not 0xD800 <= c < 0xE000 and unicodedata.category(chr(c)) != "Cn"]
    text = "".join(f"a{c}b{c}1'{c}!{c}{c} " for c in chars)
    assert tbpe.pretokenize(text) == jbpe._PRETOKENIZE.findall(text)
    assert tbpe.normalize_text(text[:200000]) == jbpe.normalize_text(text[:200000])


def test_tokenize_contract():
    arr = tokenize(["a photo of a cat", "dog"])
    assert arr.shape == (2, 77) and arr.dtype == np.int32
    assert arr[0, 0] == 49406 and arr[1, int(arr[1].argmax())] == 49407
    with pytest.raises(RuntimeError):
        tokenize("word " * 200)
    long = tokenize("word " * 200, truncate=True)
    np.testing.assert_array_equal(long, jax_tokenize("word " * 200, truncate=True))
    assert long[0, -1] == 49407
    tok = tbpe.get_tokenizer()
    assert tok.vocab_size == 49408
    assert tok.decode(tok.encode("a photo of a cat")) == jbpe.get_tokenizer().decode(tok.encode("a photo of a cat"))


# ---- engine against the JAX engine -------------------------------------------


@pytest.fixture(scope="module")
def engines():
    jc = JaxConfig(**CFG)
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(0), jc))
    model = load_jax_params(CLIP(CLIPConfig(**CFG), device="cpu"), params)
    hw = (40, 48)
    return (
        InferenceEngine(model, batch_buckets=(2, 4), input_hw=hw),
        JaxEngine(params, jc, batch_buckets=(2, 4), input_hw=hw),
    )


def _images(n, seed=0, hw=(40, 48)):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


@pytest.mark.parametrize("n", [1, 3, 6])
def test_engine_matches_jax_engine_across_buckets(engines, n):
    eng, jeng = engines
    texts = CORPUS[:n]
    np.testing.assert_allclose(eng.encode_text(texts), jeng.encode_text(texts), atol=ATOL, rtol=RTOL)
    imgs = _images(n, seed=n)
    np.testing.assert_allclose(eng.encode_image_arrays(imgs), jeng.encode_image_arrays(imgs), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        eng.similarity(imgs, texts[:2]), jeng.similarity(imgs, texts[:2]), atol=100 * ATOL, rtol=RTOL
    )


def test_engine_shapes_padding_and_microbatcher(engines):
    eng, _ = engines
    assert eng.encode_text([]).shape == (0, 16)
    # padding rows never change a real row: the same text alone and in a batch
    one = eng.encode_text(["a photo of a cat"])
    five = eng.encode_text(["a photo of a cat", "x", "y", "z", "w"])
    np.testing.assert_allclose(one[0], five[0], atol=1e-6)
    imgs = _images(1, seed=9)
    np.testing.assert_allclose(eng.encode_image_arrays(imgs, coalesce=True), eng.encode_image_arrays(imgs), atol=1e-6)
    eng.warmup()
    mb = MicroBatcher(lambda b: b * 2, max_batch=4, max_wait_ms=20)
    out = [None] * 6
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, mb.submit(np.full(3, i)))) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all((out[i] == 2 * i).all() for i in range(6))
    np.testing.assert_allclose(softmax_probs(np.array([[0.0, np.log(3.0)]])), [[0.25, 0.75]])


# ---- HTTP -----------------------------------------------------------------------


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_server_answers_healthz_encode_text_and_metrics(engines):
    eng, _ = engines
    srv = serve(eng, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["device"] == "cpu"
        assert health["buckets"] == [2, 4] and health["embed_dim"] == 16 and health["input_hw"] == [40, 48]
        code, out = _post(port, "/encode_text", {"texts": ["a cat", "a dog", "a bird"]})
        assert code == 200
        np.testing.assert_allclose(np.asarray(out["features"]), eng.encode_text(["a cat", "a dog", "a bird"]), atol=1e-6)
        assert _post(port, "/encode_text", {"wrong": []})[0] == 400
        assert _post(port, "/nope", {})[0] == 404
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
            metrics = json.loads(r.read())["endpoints"]
        assert metrics["/encode_text"]["count"] == 2 and metrics["/encode_text"]["errors"] == 1
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()


def test_server_stats_quantiles():
    stats = ServerStats(window=4)
    for ms in (1, 2, 3, 4, 5):
        stats.record("/encode_text", ms / 1e3, ok=ms != 5)
    snap = stats.snapshot()["/encode_text"]
    assert snap["count"] == 5 and snap["errors"] == 1 and snap["window"] == 4 and snap["max_ms"] == 5.0


# ---- the port's boundary ----------------------------------------------------------


_ISOLATION = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "clip_mixer_tpu", "regex", "PIL", "triton"):
    sys.modules[blocked] = None  # any import of these now raises ImportError
import clip_mixer_tpu_torch
names = [m.name for m in pkgutil.walk_packages(clip_mixer_tpu_torch.__path__, "clip_mixer_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from clip_mixer_tpu_torch.text.tokenize import tokenize
assert tokenize(["a photo of a cat"])[0, :6].tolist() == [49406, 320, 1125, 539, 320, 2368]
loaded = [m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.") or m == "clip_mixer_tpu" or m.startswith("clip_mixer_tpu."))]
print(len(names), loaded)
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATION], cwd=REPO, capture_output=True, text=True, timeout=300, check=True
    ).stdout.split()
    assert int(out[0]) >= 44 and out[1] == "[]", out


def test_entry_points_without_a_device_raise_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIP(CLIPConfig(**CFG))
    assert resolve_device("cpu") == torch.device("cpu")
