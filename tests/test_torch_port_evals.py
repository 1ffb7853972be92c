"""The port's evals (``clip_mixer_tpu_torch/evals/zeroshot.py``,
``evals/validators.py``, ``data/hf_eval.py``, ``train/metrics.py``) against
the JAX package's, on the CPU at ``tests/test_evals.py``'s ``CFG`` (width 64,
2 layers, f32) with JAX-initialised weights (``load_jax_params``).

Bounds: features, classifiers and logits within 1e-5 relative (f32; the
same chain summed in another order); top-1 / top-5 and retrieval ranks
exactly JAX's; STS correlations within 1e-6 absolute; the SST-2 probe's
``w`` / ``b`` within 1e-5 relative after its 10 epochs on the same features,
and the same accuracy. The zero-shot validators run 2 classes x 4 templates
(the class lists are patched in both packages): the 1000 x 80 ImageNet head
is the card's to run.
"""

import io
import os
import socket
import sys
import tarfile
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from clip_mixer_tpu.config import CLIPConfig as JaxConfig
from clip_mixer_tpu.data import hf_eval as j_hf
from clip_mixer_tpu.data.pipeline import FileListSource as JFileList
from clip_mixer_tpu.data.pipeline import SyntheticSource as JSynthetic
from clip_mixer_tpu.evals import validators as jv
from clip_mixer_tpu.evals import zeroshot as jz
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.text import tokenize as jax_tokenize
from clip_mixer_tpu.train.metrics import MetricsWriter as JWriter

from clip_mixer_tpu_torch import CLIP, CLIPConfig, load_jax_params
from clip_mixer_tpu_torch.data import hf_eval as t_hf
from clip_mixer_tpu_torch.data.pipeline import FileListSource, SyntheticSource
from clip_mixer_tpu_torch.evals import validators as tv
from clip_mixer_tpu_torch.evals import zeroshot as tz
from clip_mixer_tpu_torch.train.metrics import MetricsWriter

CFG = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64, vision_patch_size=16,
           context_length=77, vocab_size=49408, text_width=64, text_heads=1, text_layers=2, tower="mixer",
           compute_dtype="float32")
JCFG, TCFG = JaxConfig(**CFG), CLIPConfig(**CFG)
RTOL = 1e-5
CLASSES = ["cat", "dog"]
TEMPLATES = ["a photo of a {}.", "a drawing of a {}.", "a close-up photo of a {}.", "a photo of the {}."]
CAPTIONS = ["a cat sits on a mat", "the stock market fell", "a dog runs fast", "hello world", "a red car",
            "an old tree", "two birds", "a boat at sea", "a wooden chair", "a small house", "the moon"]
STS_PAIRS = [
    ("a cat sits on a mat", "a cat sits on a mat", 5.0),
    ("a cat sits on a mat", "the stock market fell", 1.0),
    ("a dog runs fast", "a dog runs quickly", 4.0),
    ("hello world", "goodbye cruel world", 2.0),
] * 3  # tests/test_evals.py's fixture


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port model holding them)."""
    params = jax.jit(jclip.init, static_argnums=1)(jax.random.key(0), JCFG)  # jitted: 2x faster here
    return params, load_jax_params(CLIP(TCFG, device="cpu"), jax.tree.map(np.asarray, params))


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    monkeypatch.setenv("CLIP_MIXER_OFFLINE", "1")  # no test here may probe DNS
    for var in ("HF_HUB_OFFLINE", "HF_DATASETS_OFFLINE"):  # an explicit _load sets them: restore them after
        monkeypatch.setenv(var, os.environ.get(var, "0"))
    monkeypatch.setitem(sys.modules, "datasets", None)  # every load a DatasetUnavailable at once


def rel(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def images(n, seed, res=32):
    return np.random.default_rng(seed).integers(0, 256, (n, res, res, 3), dtype=np.uint8)


@pytest.mark.parametrize("normalize", [True, False])
def test_encode_texts_batched_matches_jax(weights, normalize):
    params, model = weights
    tokens = np.asarray(jax_tokenize(CAPTIONS, 77, truncate=True))
    got = tz.encode_texts_batched(model, tokens, batch_size=4, normalize=normalize)  # last batch padded
    want = jz.encode_texts_batched(params, JCFG, tokens, batch_size=4, normalize=normalize)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(CAPTIONS), 32)
    assert rel(got, want) <= RTOL


def test_encode_texts_batched_normalises_by_default(weights):
    """The repair: the default is JAX's ``normalize=True``, on which the
    retrieval validator and the classifier rely (the old port returned the
    raw features here)."""
    params, model = weights
    tokens = np.asarray(jax_tokenize(CAPTIONS, 77, truncate=True))
    got = tz.encode_texts_batched(model, tokens, batch_size=4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    assert rel(got, jz.encode_texts_batched(params, JCFG, tokens, batch_size=4)) <= RTOL


def test_encode_images_batched_matches_jax(weights):
    params, model = weights
    x = images(10, 1)
    got = tz.encode_images_batched(model, x, batch_size=4)
    want = jz.encode_images_batched(params, JCFG, x, batch_size=4)
    assert got.dtype == np.float32 and got.shape == (10, 32)
    assert rel(got, want) <= RTOL


def test_classifier_and_logits_match_jax(weights):
    params, model = weights
    got_w = tz.build_zeroshot_classifier(model, CLASSES, TEMPLATES, batch_size=3)
    want_w = jz.build_zeroshot_classifier(params, JCFG, CLASSES, TEMPLATES, batch_size=3)
    assert got_w.shape == (32, 2) and rel(got_w, want_w) <= RTOL
    x = images(6, 2)
    got = tz.make_image_classifier(model, want_w)(x)
    want = np.asarray(jz.make_image_classifier(params, JCFG, want_w)(x))
    assert got.dtype == np.float32 and rel(got, want) <= RTOL


def test_topk_accuracy_matches_jax():
    logits = np.random.default_rng(3).normal(size=(64, 10)).astype(np.float32)
    targets = np.random.default_rng(4).integers(0, 10, 64)
    for ks in ((1, 5), (1, 2, 3)):
        assert tz.topk_accuracy(logits, targets, ks) == jz.topk_accuracy(logits, targets, ks)


def test_zero_shot_eval_matches_jax_on_ragged_batches(weights):
    params, model = weights
    classes = CLASSES + ["car", "tree", "house", "bird", "boat"]
    rng = np.random.default_rng(5)
    batches = [(images(b, 10 + b), rng.integers(0, len(classes), b)) for b in (5, 3, 8)]
    got = tz.zero_shot_eval(model, classes, TEMPLATES[:2], batches, batch_size=4)
    want = jz.zero_shot_eval(params, JCFG, classes, TEMPLATES[:2], batches, batch_size=4)
    assert got == want


def _patch_classes(monkeypatch):
    for mod in (jv, tv):
        monkeypatch.setattr(mod, "IMAGENET_CLASSNAMES", CLASSES)
        monkeypatch.setattr(mod, "MNIST_CLASSNAMES", CLASSES)
        monkeypatch.setattr(mod, "PROMPT_TEMPLATES", TEMPLATES)


@pytest.mark.parametrize("kind", ["imagenet", "mnist"])
def test_zero_shot_validators_match_jax(weights, monkeypatch, kind):
    params, model = weights
    _patch_classes(monkeypatch)
    x, y = images(12, 6), np.random.default_rng(7).integers(0, 2, 12)
    batches = lambda: iter([(x[:7], y[:7]), (x[7:], y[7:])])  # noqa: E731
    cls = {"imagenet": (jv.ImageNetValidator, tv.ImageNetValidator),
           "mnist": (jv.MNISTValidator, tv.MNISTValidator)}[kind]
    jw, tw = JWriter(), MetricsWriter()
    want = cls[0](params, JCFG, writer=jw, image_batches_fn=batches).validate(step=3)
    got = cls[1](model, TCFG, writer=tw, image_batches_fn=batches).validate(step=3)
    assert got == want and set(want) == {"top1", "top5"}
    assert dict(tw.history) == dict(jw.history)


def test_zero_shot_validators_skip_offline(weights, tmp_path, monkeypatch, capsys):
    """ImageNetV2 absent and no egress: ``{}`` and JAX's skip line, before
    any prompt is encoded; MNIST without ``datasets`` likewise."""
    _, model = weights
    monkeypatch.chdir(tmp_path)
    w = MetricsWriter()
    assert tv.ImageNetValidator(model, TCFG, writer=w).validate(step=1, verbose=True) == {}
    assert tv.MNISTValidator(model, TCFG, writer=w).validate(step=1, verbose=True) == {}
    out = capsys.readouterr().out
    assert "[imagenet] skipped: ImageNetV2 fetch failed: no URL reachable (offline)" in out
    assert "[mnist] skipped: offline and mnist not cached" in out
    assert not w.history


def test_cosine_sim_validator_matches_jax(weights):
    params, model = weights
    jw, tw = JWriter(), MetricsWriter()
    want = jv.CosineSimValidator(params, JCFG, writer=jw, datasets=[("synthetic", STS_PAIRS)]).validate(step=2)
    got = tv.CosineSimValidator(model, TCFG, writer=tw, datasets=[("synthetic", STS_PAIRS)],
                                figures=True).validate(step=2)
    assert set(got) == set(want) == {"synthetic"} and set(got["synthetic"]) == set(want["synthetic"])
    for k, v in want["synthetic"].items():
        assert abs(got["synthetic"][k] - v) <= (1e-6 if k != "l2_mean" else RTOL * abs(v)), k
    figures = {k for k in tw.history if k.endswith(":figure")}
    assert {k: v for k, v in tw.history.items() if k not in figures}.keys() == jw.history.keys()
    assert figures == {
        "synthetic/neighborContinuousHistogramL2:figure", "synthetic/neighborContinuousHistogramCosine:figure"}


def _sst2_data():
    pos = [(f"great wonderful amazing movie number {i}", 1) for i in range(48)]
    neg = [(f"terrible awful boring movie number {i}", 0) for i in range(48)]
    return [s for pair in zip(pos[:32], neg[:32]) for s in pair], pos[32:] + neg[32:]


def test_sst2_probe_matches_jax(weights):
    params, model = weights
    train, test = _sst2_data()
    tw = MetricsWriter()
    jval = jv.SST2Validator(params, JCFG, train_data=train, test_data=test)
    tval = tv.SST2Validator(model, TCFG, writer=tw, train_data=train, test_data=test)
    got = tval.validate(step=0)
    assert dict(tw.history) == {"Accuracy on SST-2": [(0, got["accuracy"])]}

    # JAX's probe, its validate() loop step for step on its own features, and
    # its accuracy; the port's probe on the same features
    xtr, ytr = jval._embed(train)
    xte, yte = jval._embed(test)
    probe = {"w": jax.numpy.zeros((xtr.shape[1], 2)), "b": jax.numpy.zeros((2,))}
    state = jval._opt.init(probe)
    for _ in range(10):
        for i in range(0, xtr.shape[0], 32):
            probe, state, _ = jval._update(probe, state, xtr[i : i + 32], ytr[i : i + 32])
    logits = np.asarray(jax.numpy.asarray(xte) @ probe["w"] + probe["b"])
    assert got == {"accuracy": 100.0 * float((logits.argmax(-1) == yte).mean())} and got["accuracy"] >= 80.0
    mine = tval.fit_probe(xtr, ytr, "cpu")
    for k in ("w", "b"):
        assert rel(mine[k].numpy(), np.asarray(probe[k], np.float64)) <= RTOL, k


def _rank_keys():
    return {"n"} | {f"{d}_{m}" for d in ("image_to_text", "text_to_image")
                    for m in ("r@1", "r@5", "r@10", "median_rank")}


@pytest.mark.parametrize("source", ["synthetic", "file_list"])
def test_retrieval_validator_matches_jax(weights, tmp_path, source):
    params, model = weights
    if source == "synthetic":
        kw = dict(batch_size=8, image_size=32, n_batches=3, n_classes=16, context_length=77)
        jsrc, tsrc = JSynthetic(**kw), SyntheticSource(**kw)
    else:
        entries = []
        for i, x in enumerate(images(13, 8, res=40)):
            entries.append((str(tmp_path / f"{i}.png"), f"a distinct caption number {i}"))
            Image.fromarray(x).save(entries[-1][0])
        kw = dict(batch_size=4, image_size=32, context_length=77, drop_last=False)
        jsrc, tsrc = JFileList(entries, **kw), FileListSource(entries, **kw)
    jw, tw = JWriter(), MetricsWriter()
    want = jv.RetrievalValidator(params, JCFG, data_source=jsrc, writer=jw, max_samples=20).validate(step=4)
    got = tv.RetrievalValidator(model, TCFG, data_source=tsrc, writer=tw, max_samples=20).validate(step=4)
    assert set(got) == _rank_keys() and got == want
    assert dict(tw.history) == dict(jw.history)


def test_validator_params_go_into_one_kept_eval_model(weights):
    """``validate(params=state_dict)``: a model built once from ``cfg`` on
    ``device`` and reused; the constructor's model is never written to."""
    params, model = weights
    other = jax.jit(jclip.init, static_argnums=1)(jax.random.key(1), JCFG)
    sd_other = load_jax_params(CLIP(TCFG, device="cpu"), jax.tree.map(np.asarray, other)).state_dict()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    src = SyntheticSource(batch_size=8, image_size=32, n_batches=1, context_length=77)
    jsrc = JSynthetic(batch_size=8, image_size=32, n_batches=1, context_length=77)
    v = tv.RetrievalValidator(model, TCFG, data_source=src)
    got = v.validate(step=1, params=sd_other)
    kept = v._eval_model
    assert kept is not None and kept is not model and kept.device == torch.device("cpu")
    assert got == jv.RetrievalValidator(None, JCFG, data_source=jsrc).validate(step=1, params=other)
    assert v.validate(step=2, params=model.state_dict()) == v.validate(step=2)  # the constructor's model
    assert v._eval_model is kept
    assert all(torch.equal(before[k], t) for k, t in model.state_dict().items())
    with pytest.raises(ValueError, match="has no model"):
        tv.RetrievalValidator(None, TCFG, data_source=src, device="cpu").validate(step=0)


def test_metrics_writer_history_only_and_figures(tmp_path, monkeypatch):
    """``log_dir=None`` keeps the history only; ``add_figure`` records
    ``"{name}:figure"`` as JAX's writer does, and no figure reaches the JSONL."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # as on the card's host (and ~6 s of TensorFlow here)
    got, want = MetricsWriter(), JWriter()
    for w in (got, want):
        w.add_scalar("Loss", 1.5, 1)
        w.add_figure("sick/plot", object(), 1)
        w.flush()
    assert dict(got.history) == dict(want.history) == {"Loss": [(1, 1.5)], "sick/plot:figure": [(1, 1.0)]}
    on_disk = MetricsWriter(str(tmp_path / "runs"))
    on_disk.add_scalar("Loss", 1.5, 1)
    on_disk.add_figure("sick/plot", object(), 1)
    on_disk.close()
    with open(tmp_path / "runs" / "metrics.jsonl") as f:
        assert f.read() == '{"step": 1, "name": "Loss", "value": 1.5}\n'
    assert os.listdir(tmp_path) == ["runs"]


def test_hf_eval_offline_autodetect(monkeypatch):
    """No egress: one DNS probe a process, each load a fast
    ``DatasetUnavailable``; explicitly offline, no probe at all."""
    calls = {"n": 0}

    def no_dns(*a, **k):
        calls["n"] += 1
        raise socket.gaierror("Name or service not known")

    monkeypatch.setattr(socket, "getaddrinfo", no_dns)
    monkeypatch.setattr(t_hf, "_REACHABLE", {})
    monkeypatch.setenv("CLIP_MIXER_OFFLINE", "0")
    monkeypatch.setenv("HF_HUB_OFFLINE", "0")
    t0 = time.monotonic()
    for _ in range(2):
        with pytest.raises(t_hf.DatasetUnavailable, match="offline and this-dataset-does-not-exist-xyz"):
            t_hf._load("this-dataset-does-not-exist-xyz", "test")
    assert time.monotonic() - t0 < 20
    assert calls["n"] == 1
    assert os.environ["HF_HUB_OFFLINE"] == "0"  # a detected outage is not handed to children

    monkeypatch.setattr(t_hf, "_REACHABLE", {})
    monkeypatch.setenv("CLIP_MIXER_OFFLINE", "1")
    assert not t_hf.host_reachable("huggingface.co") and calls["n"] == 1
    with pytest.raises(tv.DatasetUnavailable):
        t_hf.sts_pairs("sick")
    assert os.environ["HF_HUB_OFFLINE"] == "1" and calls["n"] == 1


def test_fetch_imagenetv2_and_batches_match_jax(monkeypatch, tmp_path):
    buf = io.BytesIO()
    rng = np.random.default_rng(0)
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for cls in range(2):
            for i in range(2):
                img = io.BytesIO()
                Image.fromarray(rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)).save(img, "JPEG")
                info = tarfile.TarInfo(f"imagenetv2-matched-frequency-format-val/{cls}/{i}.jpeg")
                info.size = len(img.getvalue())
                tar.addfile(info, io.BytesIO(img.getvalue()))
    archive = buf.getvalue()

    class FakeResponse:
        def __init__(self):
            self._b = io.BytesIO(archive)

        def read(self, n):
            return self._b.read(n)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    location = str(tmp_path / "inet")
    monkeypatch.setattr(t_hf, "host_reachable", lambda h, timeout=5.0: False)
    with pytest.raises(tv.DatasetUnavailable, match="offline"):
        tv.fetch_imagenetv2(location)
    assert not os.path.exists(os.path.join(location, ".imagenetv2.tar.gz.partial"))

    monkeypatch.setattr(t_hf, "host_reachable", lambda h, timeout=5.0: True)
    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout=60: FakeResponse())
    root = tv.fetch_imagenetv2(location)
    assert root.endswith("imagenetv2-matched-frequency-format-val")
    assert tv.fetch_imagenetv2(location) == root  # extracted: no second fetch
    got = list(tv._imagenetv2_batches(batch_size=3, location=location, image_size=16))
    want = list(jv._imagenetv2_batches(batch_size=3, location=location, image_size=16))
    assert [b[0].shape for b in got] == [(3, 16, 16, 3), (1, 16, 16, 3)]
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    assert j_hf.STS_SETS == t_hf.STS_SETS
