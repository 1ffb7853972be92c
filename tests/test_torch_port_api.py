"""The port's model loading (``api.load``, ``models/convert.py``'s sniffing,
import and checkpoint readers, ``_download``) against the JAX package, on
the CPU.

Each tower kind (Mixer, ViT, ResNet) at a small size is written by the port
in every source format ``load`` reads; the port's ``load`` and the JAX
``api.load`` of the same file must give the same config and f32 features
within the JAX suite's atol 5e-5 / rtol 1e-3. ``sniff_config`` is held to
JAX's for all 12 presets at full size on shape-only stand-ins (a ``meta``
model's state dict as zero-stride numpy views: no memory).
"""

import dataclasses
import hashlib
import io
import os
import sys
import threading
import time
import urllib.request
import warnings

import numpy as np
import pytest
import torch

import jax

from clip_mixer_tpu import api as japi
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.models.convert import sniff_config as jax_sniff_config

from clip_mixer_tpu_torch import CLIP, PRESETS, api
from clip_mixer_tpu_torch.api import save_pretrained
from clip_mixer_tpu_torch.models.convert import load_reference_state_dict, read_safetensors, sniff_config

ATOL, RTOL = 5e-5, 1e-3
ARCH = ("embed_dim", "image_resolution", "vision_layers", "vision_width", "vision_patch_size", "context_length",
        "vocab_size", "text_width", "text_heads", "text_layers", "tower")
SMALL = dict(embed_dim=32, context_length=16, vocab_size=512, text_width=64, text_heads=1, text_layers=2,
             compute_dtype="float32")
KINDS = {
    "mixer": PRESETS["mixer-debug"].replace(**SMALL),
    "vit": PRESETS["vit-b32"].replace(image_resolution=32, vision_layers=2, vision_width=64, vision_patch_size=16,
                                      **SMALL),
    "rn": PRESETS["rn50"].replace(image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=16, **SMALL),
}
SOURCES = ("pt", "fp16_pt", "state_dict_wrapper", "accelerate_dir", "safetensors", "jit", "export")


def source_model(kind):
    """A port model of ``kind`` whose every tensor is drawn (the ResNet's BN
    statistics and scales too, which the init leaves at 0 / 1)."""
    model = CLIP(KINDS[kind], device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)
            elif k.endswith(("running_mean", "bn3.weight")):
                v.copy_(0.1 * torch.randn(v.shape, generator=g))
    return model.eval()


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    R = cfg.image_resolution
    images = rng.normal(0, 1, (3, R, R, 3)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size - 1, (3, cfg.context_length)).astype(np.int32)
    tokens[:, 5] = cfg.vocab_size - 1  # the EOT: the argmax id
    return images, tokens


def write_sources(model, root):
    """Every source format of ``model``'s weights under ``root``: the path
    ``load`` takes and the path JAX's ``api.load`` reads for it."""
    from safetensors.torch import save_file

    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    paths = {}

    def put(name, obj, fname):
        path = os.path.join(root, fname)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(obj, path)
        paths[name] = (path, path)

    put("pt", sd, "plain.pt")
    put("fp16_pt", {k: v.half() if v.is_floating_point() else v for k, v in sd.items()}, "fp16.pt")
    put("state_dict_wrapper", {"state_dict": sd, "epoch": 3}, "wrapped.pt")
    put("accelerate_dir", {"state_dict": {f"module.{k}": v for k, v in sd.items()}}, "acc/pytorch_model.bin")
    paths["accelerate_dir"] = (os.path.join(root, "acc"), os.path.join(root, "acc"))
    os.makedirs(os.path.join(root, "st"))
    save_file({k: v.contiguous() for k, v in sd.items()}, os.path.join(root, "st", "model.safetensors"))
    paths["safetensors"] = (os.path.join(root, "st"), os.path.join(root, "st"))
    images, tokens = inputs(model.cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the tracer's warnings about Python scalars
        traced = torch.jit.trace(model, (torch.from_numpy(images), torch.from_numpy(tokens).long()),
                                 check_trace=False)
    traced.save(os.path.join(root, "jit.pt"))
    paths["jit"] = (os.path.join(root, "jit.pt"),) * 2
    save_pretrained(model, model.cfg, os.path.join(root, "export"))
    paths["export"] = (os.path.join(root, "export"), os.path.join(root, "export", "model.pt"))
    return sd, paths


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    out = {}
    for kind in KINDS:
        out[kind] = write_sources(source_model(kind), str(tmp_path_factory.mktemp(kind)))
    return out


_JAX_FNS = {}


def jax_features(params, cfg, images, tokens):
    """JAX's f32 (image, text) features, one jit per architecture."""
    key = repr(dataclasses.astuple(cfg))
    if key not in _JAX_FNS:
        _JAX_FNS[key] = jax.jit(lambda p, x, t: (jclip.encode_image(p, cfg, x), jclip.encode_text(p, cfg, t)))
    img, txt = _JAX_FNS[key](params, images, tokens)
    return np.asarray(img), np.asarray(txt)


def port_features(model, images, tokens):
    with torch.inference_mode():
        return (model.encode_image(torch.from_numpy(images)).numpy(),
                model.encode_text(torch.from_numpy(tokens)).numpy())


def test_available_models_are_the_jax_packages():
    assert api.available_models() == japi.available_models()
    assert list(api._MODELS.items()) == list(japi._MODELS.items())


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_sniff_config_matches_jax_at_full_size(name):
    with torch.device("meta"):
        model = CLIP(PRESETS[name], device="meta")
    zeros = np.zeros((), np.float32)
    sd = {k: np.broadcast_to(zeros, v.shape) for k, v in model.state_dict().items()}  # shapes only
    got, want = sniff_config(sd), jax_sniff_config(sd)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert {f: getattr(got, f) for f in ARCH} == {f: getattr(PRESETS[name], f) for f in ARCH}


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_load_matches_jax_api_load(written, kind, source):
    sd, paths = written[kind]
    port_path, jax_path = paths[source]
    model, cfg, preprocess = api.load(port_path, compute_dtype="float32", device="cpu")
    params, jcfg, _ = japi.load(jax_path, compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert {f: getattr(cfg, f) for f in ARCH} == {f: getattr(KINDS[kind], f) for f in ARCH}
    assert model.device == torch.device("cpu") and callable(preprocess)
    got = model.state_dict()
    for k, v in sd.items():  # f32 masters: the source's values, fp16-rounded for the fp16 file
        want = v.half().float() if source == "fp16_pt" and v.is_floating_point() else v
        assert got[k].dtype == want.dtype and torch.equal(got[k], want), k
    images, tokens = inputs(cfg, seed=2)
    for g, w in zip(port_features(model, images, tokens), jax_features(params, jcfg, images, tokens)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def test_resnet_import_takes_absent_batch_counts_as_zero_and_drops_logit_bias(written):
    sd, _ = written["rn"]
    cut = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    cut["logit_bias"] = torch.tensor(-10.0)
    cut["input_resolution"] = torch.tensor(64)  # the reference archives' bookkeeping
    assert len(cut) < len(sd) + 2
    model, cfg = load_reference_state_dict(cut, device="cpu")
    got = model.state_dict()
    assert "logit_bias" not in got and cfg.logit_bias_init is None
    counts = [k for k in got if k.endswith("num_batches_tracked")]
    assert counts and all(got[k].dtype == torch.int64 and int(got[k]) == 0 for k in counts)
    for k in cut:
        if k in got:
            assert torch.equal(got[k], cut[k]), k


def test_load_of_a_preset_is_the_ports_seeded_draw():
    model, cfg, _ = api.load("mixer-debug", seed=3, device="cpu", compute_dtype="bfloat16")
    assert cfg == PRESETS["mixer-debug"].replace(compute_dtype="bfloat16")
    want = CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("case", ["remote", "orbax_export", "unknown_name", "missing_tensor", "unexpected_tensor",
                                  "misshapen_tensor"])
def test_load_refusals(written, tmp_path, case):
    sd, _ = written["mixer"]
    if case == "remote":
        with pytest.raises(RuntimeError, match="local paths only"):
            api.load("gs://bucket/run/export", device="cpu")
        return
    if case == "orbax_export":
        (tmp_path / "params").mkdir()
        (tmp_path / "config.json").write_text("{}")
        with pytest.raises(RuntimeError, match="convert_checkpoint.py .* --to torch"):
            api.load(str(tmp_path), device="cpu")
        return
    if case == "unknown_name":
        with pytest.raises(RuntimeError, match="not found; available models"):
            api.load("mixer-b99", device="cpu")
        return
    bad = dict(sd)
    if case == "missing_tensor":
        del bad["visual.ln_post.bias"]
    elif case == "unexpected_tensor":
        bad["visual.extra.weight"] = torch.zeros(3)
    else:
        bad["ln_final.bias"] = torch.zeros(65)
    path = str(tmp_path / "bad.pt")
    torch.save(bad, path)
    with pytest.raises(RuntimeError, match="does not fit the sniffed mixer architecture"):
        api.load(path, device="cpu")


def test_load_without_a_device_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load("mixer-debug")


# ---- the safetensors reader ---------------------------------------------------------


def test_safetensors_reader_matches_the_package(tmp_path, monkeypatch):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(0)
    arrays = {"a.f32": rng.normal(size=(3, 5)).astype(np.float32), "b.f16": rng.normal(size=(7,)).astype(np.float16),
              "c.i64": rng.integers(-2**40, 2**40, (2, 2, 3)), "d.scalar": np.asarray(2.5, np.float32)}
    path = str(tmp_path / "m.safetensors")
    save_file(arrays, path, metadata={"format": "pt"})
    bf16 = {"e.bf16": torch.randn(4, 6, generator=torch.Generator().manual_seed(0)).bfloat16()}
    save_torch(bf16, str(tmp_path / "b.safetensors"))
    want = load_file(path)
    monkeypatch.setitem(sys.modules, "safetensors", None)  # the reader needs no package
    got = read_safetensors(path)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k].numpy(), v)
    got_bf16 = read_safetensors(str(tmp_path / "b.safetensors"))["e.bf16"]
    assert got_bf16.dtype == torch.bfloat16 and torch.equal(got_bf16, bf16["e.bf16"])


# ---- _download, offline -------------------------------------------------------------


class _Server:
    """A fake HTTP response over ``payload[start:]`` that drops the
    connection after ``fail_after`` bytes."""

    def __init__(self, payload, start=0, fail_after=None, delay=0.0):
        self._b = io.BytesIO(payload[start:])
        self._served, self._fail_after, self._delay = 0, fail_after, delay
        self.status = 206 if start else 200
        self.headers = {"Content-Length": str(len(payload) - start)}

    def read(self, n):
        if self._fail_after is not None and self._served >= self._fail_after:
            raise ConnectionResetError("mid-stream drop")
        if self._delay:
            time.sleep(self._delay)
        out = self._b.read(n)
        self._served += len(out)
        return out

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_download_resumes_with_range_and_removes_a_bad_checksum(monkeypatch, tmp_path):
    payload = bytes(range(256)) * 2048  # 512 KiB
    url = f"https://fake.test/{hashlib.sha256(payload).hexdigest()}/model.pt"
    calls = []

    def fake_urlopen(req, *a, **k):
        rng = req.get_header("Range")
        start = int(rng.split("=")[1].rstrip("-")) if rng else 0
        calls.append(start)
        return _Server(payload, start, fail_after=None if start else (128 << 10))  # the first drops at 128 KiB

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    monkeypatch.setattr("time.sleep", lambda s: None)
    target = api._download(url, str(tmp_path))
    assert open(target, "rb").read() == payload
    assert calls[0] == 0 and len(calls) == 2 and calls[1] > 0  # the second request resumed mid-file
    assert not os.path.exists(target + ".partial")
    assert api._download(url, str(tmp_path)) == target and len(calls) == 2  # the cached file is verified

    monkeypatch.setattr(urllib.request, "urlopen", lambda req, *a, **k: _Server(payload))
    with pytest.raises(RuntimeError, match="SHA256"):
        api._download(f"https://fake.test/{'0' * 64}/model2.pt", str(tmp_path))
    assert not os.path.exists(str(tmp_path / "model2.pt.partial"))
    assert not os.path.exists(str(tmp_path / "model2.pt"))


def test_download_serializes_concurrent_callers(monkeypatch, tmp_path):
    payload = b"\xab" * (256 << 10)
    url = f"https://fake.test/{hashlib.sha256(payload).hexdigest()}/model.pt"
    opened = []

    def fake_urlopen(req, *a, **k):
        opened.append(1)
        return _Server(payload, delay=0.005)

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    results, errors = [], []

    def worker():
        try:
            results.append(api._download(url, str(tmp_path)))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and len(results) == 2
    assert open(results[0], "rb").read() == payload
    assert len(opened) == 1  # the second caller found the first's verified file
