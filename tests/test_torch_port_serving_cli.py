"""The port's serving command line (``clip_mixer_tpu_torch.serving``'s
``build_server`` / ``main``) and its client, on the CPU.

A ``mixer-debug`` export of JAX-initialised weights is served by
``build_server`` with ``--int8``, ``--index``, ``--classifier``,
``--warmup`` and ``--input-size``; the port's ``ServingClient`` and the
JAX package's call every endpoint. The answers are held to the JAX
``InferenceEngine`` on the same weights, artifact, bank and classifier:
int8 features at per-row cosine >= 0.99999 (f32 compute, the bound of
``test_torch_port_quant_serving.py``), the same retrieve ids and classify
labels.
"""

import io
import json
import os
import queue
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax

from clip_mixer_tpu.client import ServingClient as JaxClient
from clip_mixer_tpu.config import PRESETS as JAX_PRESETS
from clip_mixer_tpu.evals import prompts as jax_prompts
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.serving import InferenceEngine as JaxEngine

from clip_mixer_tpu_torch import CLIP, PRESETS, load_jax_params
from clip_mixer_tpu_torch.api import save_pretrained
from clip_mixer_tpu_torch.client import ServingClient
from clip_mixer_tpu_torch.evals import prompts
from clip_mixer_tpu_torch.evals.quant_gate import synthetic_images
from clip_mixer_tpu_torch.ops import quant_io
from clip_mixer_tpu_torch.serving import InferenceEngine, build_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_COSINE = 0.99999
SERVE_START_S = 120  # the subprocess server's first line (torch import, load, bind)
N = 40  # --input-size
D = PRESETS["mixer-debug"].embed_dim
TEXTS = ["a photo of a cat", "a dark photo of a dog", "a red car", "a tall tree", "a small house"]
CLASSES = ["cat", "dog", "car", "tree", "house", "bird"]


def _npy(img):
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def _cosine(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The export, the artifact, the bank, the classifier file, the JAX
    engine holding the same, and the port's server in a thread."""
    root = tmp_path_factory.mktemp("cli")
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(0), JAX_PRESETS["mixer-debug"]))
    export = str(root / "export")
    save_pretrained(load_jax_params(CLIP(PRESETS["mixer-debug"], device="cpu"), params), PRESETS["mixer-debug"],
                    export)
    art, bank = str(root / "scales.npz"), str(root / "bank.npz")
    writer = InferenceEngine(load_jax_params(CLIP(PRESETS["mixer-debug"], device="cpu"), params),
                             batch_buckets=(8,), input_hw=(N, N))
    writer.enable_int8(synthetic_images(16, N, seed=1), TEXTS, save_calibration=art)
    bank_images = synthetic_images(12, N, seed=2)
    meta = {"cfg": quant_io._cfg_dict(writer.cfg), "path": "int8", "source": export, "input_hw": [N, N]}
    np.savez(bank, features=writer.encode_image_arrays(bank_images), ids=np.array([f"b{i}" for i in range(12)]),
             __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
    names = str(root / "classes.txt")
    with open(names, "w") as f:
        f.write("\n".join(CLASSES) + "\n\n")

    jeng = JaxEngine(params, JAX_PRESETS["mixer-debug"], input_hw=(N, N))
    jeng.enable_int8(calibration=art)
    jeng.load_index_file(bank)
    jeng.load_classifier(CLASSES, jax_prompts.PROMPT_TEMPLATES)

    server, engine = build_server(["--model", export, "--port", "0", "--device", "cpu", "--int8", art, "--index",
                                   bank, "--warmup", "--classifier", names, "--input-size", str(N)])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield dict(export=export, engine=engine, jeng=jeng, url=f"http://127.0.0.1:{server.server_address[1]}",
               images=synthetic_images(8, N, seed=3))
    server.shutdown()
    server.server_close()
    thread.join()


def test_build_server_loads_the_flags(setup):
    engine = setup["engine"]
    assert engine.path_kinds == {"image": "int8", "text": "int8"} and engine.input_hw == (N, N)
    assert len(engine._index[1]) == 12 and engine._classnames == CLASSES


@pytest.mark.parametrize("client", [ServingClient, JaxClient], ids=["port_client", "jax_client"])
def test_every_endpoint_matches_the_jax_engine(setup, client):
    c, jeng, images = client(setup["url"]), setup["jeng"], setup["images"]
    blobs = [_npy(img) for img in images]
    before = c.metrics()
    health = c.healthz()
    assert health["status"] == "ok" and health["device"] == "cpu" and health["input_hw"] == [N, N]
    assert health["paths"] == {"image": "int8", "text": "int8"} and health["index_size"] == 12

    text = c.encode_text(TEXTS)
    assert text.shape == (5, D) and _cosine(text, jeng.encode_text(TEXTS)).min() >= F32_COSINE
    image = c.encode_image_files(blobs)
    want = jeng.encode_image_arrays(images)
    assert image.shape == (8, D) and _cosine(image, want).min() >= F32_COSINE
    sim = c.similarity(blobs[:3], TEXTS[:4])
    np.testing.assert_allclose(sim["logits_per_image"], 100.0 * want[:3] @ jeng.encode_text(TEXTS[:4]).T, atol=2e-3)
    assert np.allclose(sim["probs"].sum(-1), 1.0, atol=1e-5)

    got = c.classify(blobs, top_k=3)
    assert [[r["label"] for r in row] for row in got] == [[r["label"] for r in row]
                                                          for row in jeng.classify(images, top_k=3)]
    got = c.retrieve(TEXTS, top_k=5)
    assert [[r["id"] for r in row] for row in got] == [[r["id"] for r in row] for row in jeng.retrieve(TEXTS, 5)]
    metrics = c.metrics()
    for ep in ("/encode_text", "/encode_image", "/similarity", "/classify", "/retrieve"):
        old = before.get(ep, {"count": 0, "errors": 0})
        assert (metrics[ep]["count"], metrics[ep]["errors"]) == (old["count"] + 1, old["errors"]), ep
    with pytest.raises(RuntimeError, match="HTTP 400"):  # either client's ServingError
        c.encode_image_files([b"not an image"])


def test_index_endpoint_replaces_the_bank(setup, tmp_path):
    """Last of the endpoint tests (it replaces the server's bank): /index
    through the port's client, then /retrieve against the JAX engine
    indexed with the same images."""
    c, jeng, images = ServingClient(setup["url"]), setup["jeng"], setup["images"]
    ids = [f"img{i}" for i in range(len(images))]
    assert c.index([_npy(img) for img in images], ids) == len(ids)
    jeng.index_images(images, ids)
    got = c.retrieve(TEXTS, top_k=5)
    assert [[r["id"] for r in row] for row in got] == [[r["id"] for r in row] for row in jeng.retrieve(TEXTS, 5)]
    assert c.healthz()["index_size"] == len(ids)


@pytest.mark.parametrize("case", ["all_devices", "frozen_dir"])
def test_cli_refusals(setup, tmp_path, case):
    # a frozen directory refuses the flags that would re-trace its encoders (or, for
    # --all-devices, rebuild the layout its manifest records), before loading anything
    os.makedirs(tmp_path / "servable")
    (tmp_path / "servable" / "manifest.json").write_text("{}")
    flag, name = (["--all-devices"], "--all-devices") if case == "all_devices" else (["--int8", "scales.npz"], "--int8")
    with pytest.raises(SystemExit, match=f"{name} would re-trace the encoders.*--no-frozen"):
        build_server(["--model", str(tmp_path), "--device", "cpu", *flag])


def test_cli_all_devices_serves_every_visible_card(setup, monkeypatch):
    """--all-devices: one engine over serving.local_mesh(); with no card, or
    one, the single-device engine (JAX's local_mesh is None there too)."""
    server, engine = build_server(["--model", setup["export"], "--device", "cpu", "--all-devices", "--port", "0"])
    server.server_close()
    assert engine.devices is None and len(engine.replicas) == 1
    calls = []
    monkeypatch.setattr("clip_mixer_tpu_torch.serving.local_mesh", lambda: calls.append(1) or None)
    server, engine = build_server(["--model", setup["export"], "--device", "cpu", "--all-devices", "--port", "0"])
    server.server_close()
    assert calls == []  # --device cpu: the cards are not asked


def test_cli_defaults_to_the_card(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(["--model", setup["export"], "--port", "0"])


def test_python_dash_m_serves(setup):
    """``python -m clip_mixer_tpu_torch.serving`` in a subprocess: its first
    /healthz and one /encode_text answer. Its first line is awaited for at
    most ``SERVE_START_S``, so a server that hangs before it listens fails
    the test instead of blocking the run."""
    proc = subprocess.Popen([sys.executable, "-m", "clip_mixer_tpu_torch.serving", "--model", setup["export"],
                             "--port", "0", "--device", "cpu"], cwd=REPO, stdout=subprocess.PIPE, text=True)
    first = queue.Queue()
    threading.Thread(target=lambda: first.put(proc.stdout.readline()), daemon=True).start()
    try:
        try:
            line = first.get(timeout=SERVE_START_S)
        except queue.Empty:
            pytest.fail(f"the serving CLI printed nothing in {SERVE_START_S} s")
        assert line.startswith("serving on :"), line
        url = f"http://127.0.0.1:{int(line.split(':')[1].split()[0])}"
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            assert json.loads(r.read())["paths"] == {"image": "float", "text": "float"}
        assert ServingClient(url).encode_text(TEXTS[:2]).shape == (2, D)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()


def test_prompts_are_the_jax_packages():
    assert prompts.IMAGENET_CLASSNAMES == jax_prompts.IMAGENET_CLASSNAMES
    assert prompts.PROMPT_TEMPLATES == jax_prompts.PROMPT_TEMPLATES
    assert prompts.MNIST_CLASSNAMES == jax_prompts.MNIST_CLASSNAMES
    assert len(prompts.IMAGENET_CLASSNAMES) == 1000 and len(prompts.PROMPT_TEMPLATES) == 80
