"""The port's top-level API (``clip_mixer_tpu_torch/__init__.py``), its five
examples (``examples/torch_*.py``) and its synthetic training demo
(``scripts/torch_train_synthetic_demo.py``) against the JAX package, on the CPU.

* The package exports every name of ``clip_mixer_tpu.__all__``; its
  ``tokenize`` gives JAX's tokens on the examples' captions; JAX-initialised
  ``mixer-debug`` weights, carried across by ``models/convert.py`` and
  written by the port's ``save_pretrained``, load through
  ``clip_mixer_tpu_torch.load`` and give JAX's ``clip_model.logits`` within
  the JAX suite's f32 tolerance (atol 5e-5, rtol 1e-3). Its import stays
  free of JAX and of the serving, training and parallel modules.
* Each example runs as a subprocess at ``mixer-debug`` with ``--device
  cpu``, JAX and ``clip_mixer_tpu`` blocked, exits 0 and prints its lines;
  each prints with the labels of its JAX counterpart; without ``--device``
  on a host without CUDA each exits non-zero, naming the missing device.
* ``torch_zero_shot.py`` on that export prints the probabilities of JAX's
  ``native_style`` on the same weights, within 1e-4.
* The demo's ``main`` at ``mixer-debug`` prints one JSON line with the JAX
  script's keys.
"""

import ast
import contextlib
import io
import json
import os
import re
import runpy
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import clip_mixer_tpu
from clip_mixer_tpu.config import PRESETS as JAX_PRESETS
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.ops.preprocess import make_transform as jax_transform
from clip_mixer_tpu.ops.preprocess import normalize_images as jax_normalize

import clip_mixer_tpu_torch
from clip_mixer_tpu_torch import CLIP, PRESETS, load_jax_params
from clip_mixer_tpu_torch.ops.preprocess import normalize_images

from torch_port_worlds import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
ASSET = REPO / "tests" / "assets" / "CLIP.png"
ATOL, RTOL = 5e-5, 1e-3
PROBS_ATOL = 1e-4
EXAMPLE_TIMEOUT_S = 120
EXAMPLES = ("zero_shot", "train_tiny", "serve_embed", "semantic_search", "finetune_locked_tower")
# every caption the examples tokenize
CAPTIONS = (["a diagram", "a dog", "a cat", "a photo of a dog", "a photo of a cat", "a red square", "a car",
             "a photo of a red square.", "a photo of a silver moon."]
            + [t.format(c) for c in ("dog", "cat", "car") for t in ("a photo of a {}.", "a blurry photo of a {}.")])
LABELS = ["a diagram", "a dog", "a cat"]
# JAX and the JAX package blocked as the isolation test blocks them; TensorBoard
# too (its TensorFlow import costs seconds a process)
SITE = "import sys\nfor m in ('jax', 'clip_mixer_tpu', 'torch.utils.tensorboard'):\n    sys.modules[m] = None\n"
# in one child: the package's import, then each example without --device
# (on a host without CUDA each must raise before printing anything)
NO_DEVICE = r"""
import contextlib, io, json, runpy, sys
import clip_mixer_tpu_torch as clip
loaded = sorted(m for m in sys.modules if m.startswith("clip_mixer_tpu_torch."))
out = {"all": clip.__all__, "loaded": loaded}
for script, argv in json.loads(sys.argv[1]).items():
    sys.argv, printed = [script, *argv], io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            runpy.run_path(script, run_name="__main__")
        out[script] = ["ran", printed.getvalue()]
    except RuntimeError as e:
        out[script] = [str(e), printed.getvalue()]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """JAX-initialised ``mixer-debug`` parameters, and the port export
    directory they were carried into."""
    jcfg = JAX_PRESETS["mixer-debug"]
    params = jclip.init(jax.random.key(3), jcfg)
    model = load_jax_params(CLIP(PRESETS["mixer-debug"], device="cpu"), jax.tree.map(np.asarray, params))
    out = tmp_path_factory.mktemp("jax_export") / "export"
    clip_mixer_tpu_torch.save_pretrained(model, PRESETS["mixer-debug"], str(out))
    return params, jcfg, str(out)


def child_env(tmp):
    site = Path(tmp) / "site"
    site.mkdir(exist_ok=True)
    (site / "sitecustomize.py").write_text(SITE)
    # the examples' run dirs land under the test's tmp dir; one thread beside the suite's other workers
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), str(REPO)]), TMPDIR=str(tmp),
                OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


@pytest.fixture(scope="module")
def runs(jax_export, tmp_path_factory):
    """Every child process of this file, started together (each example with
    ``--device cpu``, and the no-device child), then waited on, each under a
    timeout of its own: ``{key: (returncode, stdout, stderr)}``."""
    tmp = tmp_path_factory.mktemp("runs")
    env = child_env(tmp)
    argv, no_device = {}, {}
    for name in EXAMPLES:
        script = str(REPO / "examples" / f"torch_{name}.py")
        model = [jax_export[2]] if name == "zero_shot" else []
        argv[name] = [sys.executable, script, *model, "--device", "cpu"]
        no_device[script] = model
    argv["no_device"] = [sys.executable, "-c", NO_DEVICE, json.dumps(no_device)]
    procs = {k: (subprocess.Popen(a, cwd=str(tmp), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True), time.monotonic() + EXAMPLE_TIMEOUT_S) for k, a in argv.items()}
    out = {}
    try:
        for k, (p, deadline) in procs.items():
            stdout, stderr = p.communicate(timeout=max(0.0, deadline - time.monotonic()))
            out[k] = (p.returncode, stdout, stderr)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def printed_probs(line: str) -> dict:
    """``label: prob`` of a ``native:`` / ``compat:`` line (a printed dict of rounded floats)."""
    return {k: float(v) for k, v in re.findall(r"'([^']+)': (?:np\.float32\()?([0-9.e+-]+)", line)}


def lines(run, prefix):
    return [line for line in run[1].splitlines() if line.startswith(prefix)]


def print_labels(path: Path) -> list:
    """The string constants of each ``print`` call of a script, in order:
    what a reader diffs between the JAX example's output and the port's."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print":
            parts = []
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    parts.append(arg.value)
                elif isinstance(arg, ast.JoinedStr):
                    parts += [v.value for v in arg.values if isinstance(v, ast.Constant)]
            out.append((node.lineno, parts))
    return [parts for _, parts in sorted(out)]


# ---- (a) the top-level API ---------------------------------------------------


def test_top_level_api_exports_every_name_of_the_jax_package():
    assert set(clip_mixer_tpu.__all__) <= set(clip_mixer_tpu_torch.__all__)
    assert clip_mixer_tpu_torch.__version__ == clip_mixer_tpu.__version__ == "0.1.0"
    for name in clip_mixer_tpu_torch.__all__:
        assert hasattr(clip_mixer_tpu_torch, name), name
    assert clip_mixer_tpu_torch.available_models() == clip_mixer_tpu.available_models()
    assert set(clip_mixer_tpu_torch.PRESETS) == set(clip_mixer_tpu.PRESETS)


def no_device(runs):
    rc, stdout, stderr = runs["no_device"]
    assert rc == 0, stderr[-3000:]
    return json.loads(stdout)


def test_package_import_is_free_of_jax_and_of_serving_training_and_parallel(runs):
    got = no_device(runs)
    assert set(clip_mixer_tpu.__all__) <= set(got["all"])
    heavy = [m for m in got["loaded"] if m.startswith((
        "clip_mixer_tpu_torch.serving", "clip_mixer_tpu_torch.train", "clip_mixer_tpu_torch.aot",
        "clip_mixer_tpu_torch.evals", "clip_mixer_tpu_torch.data"))]
    # models/mixer.py takes parallel/tp.py's collectives; nothing else of parallel/
    parallel = [m for m in got["loaded"] if m.startswith("clip_mixer_tpu_torch.parallel.")]
    assert heavy == [] and parallel == ["clip_mixer_tpu_torch.parallel.tp"], got["loaded"]


@pytest.mark.parametrize("context_length,truncate", [(77, False), (16, True)])
def test_tokenize_equals_jax_on_the_example_captions(context_length, truncate):
    got = clip_mixer_tpu_torch.tokenize(CAPTIONS, context_length=context_length, truncate=truncate)
    want = clip_mixer_tpu.tokenize(CAPTIONS, context_length=context_length, truncate=truncate)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_load_of_a_jax_initialised_export_gives_jax_logits(jax_export):
    params, jcfg, export = jax_export
    model, cfg, preprocess = clip_mixer_tpu_torch.load(export, device="cpu", compute_dtype="float32")
    assert cfg == PRESETS["mixer-debug"] and model.device == torch.device("cpu")
    image = preprocess(Image.open(ASSET))
    np.testing.assert_array_equal(image, jax_transform(jcfg.image_resolution)(Image.open(ASSET)))
    images = np.stack([image, image[::-1]])
    tokens = clip_mixer_tpu_torch.tokenize(LABELS, context_length=cfg.context_length, truncate=True)
    with torch.no_grad():
        got, got_t = model.logits(normalize_images(torch.from_numpy(images.copy())), torch.from_numpy(tokens))
    want, want_t = jclip.logits(params, jcfg.replace(compute_dtype="float32"),
                                jax_normalize(jnp.asarray(images), dtype=jnp.float32), jnp.asarray(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=ATOL, rtol=RTOL)


# ---- (b) the zero-shot example against JAX's native style ---------------------


def test_zero_shot_example_prints_the_probabilities_of_jax_native_style(jax_export, runs, monkeypatch, capsys):
    params, jcfg, export = jax_export
    rc, stdout, stderr = runs["zero_shot"]
    assert rc == 0, stderr[-3000:]
    port = printed_probs(lines(runs["zero_shot"], "native:")[0])
    # JAX's native_style, as examples/zero_shot.py computes it, unrounded
    cfg = jcfg.replace(compute_dtype="float32")
    image = jnp.asarray(jax_transform(cfg.image_resolution)(Image.open(ASSET).convert("RGB")))[None]
    tokens = jnp.asarray(clip_mixer_tpu.tokenize(LABELS, context_length=cfg.context_length, truncate=True))
    per_image, _ = jclip.logits(params, cfg, jax_normalize(image), tokens)
    want = np.asarray(jax.nn.softmax(per_image, axis=-1))[0]
    assert list(port) == LABELS
    np.testing.assert_allclose([port[k] for k in LABELS], want, atol=PROBS_ATOL)
    # and the JAX example itself, run on the export's model.pt, prints the same line
    monkeypatch.setattr(sys, "argv", ["zero_shot.py", os.path.join(export, "model.pt")])
    jax_example = runpy.run_path(str(REPO / "examples" / "zero_shot.py"))
    capsys.readouterr()
    jax_example["native_style"]()
    jax_line = capsys.readouterr().out.strip()
    assert jax_line.startswith("native:")
    np.testing.assert_allclose([printed_probs(jax_line)[k] for k in LABELS], want, atol=PROBS_ATOL)


# ---- (c) the five examples as subprocesses -------------------------------------


def check_zero_shot(run):
    native, compat = lines(run, "native:"), lines(run, "compat:")
    assert len(native) == len(compat) == 1, run[1]
    a, b = printed_probs(native[0]), printed_probs(compat[0])
    assert list(a) == list(b) == LABELS
    np.testing.assert_allclose([a[k] for k in LABELS], [b[k] for k in LABELS], atol=PROBS_ATOL)
    assert abs(sum(a.values()) - 1) < 1e-3


def check_train_tiny(run):
    (line,) = lines(run, "trained + exported to ")
    assert line.endswith("/export; embed_dim=32, params load OK"), line


def check_serve_embed(run):
    assert lines(run, "text:") == ["text: (2, 32) image: (3, 32)"]
    (top2,) = lines(run, "top-2:")
    assert len(re.findall(r"'label': '(dog|cat|car)'", top2)) == 2, top2
    assert lines(run, "int8 image:") == ["int8 image: (3, 32)"]


def check_semantic_search(run):
    for query in ("a photo of a red square.", "a photo of a silver moon."):
        (line,) = lines(run, f"{query} -> ")
        assert len(re.findall(r"\('[a-z ]+#\d+', -?[0-9.]+\)", line)) == 3, line
    (demo,) = lines(run, "demo probs:")
    probs = [float(v) for v in demo.split(":", 1)[1].replace("[", " ").replace("]", " ").split()]
    assert len(probs) == 3 and abs(sum(probs) - 1) < 1e-3, demo


def check_finetune_locked_tower(run):
    assert lines(run, "visual tower locked bitwise:") == [
        "visual tower locked bitwise: True; text tower fine-tuned: True"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu_without_jax(name, runs):
    rc, stdout, stderr = runs[name]
    assert rc == 0, f"{stdout[-2000:]}\n{stderr[-3000:]}"
    globals()[f"check_{name}"](runs[name])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_a_device_raises_on_a_host_without_cuda(name, runs):
    error, printed = no_device(runs)[str(REPO / "examples" / f"torch_{name}.py")]
    assert "no CUDA device is available" in error and printed == ""


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_with_the_labels_of_its_jax_counterpart(name):
    jax_labels = print_labels(REPO / "examples" / f"{name}.py")
    assert jax_labels and print_labels(REPO / "examples" / f"torch_{name}.py") == jax_labels


# ---- (d) the synthetic training demo -------------------------------------------


def test_synthetic_demo_main_prints_one_json_line_with_the_jax_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    spec = runpy.run_path(str(REPO / "scripts" / "torch_train_synthetic_demo.py"))
    with contextlib.redirect_stderr(io.StringIO()):
        result = spec["main"](["--steps", "3", "--batch", "8", "--device", "cpu"], preset="mixer-debug")
    (line,) = capsys.readouterr().out.strip().splitlines()
    assert json.loads(line) == result
    jax_keys = re.findall(r'^\s+"(\w+)":', (REPO / "scripts" / "train_synthetic_demo.py").read_text(), re.M)
    assert list(result) == jax_keys
    assert result["steps"] == 3 and result["global_batch"] == 8 and result["loss_kind"] == "info_nce"
    assert len(result["loss_curve_every10"]) == 1 and result["chance"] == 0.0625
    assert 0.0 <= result["zero_shot_acc_16class_heldout"] <= 1.0 and result["device"] == "cpu"
    assert all(np.isfinite([result["loss_first"], result["loss_min"], result["loss_last"]]))
