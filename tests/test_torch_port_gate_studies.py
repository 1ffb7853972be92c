"""The port's gate-stability studies (``scripts/torch_image_gate_stability.py``,
``scripts/torch_text_gate_stability.py``) against the JAX package's, on the CPU.

* At ``mixer-debug`` with the JAX package's weights carried across
  (``load_jax_params``), each study's rows count the flips JAX's own gates
  count on the same inputs (n = 64): the image study's row of seed 1
  (planar; its row of seed 2, NHWC, against the port's own gate, which
  ``tests/test_torch_port_quant_gate.py`` holds to JAX's), the text
  study's two runs. The classifier and the text
  study's image bank agree with JAX's within 1e-5 (f32).
* ``summarize`` gives the committed ``IMAGE_GATE_STABILITY.json``'s
  summaries exactly from its rows.
* The text study's token array is bit for bit the one the JAX script's own
  lines build.
* Without a card and without ``--device`` each new script raises; none of
  the three leaves ``jax`` or ``clip_mixer_tpu`` in ``sys.modules``.
"""

import ast
import importlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_mixer_tpu.config import PRESETS as JAX_PRESETS
from clip_mixer_tpu.evals import quant_gate as jgate
from clip_mixer_tpu.evals.prompts import IMAGENET_CLASSNAMES, PROMPT_TEMPLATES
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.ops.preprocess import normalize_images as jax_normalize

from clip_mixer_tpu_torch import CLIP, PRESETS, load_jax_params
from clip_mixer_tpu_torch.evals import quant_gate as tgate
from torch_port_worlds import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
image_study = importlib.import_module("torch_image_gate_stability")
text_study = importlib.import_module("torch_text_gate_stability")

N = 64
COUNTS = ("n", "flips_bf16", "flips_int8", "passed")
FEATURE_ATOL = 1e-5  # f32: the classifier columns and the bank's rows, port against JAX
NEW_SCRIPTS = ("torch_image_gate_stability", "torch_text_gate_stability", "torch_acceptance")


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX params, the port model holding them) at mixer-debug."""
    jc = JAX_PRESETS["mixer-debug"]
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jclip.init(k, jc))(jax.random.key(0)))
    return jc, params, load_jax_params(CLIP(PRESETS["mixer-debug"], device="cpu"), params).eval()


def _same_counts(got, want):
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}, (got, want)
    assert got["flip_ratio"] == pytest.approx(want["flip_ratio"], rel=1e-12)


def test_image_study_rows_count_jax_flips(pair, capsys):
    jc, params, model = pair
    w = image_study.classifier(model)
    want_w = jgate.build_float_classifier(params, jc, IMAGENET_CLASSNAMES[:64], PROMPT_TEMPLATES[:4], batch_size=256)
    np.testing.assert_allclose(w, want_w, atol=FEATURE_ATOL)
    got = image_study.study(model, want_w, N, 2, 64, ["planar", "nhwc"])
    # one row against JAX's own gate (it compiles anew for each call), the other against the port's gate, which
    # tests/test_torch_port_quant_gate.py holds to JAX's for both front ends
    want = jgate.frontend_noise_floor_gate(params, jc, jgate.synthetic_images(N, 64, seed=1), want_w,
                                           calibrate_n=128, batch_size=256, front_end="planar")
    _same_counts(got["planar"]["rows"][0], want)
    want = tgate.frontend_noise_floor_gate(model, tgate.synthetic_images(N, 64, seed=2), want_w,
                                           calibrate_n=128, batch_size=256, front_end="nhwc")
    _same_counts(got["nhwc"]["rows"][1], want)
    for fe, res in got.items():
        assert len(res["rows"]) == 2 and res["summary"] == image_study.summarize(res["rows"], N)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(d["front_end"], d.get("seed")) for d in lines] == [
        ("planar", 1), ("planar", 2), ("planar", None), ("nhwc", 1), ("nhwc", 2), ("nhwc", None)]


def test_summarize_reproduces_the_jax_record():
    record = json.loads((REPO / "IMAGE_GATE_STABILITY.json").read_text())
    assert set(record["front_ends"]) == {"planar", "nhwc"}
    for fe, res in record["front_ends"].items():
        assert image_study.summarize(res["rows"], record["n"]) == res["summary"], fe


def _jax_script_texts(n, context_length):
    """The token array built by ``scripts/text_gate_stability.py``'s own
    lines, from ``gate_rng = ...`` to the EOT column, run as they stand."""
    src = (REPO / "scripts" / "text_gate_stability.py").read_text()
    main = next(f for f in ast.parse(src).body if isinstance(f, ast.FunctionDef) and f.name == "main")
    first = next(i for i, s in enumerate(main.body) if "gate_rng" in ast.unparse(s))
    body = main.body[first:first + 5]
    assert ast.unparse(body[-1]) == "texts[:, 8] = 49407", ast.unparse(body[-1])
    env = {"np": np, "args": types.SimpleNamespace(n_texts=n), "cfg": types.SimpleNamespace(context_length=context_length)}
    exec(compile(ast.Module(body=body, type_ignores=[]), "text_gate_stability.py", "exec"), env)
    return env["texts"]


@pytest.mark.parametrize("n,context_length", [(4096, 77), (N, 16)])
def test_text_tokens_bit_for_bit(n, context_length):
    got = text_study.gate_texts(n, context_length)
    want = _jax_script_texts(n, context_length)
    assert got.dtype == want.dtype == np.int32 and got.shape == (n, context_length)
    np.testing.assert_array_equal(got, want)


def test_text_study_rows_count_jax_flips(pair, capsys):
    jc, params, model = pair
    texts = text_study.gate_texts(N, jc.context_length)
    jc32 = jc.replace(compute_dtype="float32")
    imgs = jgate.synthetic_images(512, jc.image_resolution, seed=2)
    want_bank = np.asarray(jax.jit(lambda p, x: jclip.l2_normalize(
        jclip.encode_image(p, jc32, jax_normalize(x, dtype="float32"))))(params, jnp.asarray(imgs)), np.float32)
    np.testing.assert_allclose(text_study.image_bank(model), want_bank, atol=FEATURE_ATOL)
    rows = text_study.study(model, texts, want_bank, runs=2)
    want = jgate.text_noise_floor_gate(params, jc, texts, want_bank.T, calibrate_n=128, batch_size=512)
    for row in rows:
        _same_counts(row, want)
    summary = text_study.summarize(rows, N)
    assert summary["spread"] == 0.0 and summary["stable"] and summary["runs"] == 2
    assert [json.loads(line)["run"] for line in capsys.readouterr().out.splitlines()] == [0, 1]


@pytest.mark.parametrize("name,argv", [("torch_image_gate_stability", ["--n", "8"]),
                                       ("torch_text_gate_stability", ["--runs", "1"]),
                                       ("torch_acceptance", ["--stand-in"])])
def test_no_card_without_device_raises(name, argv, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(name).main(argv)
    assert list(tmp_path.iterdir()) == []


def test_scripts_leave_no_jax_in_sys_modules():
    code = ("import runpy, sys\n"
            f"for name in {NEW_SCRIPTS!r}:\n"
            "    runpy.run_path(f'scripts/{name}.py', run_name='not_main')\n"
            "left = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'clip_mixer_tpu'))\n"
            "print(left)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout
