"""``scripts/torch_acceptance.py --stand-in`` on the CPU, held against the JAX
package on the same stand-in state dict.

The script's oracle is the port's own f32 model of the state dict on the
CPU. Here the JAX package is the oracle of both: its
``state_dict_to_params`` of the same reference-keyed dict gives

* the demo probabilities within the port's f32 ViT tolerance (atol 5e-5,
  rtol 1e-3; ``tests/test_torch_port_transformer.py``),
* the same zero-shot top-1 and top-5 on the rendered class folders, and
* the same int8 gate counts on the rendered gate images.

A fault planted in the oracle (its ``logit_scale`` moved) fails stage a. A
missing checkpoint writes the record's ``error`` and exits 2.
"""

import importlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_mixer_tpu.evals import quant_gate as jgate
from clip_mixer_tpu.evals import zeroshot as jzs
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.models.convert import state_dict_to_params
from clip_mixer_tpu.ops.preprocess import normalize_images as jax_normalize
from clip_mixer_tpu.text import tokenize as jax_tokenize

from clip_mixer_tpu_torch.models.convert import load_reference_state_dict
from torch_port_worlds import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
acceptance = importlib.import_module("torch_acceptance")

ATOL, RTOL = 5e-5, 1e-3  # f32, tests/test_torch_port_transformer.py
GATE_IMAGES = 32  # stage c's rendered images (JAX's three encoders cost ~75 ms an image here)
N_COMMON = 64


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the record of one stand-in run on the CPU, its state dict, the class folders' root)."""
    work = tmp_path_factory.mktemp("acceptance")
    out = work / "ACCEPTANCE_TORCH.json"
    rc = acceptance.main(["--stand-in", "--device", "cpu", "--out", str(out), "--gate-images", str(GATE_IMAGES),
                          "--torch-n-images", str(N_COMMON)])
    record = json.loads(out.read_text())
    assert rc == 0, record
    sd = torch.load(acceptance.make_standin_checkpoint(work / "standin.pt"), map_location="cpu", weights_only=True)
    root = work / "classes"
    acceptance.make_standin_imagenet(str(root), per_class=8, size=256)
    return record, sd, root


@pytest.fixture(scope="module")
def jax_pair(run):
    params, cfg = state_dict_to_params({k: v.numpy() for k, v in run[1].items()})
    return jax.tree.map(jnp.asarray, params), cfg.replace(compute_dtype="float32")


@pytest.fixture(scope="module")
def jax_classifier(jax_pair):
    """JAX's prompt-ensemble classifier of the stand-in's 16 classes, 8 templates."""
    params, cfg = jax_pair
    classnames = [f"{c} {s}" for c, s in acceptance.STANDIN_CLASSES]
    return jzs.build_zeroshot_classifier(params, cfg, classnames, acceptance.PROMPT_TEMPLATES[:8], batch_size=128)


def test_record_passes_all_three_stages(run):
    record = run[0]
    assert record["passed"] and record["stages_executed"] == 3 and record["stand_in"]
    assert record["device"] == "cpu" and record["tf32"] is False
    assert record["demo_probs"]["max_abs_diff_vs_oracle"] < 0.01
    assert record["imagenet"]["n"] == 128 and record["imagenet"]["classes"] == 16
    assert record["imagenet"]["side_by_side_n"] == N_COMMON and record["imagenet"]["delta_pct"] <= 0.1
    assert record["int8_gate"]["n"] == GATE_IMAGES and record["int8_gate"]["passed"]


def test_demo_probs_match_jax(run, jax_pair):
    from PIL import Image

    params, cfg = jax_pair
    with Image.open(acceptance.ASSET) as im:
        image_u8 = acceptance.preprocess_pil(im, cfg.image_resolution)
    text = jnp.asarray(jax_tokenize(acceptance.DEMO_PROMPTS))
    logits = jax.jit(lambda p, x, t: jclip.logits(p, cfg, jax_normalize(x, dtype=jnp.float32), t)[0])
    per_image = logits(params, jnp.asarray(image_u8[None]), text)
    want = np.asarray(jax.nn.softmax(per_image, axis=-1), np.float64)
    np.testing.assert_allclose(run[0]["demo_probs"]["ours"], want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(run[0]["demo_probs"]["oracle"], want, atol=ATOL, rtol=RTOL)


def test_zero_shot_top1_top5_equal_jax(run, jax_pair, jax_classifier):
    params, cfg = jax_pair
    classify = jzs.make_image_classifier(params, cfg, jax_classifier)
    hits1 = hits5 = n = 0
    for images, targets in acceptance.standin_batches(str(run[2]), len(acceptance.STANDIN_CLASSES), 64,
                                                      cfg.image_resolution):
        a1, a5 = jzs.topk_accuracy(np.asarray(classify(images)), targets)
        hits1 += round(a1 * len(targets))
        hits5 += round(a5 * len(targets))
        n += len(targets)
    got = run[0]["imagenet"]
    assert n == got["n"] == 128
    assert round(got["top1_ours"] * n / 100) == hits1 and round(got["top5_ours"] * n / 100) == hits5, (got, hits1, hits5)


def test_int8_gate_counts_equal_jax(run, jax_pair, jax_classifier):
    params, cfg = jax_pair
    images = acceptance.gate_set(GATE_IMAGES, cfg.image_resolution)
    # build_float_classifier is build_zeroshot_classifier at these arguments
    want = jgate.noise_floor_gate(params, cfg, images, np.asarray(jax_classifier), calibrate_n=GATE_IMAGES,
                                  batch_size=GATE_IMAGES)
    got = run[0]["int8_gate"]
    assert {k: got[k] for k in ("n", "flips_bf16", "flips_int8", "passed")} == \
        {k: want[k] for k in ("n", "flips_bf16", "flips_int8", "passed")}, (got, want)


def test_planted_fault_in_the_oracle_fails_stage_a(run):
    model, _ = load_reference_state_dict(run[1], device="cpu", compute_dtype="float32")
    oracle, _ = load_reference_state_dict(run[1], device="cpu", compute_dtype="float32")
    transform = lambda im: acceptance.preprocess_pil(im, 224)  # noqa: E731
    assert acceptance.stage_demo_probs(model, transform, oracle, check_published=False)["passed"]
    with torch.no_grad():
        oracle.logit_scale += 2.0  # one weight: the scale x e^2
    planted = acceptance.stage_demo_probs(model, transform, oracle, check_published=False)
    assert not planted["passed"] and planted["max_abs_diff_vs_oracle"] > 0.01, planted


def test_missing_checkpoint_records_error(tmp_path):
    out = tmp_path / "ACCEPTANCE_TORCH.json"
    rc = acceptance.main(["--checkpoint", str(tmp_path / "missing.pt"), "--device", "cpu", "--out", str(out)])
    record = json.loads(out.read_text())
    assert rc == 2 and "checkpoint unavailable" in record["error"] and "passed" not in record
    assert os.listdir(tmp_path) == ["ACCEPTANCE_TORCH.json"]
