"""The port's big-preset run (``scripts/torch_bench_big_presets.py``) against
the JAX package's (``scripts/bench_big_presets.py``), on the CPU.

* ``params_m`` of ``vit-l14-336`` and ``rn50x64`` equals the committed
  ``BIG_PRESETS.json``'s, from the shapes alone (no weights drawn).
* The planner's loop picks what JAX's own loop (its lines of
  ``run_one``, run as they stand) picks at 16 GiB (the record: 512 x 8 at
  10.62 GiB; 16 x 1 at 14.15 GiB) and at 80 GiB (512 x 1 at 40.33 GiB;
  128 x 1 at 48.18 GiB).
* On small ViT and ResNet configs (width 64, 2 layers; the ResNet one
  block a stage, width 16) with a JAX param tree carried across
  (``load_jax_params``), the gate at n = 64 counts JAX's
  ``noise_floor_gate``'s flips (f32), and the first train step's loss is
  JAX's within 2e-5 relative (f32; the ViT with GradCache accumulation, as
  the planner picks it at 16 GiB).
* The gate's f32 twin, now a copy of the model (a big preset is drawn
  once), equals the fresh f32 model that loads the model's state dict.
* A preset's record has JAX's keys in JAX's order, then ``device`` and
  ``power_limit``. Only an out-of-memory error is caught in the train leg;
  ``--preset all`` runs one child a preset; ``--hbm-gib`` defaults to an
  H100's 80.
* Without a card and without ``--device`` the script raises; none of the
  three new scripts leaves ``jax`` or ``clip_mixer_tpu`` in ``sys.modules``.
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
from jax.sharding import Mesh

from clip_mixer_tpu.config import PRESETS as JAX_PRESETS
from clip_mixer_tpu.config import TrainConfig as JaxTrainConfig
from clip_mixer_tpu.evals import quant_gate as jgate
from clip_mixer_tpu.evals.prompts import IMAGENET_CLASSNAMES, PROMPT_TEMPLATES
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.parallel import train_step as jstep
from clip_mixer_tpu.train.optimizer import make_optimizer as jax_optimizer
from clip_mixer_tpu.utils import memory as jmemory

from clip_mixer_tpu_torch import CLIP, PRESETS, load_jax_params
from clip_mixer_tpu_torch.evals import quant_gate as port_gate
from clip_mixer_tpu_torch.parallel import train_step as tstep
from clip_mixer_tpu_torch.utils.memory import param_shapes
from torch_port_worlds import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
big = importlib.import_module("torch_bench_big_presets")
RECORD = json.loads((REPO / "BIG_PRESETS.json").read_text())
NEW_SCRIPTS = ("torch_bench_big_presets", "torch_serving_bench", "torch_bench_serving")
GATE_N = 64
LOSS_RTOL = 2e-5
SMALL = {  # width 64, 2 layers (the ResNet: one block a stage, width 16), the text tower width 64
    "vit": dict(vision_layers=2, vision_width=64, image_resolution=32, vision_patch_size=16),
    "rn": dict(vision_layers=(1, 1, 1, 1), vision_width=16, image_resolution=64, vision_patch_size=None),
}
BASE = {"vit": "vit-l14-336", "rn": "rn50x64"}


def small_cfg(presets, kind, **kw):
    return presets[BASE[kind]].replace(embed_dim=32, text_width=64, text_heads=1, text_layers=2, context_length=16,
                                       **SMALL[kind], **kw)


@pytest.mark.parametrize("preset", big.PRESET_LIST)
def test_params_m_equals_jax_record(preset):
    assert big.params_m(param_shapes(PRESETS[preset])) == RECORD[preset]["params_m"]


def _jax_loop(preset, hbm_gib):
    """JAX's ``train_plan``: the lines of ``scripts/bench_big_presets.py``'s
    ``run_one`` from the remat config to the record, run as they stand."""
    src = (REPO / "scripts" / "bench_big_presets.py").read_text()
    run_one = next(f for f in ast.parse(src).body if isinstance(f, ast.FunctionDef) and f.name == "run_one")
    texts = [ast.unparse(s) for s in run_one.body]
    first = texts.index("cfg = cfg.replace(remat=True)")
    last = next(i for i, t in enumerate(texts) if t.startswith("out['train_plan'] ="))
    env = {"cfg": JAX_PRESETS[preset], "args": types.SimpleNamespace(hbm_gib=hbm_gib), "out": {},
           "param_shapes": jmemory.param_shapes, "plan": jmemory.plan}
    exec(compile(ast.Module(body=run_one.body[first:last + 1], type_ignores=[]), "bench_big_presets.py", "exec"),
         env)
    return env["out"]


@pytest.mark.parametrize("preset,hbm_gib,want", [
    ("vit-l14-336", 16, (512, 8, 10.62)), ("rn50x64", 16, (16, 1, 14.15)),
    ("vit-l14-336", 80, (512, 1, 40.33)), ("rn50x64", 80, (128, 1, 48.18)),
])
def test_train_plan_is_jax_loop(preset, hbm_gib, want):
    batch, accum, _, record, verdict = big.train_plan(PRESETS[preset], hbm_gib)
    assert verdict is None and (batch, accum) == want[:2] and record["predicted_total_gib"] == want[2]
    assert {"train_plan": record} == _jax_loop(preset, hbm_gib)
    if hbm_gib == 16:
        assert record == RECORD[preset]["train_plan"]


def jax_tree(jc, seed=0):
    """A JAX param tree of ``jc``'s structure, its leaves drawn with numpy
    (fan-in scaled normals; norm scales and BN variances 1, BN means 0):
    shapes from ``jax.eval_shape`` of the JAX init, which would compile for
    seconds."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jclip.init(k, jc), jax.random.key(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path).rsplit("[", 1)[-1].strip("]'")
        if name == "logit_scale":
            return np.asarray(np.log(1 / 0.07), np.float32)
        if name in ("scale", "var"):
            return np.ones(leaf.shape, np.float32)
        if name == "mean":
            return np.zeros(leaf.shape, np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 2500
        std = 0.02 if name in ("token_embedding", "pos_embedding") else fan_in ** -0.5
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("kind", ["vit", "rn"])
def test_gate_counts_jax_flips(kind):
    """The script's gate protocol (64 classes x 4 templates, calibration
    and batch at min(--infer-batch, 128)), f32 compute as in the package's
    other gate tests: XLA's and PyTorch's bf16 roundings on the CPU
    differ, so only f32 counts compare."""
    jc = small_cfg(JAX_PRESETS, kind, compute_dtype="float32")
    params = jax_tree(jc)
    model = load_jax_params(CLIP(small_cfg(PRESETS, kind, compute_dtype="float32"), device="cpu"), params).eval()
    got = big.int8_gate(model, GATE_N, 64)
    w = jgate.build_float_classifier(params, jc, IMAGENET_CLASSNAMES[:64], PROMPT_TEMPLATES[:4], batch_size=64)
    want = jgate.noise_floor_gate(params, jc, jgate.synthetic_images(GATE_N, jc.image_resolution, seed=1), w,
                                  calibrate_n=64, batch_size=64)
    assert list(got) == list(want) == list(RECORD["rn50x64"]["int8_gate"])
    assert {k: got[k] for k in ("n", "flips_bf16", "flips_int8", "passed")} == {
        k: want[k] for k in ("n", "flips_bf16", "flips_int8", "passed")}
    assert got["flip_ratio"] == pytest.approx(want["flip_ratio"], rel=1e-12)


def _jax_first_loss(jc, params, batch, accum, rng):
    tcfg = JaxTrainConfig(global_batch_size=batch, accum_steps=accum)
    opt = jax_optimizer(tcfg, total_steps=1000)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1), ("data",))
    step = jstep.make_train_step(jc.replace(remat=True), tcfg, mesh, opt, accum_steps=accum)
    res = jc.image_resolution
    data = {"images": rng.integers(0, 256, (batch, res, res, 3), dtype=np.uint8),
            "texts": rng.integers(1, jc.vocab_size - 2, (batch, jc.context_length), dtype=np.int32)}
    _, metrics = step(jstep.init_train_state(params, opt), jax.tree.map(jax.numpy.asarray, data))
    return float(metrics["loss"])


@pytest.mark.parametrize("kind", ["vit", "rn"])
def test_float32_twin_is_the_model_in_f32(kind):
    """The gate's f32 reference, a copy of the model, equals a fresh f32
    CLIP that loads the model's state dict (the twin's old construction):
    the same state, the same features bit for bit; the model is untouched."""
    model = CLIP(small_cfg(PRESETS, kind), device="cpu", generator=torch.Generator().manual_seed(2)).eval()
    twin = port_gate.float32_twin(model)
    fresh = CLIP(model.cfg.replace(compute_dtype="float32"), device="cpu")
    fresh.load_state_dict(model.state_dict())
    fresh.eval()
    assert twin.cfg == fresh.cfg and twin.visual.cfg == fresh.visual.cfg and not twin.training
    assert model.cfg.compute_dtype == "bfloat16" and model.visual.cfg.compute_dtype == "bfloat16"
    got, want = twin.state_dict(), fresh.state_dict()
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, model.cfg.image_resolution, model.cfg.image_resolution, 3)).astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(twin.encode_image(x), fresh.encode_image(x))
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(twin.parameters(), model.parameters()))


@pytest.mark.parametrize("kind,accum", [("vit", 2), ("rn", 1)])
def test_first_train_loss_is_jax(kind, accum, monkeypatch):
    """The leg's first loss against JAX's step on the same weights and
    batch: the ViT at accum 2 (GradCache, as the planner picks it at 16
    GiB), the ResNet without accumulation (BN's train path)."""
    jc = small_cfg(JAX_PRESETS, kind, compute_dtype="float32")
    params = jax_tree(jc, seed=1)
    model = load_jax_params(CLIP(small_cfg(PRESETS, kind, compute_dtype="float32", remat=True), device="cpu"),
                            params)
    losses = []
    make = tstep.make_train_step

    def recording(*a, **kw):  # the leg's step, its unrounded losses kept
        step = make(*a, **kw)

        def run(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics
        return run

    monkeypatch.setattr(tstep, "make_train_step", recording)
    leg = big.train_leg(model.train(), 16, accum, np.random.default_rng(3), torch.device("cpu"))
    assert leg["loss_finite"] and len(losses) == 4 and leg["loss_first"] == round(losses[0], 3)
    want = _jax_first_loss(jc, params, 16, accum, np.random.default_rng(3))
    assert losses[0] == pytest.approx(want, rel=LOSS_RTOL)


@pytest.mark.parametrize("error,caught", [(torch.OutOfMemoryError("CUDA out of memory. Tried to allocate"), True),
                                          (RuntimeError("not a memory error"), False)])
def test_train_leg_catches_only_out_of_memory(error, caught, monkeypatch):
    def failing(*a, **kw):
        def step(state, batch):
            raise error
        return step

    monkeypatch.setattr(tstep, "make_train_step", failing)
    model = CLIP(PRESETS["mixer-debug"], device="cpu")
    if not caught:
        with pytest.raises(RuntimeError, match="not a memory error"):
            big.train_leg(model, 4, 1, np.random.default_rng(0), torch.device("cpu"))
        return
    leg = big.train_leg(model, 4, 1, np.random.default_rng(0), torch.device("cpu"))
    assert leg == {"error": "OutOfMemoryError: CUDA out of memory. Tried to allocate", "oom": True}


def test_preset_all_runs_one_child_a_preset(monkeypatch):
    commands = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: commands.append(cmd) or types.SimpleNamespace(
        returncode=0))
    assert big.main(["--gate-n", "256", "--device", "cpu", "--out", "x.json"]) == 0
    assert [c[c.index("--preset") + 1] for c in commands] == list(big.PRESET_LIST)
    for c in commands:
        assert c[1] == big.__file__ and c[-2:] == ["--device", "cpu"]
        assert c[c.index("--gate-n") + 1] == "256" and c[c.index("--hbm-gib") + 1] == "80.0"


def test_record_has_jax_keys(tmp_path):
    """A whole preset's run (a small ViT under ``vit-l14-336``'s name, on
    the CPU): the JAX record's keys in its order, then the card's name and
    power limit; off a card ``hbm`` says there is no allocator peak."""
    out = tmp_path / "BIG_PRESETS_TORCH.json"
    cfg = small_cfg(PRESETS, "vit")
    assert big.main(["--preset", "vit-l14-336", "--device", "cpu", "--infer-batch", "8", "--gate-n", "16",
                     "--out", str(out)], cfg=cfg) == 0
    rec = json.loads(out.read_text())["vit-l14-336"]
    assert list(rec) == list(RECORD["vit-l14-336"]) + ["device", "power_limit"]
    assert rec["hbm"] == {"actual": "no allocator peak on cpu"} and rec["device"] == "cpu"
    assert rec["train_step"]["loss_finite"] and rec["train_plan"]["batch"] == 512


def test_default_card_is_80_gib():
    assert big.parse_args([]).hbm_gib == 80.0


def test_no_card_without_device_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        big.main(["--preset", "rn50x64"])
    assert list(tmp_path.iterdir()) == []


def test_scripts_leave_no_jax_in_sys_modules():
    code = ("import runpy, sys\n"
            f"for name in {NEW_SCRIPTS!r}:\n"
            "    runpy.run_path(f'scripts/{name}.py', run_name='not_main')\n"
            "left = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'clip_mixer_tpu'))\n"
            "print(left)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout
