"""The port's train step against the JAX package's ``make_train_step``, on the CPU.

Both start from one JAX init (moved into the port through ``load_jax_params``)
and take the same three uint8 batches (numpy seeds); JAX runs on a one-device
mesh, with its Pallas kernels in interpret mode. Each step's loss, gradient
norm and scale, the final parameters and (where on) the EMA are held at the
JAX suite's own tolerances (``tests/test_train_step.py``: loss rtol 2e-5,
grad_norm rtol 2e-4, params atol 5e-4). The kernel routes run their plain
versions here, on CPU tensors; the CUDA kernels are held to those on the
card by ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.models import towers as jtowers
from clip_mixer_tpu.ops.pallas import block_kernel as jblock
from clip_mixer_tpu.parallel import train_step as jstep
from clip_mixer_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from clip_mixer_tpu.train.optimizer import make_optimizer as jax_make_optimizer

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
from clip_mixer_tpu_torch.parallel import train_step as tstep
from clip_mixer_tpu_torch.train.optimizer import make_optimizer

# tests/test_train_step.py's CFG; width 128 where the JAX Pallas kernels need it
SMALL = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64, vision_patch_size=16,
             context_length=12, vocab_size=256, text_width=64, text_heads=1, text_layers=2, tower="mixer",
             compute_dtype="float32")
WIDE = dict(SMALL, vision_width=128, text_width=128)
TRAIN = dict(global_batch_size=16, learning_rate=1e-3, warmup_steps=2)
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 2e-5, 2e-4, 5e-4  # tests/test_train_step.py:91-100
TOTAL_STEPS = 10


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(n_data=1, devices=jax.devices()[:1])


def _batch(seed=0, B=16):
    """tests/test_train_step.py's batch: uint8 images, eot (255) the max id."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
    texts = np.zeros((B, 12), np.int32)
    texts[:, 0] = 254
    for i in range(B):
        texts[i, 1:4] = rng.integers(1, 250, 3)
        texts[i, 4] = 255
    return {"images": images, "texts": texts}


BATCHES = [_batch(seed=s) for s in (3, 4, 5)]


def _configs(model=None, train=None, siglip=False):
    model, train = {**SMALL, **(model or {})}, {**TRAIN, **(train or {})}
    jc, tc = jcfg.CLIPConfig(**model), tcfg.CLIPConfig(**model)
    if siglip:
        jc, tc = jc.for_siglip(), tc.for_siglip()
    return (jc, jcfg.TrainConfig(**train)), (tc, tcfg.TrainConfig(**train))


def _run_jax(mesh, jc, jt, init_seed=1, **kw):
    """(initial params as numpy, per-step metrics, final params, EMA or None)."""
    opt = jax_make_optimizer(jt, total_steps=TOTAL_STEPS)
    params = jclip.init(jax.random.key(init_seed), jc)
    init = jax.tree.map(np.array, params)
    state = replicate(mesh, jstep.init_train_state(params, opt))
    step = jstep.make_train_step(jc, jt, mesh, opt, **kw)
    metrics = []
    for b in BATCHES:
        state, m = step(state, shard_batch(mesh, b))
        metrics.append(jax.device_get(m))
    ema = jstep.ema_params(state)
    return init, metrics, jax.device_get(state.params), None if ema is None else jax.device_get(ema)


def _run_port(tc, tt, init, fused_block=False, **kw):
    model = load_jax_params(CLIP(tc, device="cpu"), init)
    if fused_block:
        route_towers(model, True)
    opt = make_optimizer(tt, total_steps=TOTAL_STEPS)
    state = tstep.init_train_state(model, opt)
    step = tstep.make_train_step(tc, tt, opt, **kw)
    metrics = []
    for b in BATCHES:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _assert_tracks(jc, jax_out, port_state, port_metrics):
    _, jm, jparams, jema = jax_out
    for i, (j, t) in enumerate(zip(jm, port_metrics)):
        assert set(t) == set(j), i
        np.testing.assert_allclose(t["loss"], float(j["loss"]), rtol=LOSS_RTOL, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(t["grad_norm"], float(j["grad_norm"]), rtol=NORM_RTOL, err_msg=f"norm, step {i}")
        np.testing.assert_allclose(t["logit_scale"], float(j["logit_scale"]), rtol=LOSS_RTOL)
        if "logit_bias" in j:
            np.testing.assert_allclose(t["logit_bias"], float(j["logit_bias"]), atol=PARAM_ATOL)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jparams), jc)
    got = port_state.model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=PARAM_ATOL, err_msg=name)
    if jema is not None:
        want_ema = jax_params_to_state_dict(jax.tree.map(np.asarray, jema), jc)
        for name, w in want_ema.items():
            np.testing.assert_allclose(port_state.opt_state.ema[name].numpy(), w.numpy(), atol=PARAM_ATOL,
                                       err_msg=f"ema {name}")
    else:
        assert port_state.opt_state.ema is None


CASES = {
    "info_nce": dict(),
    "grad_through_gather_chunked": dict(step=dict(grad_through_gather=True, chunk_size=4)),
    "siglip": dict(siglip=True, train=dict(loss="siglip")),
    "accum2": dict(step=dict(accum_steps=2)),
    "ema": dict(train=dict(ema_decay=0.9)),
    "freeze_visual": dict(train=dict(freeze="visual")),
    "freeze_text": dict(train=dict(freeze="text")),
    "clamp": dict(model=dict(logit_scale_init=5.0)),  # above ln(100) = 4.605
    "fused_mlp": dict(model=dict(WIDE, fused_mlp=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_track_jax(case, mesh):
    c = CASES[case]
    (jc, jt), (tc, tt) = _configs(c.get("model"), c.get("train"), c.get("siglip", False))
    jax_out = _run_jax(mesh, jc, jt, **c.get("step", {}))
    state, metrics = _run_port(tc, tt, jax_out[0], **c.get("step", {}))
    _assert_tracks(jc, jax_out, state, metrics)
    if case == "clamp":
        # the first update leaves ln(scale) near 5.0; the clamp sets it to ln(100)
        assert metrics[0]["logit_scale"] == pytest.approx(100.0, rel=1e-6)
        assert all(m["logit_scale"] <= 100.0 * (1 + 1e-6) for m in metrics)
    if case.startswith("freeze"):
        frozen = tt.freeze
        init = jax_params_to_state_dict(jax_out[0], jc)
        for name, p in state.model.named_parameters():
            if name.startswith("visual.") == (frozen == "visual") and name != "logit_scale":
                assert torch.equal(p.detach(), init[name]), name  # untouched, bit for bit
            assert p.requires_grad, name  # the step restores the flags


def test_fused_block_route_tracks_jax_mixer_tower_fused(mesh, monkeypatch):
    """The port's towers through ``mixer_tower_fused`` (route_towers) against
    JAX's ``make_train_step`` with its towers through the Pallas
    ``mixer_tower_fused`` (monkeypatched into the JAX towers for this test:
    no JAX config field selects it)."""
    monkeypatch.setattr(jtowers, "mixer_tower", lambda params, x, **kw: jblock.mixer_tower_fused(params, x))
    (jc, jt), (tc, tt) = _configs(WIDE)
    jax_out = _run_jax(mesh, jc, jt)
    state, metrics = _run_port(tc, tt, jax_out[0], fused_block=True)
    _assert_tracks(jc, jax_out, state, metrics)


def test_accum2_is_exact_against_the_ports_own_full_batch():
    """GradCache: accum_steps=2 gives the full-batch step's loss and update
    (the JAX suite's own test_grad_accum_matches_full_batch tolerances)."""
    _, (tc, tt) = _configs()
    init = jax.tree.map(np.array, jclip.init(jax.random.key(7), jcfg.CLIPConfig(**SMALL)))
    runs = [_run_port(tc, tt, init, accum_steps=a) for a in (1, 2)]
    (s1, m1), (s2, m2) = runs
    for a, b in zip(m2, m1):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    for (name, a), b in zip(s2.model.state_dict().items(), s1.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4, err_msg=name)


def test_token_mix_output_bias_has_no_gradient():
    """A token-mix output bias adds one constant to a token across the
    width, and every consumer of the token mix's output is a LayerNorm over
    the width, so its exact gradient is zero: what a route computes for it
    is rounding noise (``chip_smoke.py`` holds it on its size, not against
    another route's)."""
    _, (tc, tt) = _configs()
    model, opt = CLIP(tc, device="cpu"), make_optimizer(tt, TOTAL_STEPS)
    tstep.make_train_step(tc, tt, opt)(tstep.init_train_state(model, opt), BATCHES[0])
    named = dict(model.named_parameters())
    for name, p in named.items():
        if name.endswith("token_mix_seq.lin2.bias"):
            weight = named[name.replace(".bias", ".weight")].grad.norm()
            assert p.grad.norm() <= 1e-5 * weight, name
        elif name.endswith(".bias") and "transformer" in name:
            assert p.grad.norm() > 0, name


def test_step_validates_its_arguments():
    _, (tc, tt) = _configs()
    with pytest.raises(ValueError, match="accum_steps"):
        tstep.make_train_step(tc, tt, make_optimizer(tt, 10), accum_steps=0)
    with pytest.raises(ValueError, match="not divisible"):
        tstep.flat_chunker(torch.zeros(10, 1), torch.zeros(10, 1), 4)
    images, texts = torch.arange(12).reshape(12, 1), torch.arange(12).reshape(12, 1)
    chunk = tstep.flat_chunker(images, texts, 3)(1)
    assert chunk[0].data_ptr() == images[4:].data_ptr()  # a view, no copy
    model = CLIP(tc, device="cpu")
    fwd = tstep.make_eval_forward(tc)
    img, txt, scale = fwd(model, BATCHES[0]["images"], BATCHES[0]["texts"])
    assert img.shape == (16, 32) and txt.shape == (16, 32) and not img.requires_grad


# bf16: the port's bf16 loss over three steps at width 128, relative to its
# own f32 step from the same weights and to JAX's bf16 step. Readings on the
# CPU: 4.0e-4, 1.7e-3, 2.8e-3 against f32; 2.7e-4, 3.3e-4, 1.4e-3 against
# JAX. The limits are about 3.6x the largest reading.
BF16_VS_F32 = 1e-2
BF16_VS_JAX = 5e-3


def test_bf16_step_reads_close_to_f32_and_to_jax(mesh):
    readings = {}
    (jc, jt), (tc, tt) = _configs(dict(WIDE, compute_dtype="bfloat16"))
    jax_out = _run_jax(mesh, jc, jt)
    _, bf16 = _run_port(tc, tt, jax_out[0])
    _, f32 = _run_port(dataclasses.replace(tc, compute_dtype="float32"), tt, jax_out[0])
    for i, (b, f, j) in enumerate(zip(bf16, f32, jax_out[1])):
        readings[i] = (abs(b["loss"] - f["loss"]) / f["loss"], abs(b["loss"] - float(j["loss"])) / float(j["loss"]))
    print("bf16 step loss, relative to the port's f32 step and to JAX's bf16 step:", readings)
    for i, (vs_f32, vs_jax) in readings.items():
        assert vs_f32 <= BF16_VS_F32, (i, vs_f32)
        assert vs_jax <= BF16_VS_JAX, (i, vs_jax)
