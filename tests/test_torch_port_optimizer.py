"""The port's LR schedule and optimiser against the JAX package's optax chain,
on the CPU in f32.

Parameters start from one JAX init moved through the weight bridge; the
gradients are a fixed numpy-seeded sequence in the JAX tree's shapes, moved
through the same bridge (it only transposes and reshapes), and one of them
is scaled past the clip norm so that the clip acts.
"""

import dataclasses
import math

import numpy as np
import optax
import pytest
import torch

import jax

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.train import optimizer as jopt
from clip_mixer_tpu.train import schedule as jsched

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from clip_mixer_tpu_torch.train import optimizer as topt
from clip_mixer_tpu_torch.train import schedule as tsched

SMALL = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64, vision_patch_size=16,
             context_length=12, vocab_size=256, text_width=64, text_heads=1, text_layers=2, tower="mixer",
             compute_dtype="float32", logit_bias_init=-10.0)
PARAM_TOL = dict(rtol=1e-6, atol=1e-9)  # f32 against f32: rounding only


def _bridge(tree, jc):
    return {k: v.numpy() for k, v in jax_params_to_state_dict(jax.tree.map(np.asarray, tree), jc).items()}


def _pair():
    jc = jcfg.CLIPConfig(**SMALL)
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(0), jc))
    model = load_jax_params(CLIP(tcfg.CLIPConfig(**SMALL), device="cpu"), params)
    return jc, params, model


def _grads(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: np.asarray(scale * rng.normal(0, 1e-2, np.shape(p)), np.float32), params)


@pytest.mark.parametrize("warmup,total", [(2, 10), (0, 5), (3, 3)])
def test_schedule_matches_jax(warmup, total):
    want = jsched.warmup_cosine(5e-4, 5e-6, warmup, total)
    got = tsched.warmup_cosine(5e-4, 5e-6, warmup, total)
    for s in range(total + 3):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6)
    assert got(0) == pytest.approx(5e-6 if warmup else 5e-4)


def test_decay_set_is_jax_decay_mask_through_the_bridge():
    jc, params, model = _pair()
    mask = jopt.decay_mask(params)
    want = _bridge(jax.tree.map(lambda p, m: np.full(np.shape(p), float(m), np.float32), params, mask), jc)
    got = topt.decay_mask(dict(model.named_parameters()))
    assert set(got) == set(want)
    for name, decays in got.items():
        assert np.all(want[name] == float(decays)), name
    # the ones the loss parameters and the patch conv hinge on
    for name in ("visual.conv1.weight", "token_embedding.weight", "text_projection", "visual.proj"):
        assert got[name], name
    for name in ("visual.class_embedding", "visual.ln_pre.weight", "logit_scale", "logit_bias",
                 "transformer.mixBlocks.0.token_mix_seq.lin1.bias", "ln_final.bias"):
        assert not got[name], name


@pytest.mark.parametrize("over", [{}, dict(freeze="text"), dict(weight_decay=0.0, grad_clip_norm=1.0)])
def test_five_updates_match_optax(over):
    jc, params, model = _pair()
    t = dataclasses.replace(tcfg.TrainConfig(learning_rate=1e-3, warmup_steps=2), **over)
    j = dataclasses.replace(jcfg.TrainConfig(learning_rate=1e-3, warmup_steps=2), **over)
    jchain = jopt.make_optimizer(j, total_steps=5)
    jstate = jchain.init(params)
    port = topt.make_optimizer(t, total_steps=5)
    named = dict(model.named_parameters())
    state = port.init(named)
    jp = jax.tree.map(np.asarray, params)
    for i in range(5):
        g = _grads(params, seed=i, scale=400.0 if i == 2 else 1.0)  # step 2: norm far above 20
        if t.freeze:  # the train steps hand a frozen tower zero gradients (JAX) or none (port)
            g[t.freeze] = jax.tree.map(np.zeros_like, g[t.freeze])
        want_norm = float(optax.global_norm(g))
        if i == 2:
            assert want_norm > t.grad_clip_norm
        updates, jstate = jchain.update(g, jstate, jp)
        jp = jax.tree.map(np.asarray, optax.apply_updates(jp, updates))
        tg = {k: torch.from_numpy(v) for k, v in _bridge(g, jc).items()}
        norm = port.update(named, tg, state)
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        want = _bridge(jp, jc)
        for name, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[name], err_msg=f"step {i} {name}", **PARAM_TOL)
    assert state.count == 5


def test_freeze_allocates_no_moments_for_the_frozen_tower():
    _, _, model = _pair()
    named = dict(model.named_parameters())
    for tower in ("visual", "text"):
        state = topt.make_optimizer(tcfg.TrainConfig(freeze=tower), 10).init(named)
        assert set(state.mu) == set(state.nu) == {n for n in named if topt.tower_of(n) != tower}
        assert "logit_scale" in state.mu and "logit_bias" in state.mu
    assert topt.tower_of("transformer.mixBlocks.1.layerNorm2.bias") == "text"
    assert topt.tower_of("visual.transformer.mixBlocks.1.layerNorm2.bias") == "visual"
    assert topt.tower_of("logit_scale") is None
    assert set(topt.make_optimizer(tcfg.TrainConfig(), 10).init(named).mu) == set(named)


def test_ema_slot_formula():
    _, _, model = _pair()
    named = dict(model.named_parameters())
    port = topt.make_optimizer(tcfg.TrainConfig(ema_decay=0.75), 10)
    state = port.init(named)
    before = {n: p.detach().clone() for n, p in named.items()}
    with torch.no_grad():
        for p in named.values():
            p.add_(1.0)
    port.update_ema(named, state)
    for n, e in state.ema.items():
        torch.testing.assert_close(e, 0.75 * before[n] + 0.25 * (before[n] + 1.0), rtol=1e-6, atol=1e-7)
    assert math.isclose(port.schedule(0), 5e-6)
