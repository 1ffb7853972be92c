"""The port's memory plan (``utils/memory.py``) against the JAX package's, term for term.

For ``mixer-b32``, ``vit-l14``, ``vit-l14-336`` and ``rn50x64``, every byte
term of ``plan`` (parameters, Adam, gradients, activations, total) equals
``clip_mixer_tpu.utils.memory.plan``'s under each mode: DP, FSDP, FSDP x TP,
TP, PP(2) (PP(4) and a ResNet's refusal too), with accumulation and with the
EMA, remat on and off; ``suggest`` picks the same candidate with the same
reasons at the same card size. The port computes from its own model (on the
``meta`` device) and its own rules (``parallel/fsdp.py``, ``parallel/tp.py``,
``parallel/pp.py::pp_param_specs``); its default card is 80 GiB (JAX: 16).
"""

import inspect

import pytest

import jax

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.utils import memory as jmem

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.utils import memory as tmem

PRESETS = ("mixer-b32", "vit-l14", "vit-l14-336", "rn50x64")
MODES = [("dp", 8, {}), ("fsdp", 8, {}), ("fsdp", 4, {}), ("fsdp", 8, {"n_model": 2}), ("fsdp", 4, {"n_model": 2}),
         ("tp", 8, {}), ("pp", 2, {}), ("pp", 4, {})]


def _terms(p):
    if isinstance(p, str):
        return p
    return (p.mode, p.params_bytes, p.opt_bytes, p.grad_bytes, p.act_bytes, p.total_bytes)


def _plan(mem, cfg, shapes_kw, *args, **kw):
    try:
        return _terms(mem.plan(cfg, *args, **shapes_kw, **kw))
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("preset", PRESETS)
def test_plan_terms_equal_jax(preset):
    jc, tc = jcfg.PRESETS[preset], tcfg.PRESETS[preset]
    js, tl = jmem.param_shapes(jc), tmem.jax_leaves(tmem.param_shapes(tc))
    assert tmem._full_bytes(tl) == jmem._full_bytes(js)
    checked = 0
    for remat in (True, False):
        jr, tr = jc.replace(remat=remat), tc.replace(remat=remat)
        for mode, n, kw in MODES:
            for accum in (1, 4):
                for ema in (False, True):
                    want = _plan(jmem, jr, {"shapes": js}, mode, n, 256, accum_steps=accum, ema=ema, **kw)
                    got = _plan(tmem, tr, {"leaves": tl}, mode, n, 256, accum_steps=accum, ema=ema, **kw)
                    assert got == want, (preset, remat, mode, n, kw, accum, ema)
                    checked += isinstance(got, tuple)
    assert checked >= (2 * 6 * 2 * 2 if jc.is_resnet else 2 * 8 * 2 * 2)


@pytest.mark.parametrize("preset", PRESETS)
def test_suggest_picks_jax_candidate_with_jax_reasons(preset):
    jc, tc = jcfg.PRESETS[preset], tcfg.PRESETS[preset]
    for n, gb, gib in ((1, 256, 80), (8, 32768, 80), (4, 4096, 16), (6, 300, 80)):
        jbest, jtried = jmem.suggest(jc, n, gb, hbm_bytes=gib << 30, ema=True)
        tbest, ttried = tmem.suggest(tc, n, gb, hbm_bytes=gib << 30, ema=True)
        assert (None if tbest is None else _terms(tbest)) == (None if jbest is None else _terms(jbest))
        assert [(label, None if p is None else _terms(p), why) for label, p, why in ttried] == \
            [(label, None if p is None else _terms(p), why) for label, p, why in jtried], (preset, n, gb)


def test_defaults_are_an_h100s_80_gib():
    assert tmem.HBM_BYTES == 80 << 30
    assert inspect.signature(tmem.suggest).parameters["hbm_bytes"].default == 80 << 30
    assert inspect.signature(jmem.suggest).parameters["hbm_bytes"].default == 16 << 30  # the stated deviation
    cfg = tcfg.PRESETS["vit-l14"]
    default, at80, at16 = (tmem.suggest(cfg, 8, 2048, **kw)[0] for kw in ({}, {"hbm_bytes": 80 << 30},
                                                                          {"hbm_bytes": 16 << 30}))
    assert default.mode == at80.mode != at16.mode, (default.mode, at16.mode)


def test_param_shapes_allocate_nothing_and_count_the_state():
    """The model is built on the meta device; the state counted is the
    parameters and the float buffers (BN running statistics), not
    ``num_batches_tracked`` nor the causal mask."""
    shapes = tmem.param_shapes(tcfg.PRESETS["rn50"])
    assert "visual.bn1.running_mean" in shapes and "visual.bn1.num_batches_tracked" not in shapes
    assert not any(k.endswith("attn_mask") for k in shapes)
    leaves = tmem.jax_leaves(shapes)
    jleaves = jax.tree.leaves(jmem.param_shapes(jcfg.PRESETS["rn50"]))
    assert len(leaves) == len(jleaves)
    assert sorted(tuple(l.shape) for l in leaves) == sorted(tuple(l.shape) for l in jleaves)
