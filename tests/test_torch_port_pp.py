"""The port's pipeline stages against the JAX package's, on the CPU, after ``tests/test_pp.py``.

The port's ranks run in spawned worlds of 4 processes over gloo
(``tests/torch_port_worlds.py``); JAX runs in this process on a mesh of as
many of its virtual CPU devices. Weights move through ``models/convert.py``.

* ``pipeline_tower`` (the GPipe fill-drain over the stage group, the hops
  point to point) against the plain tower, mixer and transformer, at 2 and 4
  stages with more microbatches than stages: the output and the gradients of
  the input and of every block at atol 1e-6 (``tests/test_pp.py:90,109``).
* The pipelined step on a (data 2 x stage 2) mesh against JAX's
  ``make_pp_train_step`` on the same weights and batches: InfoNCE, under
  remat, the transformer towers, ``accum_steps = 2`` and SigLIP, at the JAX
  suite's tolerances (loss rtol 2e-5, grad norm rtol 2e-4, parameters atol
  5e-4 after 2-3 f32 steps; ``tests/test_pp.py:139-142``); each rank holds
  only its stage's blocks, and the replicated parameters' gradients are
  equal bit for bit across the stage ranks of a data row.
* A planted fault must fail the bound: the last stage collecting microbatch
  t - S in place of t - (S - 1).
* The placement rule: ``pp_param_specs`` splits the block leaves only, as
  JAX's does on its stacked leaves.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.parallel import pp as jpp
from clip_mixer_tpu.parallel.mesh import shard_batch
from clip_mixer_tpu.parallel.train_step import init_train_state as jax_init_state
from clip_mixer_tpu.train.optimizer import make_optimizer as jax_make_optimizer

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from clip_mixer_tpu_torch.parallel import pp

from torch_port_worlds import one_torch_thread, run_world  # noqa: F401 (an autouse fixture)

LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 2e-5, 2e-4, 5e-4  # tests/test_pp.py:139-142
# tests/test_pp.py:90,109's atol, and a relative 1e-6 (about 8 f32 ulps):
# a microbatch's products are blocked and so rounded otherwise than the
# whole batch's
TOWER_ATOL, TOWER_RTOL = 1e-6, 1e-6
GRAD_REL_TOL = 1e-6
TOTAL_STEPS = 10
CFG = dict(embed_dim=32, image_resolution=32, vision_layers=4, vision_width=64, vision_patch_size=16,
           context_length=12, vocab_size=256, text_width=64, text_heads=1, text_layers=4, tower="mixer",
           compute_dtype="float32")  # tests/test_pp.py's CFG
TRAIN = dict(global_batch_size=16, learning_rate=1e-3, warmup_steps=2)
# the token-mix output bias has an exact gradient of zero: held to what
# three Adam steps can move it (tests/test_torch_port_fsdp.py)
NULL_GRAD_PARAMS = "token_mix_seq.lin2.bias"
NULL_GRAD_ATOL = 2 * 3 * TRAIN["learning_rate"]


def _batch(seed, B=16):
    """tests/test_pp.py's batch: uint8 images, eot (255) the max id."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
    texts = np.zeros((B, 12), np.int32)
    texts[:, 0] = 254
    for i in range(B):
        texts[i, 1:4] = rng.integers(1, 250, 3)
        texts[i, 4] = 255
    return {"images": images, "texts": texts}


def _init(model_kw, siglip=False, seed=1):
    jc = jcfg.CLIPConfig(**model_kw)
    tc = tcfg.CLIPConfig(**model_kw)
    if siglip:
        jc, tc = jc.for_siglip(), tc.for_siglip()
    init = jax.tree.map(np.array, jclip.init(jax.random.key(seed), jc))
    sd = {k: v.clone() for k, v in load_jax_params(CLIP(tc, device="cpu"), init).state_dict().items()}
    return jc, init, sd


# ---- the schedule against the plain tower -------------------------------------------------------------

TOWER_MODELS = {"mixer": CFG, "transformer": dict(CFG, tower="transformer")}
N_MICRO = 8  # more microbatches than the 2 and 4 stages


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """The world's readings, and this process's whole towers on the same
    inputs (the port's plain tower: tests/test_torch_port_model.py holds it
    to JAX's scanned tower)."""
    rng = np.random.default_rng(0)
    payload = {"models": TOWER_MODELS, "stages": (2, 4), "n_micro": N_MICRO, "init": {}, "x": {}, "ct": {}}
    plain = {}
    for kind, kw in TOWER_MODELS.items():
        jc, init, sd = _init(kw, seed=3)
        payload["init"][kind] = sd
        model = CLIP(tcfg.CLIPConfig(**kw), device="cpu")
        model.load_state_dict(sd)
        payload["x"][kind], payload["ct"][kind] = {}, {}
        for name, tower, tokens, width in (("visual", model.visual.transformer, jc.vision_tokens, 64),
                                           ("text", model.transformer, 12, 64)):
            x = rng.standard_normal((N_MICRO * 2, tokens, width)).astype(np.float32)
            ct = rng.standard_normal(x.shape).astype(np.float32)
            payload["x"][kind][name], payload["ct"][kind][name] = x, ct
            xt = torch.tensor(x, requires_grad=True)
            y = tower(xt)
            (y * torch.tensor(ct)).sum().backward()
            prefix = "visual.transformer." if name == "visual" else "transformer."
            grads = {f"{prefix}{k}": q.grad.clone() for k, q in tower.named_parameters()}
            plain[(kind, name)] = (y.detach().numpy(), xt.grad.numpy(), grads)
    ranks = run_world("pp_towers", 4, tmp_path_factory.mktemp("pp_towers"), payload)
    return ranks, plain


@pytest.mark.parametrize("kind", sorted(TOWER_MODELS))
@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_tower_matches_the_plain_tower(towers, kind, S):
    """Every rank's output and input gradient equal the whole tower's at
    atol 1e-6; each rank's block gradients equal the whole tower's blocks of
    its stage (and it holds no other block)."""
    ranks, plain = towers
    for name in ("visual", "text"):
        y, dx, grads = plain[(kind, name)]
        held = set()
        for rank, res in enumerate(ranks):
            got = res[(kind, S, name)]
            np.testing.assert_allclose(got["y"], y, atol=TOWER_ATOL, rtol=TOWER_RTOL, err_msg=f"{kind} {name} S={S}")
            np.testing.assert_allclose(got["dx"], dx, atol=TOWER_ATOL, rtol=TOWER_RTOL)
            # a block's gradient sums the 8 microbatches' products, each
            # rounded otherwise than the whole batch's: held by its relative
            # Frobenius error
            errs = {k: float((g - grads[k]).norm() / grads[k].norm()) for k, g in got["grads"].items()}
            assert max(errs.values()) <= GRAD_REL_TOL, sorted(errs.items(), key=lambda kv: kv[1])[-3:]
            held |= set(got["grads"])
            stage = rank % S
            per = 4 // S
            assert {int(pp._BLOCK.match(k).group(2)) for k in got["grads"]} == set(range(stage * per,
                                                                                     (stage + 1) * per))
        assert held == set(grads)


# ---- the pipelined step against JAX's -------------------------------------------------------------------

CASES = {  # name -> (model, train, step kwargs, n_micro, siglip, JAX steps)
    "info_nce": (CFG, {}, {}, 2, False, 3),
    "remat": (dict(CFG, remat=True), {}, {}, 2, False, 2),
    "transformer": (dict(CFG, tower="transformer"), {}, {}, 4, False, 2),
    "accum2": (CFG, {}, dict(accum_steps=2), 2, False, 2),
    "siglip": (CFG, dict(loss="siglip"), {}, 2, True, 2),
}
FAULTS = {"fault_collect_t_minus_S": "info_nce"}


@pytest.fixture(scope="module")
def inputs():
    out = {}
    for name, (model, train, step, n_micro, siglip, steps) in CASES.items():
        jc, init, sd = _init(model, siglip)
        batches = [_batch(s) for s in (3, 4, 5)][:steps]
        out[name] = (jc, init, dict(model=model, train={**TRAIN, **train}, siglip=siglip, n_stage=2,
                                    n_micro=n_micro, step=step, init=sd, batches=batches,
                                    total_steps=TOTAL_STEPS))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    payload = {name: inputs[name][2] for name in CASES}
    for name, base in FAULTS.items():
        payload[name] = dict(inputs[base][2], fault="collect_t_minus_S")
    return run_world("pp_steps", 4, tmp_path_factory.mktemp("pp4"), payload)


_JAX = {}


def _jax_pp(name, inputs):
    """(metrics, final params) of JAX's pipelined step on a (2, 2) mesh."""
    if name not in _JAX:
        jc, init, case = inputs[name]
        mesh = jpp.make_pp_mesh(n_data=2, n_stage=2, devices=jax.devices()[:4])
        jt = jcfg.TrainConfig(**case["train"])
        opt = jax_make_optimizer(jt, total_steps=TOTAL_STEPS)
        state = jpp.place_pp_state(mesh, jax_init_state(jax.tree.map(jnp.asarray, init), opt))
        step = jpp.make_pp_train_step(jc, jt, mesh, opt, n_micro=case["n_micro"], **case["step"])
        metrics = []
        for b in case["batches"]:
            state, m = step(state, shard_batch(mesh, b))
            metrics.append(jax.device_get(m))
        _JAX[name] = (metrics, jax.device_get(state.params))
    return _JAX[name]


def _tracks(jc, want, got):
    """The failures of the port's run against JAX's at the JAX suite's tolerances."""
    jm, jparams = want
    bad = []
    for i, (j, t) in enumerate(zip(jm, got["metrics"])):
        if not np.isclose(t["loss"], float(j["loss"]), rtol=LOSS_RTOL, atol=0):
            bad.append(f"loss step {i}: {t['loss']} vs {float(j['loss'])}")
        if not np.isclose(t["grad_norm"], float(j["grad_norm"]), rtol=NORM_RTOL, atol=0):
            bad.append(f"grad_norm step {i}: {t['grad_norm']} vs {float(j['grad_norm'])}")
    for k, w in jax_params_to_state_dict(jax.tree.map(np.asarray, jparams), jc).items():
        atol = NULL_GRAD_ATOL if k.endswith(NULL_GRAD_PARAMS) else PARAM_ATOL
        if not np.allclose(got["state"][k].numpy(), w.numpy(), atol=atol, rtol=0):
            bad.append(f"params {k}: max {float((got['state'][k] - w).abs().max())}")
    return bad


@pytest.mark.parametrize("name", sorted(CASES))
def test_pp_step_tracks_jax_pp_step(world, inputs, name):
    assert _tracks(inputs[name][0], _jax_pp(name, inputs), world[0][name]) == []
    assert len({r[name]["hash"] for r in world}) == 1, "the ranks' gathered states differ"
    assert len({r[name]["ema_hash"] for r in world}) == 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_holds_its_stage_and_replicated_grads_agree_bit_for_bit(world, name):
    """Rank r is stage r % 2 of data row r // 2: it holds the blocks of its
    stage only (parameters and Adam's moments), and the gradients of every
    parameter outside the blocks (embeddings, ln_pre, the heads,
    logit_scale) are equal bit for bit on the two stage ranks of a row, and
    across the rows after the data mean."""
    for rank, res in enumerate(world[0:4]):
        stage = rank % 2
        assert res[name]["blocks"] == [2 * stage, 2 * stage + 1], (rank, res[name]["blocks"])
        assert all(not pp.is_stage_block(k) or int(pp._BLOCK.match(k).group(2)) // 2 == stage
                   for k in res[name]["moment_keys"])
    ref = world[0][name]["replicated_grads"]
    assert "logit_scale" in ref and "visual.conv1.weight" in ref and "text_projection" in ref
    for res in world[1:]:
        got = res[name]["replicated_grads"]
        assert set(got) == set(ref)
        assert all(torch.equal(got[k], ref[k]) for k in ref), [k for k in ref if not torch.equal(got[k], ref[k])]


def test_planted_fault_collect_t_minus_s_fails(world, inputs):
    """The last stage collecting microbatch t - S must fail the bound."""
    got = world[0]["fault_collect_t_minus_S"]
    assert _tracks(inputs["info_nce"][0], _jax_pp("info_nce", inputs), got) != [], "the planted fault passed"


def test_pp_param_specs_split_the_blocks_only():
    """tests/test_pp.py::test_pp_param_specs_shard_blocks_only, on the
    port's names; a depth the stages do not divide stays whole."""
    shapes = {k: tuple(v.shape) for k, v in CLIP(tcfg.CLIPConfig(**CFG), device="cpu").state_dict().items()}
    specs = pp.pp_param_specs(shapes, 2)
    assert specs["visual.transformer.mixBlocks.0.channel_mix_seq.lin3.weight"] == pp.STAGE_AXIS
    assert specs["transformer.mixBlocks.3.layerNorm1.bias"] == pp.STAGE_AXIS
    assert specs["visual.conv1.weight"] is None and specs["logit_scale"] is None
    assert {k for k, v in specs.items() if v} == {k for k in shapes if pp.is_stage_block(k)}
    assert all(v is None for v in pp.pp_param_specs(shapes, 3).values())
