"""The port's tensor parallelism against the JAX package's, on the CPU, after ``tests/test_tensor_parallel.py``.

The port's ranks run in spawned worlds over gloo (``tests/torch_port_worlds.py``):
a world of 4 as a (data 2, model 2) mesh and a world of 2 as (data 1,
model 2); JAX runs its ``make_train_step`` in this process on a mesh of the
same shape over its virtual CPU devices. Weights move through
``models/convert.py``.

* The split rule: ``tp_leaf_dim`` is JAX's, and ``tp_param_specs`` splits
  the port's parameters where JAX's splits its leaves (the MLP hidden dims,
  attention's heads), in the port's layout.
* The TP step, three steps (mixer and transformer towers, GradCache,
  remat, SigLIP): losses, gradient norms and final parameters against JAX's
  on the same mesh at the JAX suite's tolerances (``tests/
  test_tensor_parallel.py:79-85``: loss rtol 1e-5, grad_norm rtol 1e-4,
  params atol 5e-4), and every rank's gathered state alike.
* Each rank stores 1/m of every split leaf, and its Adam moments alike.
* A planted fault must fail its bound: ``f_psum`` without its backward
  all-reduce.
* A model group of one (in this process) is bit for bit the whole model's
  step, mixer and transformer (``chip_smoke.py`` phase 13b on the card).
* The refusals: kernel routes under a model group, heads that the model
  axis does not divide.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.parallel import tp as jtp
from clip_mixer_tpu.parallel import train_step as jstep
from clip_mixer_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from clip_mixer_tpu.train.optimizer import make_optimizer as jax_make_optimizer

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
from clip_mixer_tpu_torch.parallel import tp as ttp
from clip_mixer_tpu_torch.parallel import train_step as tstep
from clip_mixer_tpu_torch.parallel.dist import maybe_initialize_distributed
from clip_mixer_tpu_torch.train.optimizer import make_optimizer

from torch_port_worlds import run_world

LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 5e-4  # tests/test_tensor_parallel.py:79-85
TOTAL_STEPS = 5
# tests/test_tensor_parallel.py's CFG at its TP width (128: 2 heads, 1 a rank)
CFG = dict(embed_dim=16, image_resolution=16, vision_layers=2, vision_width=128, vision_patch_size=8,
           context_length=12, vocab_size=128, text_width=128, text_heads=2, text_layers=2, tower="mixer",
           compute_dtype="float32")
TRAIN = dict(learning_rate=1e-3, warmup_steps=1)
NULL_GRAD_PARAMS = "token_mix_seq.lin2.bias"  # exact gradient zero (tests/test_torch_port_parallel.py)
NULL_GRAD_ATOL = 2 * 3 * TRAIN["learning_rate"]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _batch(seed=0, B=8):
    """tests/test_tensor_parallel.py's batch."""
    rng = np.random.default_rng(seed)
    texts = np.zeros((B, 12), np.int32)
    texts[:, 0] = 126
    texts[:, 1:3] = rng.integers(1, 120, (B, 2))
    texts[:, 3] = 127
    return {"images": rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8), "texts": texts}


# ---- the split rule ------------------------------------------------------------------------------------


def test_tp_leaf_dim_is_jax_rule():
    for keys in ([], ["channel_mix", "w_in"], ["channel_mix", "b_in"], ["channel_mix", "w_out"],
                 ["channel_mix", "b_out"], ["mlp", "w_in"], ["mlp", "w_out"], ["attn", "qkv_kernel"],
                 ["attn", "qkv_bias"], ["attn", "out_kernel"], ["attn", "out_bias"], ["token_mix", "w_in"],
                 [None, "attn", "qkv_kernel"], ["text", "token_embedding"]):
        assert ttp.tp_leaf_dim(keys) == jtp.tp_leaf_dim(keys), keys


@pytest.mark.parametrize("tower", ["mixer", "transformer"])
def test_tp_param_specs_split_where_jax_splits(tower):
    """Each port parameter is split on the port dim that JAX's
    ``tp_param_specs`` splits its leaf on (a marker on the model-axis half
    of each JAX leaf, moved into the port's layout), and nowhere else."""
    jc = jcfg.CLIPConfig(**dict(CFG, tower=tower))
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(0), jc))
    specs = jtp.tp_param_specs(params)

    def mark(leaf, spec):
        m = np.zeros(leaf.shape, np.float32)
        idx = [slice(None)] * leaf.ndim
        for ax, name in enumerate(tuple(spec)):
            if name is not None:
                idx[ax] = slice(0, leaf.shape[ax] // 2)
        m[tuple(idx)] = 1.0
        return m

    marks = jax_params_to_state_dict(jax.tree.map(mark, params, specs), jc)
    port = ttp.tp_param_specs(CLIP(tcfg.CLIPConfig(**dict(CFG, tower=tower)), device="cpu"))
    assert set(port) == set(marks)
    for k, m in marks.items():
        split = [d for d in range(m.ndim) if not bool(m.select(d, m.shape[d] - 1).any())] if m.ndim else []
        assert split == ([] if port[k] is None else [port[k]]), (k, split, port[k])
    assert sum(d is not None for d in port.values()) == (12 if tower == "transformer" else 6) * 2


def test_head_major_reorder_round_trips():
    w = torch.arange(3 * 8 * 5, dtype=torch.float32).reshape(24, 5)
    hm = ttp.reorder_attn_head_major(w, 2)
    assert torch.equal(hm[:4], w[:4]) and torch.equal(hm[4:8], w[8:12]) and torch.equal(hm[8:12], w[16:20])
    assert torch.equal(ttp.reorder_attn_head_major(hm, 2, inverse=True), w)
    np.testing.assert_array_equal(ttp._head_major_perm(8, 2), jtp._head_major_perm(8, 2))


# ---- the worlds ------------------------------------------------------------------------------------------

CASES = {  # name -> (world, model overrides, train overrides, step kwargs, siglip)
    "mixer": (4, {}, {}, {}, False),
    "transformer": (4, dict(tower="transformer"), {}, {}, False),
    "transformer_accum2": (4, dict(tower="transformer"), {}, dict(accum_steps=2), False),
    "mixer_remat": (4, dict(remat=True, remat_policy="mlp_hidden"), {}, {}, False),
    "siglip": (4, dict(vision_width=32, text_width=32, text_heads=1, logit_bias_init=-10.0,
                       logit_scale_init=float(np.log(10.0))),
               dict(global_batch_size=16, warmup_steps=2, loss="siglip"), {}, False),
    "mixer_world2": (2, {}, {}, {}, False),
    "transformer_world2": (2, dict(tower="transformer"), {}, {}, False),
}
FAULTS = {"fault_f_psum_no_allreduce": ("mixer", "f_psum_no_allreduce")}


def _init(model_kw):
    jc = jcfg.CLIPConfig(**model_kw)
    init = jax.tree.map(np.array, jclip.init(jax.random.key(7), jc))
    sd = {k: v.clone() for k, v in load_jax_params(CLIP(tcfg.CLIPConfig(**model_kw), device="cpu"),
                                                    init).state_dict().items()}
    return jc, init, sd


@pytest.fixture(scope="module")
def inputs():
    out = {}
    for name, (n, model, train, step, _) in CASES.items():
        model_kw = dict(CFG, **model)
        jc, init, sd = _init(model_kw)
        out[name] = (jc, init, dict(model=model_kw, train={**TRAIN, **train}, n_model=2, step=step, init=sd,
                                    batches=[_batch(0), _batch(1), _batch(2)], total_steps=TOTAL_STEPS))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, inputs):
    done = {}

    def get(n):
        if n not in done:
            payload = {name: inputs[name][2] for name, c in CASES.items() if c[0] == n}
            if n == 4:
                for name, (base, fault) in FAULTS.items():
                    payload[name] = dict(inputs[base][2], fault=fault)
            done[n] = run_world("sharded_steps", n, tmp_path_factory.mktemp(f"tp{n}"), payload)
        return done[n]

    return get


_JAX = {}


def _jax_tp(name, inputs):
    """(metrics, final params) of JAX's step on a (data, model=2) mesh."""
    if name not in _JAX:
        jc, init, case = inputs[name]
        n = CASES[name][0]
        mesh = make_mesh(n_data=n // 2, n_model=2, devices=jax.devices()[:n])
        jt = jcfg.TrainConfig(**case["train"])
        opt = jax_make_optimizer(jt, total_steps=TOTAL_STEPS)
        state = replicate(mesh, jstep.init_train_state(jax.tree.map(jnp.asarray, init), opt))
        step = jstep.make_train_step(jc, jt, mesh, opt, **case["step"])
        metrics = []
        for b in case["batches"]:
            state, m = step(state, shard_batch(mesh, b))
            metrics.append(jax.device_get(m))
        _JAX[name] = (metrics, jax.device_get(state.params))
    return _JAX[name]


def _tracks(jc, want, got):
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


@pytest.mark.parametrize("name", list(CASES), ids=[f"world{CASES[c][0]}-{c}" for c in CASES])
def test_tp_step_tracks_jax_mesh(worlds, inputs, name):
    ranks = worlds(CASES[name][0])
    assert _tracks(inputs[name][0], _jax_tp(name, inputs), ranks[0][name]) == []
    assert len({r[name]["hash"] for r in ranks}) == 1, "the ranks' gathered states differ"
    if name == "siglip":
        assert ranks[0][name]["state"]["logit_bias"].item() != -10.0


def test_split_leaves_are_stored_split(worlds, inputs):
    """Each rank holds 1/2 of every split leaf (and its Adam moments alike),
    every other leaf whole; the two model ranks of a data row hold
    different halves."""
    ranks = worlds(4)
    whole = {k: tuple(v.shape) for k, v in inputs["transformer"][2]["init"].items()}
    for r in ranks:
        got = r["transformer"]
        for k, shape in got["shapes"].items():
            d = ttp.port_tp_dim(k)
            want = whole[k] if d is None else tuple(s // 2 if i == d else s for i, s in enumerate(whole[k]))
            assert shape == want and got["moment_shapes"][k] == want, (k, shape, want)


def test_planted_fault_f_psum_without_backward_allreduce_fails(worlds, inputs):
    got = worlds(4)[0]["fault_f_psum_no_allreduce"]
    assert _tracks(inputs["mixer"][0], _jax_tp("mixer", inputs), got) != [], "the planted fault passed"


# ---- a model group of one, in this process ------------------------------------------------------------


@pytest.fixture
def group1(tmp_path, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize_distributed("cpu", coordinator=f"file://{tmp_path / 'store'}", num_processes=1,
                                        process_id=0, timeout_s=30)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("tower", ["mixer", "transformer"])
def test_a_model_group_of_one_is_the_whole_step_bit_for_bit(group1, tower):
    cfg = tcfg.CLIPConfig(**dict(CFG, tower=tower))
    tc = tcfg.TrainConfig(**TRAIN, ema_decay=0.9)
    runs = []
    for split in (False, True):
        model = CLIP(cfg, device="cpu")
        if split:
            ttp.shard_model_tp(model, group1)
        opt = make_optimizer(tc, TOTAL_STEPS)
        state, step = tstep.init_train_state(model, opt), tstep.make_train_step(cfg, tc, opt)
        losses = [step(state, _batch(s))[1]["loss"] for s in (0, 1)]
        sd = {k: ttp.gather_tp(k, v, getattr(model, "tp_group", None), ttp.heads_of(model, k))
              for k, v in model.state_dict().items()}
        runs.append((losses, sd))
    (la, a), (lb, b) = runs
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


def test_kernel_routes_and_indivisible_heads_are_refused(group1):
    with pytest.raises(ValueError, match="plain route"):
        ttp.shard_model_tp(CLIP(tcfg.CLIPConfig(**dict(CFG, fused_mlp=True)), device="cpu"), group1)
    routed = CLIP(tcfg.CLIPConfig(**CFG), device="cpu")
    route_towers(routed, True)
    with pytest.raises(ValueError, match="route"):
        ttp.shard_model_tp(routed, group1)
    split = ttp.shard_model_tp(CLIP(tcfg.CLIPConfig(**CFG), device="cpu"), group1)
    with pytest.raises(ValueError, match="plain"):
        route_towers(split, True)
    with pytest.raises(ValueError, match="text_heads=2 is not divisible by the 4 ranks"):
        ttp.check_tp(tcfg.CLIPConfig(**dict(CFG, tower="transformer")), 4)
    with pytest.raises(ValueError, match="vision_heads=1"):
        ttp.check_tp(tcfg.CLIPConfig(**dict(CFG, tower="transformer", vision_width=64)), 2)
    # CLIPConfig.model_axis is taken; pipeline_axis is still refused
    CLIP(tcfg.CLIPConfig(**dict(CFG, model_axis="model")), device="cpu")
    with pytest.raises(NotImplementedError, match="item 16b, pipeline stages"):
        CLIP(tcfg.CLIPConfig(**dict(CFG, pipeline_axis="stage")), device="cpu")
