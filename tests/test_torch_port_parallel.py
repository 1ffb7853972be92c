"""The port's data-parallel layer against the JAX package's mesh forms, on the CPU.

The port's ranks run in spawned worlds of 2 and 4 processes over gloo
(``tests/torch_port_worlds.py``: torch only, a ``file://`` rendezvous, a
deadline); JAX runs in this process on a mesh of as many of its 8 virtual
CPU devices, its Pallas kernels in interpret mode. Inputs come from numpy
seeds; weights move through ``models/convert.py``.

* The cross-device losses (``info_nce`` with both gather settings and
  chunked, the SigLIP ring) and SyncBN's ``batch_moments``: each rank's
  loss and gradients against JAX's under ``shard_map``.
* The data-parallel train step, three steps: each case's losses, gradient
  norms, final parameters (and EMA) against JAX's ``make_train_step`` at
  the JAX suite's tolerances (loss rtol 2e-5, grad_norm rtol 2e-4, params
  atol 5e-4), and every rank's parameters hashing alike.
* Port world 2 against port world 1 on one augmented global batch (the
  crops are drawn for the global batch).
* Planted faults that must fail their bound: the gradients summed, not
  averaged; the ring's backward sending cotangents on instead of back;
  SyncBN's all-reduce outside the autograd graph.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.sharding import PartitionSpec as P

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.models import resnet as jres
from clip_mixer_tpu.models import towers as jtowers
from clip_mixer_tpu.ops import losses as jloss
from clip_mixer_tpu.ops.pallas import block_kernel as jblock
from clip_mixer_tpu.parallel import train_step as jstep
from clip_mixer_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from clip_mixer_tpu.train.optimizer import make_optimizer as jax_make_optimizer

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from clip_mixer_tpu_torch.parallel import train_step as tstep
from clip_mixer_tpu_torch.train.optimizer import make_optimizer

from torch_port_worlds import run_world

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)  # f32 against f32 across ranks: summation order only
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 2e-5, 2e-4, 5e-4  # tests/test_train_step.py:91-100
TOTAL_STEPS = 10

SMALL = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64, vision_patch_size=16,
             context_length=12, vocab_size=256, text_width=64, text_heads=1, text_layers=2, tower="mixer",
             compute_dtype="float32")
WIDE = dict(SMALL, vision_width=128, text_width=128)
RN = dict(embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=8, vision_patch_size=None,
          context_length=12, vocab_size=256, text_width=64, text_heads=1, text_layers=1, tower="transformer",
          compute_dtype="float32")
TRAIN = dict(global_batch_size=16, learning_rate=1e-3, warmup_steps=2)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _mesh(n):
    return make_mesh(n_data=n, devices=jax.devices()[:n])


# ---- the losses and SyncBN's moments ---------------------------------------------------------------

B, D = 16, 8


def _loss_inputs():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(B, D)).astype(np.float32)
    txt = rng.normal(size=(B, D)).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    x = rng.normal(1.0, 2.0, (8, 3, 3, 5)).astype(np.float32)
    return {"img": img, "txt": txt, "scale": np.float32(10.0), "bias": np.float32(-10.0), "chunk": 4,
            "x": x, "c": rng.normal(size=x.shape).astype(np.float32)}


LOSS_INPUTS = _loss_inputs()


def _lazy_worlds(start):
    """A getter of each world size's results, each world spawned once."""
    done = {}

    def get(n):
        if n not in done:
            done[n] = start(n)
        return done[n]

    return get


@pytest.fixture(scope="module")
def loss_worlds(tmp_path_factory):
    return _lazy_worlds(lambda n: run_world("losses", n, tmp_path_factory.mktemp(f"losses{n}"), LOSS_INPUTS))


def _jax_per_rank(n, fn):
    """Each rank's (loss, d img, d txt, d scale, d bias) of ``fn(img, txt,
    scale, bias)`` under ``shard_map`` on n devices (a rank's gradients are
    of its own loss, through the collectives' transposes)."""
    p = LOSS_INPUTS

    def local(i, t, s, b):
        loss, (gi, gt, gs, gb) = jax.value_and_grad(fn, argnums=(0, 1, 2, 3))(i, t, s, b)
        return loss[None], gi, gt, gs[None], gb[None]

    out = jax.jit(jax.shard_map(local, mesh=_mesh(n), in_specs=(P("data"), P("data"), P(), P()),
                                out_specs=(P("data"),) * 5, check_vma=False))(
        jnp.asarray(p["img"]), jnp.asarray(p["txt"]), jnp.asarray(p["scale"]), jnp.asarray(p["bias"]))
    return [np.asarray(o) for o in out]


def _assert_rank_grads(ranks, name, want, with_bias, fails=False):
    loss, gi, gt, gs, gb = want
    b = B // len(ranks)
    checks = []
    for r, res in enumerate(ranks):
        got = res[name]
        rows = slice(r * b, (r + 1) * b)
        checks += [(got["loss"], loss[r], LOSS_TOL), (got["img"], gi[rows], GRAD_TOL),
                   (got["txt"], gt[rows], GRAD_TOL), (got["scale"], gs[r], GRAD_TOL)]
        if with_bias:
            checks.append((got["bias"], gb[r], GRAD_TOL))
    if not fails:
        for got, w, tol in checks:
            np.testing.assert_allclose(got, w, err_msg=name, **tol)
        return
    assert not all(np.allclose(got, w, **tol) for got, w, tol in checks), f"{name}: the planted fault passed"


@pytest.mark.parametrize("n", [2, 4], ids=["world2", "world4"])
@pytest.mark.parametrize("gtg", [False, True], ids=["detached", "grad_through_gather"])
@pytest.mark.parametrize("chunk", [None, 4], ids=["full", "chunked"])
def test_info_nce_matches_jax_shard_map(loss_worlds, n, gtg, chunk):
    ranks = loss_worlds(n)
    want = _jax_per_rank(n, lambda i, t, s, b: jloss.info_nce(i, t, s, axis_name="data", grad_through_gather=gtg,
                                                              chunk_size=chunk))
    _assert_rank_grads(ranks, f"info_nce_gtg{int(gtg)}_chunk{chunk}", want, with_bias=False)


@pytest.mark.parametrize("n", [2, 4], ids=["world2", "world4"])
def test_siglip_ring_matches_jax_ring(loss_worlds, n):
    ranks = loss_worlds(n)
    want = _jax_per_rank(n, lambda i, t, s, b: jloss.siglip_loss(i, t, s, b, axis_name="data"))
    _assert_rank_grads(ranks, "siglip", want, with_bias=True)
    if n == 4:  # on a ring of 2 the next rank is the previous one: the fault shows from 3 ranks
        _assert_rank_grads(ranks, "siglip_fault_backward_forward", want, with_bias=True, fails=True)


@pytest.fixture(scope="module")
def moments_world(tmp_path_factory):
    return run_world("moments", 2, tmp_path_factory.mktemp("moments"), LOSS_INPUTS)


def test_batch_moments_match_jax_axis_name(moments_world):
    """SyncBN's moments and their gradient (through the all-reduce, inside
    the graph) against JAX's ``batch_moments(x, axis_name)``; the all-reduce
    outside the graph keeps the forward and must fail the gradient."""
    p = LOSS_INPUTS
    n = len(moments_world)

    def local(x, c):
        def f(xs):
            mean, var = jres.batch_moments(xs, "data")
            return ((xs - mean) * jax.lax.rsqrt(var + 1e-5) * c).sum(), (mean, var)

        (_, (mean, var)), g = jax.value_and_grad(f, has_aux=True)(x)
        return mean, var, g

    mean, var, grad = jax.jit(jax.shard_map(local, mesh=_mesh(n), in_specs=(P("data"), P("data")),
                                            out_specs=(P(), P(), P("data")), check_vma=False))(
        jnp.asarray(p["x"]), jnp.asarray(p["c"]))
    b = p["x"].shape[0] // n
    for r, res in enumerate(moments_world):
        for name in ("right", "fault_detached"):
            np.testing.assert_allclose(res[name]["mean"], mean, **LOSS_TOL)
            np.testing.assert_allclose(res[name]["var"], var, **LOSS_TOL)
        np.testing.assert_allclose(res["right"]["grad"], grad[r * b:(r + 1) * b], **GRAD_TOL)
    assert not all(np.allclose(res["fault_detached"]["grad"], grad[r * b:(r + 1) * b], **GRAD_TOL)
                   for r, res in enumerate(moments_world))


# ---- the data-parallel step ------------------------------------------------------------------------


def _batch(seed, B=16, res=32, ctx=12):
    """tests/test_train_step.py's batch: uint8 images, eot (255) the max id."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, res, res, 3), dtype=np.uint8)
    texts = np.zeros((B, ctx), np.int32)
    texts[:, 0] = 254
    for i in range(B):
        k = 2 + i % 8
        texts[i, 1:k] = rng.integers(1, 250, k - 1)
        texts[i, k] = 255
    return {"images": images, "texts": texts}


def _perturb_bn(node, rng):
    """Every BN site of a JAX visual tree drawn from ``rng`` (the seed init's
    zero scales would leave the bottlenecks adding nothing)."""
    if isinstance(node, list):
        return [_perturb_bn(c, rng) for c in node]
    if isinstance(node, dict):
        if set(node) == {"scale", "bias", "mean", "var"}:
            c = node["scale"].shape[0]
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.normal(0, 0.1, c).astype(np.float32),
                    "mean": rng.normal(0, 0.2, c).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        return {k: _perturb_bn(v, rng) for k, v in node.items()}
    return node


# name -> (model, train, siglip, step kwargs, fused_block, fault); resnet cases use RN's batches
DP_CASES = {
    "info_nce_ema": dict(train=dict(ema_decay=0.9)),
    "grad_through_gather_chunked": dict(step=dict(grad_through_gather=True, chunk_size=4)),
    "siglip": dict(siglip=True, train=dict(loss="siglip")),
    "accum2": dict(step=dict(accum_steps=2)),
    "freeze_text": dict(train=dict(freeze="text")),
    "fused_mlp": dict(model=dict(WIDE, fused_mlp=True)),
    "fused_block": dict(model=WIDE, fused_block=True),
    "resnet_syncbn": dict(model=RN, train=dict(global_batch_size=8, ema_decay=0.9)),
}
DP_FAULTS = {  # a fault case runs its base case's inputs with the fault planted
    "fault_summed_gradients": ("info_nce_ema", "sum"),
    "fault_syncbn_detached": ("resnet_syncbn", "bn_detached"),
}
WORLD4 = ("grad_through_gather_chunked", "resnet_syncbn")


def _case_inputs(name):
    c = DP_CASES[name]
    model = c.get("model", SMALL)
    resnet = model is RN
    jc = jcfg.CLIPConfig(**model)
    if c.get("siglip"):
        jc = jc.for_siglip()
    train = {**TRAIN, **c.get("train", {})}
    init = jax.tree.map(np.array, jclip.init(jax.random.key(1), jc))
    if resnet:
        init["visual"] = _perturb_bn(init["visual"], np.random.default_rng(1))
        batches = [_batch(s, B=8, res=64) for s in (3, 4, 5)]
    else:
        batches = [_batch(s) for s in (3, 4, 5)]
    tc = tcfg.CLIPConfig(**model)
    if c.get("siglip"):
        tc = tc.for_siglip()
    sd = {k: v.clone() for k, v in load_jax_params(CLIP(tc, device="cpu"), init).state_dict().items()}
    return jc, init, batches, dict(model=model, train=train, siglip=c.get("siglip", False), step=c.get("step", {}),
                                   fused_block=c.get("fused_block", False), init=sd, batches=batches,
                                   total_steps=TOTAL_STEPS)


@pytest.fixture(scope="module")
def dp_inputs():
    return {name: _case_inputs(name) for name in DP_CASES}


@pytest.fixture(scope="module")
def dp_worlds(tmp_path_factory, dp_inputs):
    def start(n):
        payload = {name: dp_inputs[name][3] for name in (DP_CASES if n == 2 else WORLD4)}
        if n == 2:
            for name, (base, fault) in DP_FAULTS.items():
                payload[name] = dict(dp_inputs[base][3], fault=fault)
            payload["augment"] = dict(dp_inputs["info_nce_ema"][3], train=dict(TRAIN, augment=True),
                                      batches=[_batch(s, res=40) for s in (6, 7)])
        return run_world("dp_steps", n, tmp_path_factory.mktemp(f"dp{n}"), payload), payload

    return _lazy_worlds(start)


_JAX_RUNS = {}


def _jax_run(name, n, dp_inputs, monkeypatch):
    """(metrics, final params, EMA) of JAX's step on an n-device mesh."""
    if (name, n) in _JAX_RUNS:
        return _JAX_RUNS[name, n]
    jc, init, batches, case = dp_inputs[name]
    if case["fused_block"]:
        monkeypatch.setattr(jtowers, "mixer_tower", lambda params, x, **kw: jblock.mixer_tower_fused(params, x))
    mesh = _mesh(n)
    jt = jcfg.TrainConfig(**case["train"])
    opt = jax_make_optimizer(jt, total_steps=TOTAL_STEPS)
    state = replicate(mesh, jstep.init_train_state(jax.tree.map(jnp.asarray, init), opt))
    step = jstep.make_train_step(jc, jt, mesh, opt, **case["step"])
    metrics = []
    for b in batches:
        state, m = step(state, shard_batch(mesh, b))
        metrics.append(jax.device_get(m))
    ema = jstep.ema_params(state)
    _JAX_RUNS[name, n] = (metrics, jax.device_get(state.params), None if ema is None else jax.device_get(ema))
    return _JAX_RUNS[name, n]


# A token-mix output bias has an exact gradient of zero (its constant is
# taken out by the LayerNorm over the width that every consumer of the
# token mix applies; tests/test_torch_port_train_step.py::
# test_token_mix_output_bias_has_no_gradient): what both packages compute
# for it is rounding noise, which Adam scales up to steps of up to ~lr, and
# the noise differs with the batch split. Such a parameter is held to what
# three Adam steps can move it on either side, not to another run's noise.
NULL_GRAD_PARAMS = "token_mix_seq.lin2.bias"
NULL_GRAD_ATOL = 2 * 3 * TRAIN["learning_rate"]


def _tracks(jc, want, got):
    """Whether the port's run is within the JAX suite's tolerances of JAX's
    (a list of the failures)."""
    jm, jparams, jema = want
    bad = []
    for i, (j, t) in enumerate(zip(jm, got["metrics"])):
        if not np.isclose(t["loss"], float(j["loss"]), rtol=LOSS_RTOL, atol=0):
            bad.append(f"loss step {i}: {t['loss']} vs {float(j['loss'])}")
        if not np.isclose(t["grad_norm"], float(j["grad_norm"]), rtol=NORM_RTOL, atol=0):
            bad.append(f"grad_norm step {i}: {t['grad_norm']} vs {float(j['grad_norm'])}")
    for what, tree, port in (("params", jparams, got["state"]), ("ema", jema, got["ema"])):
        if tree is None:
            assert port is None
            continue
        want_sd = jax_params_to_state_dict(jax.tree.map(np.asarray, tree), jc)
        for k, w in want_sd.items():
            if k.endswith("num_batches_tracked"):  # torch counts the merges; the JAX export writes 0
                assert k not in port or int(port[k]) == len(jm), k
                continue
            atol = NULL_GRAD_ATOL if k.endswith(NULL_GRAD_PARAMS) else PARAM_ATOL
            if not np.allclose(port[k].numpy(), w.numpy(), atol=atol, rtol=0):
                bad.append(f"{what} {k}")
    return bad


def _dp_cases():
    return [(n, name) for n in (2, 4) for name in DP_CASES if n == 2 or name in WORLD4]


@pytest.mark.parametrize("n,name", _dp_cases(), ids=[f"world{n}-{c}" for n, c in _dp_cases()])
def test_dp_step_tracks_jax_mesh(dp_worlds, dp_inputs, monkeypatch, n, name):
    ranks, _ = dp_worlds(n)
    want = _jax_run(name, n, dp_inputs, monkeypatch)
    assert _tracks(dp_inputs[name][0], want, ranks[0][name]) == []
    assert len({r[name]["hash"] for r in ranks}) == 1, "the replicas drifted apart"
    assert len({r[name]["ema_hash"] for r in ranks}) == 1


@pytest.mark.parametrize("fault", sorted(DP_FAULTS))
def test_dp_planted_faults_fail(dp_worlds, dp_inputs, monkeypatch, fault):
    ranks, _ = dp_worlds(2)
    base = DP_FAULTS[fault][0]
    want = _jax_run(base, 2, dp_inputs, monkeypatch)
    assert _tracks(dp_inputs[base][0], want, ranks[0][fault]) != [], f"{fault} passed its bound"


def test_world2_crops_as_world1(dp_worlds):
    """With augmentation on, two ranks on one global batch crop exactly as
    one device does: the same losses, norms and parameters."""
    ranks, payload = dp_worlds(2)
    case = payload["augment"]
    cfg, tc = tcfg.CLIPConfig(**case["model"]), tcfg.TrainConfig(**case["train"])
    model = CLIP(cfg, device="cpu")
    model.load_state_dict(case["init"])
    opt = make_optimizer(tc, total_steps=TOTAL_STEPS)
    state, step = tstep.init_train_state(model, opt), tstep.make_train_step(cfg, tc, opt)
    for b, got in zip(case["batches"], ranks[0]["augment"]["metrics"]):
        state, m = step(state, b)
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=NORM_RTOL)
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(ranks[0]["augment"]["state"][k].numpy(), v.numpy(), atol=PARAM_ATOL, err_msg=k)
    assert ranks[0]["augment"]["hash"] == ranks[1]["augment"]["hash"]
