"""The port's FSDP layer against the JAX package's, on the CPU, after ``tests/test_fsdp.py``.

The port's ranks run in spawned worlds of 2 and 4 processes over gloo
(``tests/torch_port_worlds.py``); JAX runs in this process on a mesh of as
many of its virtual CPU devices. Weights move through ``models/convert.py``.

* The storage rule: ``fsdp_spec`` / ``_merged_spec`` are JAX's, and the
  shards each rank stores are the blocks JAX's specs give (the rank-0 block
  of each JAX leaf, moved into the port's layout), at a data axis of 4 and
  on a 2 x 2 (data, model) grid; the Adam moments are stored alike.
* The FSDP step, three steps: losses, gradient norms, final parameters
  (and EMA) against JAX's ``make_fsdp_train_step`` on the same mesh at the
  JAX suite's tolerances (loss rtol 2e-5, grad_norm rtol 2e-4, params atol
  5e-4), and against the port's data-parallel step with
  ``grad_through_gather=True`` in the same world; with GradCache, the
  transformer tower, SigLIP, the EMA, FSDP x TP, and a ResNet trunk (SyncBN
  moments, the running statistics merged after the step).
* The kernel routes under FSDP (their plain versions on CPU tensors): the
  ``fused_mlp`` and the fused-block routes' gradients come back
  reduce-scattered and match the plain route's.
* A world of one is bit for bit the single-device step on all three routes.
* A planted fault must fail its bound: the ``logit_scale`` gradient (a leaf
  outside FSDP) left unreduced.
* The trainer through ``train_cli --fsdp --tensor-parallel 2`` in a world of
  4: a crashed run resumes bit for bit; a restore into another layout is
  refused, naming both.
"""

import inspect

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.fsdp import fully_shard

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.parallel import fsdp as jfsdp
from clip_mixer_tpu.parallel import train_step as jstep
from clip_mixer_tpu.parallel.mesh import make_mesh, shard_batch
from clip_mixer_tpu.train.optimizer import make_optimizer as jax_make_optimizer

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
from clip_mixer_tpu_torch.parallel import fsdp as tfsdp
from clip_mixer_tpu_torch.parallel import train_step as tstep
from clip_mixer_tpu_torch.parallel.dist import maybe_initialize_distributed
from clip_mixer_tpu_torch.parallel.mesh import make_mesh as port_mesh
from clip_mixer_tpu_torch.parallel.tp import port_tp_dim
from clip_mixer_tpu_torch.train.optimizer import make_optimizer

from torch_port_worlds import run_world

LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 2e-5, 2e-4, 5e-4  # tests/test_fsdp.py:108-112
TOTAL_STEPS = 10
SMALL = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64, vision_patch_size=16,
             context_length=12, vocab_size=256, text_width=64, text_heads=1, text_layers=2, tower="mixer",
             compute_dtype="float32")
WIDE = dict(SMALL, vision_width=128, text_width=128)
TRANSFORMER = dict(SMALL, tower="transformer")
RN = dict(embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=8, vision_patch_size=None,
          context_length=12, vocab_size=256, text_width=64, text_heads=1, text_layers=1, tower="transformer",
          compute_dtype="float32")
TRAIN = dict(global_batch_size=16, learning_rate=1e-3, warmup_steps=2)
# the token-mix output bias has an exact gradient of zero: held to what
# three Adam steps can move it (tests/test_torch_port_parallel.py)
NULL_GRAD_PARAMS = "token_mix_seq.lin2.bias"
NULL_GRAD_ATOL = 2 * 3 * TRAIN["learning_rate"]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _batch(seed, B=16, res=32, ctx=12):
    """tests/test_fsdp.py's batch: uint8 images, eot (255) the max id."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, res, res, 3), dtype=np.uint8)
    texts = np.zeros((B, ctx), np.int32)
    texts[:, 0] = 254
    for i in range(B):
        texts[i, 1:4] = rng.integers(1, 250, 3)
        texts[i, 4] = 255
    return {"images": images, "texts": texts}


# ---- the storage rule ---------------------------------------------------------------------------------


def test_fsdp_spec_rules():
    """tests/test_fsdp.py::test_fsdp_spec_rules, on the port's copy."""
    assert tfsdp.fsdp_spec((12, 64, 256), 4) == (None, None, "data")
    assert tfsdp.fsdp_spec((12, 64, 250), 4) == (None, "data", None)
    assert tfsdp.fsdp_spec((12, 64), 4) == ()
    assert tfsdp.fsdp_spec((), 4) == ()
    assert tfsdp.fsdp_spec((4095, 3), 4) == ()


KEYS = [(), ("channel_mix", "w_in"), ("channel_mix", "b_in"), ("channel_mix", "w_out"), ("mlp", "w_in"),
        ("attn", "qkv_kernel"), ("attn", "out_kernel"), ("attn", "out_bias"), ("token_mix", "w_in")]
SHAPES = [(), (64,), (4096,), (3, 2048), (12, 64, 256), (12, 64, 250), (12, 256, 64), (2, 64, 192), (12, 3072),
          (7, 4096), (4095, 3)]


def test_specs_are_jax_specs():
    """``fsdp_spec`` and ``_merged_spec`` give JAX's specs on every shape,
    path and mesh tried (a ``PartitionSpec`` as a tuple)."""
    for shape in SHAPES:
        for n in (1, 2, 4, 3):
            assert tfsdp.fsdp_spec(shape, n) == tuple(jfsdp.fsdp_spec(shape, n)), (shape, n)
            for keys in KEYS:
                for m in (1, 2, 4):
                    got = tfsdp._merged_spec(shape, keys, n, m)
                    assert got == tuple(jfsdp._merged_spec(shape, keys, n, m)), (shape, keys, n, m)


def _rank0_blocks(cfg_kw, n_data, n_model):
    """The shape of rank 0's block of each port parameter under JAX's FSDP
    (x TP) storage specs: each JAX leaf's rank-0 block marked, the mask
    moved into the port's layout by ``jax_params_to_state_dict``, its
    bounding box read."""
    jc = jcfg.CLIPConfig(**cfg_kw)
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(0), jc))

    def mask(path, leaf):
        keys = [getattr(p, "key", None) for p in path]
        spec = jfsdp._merged_spec(leaf.shape, keys, n_data, n_model)
        m = np.zeros(leaf.shape, np.float32)
        idx = [slice(None)] * leaf.ndim
        for ax, name in enumerate(spec):
            if name is not None:
                idx[ax] = slice(0, leaf.shape[ax] // (n_data if name == "data" else n_model))
        m[tuple(idx)] = 1.0
        return m

    masks = jax_params_to_state_dict(jax.tree_util.tree_map_with_path(mask, params), jc)
    out = {}
    for k, m in masks.items():
        nz = torch.nonzero(m)
        out[k] = tuple(int(nz[:, d].max()) + 1 for d in range(m.ndim)) if m.ndim else ()
    return out


# ---- the worlds -----------------------------------------------------------------------------------------

CASES = {  # name -> (world, model, n_model, fsdp, train, step kwargs, siglip)
    "mixer": (4, SMALL, 1, True, {}, {}, False),
    "mixer_dp_gtg": (4, SMALL, 1, False, {}, dict(grad_through_gather=True), False),
    "siglip_accum2": (4, SMALL, 1, True, dict(loss="siglip"), dict(accum_steps=2), True),
    "siglip_dp_gtg": (4, SMALL, 1, False, dict(loss="siglip"), dict(grad_through_gather=True), True),
    "fsdp_tp": (4, SMALL, 2, True, {}, {}, False),
    "fsdp_tp_transformer_accum2": (4, dict(WIDE, tower="transformer", text_heads=2), 2, True, {},
                                   dict(accum_steps=2), False),
    "accum2": (2, SMALL, 1, True, {}, dict(accum_steps=2), False),
    "transformer": (2, TRANSFORMER, 1, True, {}, {}, False),
    "ema": (2, SMALL, 1, True, dict(ema_decay=0.9), {}, False),
    "ema_dp_gtg": (2, SMALL, 1, False, dict(ema_decay=0.9), dict(grad_through_gather=True), False),
    "resnet_bn": (2, RN, 1, True, dict(global_batch_size=8, ema_decay=0.9), {}, False),
}
FAULTS = {"fault_logit_scale_unreduced": ("ema", "logit_scale_unreduced")}
ROUTES = ("plain", "fused_mlp", "fused_block")  # world 2, WIDE, one step each, gradients kept


def _perturb_bn(node, rng):
    """Every BN site of a JAX visual tree drawn from ``rng`` (the seed init's
    zero scales would leave the bottlenecks adding nothing), as
    tests/test_torch_port_parallel.py draws them."""
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


def _init(model_kw, siglip, seed=1):
    jc = jcfg.CLIPConfig(**model_kw)
    if siglip:
        jc = jc.for_siglip()
    tc = tcfg.CLIPConfig(**model_kw)
    if siglip:
        tc = tc.for_siglip()
    init = jax.tree.map(np.array, jclip.init(jax.random.key(seed), jc))
    if jc.is_resnet:
        init["visual"] = _perturb_bn(init["visual"], np.random.default_rng(seed))
    sd = {k: v.clone() for k, v in load_jax_params(CLIP(tc, device="cpu"), init).state_dict().items()}
    return jc, init, sd


@pytest.fixture(scope="module")
def inputs():
    out = {}
    for name, (n, model, n_model, fsdp, train, step, siglip) in CASES.items():
        jc, init, sd = _init(model, siglip)
        batches = [_batch(s, B=8, res=64) if model is RN else _batch(s) for s in (3, 4, 5)]
        out[name] = (jc, init, dict(model=model, train={**TRAIN, **train}, siglip=siglip, n_model=n_model,
                                    fsdp=fsdp, step=step, init=sd, batches=batches, total_steps=TOTAL_STEPS))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, inputs):
    done = {}

    def get(n):
        if n not in done:
            payload = {name: inputs[name][2] for name, c in CASES.items() if c[0] == n}
            if n == 2:
                for name, (base, fault) in FAULTS.items():
                    payload[name] = dict(inputs[base][2], fault=fault)
                _, _, sd = _init(WIDE, False)
                for route in ROUTES:
                    payload[f"route_{route}"] = dict(model=dict(WIDE, fused_mlp=route == "fused_mlp"), train=TRAIN,
                                                     fsdp=True, fused_block=route == "fused_block", init=sd,
                                                     batches=[_batch(6)], total_steps=TOTAL_STEPS, grads=True)
            done[n] = run_world("sharded_steps", n, tmp_path_factory.mktemp(f"fsdp{n}"), payload)
        return done[n]

    return get


_JAX = {}


def _jax_fsdp(name, inputs):
    """(metrics, final params, EMA) of JAX's FSDP step on the case's mesh."""
    if name not in _JAX:
        jc, init, case = inputs[name]
        n, n_model = CASES[name][0], case["n_model"]
        mesh = make_mesh(n_data=n // n_model, n_model=n_model, devices=jax.devices()[:n])
        jt = jcfg.TrainConfig(**case["train"])
        opt = jax_make_optimizer(jt, total_steps=TOTAL_STEPS)
        state = jfsdp.shard_state(mesh, jstep.init_train_state(jax.tree.map(jnp.asarray, init), opt))
        step = jfsdp.make_fsdp_train_step(jc, jt, mesh, opt, state, **case["step"])
        metrics = []
        for b in case["batches"]:
            state, m = step(state, shard_batch(mesh, b))
            metrics.append(jax.device_get(m))
        ema = jstep.ema_params(state)
        _JAX[name] = (metrics, jax.device_get(state.params), None if ema is None else jax.device_get(ema))
    return _JAX[name]


def _tracks(jc, want, got):
    """The failures of the port's run against JAX's at the JAX suite's tolerances."""
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
        for k, w in jax_params_to_state_dict(jax.tree.map(np.asarray, tree), jc).items():
            if k.endswith("num_batches_tracked"):  # torch counts the merges; the JAX export writes 0
                continue
            atol = NULL_GRAD_ATOL if k.endswith(NULL_GRAD_PARAMS) else PARAM_ATOL
            if not np.allclose(port[k].numpy(), w.numpy(), atol=atol, rtol=0):
                bad.append(f"{what} {k}: max {float((port[k] - w).abs().max())}")
    return bad


def _tracks_port(got, want):
    """The failures of one port run against another (the DP step)."""
    bad = []
    for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        if not np.isclose(a["loss"], b["loss"], rtol=LOSS_RTOL, atol=0):
            bad.append(f"loss step {i}")
        if not np.isclose(a["grad_norm"], b["grad_norm"], rtol=NORM_RTOL, atol=0):
            bad.append(f"grad_norm step {i}")
    for k, w in want["state"].items():
        atol = NULL_GRAD_ATOL if k.endswith(NULL_GRAD_PARAMS) else PARAM_ATOL
        if not np.allclose(got["state"][k].numpy(), w.numpy(), atol=atol, rtol=0):
            bad.append(k)
    return bad


FSDP_CASES = [name for name, c in CASES.items() if c[3]]
DP_OF = {"mixer": "mixer_dp_gtg", "siglip_accum2": "siglip_dp_gtg", "fsdp_tp": "mixer_dp_gtg", "ema": "ema_dp_gtg"}


@pytest.mark.parametrize("name", FSDP_CASES, ids=[f"world{CASES[c][0]}-{c}" for c in FSDP_CASES])
def test_fsdp_step_tracks_jax_fsdp_step(worlds, inputs, name):
    ranks = worlds(CASES[name][0])
    assert _tracks(inputs[name][0], _jax_fsdp(name, inputs), ranks[0][name]) == []
    assert len({r[name]["hash"] for r in ranks}) == 1, "the ranks' gathered states differ"
    assert len({r[name]["ema_hash"] for r in ranks}) == 1
    if name in DP_OF:  # and the port's data-parallel step with grad_through_gather, in the same world
        assert _tracks_port(ranks[0][name], ranks[0][DP_OF[name]]) == []


@pytest.mark.parametrize("world,n_model", [(4, 1), (4, 2)], ids=["data4", "data2_model2"])
def test_stored_shards_are_jax_blocks(worlds, world, n_model):
    """Rank 0 stores, for every parameter, the block JAX's spec gives its
    device, in the port's layout; its Adam moments have the same shape.
    Under TP the small hidden leaves are the stated deviation: JAX's storage
    leaves them whole, the port's split compute needs them sliced."""
    name = "mixer" if n_model == 1 else "fsdp_tp"
    got = worlds(world)[0][name]
    want = _rank0_blocks(SMALL, world // n_model, n_model)
    whole = {k: tuple(v.shape) for k, v in CLIP(tcfg.CLIPConfig(**SMALL), device="cpu").named_parameters()}
    deviations = []
    for k, shape in got["shapes"].items():
        w, d = want[k], port_tp_dim(k) if n_model > 1 else None
        if d is not None and w[d] == whole[k][d]:  # JAX's storage leaves it whole on the model axis
            deviations.append(k)
            w = tuple(s // n_model if i == d else s for i, s in enumerate(w))
        assert shape == w, (k, shape, w)
        if k in got["moment_shapes"]:
            assert got["moment_shapes"][k] == shape, k
    assert sorted(deviations) == ([] if n_model == 1 else sorted(
        f"{t}.mixBlocks.{i}.channel_mix_seq.lin3.bias" for t in ("visual.transformer", "transformer") for i in (0, 1)))
    w_in = "visual.transformer.mixBlocks.0.channel_mix_seq.lin3.weight"
    assert np.prod(got["shapes"][w_in]) * world == np.prod(whole[w_in])  # 1/(n_data n_model) of it
    # a sharded leaf is a DTensor shard, on the dim the rule picked
    assert got["fsdp_dims"]["visual.transformer.mixBlocks.0.channel_mix_seq.lin3.weight"] == (0 if n_model == 1
                                                                                              else 1)


def test_planted_fault_logit_scale_unreduced_fails(worlds, inputs):
    """``logit_scale`` lives outside FSDP: leaving its gradient unreduced
    must fail the bound against JAX."""
    got = worlds(2)[0]["fault_logit_scale_unreduced"]
    assert _tracks(inputs["ema"][0], _jax_fsdp("ema", inputs), got) != [], "the planted fault passed"


def test_kernel_routes_under_fsdp_match_the_plain_route(worlds):
    """The fused_mlp and fused-block routes under FSDP (their wrappers'
    plain versions on CPU tensors): every block's gradient comes back
    reduce-scattered (a DTensor shard), and every rank's gradients and the
    loss match the plain route's."""
    for rank, res in enumerate(worlds(2)):
        plain = res["route_plain"]
        for route in ("fused_mlp", "fused_block"):
            got = res[f"route_{route}"]
            np.testing.assert_allclose(got["metrics"][0]["loss"], plain["metrics"][0]["loss"], rtol=1e-6)
            block_params = [k for k in got["grads"] if ".mixBlocks." in k and "lin3.weight" in k]
            assert block_params and all(got["grad_kinds"][k] == "DTensor" for k in block_params), route
            for k, g in plain["grads"].items():
                # a token-mix output bias's exact gradient is zero: both hold rounding noise
                atol = 1e-5 if k.endswith(NULL_GRAD_PARAMS) else 1e-6
                torch.testing.assert_close(got["grads"][k], g, rtol=1e-4, atol=atol, msg=f"{route} rank {rank} {k}")


# ---- a world of one, in this process ---------------------------------------------------------------


@pytest.fixture
def world1(tmp_path, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize_distributed("cpu", coordinator=f"file://{tmp_path / 'store'}", num_processes=1,
                                        process_id=0, timeout_s=30)
    yield port_mesh(device="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("route", ROUTES)
def test_world_of_one_is_the_single_device_step_bit_for_bit(world1, route):
    """FSDP over a data group of one, on each route: every loss, and every
    parameter, Adam moment and EMA entry after three steps, bit for bit the
    single-device step's (``chip_smoke.py`` phase 13a holds this on the card)."""
    cfg = tcfg.CLIPConfig(**WIDE, fused_mlp=route == "fused_mlp")
    tc = tcfg.TrainConfig(**TRAIN, ema_decay=0.9)
    runs = {}
    for name in ("single", "fsdp"):
        model = CLIP(cfg, device="cpu")
        if route == "fused_block":
            route_towers(model, True)
        opt = make_optimizer(tc, TOTAL_STEPS)
        if name == "fsdp":
            tfsdp.apply_fsdp(model, world1)
            step = tfsdp.make_fsdp_train_step(cfg, tc, opt, world1)
        else:
            step = tstep.make_train_step(cfg, tc, opt, grad_through_gather=True)
        state = tstep.init_train_state(model, opt)
        losses = [step(state, _batch(s))[1]["loss"] for s in (3, 4, 5)]
        runs[name] = (losses, tfsdp.gather_full(model), state.opt_state)
    (la, pa, oa), (lb, pb, ob) = runs["single"], runs["fsdp"]
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for what, a, b in (("params", pa, pb), ("mu", oa.mu, ob.mu), ("nu", oa.nu, ob.nu), ("ema", oa.ema, ob.ema)):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), what
    assert {"shard_placement_fn", "ignored_params"} <= set(inspect.signature(fully_shard).parameters)


def test_route_after_fsdp_and_fsdp_without_a_mesh_are_refused(world1, tmp_path):
    model = tfsdp.apply_fsdp(CLIP(tcfg.CLIPConfig(**WIDE), device="cpu"), world1)
    with pytest.raises(ValueError, match="before parallel/fsdp.py::apply_fsdp"):
        route_towers(model, True)
    step = tfsdp.make_fsdp_train_step(model.cfg, tcfg.TrainConfig(**TRAIN), make_optimizer(tcfg.TrainConfig(**TRAIN), 2),
                                      world1)
    plain = CLIP(tcfg.CLIPConfig(**WIDE), device="cpu")
    with pytest.raises(ValueError, match="apply_fsdp"):
        step(tstep.init_train_state(plain, make_optimizer(tcfg.TrainConfig(**TRAIN), 2)), _batch(3))


# ---- the trainer and the CLI ---------------------------------------------------------------------------

CLI_ARGV = ["--synthetic", "--preset", "mixer-debug", "--global-batch-size", "8", "--steps-per-epoch", "4",
            "--epochs", "1", "--checkpoint-every", "2", "--no-validators", "--device", "cpu", "--ema-decay", "0.9"]


def test_trainer_fsdp_tp_resumes_bit_for_bit_and_refuses_another_layout(tmp_path):
    """``train_cli --fsdp --tensor-parallel 2`` in a world of 4 (data 2 x
    model 2): every rank writes its shard of each checkpoint; a run crashed
    by the drill after its save at step 2 resumes, and its last checkpoint
    (every rank's shard) and export are bit for bit the straight run's; the
    export holds the whole parameters. A restore of that checkpoint with
    FSDP off is refused, naming both layouts; that layout (tensor
    parallelism alone) trains, saves its shards and exports whole."""
    ranks = run_world("sharded_trainer", 4, tmp_path, dict(argv=CLI_ARGV, flags=["--fsdp", "--tensor-parallel", "2"],
                                                          other_flags=["--tensor-parallel", "2"], crash=2))
    for r in ranks:
        assert r["after_crash"] == ["2"]
        assert r["checkpoints"] == {"straight": ["2", "4"], "resumed": ["2", "4"]}
        assert r["files"] == ["layout.json", "meta.json", "shard-0.pt", "shard-1.pt", "shard-2.pt", "shard-3.pt"]
        assert r["shard_steps"] == [4, 4]
        assert r["shard_hashes"][0] == r["shard_hashes"][1], "the resumed shard differs from the straight one"
        assert r["export_hashes"][0] == r["export_hashes"][1]
        assert "FSDP-sharded" in r["refusal"] and "not FSDP-sharded" in r["refusal"], r["refusal"]
    assert len({r["shard_hashes"][0] for r in ranks}) == 4  # four different shards
    whole = {k: tuple(v.shape) for k, v in CLIP(tcfg.PRESETS["mixer-debug"], device="cpu").state_dict().items()}
    assert ranks[0]["export_shapes"] == whole and ranks[0]["other_export_shapes"] == whole
    assert ranks[0]["other_files"] == ranks[0]["files"]
