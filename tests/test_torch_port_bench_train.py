"""The port's card-side measuring scripts (``scripts/torch_bench_loss.py``,
``torch_bench_remat_policy.py``, ``torch_bench_rn_accum.py``,
``torch_profile_mixer.py``) against the JAX package on the CPU: each
function a script times computes what the JAX script's timed function
computes, on the same inputs made from numpy seeds and the same weights
(a JAX init carried across with ``load_jax_params``).

Bounds, the JAX suite's and the port's existing ones:

* losses in f32 at 1e-5 relative (``LOSS_RTOL``), the global gradient
  norm at 2e-4 (``tests/test_train_step.py``'s), each remat policy's
  gradients equal to no remat at 1e-6 (``tests/test_torch_port_remat.py``);
* the ablated encoders in f32 at atol 5e-5 / rtol 1e-3
  (``tests/test_torch_port_model.py``'s feature bound);
* RN bf16 and int8 features per-row cosine >= 0.999 (the port's bf16
  bound in ``tests/test_torch_port_resnet_quant.py``).

The JAX scripts that call ``jax.config.update`` at import are not
imported: where their computation is a closure inside ``main``
(``scripts/profile_mixer.py:67-88``), it is written out here in JAX from
those lines. Each script's ``main`` also runs at ``mixer-debug`` size on
the CPU and prints the JAX script's keys plus ``power_limit``.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.models.layers import layer_norm as jlayer_norm
from clip_mixer_tpu.models.layers import quick_gelu as jquick_gelu
from clip_mixer_tpu.models.mixer import token_mix as jtoken_mix
from clip_mixer_tpu.models.towers import patchify as jpatchify
from clip_mixer_tpu.ops import losses as jlosses
from clip_mixer_tpu.ops import quant as jq
from clip_mixer_tpu.ops.preprocess import make_batch_preprocess as jax_preprocess
from clip_mixer_tpu.parallel import train_step as jstep
from clip_mixer_tpu.train.optimizer import make_optimizer as jax_optimizer

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.device import compute_dtype
from clip_mixer_tpu_torch.models import clip as tclip
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import load_jax_params
from clip_mixer_tpu_torch.ops.losses import info_nce
from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess, normalize_images
from clip_mixer_tpu_torch.parallel import train_step as tstep
from clip_mixer_tpu_torch.train.optimizer import make_optimizer
from clip_mixer_tpu_torch.utils import profiling
from torch_port_worlds import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
bench_loss = importlib.import_module("torch_bench_loss")
bench_remat = importlib.import_module("torch_bench_remat_policy")
bench_rn = importlib.import_module("torch_bench_rn_accum")
profile = importlib.import_module("torch_profile_mixer")

LOSS_RTOL = 1e-5
NORM_RTOL = 2e-4  # tests/test_train_step.py:91-100
GRAD_TOL = dict(atol=1e-6, rtol=1e-6)  # tests/test_torch_port_remat.py
FEATURE_TOL = dict(atol=5e-5, rtol=1e-3)  # tests/test_torch_port_model.py
BF16_COSINE = 0.999  # tests/test_torch_port_resnet_quant.py
DEBUG = dict(compute_dtype="float32")  # mixer-debug (vocab 49408: the scripts' token ids), in f32
RN = dict(embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=16, vision_patch_size=None,
          context_length=12, vocab_size=256, text_width=64, text_heads=1, text_layers=1, tower="transformer")
B = 4
IN_HW = (256, 256)  # the scripts' uint8 input


def _debug(presets, **kw):
    return presets["mixer-debug"].replace(**DEBUG, **kw)


def _jax_init(jc, seed):
    """A JAX param tree of ``jc``'s structure, its leaves drawn with numpy
    (fan-in scaled normals; norm scales and BN variances 1, BN means 0),
    as ``tests/test_torch_port_big_presets.py`` draws one: the shapes from
    ``jax.eval_shape`` of the JAX init, which takes seconds compiled and
    more eagerly."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path).rsplit("[", 1)[-1].strip("]'")
        if name == "logit_scale":
            return np.asarray(np.log(1 / 0.07), np.float32)
        if name == "logit_bias":
            return np.asarray(-10.0, np.float32)
        if name in ("scale", "var"):
            return np.ones(leaf.shape, np.float32)
        if name == "mean":
            return np.zeros(leaf.shape, np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 2500
        std = 0.02 if name in ("token_embedding", "pos_embedding") else fan_in ** -0.5
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(lambda k: jclip.init(k, jc), jax.random.key(0)))


def _pair(kw=None, seed=0):
    """(JAX config, JAX params, the port model on those weights), mixer-debug in f32."""
    jc = _debug(jcfg.PRESETS, **(kw or {}))
    params = jax.tree.map(np.asarray, _jax_init(jc, seed))
    return jc, params, load_jax_params(CLIP(_debug(tcfg.PRESETS, **(kw or {})), device="cpu"), params)


def _inputs(cfg):
    """The scripts' own batch (``torch_bench_loss.bench_inputs``): torch and JAX views."""
    imgs, toks = bench_loss.bench_inputs(B, cfg.context_length, "cpu")
    return (imgs, toks), (jnp.asarray(imgs.numpy()), jnp.asarray(toks.numpy()))


def _jax_pre(jc):
    return jax_preprocess(IN_HW, jc.image_resolution, normalize=True, dtype=jnp.float32)


def _port_pre(cfg):
    return make_batch_preprocess(IN_HW, cfg.image_resolution, normalize=True, dtype=torch.float32)


def _global_norm(tensors):
    return float(np.sqrt(sum(float(np.sum(np.asarray(t, np.float64) ** 2)) for t in tensors)))


def _port_grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def test_bench_inputs_are_jax_scripts():
    """The JAX scripts' batch (bench_loss.py:76-82): uint8 images, then the
    token rows from the same numpy seed."""
    imgs, toks = bench_loss.bench_inputs(3, 77, "cpu")
    rng = np.random.default_rng(0)
    want_imgs = rng.integers(0, 256, (3, 256, 256, 3), dtype=np.uint8)
    want = np.zeros((3, 77), np.int32)
    want[:, 0] = 49406
    want[:, 1:8] = rng.integers(1, 49000, (3, 7))
    want[:, 8] = 49407
    assert np.array_equal(imgs.numpy(), want_imgs) and np.array_equal(toks.numpy(), want)


@pytest.mark.parametrize("kind", ["info_nce", "siglip"])
def test_loss_and_grads_with_resize_match_jax(kind):
    """bench_loss.py:89-95: the loss of the forward on the resized batch,
    remat on, SigLIP with its -10 bias, and its gradients."""
    cfg_kw = {"remat": True, "logit_bias_init": -10.0 if kind == "siglip" else None}
    jc, params, model = _pair(cfg_kw)
    assert model.cfg == bench_loss.loss_config(_debug(tcfg.PRESETS), kind)
    (imgs, toks), (jimgs, jtoks) = _inputs(model.cfg)
    pre = _jax_pre(jc)
    jc = jc.replace(remat=False)  # the same values in JAX (its remat tests), compiled faster

    def loss_fn(pp):
        img, txt, scale = jclip.forward(pp, jc, pre(jimgs), jtoks)
        return jlosses.contrastive_loss(kind, img, txt, scale, logit_bias=pp.get("logit_bias"))

    want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    got = bench_loss.make_loss_and_grads(kind, _port_pre(model.cfg))(model, imgs, toks)
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)
    grads = _port_grads(model)  # JAX stacks the blocks' leaves: the norms compare
    assert _global_norm(grads.values()) == pytest.approx(_global_norm(jax.tree.leaves(jgrads)), rel=NORM_RTOL)
    if kind == "siglip":
        assert float(grads["logit_bias"]) == pytest.approx(float(jgrads["logit_bias"]), rel=NORM_RTOL)


@pytest.fixture(scope="module")
def remat_case():
    """JAX's plain InfoNCE loss on the resized batch
    (bench_remat_policy.py:85-89), and the port's no-remat gradients."""
    jc, params, model = _pair()
    (imgs, toks), (jimgs, jtoks) = _inputs(model.cfg)
    pre = _jax_pre(jc)
    want = float(jax.jit(lambda p: jlosses.info_nce(*jclip.forward(p, jc, pre(jimgs), jtoks)))(params))
    bench_remat.make_loss_and_grads(_port_pre(model.cfg), 1, B)(model, imgs, toks)
    return params, want, _port_grads(model)


@pytest.mark.parametrize("policy", ["none", "mlp_hidden", "all_hidden"])
def test_remat_policy_loss_is_jax_and_grads_equal_no_remat(policy, remat_case):
    params, want, no_remat = remat_case
    model = load_jax_params(CLIP(_debug(tcfg.PRESETS, remat=True, remat_policy=policy), device="cpu"), params)
    imgs, toks = _inputs(model.cfg)[0]
    got = bench_remat.make_loss_and_grads(_port_pre(model.cfg), 1, B)(model, imgs, toks)
    assert float(got) == pytest.approx(want, rel=LOSS_RTOL)
    grads = _port_grads(model)
    assert list(grads) == list(no_remat)
    for name, g in grads.items():
        torch.testing.assert_close(g, no_remat[name], msg=name, **GRAD_TOL)


def test_remat_accum2_is_jax_two_pass():
    """``--accum 2``: the two-pass GradCache over ``forward_train``, against
    JAX's ``two_pass_accum_grads`` with bench_remat_policy.py:74-84's
    ``micro_feats`` and ``feat_loss``."""
    jc, params, model = _pair({"remat": True})
    (imgs, toks), (jimgs, jtoks) = _inputs(model.cfg)
    pre = _jax_pre(jc)
    jc = jc.replace(remat=False)  # the same values in JAX, compiled faster

    def micro_feats(pp, im_u8, tx):
        img, txt, _s, _bn = jclip.forward_train(pp, jc, pre(im_u8), tx)
        return img, txt

    def feat_loss(fi, ft, loss_params):
        return jlosses.info_nce(fi.reshape(B, -1), ft.reshape(B, -1), jnp.exp(loss_params["logit_scale"]))

    want, jgrads = jax.jit(lambda p: jstep.two_pass_accum_grads(p, 2, jstep.flat_chunker(jimgs, jtoks, 2), micro_feats,
                                                                feat_loss))(params)
    got = bench_remat.make_loss_and_grads(_port_pre(model.cfg), 2, B)(model, imgs, toks)
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)
    assert _global_norm(_port_grads(model).values()) == pytest.approx(_global_norm(jax.tree.leaves(jgrads)),
                                                                      rel=NORM_RTOL)


def test_accum_mode_first_loss_is_jax_train_step(monkeypatch):
    """The ``accum`` mode's step (``make_train_step(accum_steps=2)`` at
    batch 8, remat on) on JAX's weights: its first loss is JAX's
    ``make_train_step`` on the batch the script draws."""
    jc, params, _ = _pair({"remat": True}, seed=1)
    losses = []
    make = tstep.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics
        return run

    real_clip = tclip.CLIP
    monkeypatch.setattr(tstep, "make_train_step", recording)
    monkeypatch.setattr(tclip, "CLIP", lambda cfg, device=None, generator=None: load_jax_params(
        real_clip(cfg, device=device), params))
    out = bench_rn.bench_accum(torch.device("cpu"), _debug(tcfg.PRESETS), configs=((2, 8),), chain=(1, 2))
    assert len(losses) == 1 + 1 + 2 and out["accum2_batch8"]["loss"] == round(losses[-1], 4)

    tc = jcfg.TrainConfig()
    opt = jax_optimizer(tc, total_steps=1000)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1), ("data",))
    step = jstep.make_train_step(jc.replace(remat=False), tc, mesh, opt, accum_steps=2)  # remat moves no value
    batch = bench_rn.accum_batch(np.random.default_rng(0), jc, 8, "cpu")
    _, metrics = step(jstep.init_train_state(params, opt), {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert losses[0] == pytest.approx(float(metrics["loss"]), rel=LOSS_RTOL)


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_rn_bf16_and_int8_features_match_jax():
    """The ``rn`` mode's encoders on a small ResNet in bf16 (one block a
    stage, width 16, 64 px from 256 px uint8): the float tower through the
    bf16 front end, and the int8 tower calibrated on the batch's first
    images, each against JAX's (bench_rn_accum.py:48-71)."""
    jc = jcfg.CLIPConfig(**RN, compute_dtype="bfloat16")
    params = jax.tree.map(np.asarray, _jax_init(jc, 3))
    model = load_jax_params(CLIP(tcfg.CLIPConfig(**RN, compute_dtype="bfloat16"), device="cpu"), params).eval()
    u8 = np.random.default_rng(0).integers(0, 256, (6, 256, 256, 3), dtype=np.uint8)
    jpre = jax_preprocess(IN_HW, 64, normalize=True, dtype=jnp.bfloat16)

    @jax.jit
    def jax_features(p, u):
        qp = jq.quantize_resnet_tower(p, jc, jq.calibrate_resnet_tower(p, jc, jpre(u[:4])))
        return jclip.encode_image(p, jc, jpre(u)), jq.encode_image_rn_q(qp, jc, jpre(u))

    want_bf, want_q = (np.asarray(f, np.float32) for f in jax_features(params, u8))

    pre = make_batch_preprocess(IN_HW, 64, normalize=True, dtype=torch.bfloat16)
    bf16, int8 = bench_rn.rn_encoders(model, pre, torch.from_numpy(u8[:4]))
    with torch.no_grad():
        got_bf = bf16(torch.from_numpy(u8)).float().numpy()
        got_q = int8(torch.from_numpy(u8)).float().numpy()
    assert _cosine(got_bf, want_bf).min() >= BF16_COSINE
    assert _cosine(got_q, want_q).min() >= BF16_COSINE
    assert bench_rn.row_cosine_min(got_bf, got_q) == pytest.approx(float(_cosine(got_bf, got_q).min()), rel=1e-6)


def _jax_encode_ablated(p, cfg, x, ablate):
    """scripts/profile_mixer.py:67-88, on preprocessed images ``x``."""
    dt = jnp.dtype(cfg.compute_dtype)
    v = p["visual"]
    x = jpatchify(x.astype(dt), cfg.vision_patch_size)
    x = x @ v["patch_embed"]["kernel"].astype(dt)
    cls = jnp.broadcast_to(v["class_embedding"].astype(dt), (x.shape[0], 1, x.shape[-1]))
    x = jnp.concatenate([cls, x], axis=1)
    x = jlayer_norm(v["ln_pre"], x)

    def step(h, lp):
        if ablate != "token":
            h = h + jtoken_mix(lp, h)
        if ablate != "channel":
            y = jlayer_norm(lp["ln_channel"], h)
            cm = lp["channel_mix"]
            hid = jquick_gelu(y @ cm["w_in"].astype(dt) + cm["b_in"].astype(dt))
            h = h + hid @ cm["w_out"].astype(dt) + cm["b_out"].astype(dt)
        return h, None

    x, _ = jax.lax.scan(step, x, v["tower"]["blocks"])
    x = jlayer_norm(v["ln_post"], x[:, 0, :])
    return x @ v["proj"].astype(dt)


@pytest.fixture(scope="module")
def ablation_case():
    """JAX's three ablated encoders on one uint8 batch, in one program."""
    jc, params, model = _pair(seed=2)
    u8 = np.random.default_rng(4).integers(0, 256, (B, 256, 256, 3), dtype=np.uint8)
    want = jax.jit(lambda p, u: {a: _jax_encode_ablated(p, jc, _jax_pre(jc)(u), a) for a in profile.ABLATIONS})(
        params, u8)
    return model, _port_pre(model.cfg)(torch.from_numpy(u8)), {a: np.asarray(w) for a, w in want.items()}


@pytest.mark.parametrize("ablate", profile.ABLATIONS)
def test_ablated_encoder_matches_jax(ablate, ablation_case):
    model, x, want = ablation_case
    with torch.no_grad():
        got = profile.encode_ablated(model.visual, x, ablate).numpy()
        if ablate == "none":  # the mirror is the model's own encoder
            np.testing.assert_allclose(got, model.encode_image(x).numpy(), **FEATURE_TOL)
    np.testing.assert_allclose(got, want[ablate], **FEATURE_TOL)


def test_mirror_is_the_models_encoder_in_bf16():
    """In bf16 over 12 blocks the mirror is ``encode_image`` bit for bit:
    it adds each block's channel-mix residual last, as the model's chain
    does (grouped the other way it drifts by 0.047 here, as on the card,
    past the script's 2e-2 check)."""
    cfg = tcfg.PRESETS["mixer-debug"].replace(compute_dtype="bfloat16", vision_layers=12)
    model = CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    u8 = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, 256, 256, 3), dtype=np.uint8))
    x = make_batch_preprocess(IN_HW, cfg.image_resolution, normalize=True, dtype=torch.bfloat16)(u8)
    with torch.no_grad():
        assert torch.equal(profile.encode_ablated(model.visual, x, "none"), model.encode_image(x))


def test_update_step_is_the_train_steps_update():
    """``utils/profiling.update_step`` (the JAX chain's body: gradients,
    the update, the clamp) on ``make_train_step``'s own loss trains the
    weights as ``make_train_step`` does, bit for bit."""
    cfg = tcfg.PRESETS["mixer-debug"]
    tc = tcfg.TrainConfig(learning_rate=1e-3, warmup_steps=1)
    imgs, toks = bench_loss.bench_inputs(B, cfg.context_length, "cpu")
    imgs = imgs[:, :32, :32]
    models = [CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(5)) for _ in range(2)]

    def loss_and_grads(model, im, tx):
        loss = info_nce(*model(normalize_images(im, compute_dtype(cfg.compute_dtype)), tx))
        loss.backward()
        return loss

    opts = [make_optimizer(tc, 100) for _ in models]
    states = [tstep.init_train_state(m, o) for m, o in zip(models, opts)]
    ours = profiling.update_step(opts[0], tc.logit_scale_max, loss_and_grads)
    theirs = tstep.make_train_step(cfg, tc, opts[1])
    for _ in range(2):
        _, m0 = ours(states[0], (imgs, toks))
        _, m1 = theirs(states[1], {"images": imgs, "texts": toks})
        assert torch.equal(m0["loss"], m1["loss"])
    assert states[0].step == states[1].step == 2
    for (n, a), b in zip(models[0].named_parameters(), models[1].parameters()):
        assert torch.equal(a, b), n


def test_chained_calls_consume_the_previous_result():
    seen = []

    def fn(u8):
        seen.append(u8.clone())
        return u8.float() + 1.0

    u8 = torch.randint(0, 256, (2, 4, 4, 3), dtype=torch.uint8)
    carry = profiling.chained(fn, u8)(3)
    assert len(seen) == 3 and all(torch.equal(s, u8) for s in seen)  # the carry adds a zero
    assert carry.ndim == 0 and 0 < float(carry) < 1e-6


def _main_keys(capsys):
    import json

    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def test_loss_main_prints_jax_keys(capsys):
    out = bench_loss.main(["--preset", "mixer-debug", "--batch", "4", "--device", "cpu"], chain=(1, 2))
    lines = _main_keys(capsys)
    assert [list(x) for x in lines[:-1]] == [["loss", "batch", "ms_per_step", "imgs_per_sec"]] * 2
    assert lines[-1] == out and list(out) == ["preset", "batch", "device", "power_limit", "results"]
    assert out["device"] == "cpu" and all(r["ms_per_step"] > 0 for r in out["results"].values())


@pytest.mark.parametrize("accum", [1, 2])
def test_remat_main_prints_jax_keys(accum, capsys):
    out = bench_remat.main(["--preset", "mixer-debug", "--batch", "4", "--accum", str(accum), "--device", "cpu"],
                           chain=(1, 2))
    lines = _main_keys(capsys)
    assert [list(x) for x in lines[:-1]] == [["policy", "batch", "accum", "ms_per_step", "imgs_per_sec"]] * 3
    assert list(out) == ["preset", "batch", "accum", "device", "power_limit", "results"]
    assert list(out["results"]) == ["none", "mlp_hidden", "all_hidden"] and out["accum"] == accum


def test_remat_out_of_memory_is_a_result(monkeypatch, capsys):
    """Only an out-of-memory error becomes the policy's result."""
    def oom(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")

    monkeypatch.setattr(profiling, "chained_train_time", oom)
    out = bench_remat.main(["--preset", "mixer-debug", "--batch", "4", "--policies", "none", "--device", "cpu"])
    assert out["results"] == {"none": {"error": "OutOfMemoryError: CUDA out of memory. Tried to allocate"}}
    monkeypatch.setattr(profiling, "chained_train_time", lambda *a, **kw: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        bench_remat.main(["--preset", "mixer-debug", "--batch", "4", "--policies", "none", "--device", "cpu"])


def test_rn_accum_main_prints_jax_keys(capsys, monkeypatch):
    rn = bench_rn.main(["rn", "--device", "cpu"], cfg=tcfg.CLIPConfig(**RN), batch=4)
    assert list(rn) == ["model", "batch", "bf16_imgs_per_sec", "int8_imgs_per_sec", "speedup", "cosine_min",
                        "device", "power_limit"]
    assert rn["batch"] == 4 and np.isfinite(rn["cosine_min"])
    # ACCUM_FAST=1 keeps JAX's meaning: the first and the last configuration
    monkeypatch.setattr(bench_rn, "ACCUM_CONFIGS", ((1, 4), (2, 4), (4, 8)))
    monkeypatch.setattr(bench_rn, "ACCUM_FAST_CONFIGS", ((1, 4), (4, 8)))
    monkeypatch.setenv("ACCUM_FAST", "1")
    accum = bench_rn.main(["accum", "--device", "cpu"], cfg=_debug(tcfg.PRESETS), chain=(1, 2))
    assert list(accum) == ["accum1_batch4", "accum4_batch8", "device", "power_limit"]
    assert all(list(accum[k]) == ["ms_per_step", "imgs_per_sec", "loss"] for k in list(accum)[:2])
    lines = _main_keys(capsys)
    assert lines[0] == rn and [list(x) for x in lines[1:3]] == [["accum1_batch4"], ["accum4_batch8"]]
    assert lines[-1] == accum


def test_profile_main_prints_jax_keys(capsys):
    out = profile.main(["--device", "cpu"], cfg=tcfg.PRESETS["mixer-debug"], batch=8, chain=(1, 3))
    assert list(out) == ["batch", "e2e_ms", "token_mix_ms", "channel_mix_ms", "other_ms", "token_mix_pct",
                         "imgs_per_sec_full", "device", "power_limit"]
    assert _main_keys(capsys) == [out] and out["e2e_ms"] > 0
