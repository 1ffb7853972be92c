"""Training the port's ResNet CLIP against the JAX package, on the CPU.

Both start from one JAX init with every BN site perturbed from a numpy seed
(moved into the port by ``load_jax_params``) and take the same uint8
batches; JAX runs its ``make_train_step`` on a one-device mesh. The step
normalises the vision tower with batch moments, merges them into the
running statistics after the update and the ``logit_scale`` clamp, then
updates the EMA over the parameters and the running statistics. Bounds, the
train step's (``tests/test_train_step.py``): loss rtol 2e-5, grad_norm rtol
2e-4, parameters, running statistics and EMA atol 5e-4. Also: ``freeze=
"visual"`` keeps the vision tower and its running statistics bit for bit;
``accum_steps > 1`` is refused; per-bottleneck remat gives step 1's loss
and running statistics bit for bit; a checkpoint resumes bit for bit; the
export loads in the JAX ``api.load`` and back in the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_mixer_tpu import api as japi
from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.parallel import train_step as jstep
from clip_mixer_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from clip_mixer_tpu.train import optimizer as jopt

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.api import load_pretrained, save_pretrained
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from clip_mixer_tpu_torch.parallel import train_step as tstep
from clip_mixer_tpu_torch.train import optimizer as topt
from clip_mixer_tpu_torch.train.checkpoint import Checkpointer

RN = dict(embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=8, vision_patch_size=None,
          context_length=12, vocab_size=256, text_width=64, text_heads=1, text_layers=1, tower="transformer",
          compute_dtype="float32")
TRAIN = dict(global_batch_size=8, learning_rate=1e-3, warmup_steps=1, ema_decay=0.9)
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 2e-5, 2e-4, 5e-4  # tests/test_train_step.py:91-100
TOTAL_STEPS = 10


def perturb_bn(visual, seed):
    """Every BN site of a JAX visual tree drawn from a numpy seed."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, list):
            return [walk(c) for c in node]
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                c = node["scale"].shape[0]
                return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                        "bias": rng.normal(0, 0.1, c).astype(np.float32),
                        "mean": rng.normal(0, 0.2, c).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(visual)


def _batch(seed=0, B=8):
    """uint8 images; token ids with the eot (255) the max id."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    texts = np.zeros((B, 12), np.int32)
    texts[:, 0] = 254
    for i in range(B):
        n = 2 + i % 8
        texts[i, 1:n] = rng.integers(1, 250, n - 1)
        texts[i, n] = 255
    return {"images": images, "texts": texts}


BATCHES = [_batch(seed=s) for s in (3, 4, 5)]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(n_data=1, devices=jax.devices()[:1])


def _init(seed=1):
    jc = jcfg.CLIPConfig(**RN)
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(seed), jc))
    params["visual"] = perturb_bn(params["visual"], seed)
    return jc, params


def _run_jax(mesh, jc, jt, init):
    opt = jopt.make_optimizer(jt, total_steps=TOTAL_STEPS)
    state = replicate(mesh, jstep.init_train_state(jax.tree.map(jnp.asarray, init), opt))
    step = jstep.make_train_step(jc, jt, mesh, opt)
    metrics = []
    for b in BATCHES:
        state, m = step(state, shard_batch(mesh, b))
        metrics.append(jax.device_get(m))
    return metrics, jax.device_get(state.params), jax.device_get(jstep.ema_params(state))


def _port(tc, tt, init):
    model = load_jax_params(CLIP(tc, device="cpu"), init)
    opt = topt.make_optimizer(tt, total_steps=TOTAL_STEPS)
    return tstep.init_train_state(model, opt), tstep.make_train_step(tc, tt, opt)


def _run_port(tc, tt, init, batches=BATCHES):
    state, step = _port(tc, tt, init)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _running(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("freeze", [None, "text"], ids=["all", "freeze_text"])
def test_three_steps_track_jax(mesh, freeze):
    """Loss, gradient norm, every parameter, every running statistic and the
    EMA of both after three steps, against JAX's."""
    jc, init = _init()
    train = dict(TRAIN, freeze=freeze)
    jm, jparams, jema = _run_jax(mesh, jc, jcfg.TrainConfig(**train), init)
    state, metrics = _run_port(tcfg.CLIPConfig(**RN), tcfg.TrainConfig(**train), init)
    for i, (j, t) in enumerate(zip(jm, metrics)):
        np.testing.assert_allclose(t["loss"], float(j["loss"]), rtol=LOSS_RTOL, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(t["grad_norm"], float(j["grad_norm"]), rtol=NORM_RTOL, err_msg=f"norm, step {i}")
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jparams), jc)
    got = state.model.state_dict()
    assert set(got) == set(want)
    start = jax_params_to_state_dict(init, jc)
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            assert int(got[name]) == len(BATCHES), name  # torch counts the merges; the JAX export writes 0
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=PARAM_ATOL, err_msg=name)
    moved = _running(got)
    assert len(moved) == 2 * 19 and all(not torch.equal(v, start[k]) for k, v in moved.items())
    ema_want = jax_params_to_state_dict(jax.tree.map(np.asarray, jema), jc)
    ema = state.opt_state.ema
    assert set(ema) == {k for k in want if not k.endswith("num_batches_tracked")}
    for name, e in ema.items():
        np.testing.assert_allclose(e.numpy(), ema_want[name].numpy(), atol=PARAM_ATOL, err_msg=name)
    assert not any(k.endswith(("running_mean", "running_var")) for k in state.opt_state.mu)


def test_freeze_visual_keeps_the_tower_and_its_running_stats_bit_for_bit(mesh):
    """A locked vision tower normalises with its running statistics
    (``bn_eval``) and keeps them and its parameters bit for bit, as JAX's
    step does; the text tower trains on, as in JAX. The losses are held to
    JAX's for two steps: here the third step's loss moves 1.3e-4 (relative)
    in JAX itself when the text weights are perturbed by 1e-6 (Adam on
    gradients near its eps), so the packages' rounding differences show
    there at that size too (read 2.3e-4)."""
    jc, init = _init(seed=2)
    train = dict(TRAIN, freeze="visual")
    jm, jparams, _ = _run_jax(mesh, jc, jcfg.TrainConfig(**train), init)
    state, metrics = _run_port(tcfg.CLIPConfig(**RN), tcfg.TrainConfig(**train), init)
    start = jax_params_to_state_dict(init, jc)
    got = state.model.state_dict()
    visual = [k for k in got if k.startswith("visual.")]
    assert len(_running({k: got[k] for k in visual})) == 2 * 19
    for k in visual:
        assert torch.equal(got[k], start[k]), k
    for j, t in zip(jm[:2], metrics[:2]):
        np.testing.assert_allclose(t["loss"], float(j["loss"]), rtol=LOSS_RTOL)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jparams), jc)
    for k in ("text_projection", "transformer.resblocks.0.attn.in_proj_weight"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=PARAM_ATOL)
        assert not torch.equal(got[k], start[k])


def test_accum_steps_is_refused_for_a_bn_tower():
    opt = topt.make_optimizer(tcfg.TrainConfig(**TRAIN), TOTAL_STEPS)
    with pytest.raises(NotImplementedError, match="BN"):
        tstep.make_train_step(tcfg.CLIPConfig(**RN), tcfg.TrainConfig(**TRAIN), opt, accum_steps=2)


def test_remat_step_one_equals_no_remat():
    """Per-bottleneck remat: the same loss bits and the same running
    statistics after step 1 (the moments are outputs of the checkpointed
    blocks; a recompute updates nothing), gradients to 1e-6."""
    _, init = _init(seed=3)
    out = {}
    for remat in (False, True):
        state, step = _port(tcfg.CLIPConfig(**RN, remat=remat), tcfg.TrainConfig(**TRAIN), init)
        state, m = step(state, BATCHES[0])
        out[remat] = (m["loss"], {k: v.clone() for k, v in state.model.state_dict().items()},
                      {n: p.grad.clone() for n, p in state.model.named_parameters() if p.grad is not None})
    assert torch.equal(out[True][0], out[False][0])
    for k, v in _running(out[False][1]).items():
        assert torch.equal(out[True][1][k], v), k
    assert int(out[True][1]["visual.layer1.0.bn1.num_batches_tracked"]) == 1
    for n, g in out[False][2].items():
        torch.testing.assert_close(out[True][2][n], g, atol=1e-6, rtol=1e-6, msg=n)


def test_checkpoint_resumes_bit_for_bit(tmp_path):
    """Save after step 2, resume in a model of other weights, take step 3:
    every tensor (parameters, running statistics and their counts, moments,
    the EMA of both) equals the uninterrupted run's."""
    _, init = _init(seed=4)
    tc, tt = tcfg.CLIPConfig(**RN), tcfg.TrainConfig(**TRAIN)
    state, step = _port(tc, tt, init)
    ck = Checkpointer(str(tmp_path / "ckpt"))
    for i, b in enumerate(BATCHES):
        state, _ = step(state, b)
        if i == 1:
            ck.save(state, epoch=0, step=2)
    _, other = _init(seed=5)
    resumed, step_b = _port(tc, tt, other)
    resumed, _, _ = Checkpointer(str(tmp_path / "ckpt")).restore(resumed)
    resumed, _ = step_b(resumed, BATCHES[2])
    a, b = state.model.state_dict(), resumed.model.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for slot in ("mu", "nu", "ema"):
        sa, sb = getattr(state.opt_state, slot), getattr(resumed.opt_state, slot)
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (slot, k)
    assert any(k.endswith("running_var") for k in state.opt_state.ema)


def test_the_export_loads_in_jax_and_back(tmp_path):
    """``save_pretrained`` writes the tuple ``vision_layers`` and the BN
    buffers; the JAX ``api.load`` sniffs a ResNet from ``model.pt`` and
    gives the port's features, and ``load_pretrained`` gives back every
    tensor."""
    jc, init = _init(seed=6)
    state, _ = _run_port(tcfg.CLIPConfig(**RN), tcfg.TrainConfig(**TRAIN), init, batches=BATCHES[:1])
    model = state.model
    save_pretrained(model, model.cfg, str(tmp_path / "export"))
    params, jcfg_loaded, _ = japi.load(str(tmp_path / "export" / "model.pt"), compute_dtype="float32")
    assert jcfg_loaded.is_resnet and jcfg_loaded.vision_layers == (1, 1, 1, 1)
    assert (jcfg_loaded.vision_width, jcfg_loaded.image_resolution, jcfg_loaded.embed_dim) == (8, 64, 32)
    images = np.random.default_rng(7).normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(images)).numpy()
    want = np.asarray(jclip.encode_image(params, jcfg_loaded, jnp.asarray(images)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    back, cfg = load_pretrained(str(tmp_path / "export"), device="cpu")
    assert cfg == model.cfg and cfg.vision_layers == (1, 1, 1, 1)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    assert back.state_dict()["visual.bn1.num_batches_tracked"].dtype == torch.int64
