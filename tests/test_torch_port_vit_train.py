"""Training the port's transformer (ViT) CLIP against the JAX package, on the CPU.

Both start from one JAX init (moved into the port by ``load_jax_params``) and
take the same three uint8 batches (numpy seeds); JAX runs its
``make_train_step`` on a one-device mesh. Bounds, the train step's
(``tests/test_train_step.py``): loss rtol 2e-5, grad_norm rtol 2e-4,
params atol 5e-4. Remat under each policy gives the gradients of the model
without remat to 1e-6, and the same loss bit for bit. Under
``freeze="text"`` the text tower's ``positional_embedding`` stays bit for
bit, as under JAX's ``freeze_subtree`` of the whole ``"text"`` subtree.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.models.convert import params_to_state_dict
from clip_mixer_tpu.parallel import train_step as jstep
from clip_mixer_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from clip_mixer_tpu.train import optimizer as jopt

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.api import save_pretrained
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from clip_mixer_tpu_torch.ops.losses import info_nce
from clip_mixer_tpu_torch.parallel import train_step as tstep
from clip_mixer_tpu_torch.train import optimizer as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# width 64, two layers, two text heads, patch 16 on 32 px, a 12-token context
SMALL = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64, vision_patch_size=16,
             context_length=12, vocab_size=256, text_width=64, text_heads=2, text_layers=2, tower="transformer",
             compute_dtype="float32")
TRAIN = dict(global_batch_size=16, learning_rate=1e-3, warmup_steps=2)
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 2e-5, 2e-4, 5e-4  # tests/test_train_step.py:91-100
TOTAL_STEPS = 10
POLICIES = ("none", "mlp_hidden", "all_hidden")
GRAD_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(n_data=1, devices=jax.devices()[:1])


def _batch(seed=0, B=16):
    """uint8 images; token ids with the eot (255) the max id."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
    texts = np.zeros((B, 12), np.int32)
    texts[:, 0] = 254
    for i in range(B):
        n = 2 + i % 8
        texts[i, 1:n] = rng.integers(1, 250, n - 1)
        texts[i, n] = 255
    return {"images": images, "texts": texts}


BATCHES = [_batch(seed=s) for s in (3, 4, 5)]


def _configs(train=None, siglip=False):
    train = {**TRAIN, **(train or {})}
    jc, tc = jcfg.CLIPConfig(**SMALL), tcfg.CLIPConfig(**SMALL)
    if siglip:
        jc, tc = jc.for_siglip(), tc.for_siglip()
    return (jc, jcfg.TrainConfig(**train)), (tc, tcfg.TrainConfig(**train))


def _run_jax(mesh, jc, jt):
    opt = jopt.make_optimizer(jt, total_steps=TOTAL_STEPS)
    params = jclip.init(jax.random.key(1), jc)
    init = jax.tree.map(np.array, params)
    state = replicate(mesh, jstep.init_train_state(params, opt))
    step = jstep.make_train_step(jc, jt, mesh, opt)
    metrics = []
    for b in BATCHES:
        state, m = step(state, shard_batch(mesh, b))
        metrics.append(jax.device_get(m))
    return init, metrics, jax.device_get(state.params)


def _run_port(tc, tt, init):
    model = load_jax_params(CLIP(tc, device="cpu"), init)
    opt = topt.make_optimizer(tt, total_steps=TOTAL_STEPS)
    state = tstep.init_train_state(model, opt)
    step = tstep.make_train_step(tc, tt, opt)
    metrics = []
    for b in BATCHES:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


CASES = {
    "info_nce": dict(),
    "siglip": dict(siglip=True, train=dict(loss="siglip")),
    "freeze_text": dict(train=dict(freeze="text")),
    "freeze_visual": dict(train=dict(freeze="visual")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_track_jax(case, mesh):
    c = CASES[case]
    (jc, jt), (tc, tt) = _configs(c.get("train"), c.get("siglip", False))
    init, jm, jparams = _run_jax(mesh, jc, jt)
    state, metrics = _run_port(tc, tt, init)
    for i, (j, t) in enumerate(zip(jm, metrics)):
        assert set(t) == set(j), i
        np.testing.assert_allclose(t["loss"], float(j["loss"]), rtol=LOSS_RTOL, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(t["grad_norm"], float(j["grad_norm"]), rtol=NORM_RTOL, err_msg=f"norm, step {i}")
        np.testing.assert_allclose(t["logit_scale"], float(j["logit_scale"]), rtol=LOSS_RTOL)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jparams), jc)
    got = state.model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=PARAM_ATOL, err_msg=name)
    if tt.freeze:
        start = jax_params_to_state_dict(init, jc)
        frozen = [n for n in got if topt.tower_of(n) == tt.freeze]
        assert frozen and all(torch.equal(got[n], start[n]) for n in frozen)
        moving = [n for n in got if topt.tower_of(n) not in (tt.freeze, None)]
        assert all(not torch.equal(got[n], start[n]) for n in moving)


def test_freeze_text_keeps_the_text_positional_embedding():
    """The text tower's position table is in JAX's ``"text"`` subtree, which
    ``freeze="text"`` stops whole: the port names it a text parameter, gives
    it no moments and leaves it bit for bit after a step."""
    assert topt.tower_of("positional_embedding") == "text"
    assert topt.tower_of("visual.positional_embedding") == "visual"
    _, (tc, tt) = _configs(dict(freeze="text"))
    model = CLIP(tc, device="cpu", generator=torch.Generator().manual_seed(4))
    before = model.positional_embedding.detach().clone()
    opt = topt.make_optimizer(tt, total_steps=TOTAL_STEPS)
    state = tstep.init_train_state(model, opt)
    assert "positional_embedding" not in state.opt_state.mu
    state, _ = tstep.make_train_step(tc, tt, opt)(state, BATCHES[0])
    assert torch.equal(model.positional_embedding.detach(), before)
    assert not torch.equal(model.visual.positional_embedding.detach(),
                           CLIP(tc, device="cpu", generator=torch.Generator().manual_seed(4)).visual.positional_embedding)


def test_decay_mask_is_jax_decay_mask_through_the_bridge():
    """JAX's stacked-aware rule (``train/optimizer.py:20-35``) on the
    transformer tree, mapped to the port's names, is the port's ndim rule."""
    jc = jcfg.CLIPConfig(**SMALL)
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(0), jc))
    mask = jopt.decay_mask(params)
    want = params_to_state_dict(jax.tree.map(lambda p, m: np.full(np.shape(p), float(m), np.float32), params, mask),
                                jc)
    model = CLIP(tcfg.CLIPConfig(**SMALL), device="cpu")
    got = topt.decay_mask(dict(model.named_parameters()))
    assert set(got) == set(want)
    for name, decays in got.items():
        assert np.all(want[name] == float(decays)), name
    for name in ("positional_embedding", "visual.positional_embedding", "transformer.resblocks.0.attn.in_proj_weight",
                 "visual.transformer.resblocks.1.mlp.c_fc.weight"):
        assert got[name], name
    for name in ("transformer.resblocks.0.attn.in_proj_bias", "visual.transformer.resblocks.0.ln_1.weight",
                 "transformer.resblocks.1.attn.out_proj.bias", "visual.class_embedding"):
        assert not got[name], name


# ---- remat ------------------------------------------------------------------------


def _grads(cfg, images, texts):
    model = CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    img, txt, scale, _ = model.forward_train(images, texts)
    loss = info_nce(img, txt, scale, grad_through_gather=True)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_equal_no_remat(policy):
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(0, 1, (6, 32, 32, 3)).astype(np.float32))
    texts = torch.from_numpy(_batch(seed=1, B=6)["texts"].astype(np.int64))
    base = tcfg.CLIPConfig(**SMALL)
    want_loss, want = _grads(base, images, texts)
    got_loss, got = _grads(base.replace(remat=True, remat_policy=policy), images, texts)
    assert torch.equal(got_loss, want_loss)  # the same forward, bit for bit
    for name, g in got.items():
        torch.testing.assert_close(g, want[name], msg=name, **GRAD_TOL)


def test_train_cli_runs_two_steps_of_a_vit(tmp_path):
    """``train_cli --preset vit-b32 --device cpu`` with the architecture of a
    small ViT export (``--init-from``; the full preset is card-sized): two
    steps, a checkpoint and the export."""
    export = tmp_path / "small"
    cfg = tcfg.CLIPConfig(**dict(SMALL, vocab_size=49408, context_length=77))
    save_pretrained(CLIP(cfg, device="cpu"), cfg, str(export))
    args = ["--synthetic", "--preset", "vit-b32", "--init-from", str(export), "--global-batch-size", "4",
            "--steps-per-epoch", "2", "--epochs", "1", "--checkpoint-every", "2", "--device", "cpu",
            "--no-validators", "--run-name", "vit"]
    out = subprocess.run([sys.executable, "-m", "clip_mixer_tpu_torch.train_cli", *args], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    run = tmp_path / "outputs" / "vit"
    assert (run / "export" / "model.pt").is_file() and (run / "checkpoints" / "2").is_dir()
    sd = torch.load(run / "export" / "model.pt", weights_only=True)
    assert "transformer.resblocks.1.attn.in_proj_weight" in sd and sd["positional_embedding"].shape == (77, 64)
