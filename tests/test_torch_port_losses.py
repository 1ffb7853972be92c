"""The port's contrastive losses, augmentation and TrainConfig against the
JAX package, on the CPU.

Features, scales and images come from numpy seeds; the gradients are held to
``jax.grad`` of the JAX losses. In f32 the two differ only in summation
order: losses are held at rtol 1e-6, gradients at rtol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.ops import augment as jaug
from clip_mixer_tpu.ops import losses as jloss

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.ops import augment as taug
from clip_mixer_tpu_torch.ops import losses as tloss

LOSS_TOL = dict(rtol=1e-6, atol=1e-7)  # f32 against f32: summation order only
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


def _features(B=16, D=24, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(0, 1, (B, D)).astype(np.float32)
    txt = (img * 0.3 + rng.normal(0, 1, (B, D))).astype(np.float32)  # correlated pairs
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    return img, txt


def _port(fn, img, txt, *scalars):
    """fn's value and gradients in every input, the port's way (an input
    the loss does not use gets zeros, as ``jax.grad`` gives)."""
    ts = [torch.tensor(a, requires_grad=True) for a in (img, txt, *scalars)]
    loss = fn(*ts)
    loss.backward()
    return float(loss.detach()), [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in ts]


def _jax(fn, img, txt, *scalars):
    args = [jnp.asarray(a) for a in (img, txt, *scalars)]
    loss, grads = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(*args)
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("grad_through_gather", [False, True])
@pytest.mark.parametrize("chunk_size", [None, 4])
def test_info_nce_value_and_grads_match_jax(grad_through_gather, chunk_size):
    img, txt = _features(seed=1)
    scale = np.float32(14.3)
    kw = dict(grad_through_gather=grad_through_gather, chunk_size=chunk_size)
    got, got_g = _port(lambda i, t, s: tloss.info_nce(i, t, s, **kw), img, txt, scale)
    want, want_g = _jax(lambda i, t, s: jloss.info_nce(i, t, s, **kw), img, txt, scale)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    for name, g, w in zip(("image", "text", "scale"), got_g, want_g):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


def test_info_nce_detaches_the_keys_by_default():
    """With the keys detached, the gradient in the image features comes only
    from the image rows (queries) of logits_i2t: it differs from the exact
    gradient. A port that lets it through both sides gets the loss right and
    this wrong."""
    img, txt = _features(seed=2)
    scale = np.float32(10.0)
    loss_d, (g_d, *_) = _port(lambda i, t, s: tloss.info_nce(i, t, s), img, txt, scale)
    loss_x, (g_x, *_) = _port(lambda i, t, s: tloss.info_nce(i, t, s, grad_through_gather=True), img, txt, scale)
    assert loss_d == loss_x
    assert np.abs(g_d - g_x).max() > 1e-3
    # the detached gradient is half of what the image rows alone give
    i = torch.tensor(img, requires_grad=True)
    t = torch.tensor(txt)
    logits = 10.0 * i @ t.t()
    (0.5 * torch.nn.functional.cross_entropy(logits, torch.arange(16))).backward()
    np.testing.assert_allclose(g_d, i.grad.numpy(), rtol=1e-5, atol=1e-7)


def test_siglip_value_and_grads_match_jax():
    img, txt = _features(seed=3)
    scale, bias = np.float32(10.0), np.float32(-10.0)
    got, got_g = _port(tloss.siglip_loss, img, txt, scale, bias)
    want, want_g = _jax(jloss.siglip_loss, img, txt, scale, bias)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    for name, g, w in zip(("image", "text", "scale", "bias"), got_g, want_g):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("kind", ["info_nce", "siglip"])
def test_contrastive_loss_dispatch_matches_jax(kind):
    img, txt = _features(seed=4)
    scale, bias = np.float32(12.0), np.float32(-8.0)
    got, got_g = _port(lambda i, t, s, b: tloss.contrastive_loss(kind, i, t, s, logit_bias=b, chunk_size=8),
                       img, txt, scale, bias)
    want, want_g = _jax(lambda i, t, s, b: jloss.contrastive_loss(kind, i, t, s, logit_bias=b, chunk_size=8),
                        img, txt, scale, bias)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, **GRAD_TOL)
    assert tloss.loss_param_keys(kind) == jloss.loss_param_keys(kind)


def test_contrastive_loss_errors_match_jax():
    img, txt = _features(B=4, seed=5)
    s = np.float32(1.0)
    for mod, arr in ((tloss, torch.tensor), (jloss, jnp.asarray)):
        with pytest.raises(ValueError, match="logit_bias"):
            mod.contrastive_loss("siglip", arr(img), arr(txt), arr(s))
        with pytest.raises(ValueError, match="unknown contrastive loss"):
            mod.contrastive_loss("triplet", arr(img), arr(txt), arr(s))
    with pytest.raises(ValueError, match="not divisible"):
        tloss.info_nce(torch.tensor(img), torch.tensor(txt), torch.tensor(s), chunk_size=3)


@pytest.mark.parametrize("kind", ["info_nce", "info_nce_gtg", "info_nce_chunked", "siglip"])
def test_a_group_of_one_is_the_one_device_loss_bit_for_bit(kind, tmp_path):
    """The cross-device forms on a process group of one (gloo, in this
    process) give the one-device loss and gradients bit for bit: the
    gather is a copy, the labels' offset 0, the ring one tick. Worlds of 2
    and 4 are held to JAX's mesh forms in tests/test_torch_port_parallel.py."""
    import torch.distributed as dist

    img, txt = _features(B=8, seed=6)
    kw = {"info_nce": {}, "info_nce_gtg": dict(grad_through_gather=True),
          "info_nce_chunked": dict(chunk_size=4), "siglip": {}}[kind]
    name = "siglip" if kind == "siglip" else "info_nce"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        out = []
        for group in (None, dist.group.WORLD):
            args = [torch.tensor(img, requires_grad=True), torch.tensor(txt, requires_grad=True),
                    torch.tensor(np.float32(12.0), requires_grad=True)]
            if name == "siglip":
                args.append(torch.tensor(np.float32(-10.0), requires_grad=True))
            loss = getattr(tloss, f"{name}_loss" if name == "siglip" else name)(*args, group=group, **kw)
            loss.backward()
            out.append([loss.detach()] + [a.grad for a in args])
    finally:
        dist.destroy_process_group()
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_train_config_matches_jax_field_by_field():
    t, j = tcfg.TrainConfig(), jcfg.TrainConfig()
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for bad in (dict(loss="hinge"), dict(freeze="both"), dict(max_inflight_steps=0), dict(ema_decay=1.0)):
        with pytest.raises(ValueError):
            jcfg.TrainConfig(**bad)
        with pytest.raises(ValueError):
            tcfg.TrainConfig(**bad)


# ---- augmentation --------------------------------------------------------------


def test_source_size_matches_jax():
    for r in (32, 64, 224, 288, 336, 384):
        assert taug.source_size(r) == jaug.source_size(r)


@pytest.mark.parametrize("hw,out", [((40, 40), 32), ((256, 256), 224), ((37, 45), 32), ((32, 32), 32)])
def test_crop_flip_is_bitwise_jax_with_its_offsets(hw, out):
    """The port cannot draw jax.random's numbers, so the offsets come from
    JAX's own split / randint / bernoulli calls on the same key
    (ops/augment.py in the JAX package); given them, the crop is bit for bit."""
    B = 8
    imgs = np.random.default_rng(6).integers(0, 256, (B, *hw, 3), dtype=np.uint8)
    key = jax.random.fold_in(jax.random.key(7 ^ 0x5EED), 3)
    want = np.asarray(jaug.random_crop_flip(key, jnp.asarray(imgs), out))
    ky, kx, kf = jax.random.split(key, 3)
    oy = jax.random.randint(ky, (B,), 0, hw[0] - out + 1)
    ox = jax.random.randint(kx, (B,), 0, hw[1] - out + 1)
    flip = jax.random.bernoulli(kf, 0.5, (B,))
    got = taug.crop_flip(torch.from_numpy(imgs), out, torch.tensor(np.asarray(oy)),
                         torch.tensor(np.asarray(ox)), torch.tensor(np.asarray(flip)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_augment_is_keyed_on_seed_and_step():
    cfg = tcfg.CLIPConfig(image_resolution=32)
    t = tcfg.TrainConfig(augment=True, seed=11)
    imgs = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (16, 40, 40, 3), dtype=np.uint8))
    a = taug.maybe_augment(t, cfg, 5, imgs)
    assert a.shape == (16, 32, 32, 3)
    assert torch.equal(a, taug.maybe_augment(t, cfg, 5, imgs))  # a resume replays the stream
    assert not torch.equal(a, taug.maybe_augment(t, cfg, 6, imgs))
    assert not torch.equal(a, taug.maybe_augment(dataclasses.replace(t, seed=12), cfg, 5, imgs))
    oy, ox, flip = taug.draw_crops(11 ^ 0x5EED, 5, 16, 40, 40, 32)
    assert 0 < int(flip.sum()) < 16 and int(oy.max()) <= 8 and int(ox.max()) <= 8
    off = dataclasses.replace(t, augment=False)
    assert taug.maybe_augment(off, cfg, 5, imgs) is imgs
    with pytest.raises(ValueError, match="out of range"):
        taug.crop_flip(imgs, 32, oy + 9, ox, flip)
