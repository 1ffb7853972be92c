"""The port's ResNet vision tower (``clip_mixer_tpu_torch/models/resnet.py``)
against the JAX package's ``clip_mixer_tpu/models/resnet.py``, on the CPU.

Configs are small (``vision_layers=(1, 1, 1, 1)``, width 16, 64 px, so the
attention pool sees a 2 x 2 grid), as the JAX suite's RN tests are. The
JAX init leaves every BN site at running mean 0 / var 1 and each
bottleneck's ``bn3`` scale at 0, so every BN site is perturbed from a numpy
seed (as ``tests/test_quant.py`` does) and the convs of every block count.
Weights move by ``load_jax_params``. Bounds:

* f32, each module (conv with padding and stride, BN, ``avg_pool``,
  ``bottleneck`` with and without downsample, ``attention_pool``, the
  tower, ``forward``, the training forward): relative Frobenius <= 1e-5;
* ``batch_moments`` and ``apply_bn_updates``: atol 1e-5 (JAX
  ``tests/test_train_step.py``);
* bf16 tower: per-row cosine >= 0.999;
* planted faults fail the f32 bound: ``bn3`` skipped, the stride-2 avg pool
  before ``conv2`` instead of after it, the pool's score scale rounded to
  bf16. (The pool moved after ``conv3`` is no fault: a 1x1 conv and a
  per-channel BN are affine per pixel and commute with a 2x2 mean, so that
  tower reads within 1e-6 of the right one; the test shows it.)
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.models import resnet as jres
from clip_mixer_tpu.models.convert import params_to_state_dict

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.models import resnet as tres
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params

# the JAX suite's RN geometry (tests/test_quant.py:216), on 64 px
RN = dict(embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=16, vision_patch_size=None,
          context_length=12, vocab_size=256, text_width=64, text_heads=1, text_layers=1, tower="transformer",
          compute_dtype="float32")
F32_REL = 1e-5
STATS_ATOL = 1e-5
BF16_COSINE = 0.999


def perturb_bn(visual, seed):
    """Every BN site of a JAX visual tree drawn from a numpy seed: scale
    U(0.5, 1.5), bias N(0, 0.1), mean N(0, 0.2), var U(0.5, 2)."""
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


def rn_pair(seed=0, dtype="float32", **over):
    """(JAX config, JAX params as numpy with BN perturbed, the port CLIP
    with the same weights)."""
    cfg = dict(RN, compute_dtype=dtype, **over)
    jc = jcfg.CLIPConfig(**cfg)
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(seed), jc))
    params["visual"] = perturb_bn(params["visual"], seed)
    return jc, params, load_jax_params(CLIP(tcfg.CLIPConfig(**cfg), device="cpu"), params)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---- the primitives ------------------------------------------------------------------


@pytest.mark.parametrize("k,stride,padding", [(3, 1, 1), (3, 2, 1), (1, 1, 0), (3, 1, 0), (3, 2, 0)])
def test_conv_matches_jax(k, stride, padding):
    """NHWC in and out; the port's OIHW weight is the JAX HWIO kernel."""
    rng = np.random.default_rng(k + stride + padding)
    kernel = rng.normal(0, 0.3, (k, k, 6, 10)).astype(np.float32)
    x = _x((2, 9, 11, 6), seed=1)
    want = jres.conv({"kernel": jnp.asarray(kernel)}, jnp.asarray(x), stride=stride, padding=padding)
    got = tres.conv(_t(kernel.transpose(3, 2, 0, 1)), _t(x), stride=stride, padding=padding)
    assert got.shape == want.shape and got.is_contiguous()
    assert rel(got, want) <= F32_REL


def test_batch_norm_and_avg_pool_match_jax():
    _, params, model = rn_pair(seed=1)
    x = _x((2, 8, 8, 8), seed=2)
    bn_p = params["visual"]["bn1"]
    want = jres.batch_norm(jax.tree.map(jnp.asarray, bn_p), jnp.asarray(x))
    with torch.no_grad():
        got = model.visual.bn1(_t(x))
    assert rel(got, want) <= F32_REL
    y = _x((2, 8, 6, 5), seed=3)
    assert rel(tres.avg_pool(_t(y), 2), jres.avg_pool(jnp.asarray(y), 2)) <= F32_REL
    bf = torch.from_numpy(y).bfloat16()
    assert tres.avg_pool(bf, 2).dtype == torch.bfloat16


def test_batch_moments_match_jax():
    x = _x((3, 6, 5, 7), seed=4) * 2 + 1
    jm, jv = jres.batch_moments(jnp.asarray(x))
    m, v = tres.batch_moments(_t(x))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=STATS_ATOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=STATS_ATOL)


@pytest.mark.parametrize("layers,where,downsample", [
    ((1, 1, 1, 1), (2, 0), True),   # stride 2: the avg pools on both branches
    ((1, 1, 1, 1), (1, 0), True),   # stride 1, widening
    ((2, 1, 1, 1), (1, 1), False),  # no downsample branch
], ids=["stride2", "widening", "identity"])
def test_bottleneck_matches_jax(layers, where, downsample):
    _, params, model = rn_pair(seed=2, vision_layers=layers)
    stage, b = where
    bp = jax.tree.map(jnp.asarray, params["visual"][f"layer{stage}"][b])
    block = getattr(model.visual, f"layer{stage}")[b]
    assert (block.downsample is not None) == downsample == ("downsample" in bp)
    x = np.abs(_x((2, 8, 8, block.conv1.in_channels), seed=5))
    want = jres.bottleneck(bp, jnp.asarray(x), block.stride)
    with torch.no_grad():
        got = block(_t(x))
    assert rel(got, want) <= F32_REL


def _jax_pool(c, heads, seed):
    rng = np.random.default_rng(seed)
    lin = lambda d: {"kernel": rng.normal(0, c**-0.5, (c, d)).astype(np.float32),  # noqa: E731
                     "bias": rng.normal(0, 0.1, d).astype(np.float32)}
    return {"pos_embedding": rng.normal(0, c**-0.5, (5, c)).astype(np.float32),
            "q": lin(c), "k": lin(c), "v": lin(c), "c": lin(24)}


def _port_pool(jp, heads):
    c = jp["pos_embedding"].shape[1]
    pool = tres.AttentionPool2d(2, c, heads, 24)
    sd = {"positional_embedding": _t(jp["pos_embedding"])}
    for n in "qkvc":
        sd[f"{n}_proj.weight"] = _t(jp[n]["kernel"].T.copy())
        sd[f"{n}_proj.bias"] = _t(jp[n]["bias"])
    pool.load_state_dict(sd)
    return pool


def _pool_scale_in_bf16(pool, x):
    """The planted fault: the score scale rounded to bf16 before the product
    (the transformer core's rounding), scores otherwise as the pool's."""
    B, H, W, C = x.shape
    tokens = x.reshape(B, H * W, C)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1) + pool.positional_embedding
    hd = C // pool.n_heads

    def heads(t):
        return t.reshape(B, -1, pool.n_heads, hd).transpose(1, 2)

    q, k, v = (heads(tres._linear(lin, t)) for lin, t in
               ((pool.q_proj, tokens[:, :1]), (pool.k_proj, tokens), (pool.v_proj, tokens)))
    scale = torch.tensor(hd**-0.5, dtype=torch.bfloat16).item()
    attn = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale, dim=-1)
    return tres._linear(pool.c_proj, torch.einsum("bhqk,bhkd->bhqd", attn, v).transpose(1, 2).reshape(B, C))


@pytest.mark.parametrize("c,heads", [(128, 2), (96, 2)], ids=["hd64", "hd48"])
def test_attention_pool_matches_jax(c, heads):
    """hd 64 is every RN preset's (width 32 x w over heads w / 2); at hd 48
    the scale has no exact bf16 value, and the rounded scale must fail."""
    jp = _jax_pool(c, heads, seed=c)
    pool = _port_pool(jp, heads)
    x = _x((3, 2, 2, c), seed=6)
    want = jres.attention_pool(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), heads)
    with torch.no_grad():
        assert rel(pool(_t(x)), want) <= F32_REL
        fault = rel(_pool_scale_in_bf16(pool, _t(x)), want)
    if c // heads == 48:
        assert fault > F32_REL, fault


# ---- the tower, the CLIP forward, bf16 -------------------------------------------------


def _images(n=4, seed=7):
    return _x((n, 64, 64, 3), seed)


def test_tower_and_forward_match_jax():
    jc, params, model = rn_pair(seed=3)
    images = _images()
    text = np.random.default_rng(8).integers(1, 255, (4, 12)).astype(np.int32)
    text[:, 6] = 255
    jp = jax.tree.map(jnp.asarray, params)
    with torch.no_grad():
        assert rel(model.encode_image(_t(images)), jclip.encode_image(jp, jc, jnp.asarray(images))) <= F32_REL
        img, txt, scale = model(_t(images), _t(text))
    j_img, j_txt, j_scale = jclip.forward(jp, jc, jnp.asarray(images), jnp.asarray(text))
    assert rel(img, j_img) <= F32_REL and rel(txt, j_txt) <= F32_REL
    np.testing.assert_allclose(float(scale), float(j_scale), rtol=1e-6)


def _faulty_tower(visual, images, fault):
    """The tower with one planted change: ``"skip_bn3"`` (each bottleneck's
    bn3 an identity), ``"pool_before_conv2"`` or ``"pool_after_conv3"``
    (the stride-2 avg pool moved from after conv2)."""
    relu = torch.nn.functional.relu
    pool_at = {"pool_before_conv2": "before_conv2", "pool_after_conv3": "after_conv3"}.get(fault, "after_conv2")
    x = visual.stem(images, tres._running_norm)
    for _, blk in visual.blocks():
        def pool(y, at):
            return tres.avg_pool(y, blk.stride) if blk.stride > 1 and at == pool_at else y

        out = pool(relu(blk.bn1(tres.conv(blk.conv1.weight, x))), "before_conv2")
        out = pool(relu(blk.bn2(tres.conv(blk.conv2.weight, out, padding=1))), "after_conv2")
        out = pool(tres.conv(blk.conv3.weight, out), "after_conv3")
        out = out if fault == "skip_bn3" else blk.bn3(out)
        identity = x
        if blk.downsample is not None:
            identity = x if blk.stride == 1 else tres.avg_pool(x, blk.stride)
            identity = blk.downsample[1](tres.conv(blk.downsample[0].weight, identity))
        x = relu(out + identity)
    return visual.attnpool(x)


@pytest.mark.parametrize("fault", ["skip_bn3", "pool_before_conv2"])
def test_planted_tower_faults_fail_the_bound(fault):
    jc, params, model = rn_pair(seed=3)
    images = _images()
    want = jclip.encode_image(jax.tree.map(jnp.asarray, params), jc, jnp.asarray(images))
    with torch.no_grad():
        assert rel(_faulty_tower(model.visual, _t(images), None), want) <= F32_REL  # the harness itself is sound
        assert rel(_faulty_tower(model.visual, _t(images), fault), want) > F32_REL
        # the pool after conv3 commutes with the 1x1 conv and bn3: no fault
        assert rel(_faulty_tower(model.visual, _t(images), "pool_after_conv3"), want) <= F32_REL


def test_bf16_tower_matches_jax():
    jc, params, model = rn_pair(seed=4, dtype="bfloat16")
    images = _images(n=6, seed=9)
    want = np.asarray(jclip.encode_image(jax.tree.map(jnp.asarray, params), jc, jnp.asarray(images)), np.float32)
    with torch.no_grad():
        got = model.encode_image(_t(images))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= BF16_COSINE, cos


# ---- the training forward, the running-stat merge --------------------------------------


def _jax_site(stats, name):
    """A port BN site name ("layer2.0.downsample.1") -> JAX stats subtree."""
    parts = name.split(".")
    if len(parts) == 1:
        return stats[parts[0]]
    node = stats[parts[0]][int(parts[1])]
    return node["downsample"]["bn"] if parts[2] == "downsample" else node[parts[2]]


@pytest.mark.parametrize("remat", [False, True])
def test_training_forward_and_bn_updates_match_jax(remat):
    jc, params, model = rn_pair(seed=5, remat=remat)
    images = _images(n=8, seed=10)
    jp = jax.tree.map(jnp.asarray, params)
    want, jstats = jres.resnet_encoder_train(jp["visual"], jc, jnp.asarray(images))
    got, stats = tres.resnet_encoder_train(model.visual, _t(images).requires_grad_())
    assert rel(got.detach(), want) <= F32_REL
    assert list(stats) == list(model.visual.bn_sites())
    for name, s in stats.items():
        js = _jax_site(jstats, name)
        np.testing.assert_allclose(s["mean"].detach().numpy(), np.asarray(js["mean"]), atol=STATS_ATOL)
        np.testing.assert_allclose(s["var"].detach().numpy(), np.asarray(js["var"]), atol=STATS_ATOL)
        assert s["n"] == float(js["n"])
    updated = jres.apply_bn_updates(jp["visual"], jstats)
    tres.apply_bn_updates(model.visual, stats)
    for name, bn in model.visual.bn_sites().items():
        js = _jax_site(updated, name)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(js["mean"]), atol=STATS_ATOL)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(js["var"]), atol=STATS_ATOL)
        assert int(bn.num_batches_tracked) == 1


def test_apply_bn_updates_is_torch_semantics():
    """One merge: running = 0.9 running + 0.1 batch, the variance unbiased,
    as ``nn.BatchNorm2d`` in training mode computes it."""
    _, _, model = rn_pair(seed=6)
    images = _t(_images(n=2, seed=11))
    pre = tres.conv(model.visual.conv1.weight, images, stride=2, padding=1)
    ref = torch.nn.BatchNorm2d(pre.shape[-1], momentum=0.1)
    ref.running_mean.copy_(model.visual.bn1.running_mean)
    ref.running_var.copy_(model.visual.bn1.running_var)
    ref.train()(pre.detach().permute(0, 3, 1, 2))
    with torch.no_grad():
        _, stats = tres.resnet_encoder_train(model.visual, images)
    tres.apply_bn_updates(model.visual, {"bn1": stats["bn1"]})
    torch.testing.assert_close(model.visual.bn1.running_mean, ref.running_mean, atol=STATS_ATOL, rtol=0)
    torch.testing.assert_close(model.visual.bn1.running_var, ref.running_var, atol=STATS_ATOL, rtol=0)


# ---- the weight bridge, the init -------------------------------------------------------


def test_state_dict_matches_jax_params_to_state_dict():
    """Key for key and value for value the JAX ``params_to_state_dict``:
    ``visual.layer{i}.{b}.conv1.weight`` OIHW, ``downsample.0/1``, the BN
    buffers with ``num_batches_tracked``, ``attnpool.{q,k,v,c}_proj``."""
    jc, params, model = rn_pair(seed=7)
    want = params_to_state_dict(jax.tree.map(jnp.asarray, params), jc)
    got = jax_params_to_state_dict(params, model.cfg)
    assert set(got) == set(want) == set(model.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    assert got["visual.layer1.0.bn1.num_batches_tracked"].dtype == torch.int64
    for key in ("visual.layer2.0.downsample.0.weight", "visual.layer2.0.downsample.1.running_var",
                "visual.attnpool.c_proj.weight", "visual.attnpool.positional_embedding", "visual.bn3.running_mean"):
        assert key in got


def test_init_mirrors_jax_init_resnet():
    """The port's seeded init draws what ``init_resnet`` draws: each
    bottleneck's bn3 scale 0, running stats 0 / 1, conv bounds (fan_in)^-1/2,
    the attention pool's table and projections std C^-1/2, biases 0."""
    cfg = tcfg.CLIPConfig(**RN)
    model = CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    v = model.visual
    for _, blk in v.blocks():
        assert torch.all(blk.bn3.weight == 0) and torch.all(blk.bn1.weight == 1)
    for bn in v.bn_sites().values():
        assert torch.all(bn.running_mean == 0) and torch.all(bn.running_var == 1) and torch.all(bn.bias == 0)
    bound = (v.conv2.in_channels * 9) ** -0.5
    assert v.conv2.weight.abs().max() <= bound and v.conv2.weight.abs().max() > 0.9 * bound
    c = cfg.vision_width * 32
    assert torch.all(v.attnpool.q_proj.bias == 0)
    assert abs(float(v.attnpool.k_proj.weight.detach().std()) - c**-0.5) < 0.1 * c**-0.5
    assert cfg.vision_heads == c // 64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_bn_gradient_is_autograd_of_the_chain(dtype):
    """The training BN's written-out backward (it keeps x, not three f32
    copies) against autograd of ``bn_normalize(x, *batch_moments(x))``:
    the same forward bits, gradients of x, scale and bias to 1e-5 (f32) /
    bf16 rounding of the same f32 values."""
    x = (torch.from_numpy(_x((3, 5, 4, 6), seed=12)) * 2 + 0.5).to(dtype)
    scale = torch.from_numpy(np.random.default_rng(13).uniform(0.5, 1.5, 6).astype(np.float32))
    bias = torch.from_numpy(np.random.default_rng(14).normal(0, 0.1, 6).astype(np.float32))
    g = torch.from_numpy(_x((3, 5, 4, 6), seed=15)).to(dtype)
    outs = []
    for fn in ("chain", "function"):
        xs, ss, bs = (t.clone().requires_grad_() for t in (x, scale, bias))
        if fn == "chain":
            y = tres.bn_normalize(xs, *tres.batch_moments(xs), ss, bs)
        else:
            y, _, _ = tres._BatchNormTrain.apply(xs, ss, bs, tres.BN_EPS)
        y.backward(g)
        outs.append((y.detach(), xs.grad, ss.grad, bs.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    for want, got in zip(outs[0][1:], outs[1][1:]):
        torch.testing.assert_close(got.float(), want.float(), **tol)
