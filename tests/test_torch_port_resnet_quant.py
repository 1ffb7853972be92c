"""The port's int8 ResNet tower (``clip_mixer_tpu_torch/ops/quant.py``'s
``fold_bn_into_conv``, ``quantize_conv_weight``, ``int8_conv``,
``quantize_resnet_tower``, ``encode_image_rn_q``,
``calibrate_resnet_tower``) against the JAX package's, on the CPU.

Configs are ``tests/test_torch_port_resnet.py``'s (``vision_layers=(1, 1,
1, 1)``, width 16, 64 px, every BN site perturbed from a numpy seed).
Bounds:

* ``int8_conv``'s int32 sums: JAX's ``conv_general_dilated`` with
  ``preferred_element_type=int32``, exactly, at stride 1 / 2 and padding
  0 / 1 (and the stem's K = 27, padded to 32); its dequantised output bit
  for bit;
* the BN fold: conv + BN at atol 1e-5 (JAX ``test_bn_fold_exact``);
* calibration trees: the site on the images themselves within 1 ulp of
  JAX's (``jnp.quantile`` interpolates otherwise than ``numpy.quantile``,
  which the port's ``quantile`` is bit for bit), every site within 4 ulps
  (read at most 2 over three seeds: the activations carry the two
  libraries' convolution summation orders);
* the port's quantisation of JAX's folded kernels: JAX's int8 packs bit
  for bit; of its own folds (``torch.rsqrt`` and XLA's CPU rsqrt each sit
  within 1 ulp of the exact value, on either side): at most one weight a
  site one step away, scales within 4 ulps, folded biases at atol 1e-6;
* the int8 features on JAX's qparams: per-row cosine >= 0.99999 in f32,
  >= 0.999 in bf16; a planted fault (one conv's folded bias zeroed, the
  input scale applied twice) fails the f32 bound;
* an artifact written by either package serves in the other, and the gate
  counts JAX's flips.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.evals import quant_gate as jgate
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.models import resnet as jres
from clip_mixer_tpu.ops import quant as jq
from clip_mixer_tpu.ops import quant_io as jax_quant_io
from clip_mixer_tpu.ops.preprocess import normalize_images as jax_normalize
from clip_mixer_tpu.serving import InferenceEngine as JaxEngine

from clip_mixer_tpu_torch import CLIP, CLIPConfig, load_jax_params
from clip_mixer_tpu_torch.evals import quant_gate as tgate
from clip_mixer_tpu_torch.models import resnet as tres
from clip_mixer_tpu_torch.models.convert import load_jax_qparams
from clip_mixer_tpu_torch.ops import quant as tq
from clip_mixer_tpu_torch.ops import quant_io
from clip_mixer_tpu_torch.serving import InferenceEngine, encoder_fns

RN = dict(embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=16, vision_patch_size=None,
          context_length=12, vocab_size=256, text_width=64, text_heads=1, text_layers=1, tower="transformer",
          compute_dtype="float32")
SERVE = dict(RN, context_length=77, vocab_size=49408)  # the engine and gate tests tokenize captions
F32_COSINE = 0.99999
BF16_COSINE = 0.999
TEXTS = [f"a {a} photo of a {b}" for a in ("small", "dark", "bright") for b in ("cat", "dog", "car", "tree")]
CLASSNAMES = ["cat", "dog", "car", "tree", "house", "bird", "boat", "chair"]
TEMPLATES = ["a photo of a {}.", "an image of a {}."]
COUNTS = ("n", "flips_bf16", "flips_int8", "passed")


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


def _pair(dtype="float32", seed=0, cfg=RN):
    cfg = dict(cfg, compute_dtype=dtype)
    jc = jcfg.CLIPConfig(**cfg)
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(seed), jc))
    params["visual"] = perturb_bn(params["visual"], seed)
    return jc, params, load_jax_params(CLIP(CLIPConfig(**cfg), device="cpu"), params)


def _images(n=6, seed=3):
    return np.random.default_rng(seed).normal(0, 1, (n, 64, 64, 3)).astype(np.float32)


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


# ---- the int8 convolution -------------------------------------------------------------


@pytest.mark.parametrize("k,cin,stride,padding", [(3, 3, 2, 1), (3, 8, 1, 1), (3, 8, 2, 0), (3, 8, 1, 0),
                                                  (1, 16, 1, 0)],
                         ids=["stem_k27", "s1p1", "s2p0", "s1p0", "1x1"])
def test_int8_conv_sums_equal_jax(k, cin, stride, padding):
    rng = np.random.default_rng(k * 100 + cin + stride + padding)
    xq = rng.integers(-127, 128, (2, 9, 10, cin)).astype(np.int8)
    q = rng.integers(-127, 128, (k, k, cin, 24)).astype(np.int8)  # HWIO
    want = jax.lax.conv_general_dilated(jnp.asarray(xq), jnp.asarray(q), (stride, stride), [(padding, padding)] * 2,
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        preferred_element_type=jnp.int32)
    q_port = tq.pad_k(torch.from_numpy(q.reshape(-1, 24).T.copy()))  # [out, kh kw cin], K padded to 8
    assert q_port.shape[1] % 8 == 0
    got = tq.conv_sums(torch.from_numpy(xq), q_port, k, stride, padding)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # the whole int8_conv on the same pack: quantise, sums, dequantise, bit for bit
    x = rng.normal(0, 1, (2, 9, 10, cin)).astype(np.float32)
    a = np.float32(np.abs(x).max() / 127.0)
    scale = rng.uniform(1e-3, 2e-3, 24).astype(np.float32)
    bias = rng.normal(0, 0.1, 24).astype(np.float32)
    cp = {"q": jnp.asarray(q), "scale": jnp.asarray(scale), "a": jnp.asarray(a), "bias": jnp.asarray(bias)}
    want = jq.int8_conv(jnp.asarray(x), cp, stride, padding, out_dtype=jnp.float32)
    qc = torch.nn.Module()
    qc.q, qc.scale, qc.bias, qc.a, qc.kernel_size = q_port, *map(torch.from_numpy, (scale, bias, np.asarray(a))), k
    got = tq.int8_conv(torch.from_numpy(x), qc, stride, padding, out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bn_fold_exact():
    """Folded conv + bias equals conv followed by inference BN, and the
    fold is JAX's."""
    _, params, model = _pair(seed=3)
    v = model.visual
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (2, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        want = v.bn1(tres.conv(v.conv1.weight, x, stride=2, padding=1))
        kernel, bias = tq.fold_bn_into_conv(v.conv1.weight, v.bn1)
        got = tres.conv(kernel, x, stride=2, padding=1) + bias
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    jk, jb = jq.fold_bn_into_conv(jax.tree.map(jnp.asarray, params["visual"]["conv1"]),
                                  jax.tree.map(jnp.asarray, params["visual"]["bn1"]))
    np.testing.assert_allclose(kernel.numpy(), np.asarray(jk).transpose(3, 2, 0, 1), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bias.numpy(), np.asarray(jb), atol=1e-6, rtol=1e-6)


# ---- calibration, the packs, the encoder -----------------------------------------------


def test_calibration_tree_matches_jax():
    jc, params, model = _pair(seed=5)
    imgs = _images(seed=5)
    want = jq.calibrate_resnet_tower(jax.tree.map(jnp.asarray, params), jc, jnp.asarray(imgs))
    got = tq.calibrate_resnet_tower(model, torch.from_numpy(imgs))
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), got))
    assert set(got["layer2"][0]) == {"conv1", "conv2", "conv3", "downsample"}
    np.testing.assert_array_max_ulp(got["conv1"].numpy(), np.asarray(want["conv1"]), maxulp=1)
    for g, w in zip(_leaves(jax.tree.map(lambda t: t.numpy(), got)), _leaves(want)):
        np.testing.assert_array_max_ulp(g, w, maxulp=4)


def _qtree(params, jc, imgs):
    scales = jq.calibrate_resnet_tower(jax.tree.map(jnp.asarray, params), jc, jnp.asarray(imgs))
    return scales, jax.tree.map(np.asarray, jq.quantize_resnet_tower(jax.tree.map(jnp.asarray, params), jc, scales))


def test_quantized_convs_equal_jax_quantize():
    """The port's quantisation of JAX's folded kernels gives JAX's int8
    kernels and weight scales bit for bit; its own folds land where the
    two libraries' rsqrt lets them; the activation scales are the tree's."""
    jc, params, model = _pair(seed=6)
    scales, qtree = _qtree(params, jc, _images(seed=6))
    jv, jt = load_jax_qparams(model, qtree)
    assert jt is None and isinstance(jv, tq.QuantResNet)
    jp = jax.tree.map(jnp.asarray, params["visual"])
    sites = [(jp[f"conv{i}"], jp[f"bn{i}"]) for i in (1, 2, 3)]
    for i in range(1, 5):
        sites += [(bp[c], bp[f"bn{c[-1]}"]) for bp in jp[f"layer{i}"] for c in ("conv1", "conv2", "conv3")]
    for conv_p, bn_p in sites:
        kernel, _ = jq.fold_bn_into_conv(conv_p, bn_p)
        want = jq.quantize_conv_weight(kernel)
        got = tq.quantize_conv_weight(torch.from_numpy(np.asarray(kernel).transpose(3, 2, 0, 1).copy()))
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    mine = tq.quantize_resnet_tower(model, jax.tree.map(np.asarray, scales))
    want = dict(jv.named_buffers())
    assert set(dict(mine.named_buffers())) == set(want)
    assert {"conv1.q", "layer2.0.downsample.q", "layer4.0.conv3.scale", "layer1.0.conv2.a"} <= set(want)
    assert mine.conv1.q.shape == (8, 32)  # the stem's K = 27, padded to 32
    for name, buf in mine.named_buffers():
        got, ref = buf.numpy(), want[name].numpy()
        if name.endswith(".q"):
            steps = np.abs(got.astype(np.int32) - ref)
            assert steps.max() <= 1 and (steps > 0).sum() <= 1, name
        elif name.endswith(".scale"):
            np.testing.assert_array_max_ulp(got, ref, maxulp=4)
        elif name.endswith(".bias"):
            np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
    assert mine.attnpool is model.visual.attnpool
    for g, w in zip(_leaves(jax.tree.map(lambda t: t.numpy(), mine.a_scales())), _leaves(scales)):
        np.testing.assert_array_equal(g, w)


def _zero_a_bias(q):
    q.layer3[0].conv2.bias.zero_()


def _scale_twice(monkeypatch):
    real = tq.quantize_activation
    monkeypatch.setattr(tq, "quantize_activation", lambda x, s: real(tq.true_div(x, s), s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_features_match_jax(dtype):
    jc, params, model = _pair(dtype, seed=7)
    imgs = _images(seed=7)
    _, qtree = _qtree(params, jc, imgs)
    qvis, _ = load_jax_qparams(model, qtree)
    calibrate, quantize, encode = tq.image_quant_fns(model.cfg)
    assert encode is tq.encode_image_rn_q and calibrate is tq.calibrate_resnet_tower
    want = np.asarray(jq.encode_image_rn_q(jax.tree.map(jnp.asarray, qtree), jc, jnp.asarray(imgs)), np.float32)
    got = encode(qvis, torch.from_numpy(imgs))
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    cos = _cosine(got.float().numpy(), want)
    assert cos.min() >= (F32_COSINE if dtype == "float32" else BF16_COSINE), cos
    # and against the float tower (JAX test_resnet_int8_fidelity's bound)
    with torch.no_grad():
        assert _cosine(got.float().numpy(), model.encode_image(torch.from_numpy(imgs)).float().numpy()).min() > 0.99


@pytest.mark.parametrize("fault", ["zeroed_bias", "input_scale_twice"])
def test_planted_int8_faults_fail_the_f32_bound(fault, monkeypatch):
    jc, params, model = _pair(seed=7)
    imgs = _images(seed=7)
    _, qtree = _qtree(params, jc, imgs)
    qvis, _ = load_jax_qparams(model, qtree)
    want = np.asarray(jq.encode_image_rn_q(jax.tree.map(jnp.asarray, qtree), jc, jnp.asarray(imgs)), np.float32)
    if fault == "zeroed_bias":
        _zero_a_bias(qvis)
    else:
        _scale_twice(monkeypatch)
    cos = _cosine(tq.encode_image_rn_q(qvis, torch.from_numpy(imgs)).numpy(), want)
    assert cos.min() < F32_COSINE, cos.min()


# ---- the engine, the artifacts, the gates --------------------------------------------


@pytest.fixture(scope="module")
def serve_weights():
    jc = jcfg.CLIPConfig(**SERVE)
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(0), jc))
    params["visual"] = perturb_bn(params["visual"], 0)
    return jc, params


def _u8(n, seed):
    return tgate.synthetic_images(n, 64, seed=seed)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_rn_artifact_of_either_package_serves_in_the_other(serve_weights, tmp_path, writer):
    """The RN scale tree (per-stage lists of per-block dicts) round-trips
    through either package's ``.npz``; both engines then serve the image
    tower int8 from it, and the text tower (a transformer) int8 too."""
    jc, params = serve_weights
    path = str(tmp_path / f"{writer}.npz")
    eng = InferenceEngine(load_jax_params(CLIP(CLIPConfig(**SERVE), device="cpu"), params), batch_buckets=(2, 4))
    jeng = JaxEngine(params, jc, batch_buckets=(2, 4))
    first, second = (jeng, eng) if writer == "jax" else (eng, jeng)
    first.enable_int8(_u8(8, seed=0), TEXTS, save_calibration=path)
    second.enable_int8(calibration=path)
    assert eng.path_kinds == {"image": "int8", "text": "int8"}
    assert isinstance(eng._image_path[1], tq.QuantResNet) and isinstance(eng._text_path[1], tq.QuantTextTower)
    art, jart = quant_io.load_calibration(path), jax_quant_io.load_calibration(path)
    assert art["cfg"] == jart["cfg"] and isinstance(art["image_scales"]["layer1"], list)
    for g, w in zip(_leaves(art["image_scales"]), _leaves(jart["image_scales"])):
        np.testing.assert_array_equal(g, w)
    assert jax.tree.structure(art["image_scales"]) == jax.tree.structure(jart["image_scales"])
    imgs = _u8(5, seed=3)
    for got, want in ((eng.encode_image_arrays(imgs), jeng.encode_image_arrays(imgs)),
                      (eng.encode_text(TEXTS[:5]), jeng.encode_text(TEXTS[:5]))):
        assert _cosine(got, want).min() >= F32_COSINE
    if writer == "port":  # the reload serves the same bits as the engine that wrote it
        again = InferenceEngine(eng.model, batch_buckets=(2, 4))
        again.enable_int8(calibration=path)
        np.testing.assert_array_equal(again.encode_image_arrays(imgs), eng.encode_image_arrays(imgs))


def test_rn_int8_engine_with_input_hw_takes_the_float_front_end(serve_weights):
    """An int8 ResNet engine on uint8 at another resolution resizes in float
    and runs the int8 tower, as JAX's ``encoder_fns`` (the planar front end
    is the Mixer's)."""
    jc, params = serve_weights
    model = load_jax_params(CLIP(CLIPConfig(**SERVE), device="cpu"), params)
    eng = InferenceEngine(model, batch_buckets=(4,), input_hw=(80, 72))
    u8 = np.random.default_rng(5).integers(0, 256, (3, 80, 72, 3), dtype=np.uint8)
    before = eng.encode_image_arrays(u8)
    eng.enable_int8(np.random.default_rng(6).integers(0, 256, (4, 80, 72, 3), dtype=np.uint8))
    assert eng.path_kinds == {"image": "int8", "text": "float"}
    qvis = eng._image_path[1]
    image_fn = encoder_fns(model.cfg, int8=True, input_hw=(80, 72))[0]
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess

    pre = make_batch_preprocess((80, 72), 64, normalize=True, dtype=torch.float32)
    with torch.inference_mode():
        np.testing.assert_array_equal(image_fn(qvis, torch.from_numpy(u8)).numpy(),
                                      tgate.l2_normalize(tq.encode_image_rn_q(qvis, pre(torch.from_numpy(u8)))).numpy())
    assert _cosine(eng.encode_image_arrays(u8), before).min() > 0.99


def test_image_noise_floor_gate_counts_match_jax(serve_weights):
    """The RN image gate runs through the float front end and counts JAX's
    flips; the planar front-end gate refuses a ResNet, as JAX's does."""
    jc, params = serve_weights
    model = load_jax_params(CLIP(CLIPConfig(**SERVE), device="cpu"), params)
    imgs = tgate.synthetic_images(24, 64, seed=3)
    w = jgate.build_float_classifier(params, jc, CLASSNAMES, TEMPLATES)
    got = tgate.noise_floor_gate(model, imgs, w, calibrate_n=8, batch_size=8)
    want = jgate.noise_floor_gate(params, jc, imgs, w, calibrate_n=8, batch_size=8)
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}, (got, want)
    assert got["flip_ratio"] == pytest.approx(want["flip_ratio"], rel=1e-12)
    with pytest.raises(ValueError, match="Mixer towers"):
        tgate.frontend_noise_floor_gate(model, _u8(8, seed=1), w, front_end="nhwc")
    jbank = np.asarray(jclip.l2_normalize(jclip.encode_image(params, jc, jax_normalize(imgs[:8], dtype="float32"))))
    assert np.isfinite(jbank).all()
