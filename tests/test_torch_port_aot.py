"""Frozen serving programs of the port (clip_mixer_tpu_torch/aot.py), on the
CPU, on the model of tests/test_aot.py.

Contract: ``export_servable`` writes a ``save_pretrained`` superset whose
recorded ``torch.export`` programs answer bit for bit as the live engine on
the same weights (JAX-converted, ``load_jax_params``) and route, and as the
JAX package's frozen programs on those weights within the bounds of
``test_torch_port_serving.py`` (f32 atol 5e-5 / rtol 1e-3) and
``test_torch_port_quant_serving.py`` (int8 per-row cosine >= 0.99999); a
program takes the weights as its input and holds none; the kernels'
operators are one node each in it (on the CPU their plain bodies run)."""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from clip_mixer_tpu import aot as jaot
from clip_mixer_tpu.config import CLIPConfig as JaxConfig
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.serving import InferenceEngine as JaxEngine

from clip_mixer_tpu_torch import CLIP, CLIPConfig, aot, load_jax_params
from clip_mixer_tpu_torch.api import load
from clip_mixer_tpu_torch.config import TrainConfig
from clip_mixer_tpu_torch.data.pipeline import SyntheticSource
from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
from clip_mixer_tpu_torch.serving import InferenceEngine
from clip_mixer_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
CFG = dict(
    embed_dim=16,
    image_resolution=32,
    vision_layers=2,
    vision_width=32,
    vision_patch_size=16,
    context_length=16,
    vocab_size=49408,
    text_width=32,
    text_heads=1,
    text_layers=2,
    tower="mixer",
    compute_dtype="float32",
)
TEXTS = ["a cat", "two dogs", "a diagram"]
ATOL, RTOL = 5e-5, 1e-3  # the f32 engine against JAX's, test_torch_port_serving.py
INT8_COSINE = 0.99999  # int8 features from one artifact in both packages, test_torch_port_quant_serving.py
# the manifest keys both packages write
SHARED_KEYS = ("version", "buckets", "int8", "platforms", "mesh", "input_hw")
OPS = {"plain": None, "fused_mlp": "clip_mixer.ln_mlp.default", "fused_block": "clip_mixer.mixer_block.default"}


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jclip.init(jax.random.key(0), JaxConfig(**CFG)))


def _model(jax_params, route="plain"):
    model = load_jax_params(CLIP(CLIPConfig(**CFG).replace(fused_mlp=route == "fused_mlp"), device="cpu"), jax_params)
    if route == "fused_block":
        route_towers(model, True)
    return model


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


# each route's export: the plain one with two buckets, the kernel routes with one
BUCKETS = {"plain": (4, 8), "fused_mlp": (8,), "fused_block": (8,)}


@pytest.fixture(scope="module")
def exports(jax_params, tmp_path_factory):
    """One float export a route: {route: (model, dir)}."""
    root = tmp_path_factory.mktemp("aot")
    out = {}
    for route in OPS:
        model = _model(jax_params, route)
        out[route] = (model, aot.export_servable(model, str(root / route), batch_buckets=BUCKETS[route]))
    return out


@pytest.fixture(scope="module")
def frozen(exports):
    """{route: the load_servable engine of its export}, for tests that leave it as it is."""
    return {route: aot.load_servable(out, device="cpu") for route, (_, out) in exports.items()}


@pytest.mark.parametrize("route", sorted(OPS))
def test_float_export_matches_live_engine(exports, frozen, route):
    model, out = exports[route]
    eng = frozen[route]
    live = InferenceEngine(model, batch_buckets=BUCKETS[route])
    assert aot.serving_route(eng.model) == route and eng.frozen
    imgs = _images(6)  # pads to bucket 8
    got_i, got_t = eng.encode_image_arrays(imgs), eng.encode_text(TEXTS)
    assert np.all(np.isfinite(got_i)) and np.all(np.isfinite(got_t))
    np.testing.assert_array_equal(got_i, live.encode_image_arrays(imgs))
    np.testing.assert_array_equal(got_t, live.encode_text(TEXTS))
    big = _images(11, seed=1)  # two calls: 8, then 3 padded
    np.testing.assert_array_equal(eng.encode_image_arrays(big), live.encode_image_arrays(big))

    # the directory stays a checkpoint of the same weights
    loaded, cfg, _ = load(out, device="cpu")
    assert cfg == model.cfg
    want = model.state_dict()
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, want[k], atol=0, rtol=0)


@pytest.mark.parametrize("route", sorted(OPS))
def test_programs_hold_the_kernel_operators_and_no_weights(exports, route):
    model, out = exports[route]
    weights = {tuple(v.shape) for v in model.state_dict().values() if v.numel() > 3}
    n_params = sum(v.numel() for v in model.state_dict().values())
    paths = sorted((Path(out) / "servable").glob("*.pt2"))
    assert [p.stem for p in paths] == sorted(f"{m}_{b}" for m in ("image", "text") for b in BUCKETS[route])
    for path in paths:
        name = path.stem
        ep = torch.export.load(str(path))
        assert ep.state_dict == {}
        # the constants are the normalisation's mean and std, nothing shaped like a weight
        assert all(tuple(c.shape) not in weights for c in ep.constants.values() if isinstance(c, torch.Tensor))
        assert path.stat().st_size < 4 * n_params  # an f32 copy of the weights would not fit
        targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
        layers = CFG["vision_layers"] if name.startswith("image") else CFG["text_layers"]
        for op in filter(None, OPS.values()):
            assert targets.count(op) == (layers if op == OPS[route] else 0), (route, name, op)


@pytest.fixture(scope="module")
def jax_frozen(jax_params, tmp_path_factory):
    """The JAX package's frozen programs of the same weights: the float
    ones at the plain route's buckets, and int8 ones at bucket 8 on an
    artifact of both towers written by JAX's engine."""
    root = tmp_path_factory.mktemp("jax_aot")
    jc = JaxConfig(**CFG)
    jaot.export_servable(jax_params, jc, str(root / "float"), batch_buckets=BUCKETS["plain"])
    calib = str(root / "scales.npz")
    JaxEngine(jax_params, jc, batch_buckets=(8,)).enable_int8(_images(8, seed=3), TEXTS, save_calibration=calib)
    jaot.export_servable(jax_params, jc, str(root / "int8"), batch_buckets=(8,), int8_calibration=calib)
    return {"float": str(root / "float"), "int8": str(root / "int8"), "calibration": calib}


def _cosine(a, b):
    return np.sum(a * b, axis=-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("route", sorted(OPS))
def test_float_programs_match_jax_programs(exports, frozen, jax_frozen, route):
    jeng = jaot.load_servable(jax_frozen["float"])
    eng = frozen[route]
    for n in (3, 6):  # bucket 4 and 8 in JAX's, 8 in a kernel route's
        imgs = _images(n, seed=10 + n)
        np.testing.assert_allclose(eng.encode_image_arrays(imgs), jeng.encode_image_arrays(imgs), atol=ATOL, rtol=RTOL)
        texts = (TEXTS * 2)[:n]
        np.testing.assert_allclose(eng.encode_text(texts), jeng.encode_text(texts), atol=ATOL, rtol=RTOL)
    m = aot.read_manifest(exports[route][1])
    jm = json.loads((Path(jax_frozen["float"]) / "servable" / "manifest.json").read_text())
    got = {k: m[k] for k in SHARED_KEYS}
    assert got == {**{k: jm[k] for k in SHARED_KEYS}, "buckets": list(BUCKETS[route])}
    assert jm["buckets"] == list(BUCKETS["plain"]) and m["route"] == route


def test_int8_programs_match_jax_programs(jax_params, jax_frozen, tmp_path):
    """JAX's artifact frozen by both packages: the port's programs read it
    as JAX's do, and their manifests agree."""
    out = str(tmp_path / "srv8")
    aot.export_servable(_model(jax_params), out, batch_buckets=(8,), int8_calibration=jax_frozen["calibration"])
    eng, jeng = aot.load_servable(out, device="cpu"), jaot.load_servable(jax_frozen["int8"])
    assert eng.path_kinds == jeng.path_kinds == {"image": "int8", "text": "int8"}
    imgs = _images(7, seed=4)
    for got, want in ((eng.encode_image_arrays(imgs), jeng.encode_image_arrays(imgs)),
                      (eng.encode_text(TEXTS), jeng.encode_text(TEXTS))):
        assert np.all(np.isfinite(got)) and got.shape == want.shape
        assert _cosine(got, want).min() >= INT8_COSINE
    m, jm = aot.read_manifest(out), json.loads((Path(jax_frozen["int8"]) / "servable" / "manifest.json").read_text())
    assert {k: m[k] for k in SHARED_KEYS} == {k: jm[k] for k in SHARED_KEYS}
    assert (Path(out) / "servable" / "calibration.npz").read_bytes() == Path(jax_frozen["calibration"]).read_bytes()


def test_programs_check_their_inputs_once_per_state_and_shape(exports, monkeypatch):
    """torch.export's check of a call's inputs against the recorded spec
    runs on a program's first call, and again for a new batch shape or a
    new state (another dict, or the same dict holding another tensor), but
    not on a repeat; a checked call with a misshapen weight raises."""
    from torch.export import _unlift

    checks = []
    for name in ("_check_input_constraints_for_module", "_check_inputs_match"):
        real = getattr(_unlift, name)
        monkeypatch.setattr(_unlift, name, lambda *a, real=real, **kw: (checks.append(1), real(*a, **kw))[1])

    def checked(state, x):
        before = len(checks)
        out = fn(state, x)
        return len(checks) > before, out

    fn, state = aot.load_servable(exports["plain"][1], device="cpu")._image_path
    x8, x4 = torch.from_numpy(_images(8)), torch.from_numpy(_images(4))
    first, want = checked(state, x8)
    assert first
    again, got = checked(state, x8)
    assert not again
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert checked(state, x4)[0] and not checked(state, x4)[0]
    other = dict(state)
    assert checked(other, x8)[0] and not checked(other, x8)[0]
    key = next(k for k, v in other.items() if v.ndim == 2)
    other[key] = other[key].clone()
    assert checked(other, x8)[0]
    other[key] = other[key][:, :1]
    n = len(checks)
    with pytest.raises(RuntimeError, match="Expected input"):
        fn(other, x8)
    assert len(checks) > n


def test_frozen_engine_runs_no_model_code(frozen, monkeypatch):
    eng = frozen["fused_block"]
    want = eng.encode_text(TEXTS)

    def refuse(*a, **kw):
        raise AssertionError("the frozen engine traced model code")

    monkeypatch.setattr(CLIP, "encode_text", refuse)
    monkeypatch.setattr(CLIP, "encode_image", refuse)
    np.testing.assert_array_equal(eng.encode_text(TEXTS), want)
    assert eng.encode_image_arrays(_images(2)).shape == (2, CFG["embed_dim"])


def test_int8_export_matches_live_int8(jax_params, tmp_path):
    imgs = _images(8, seed=3)
    texts = ["a photo of a cat", "a dog"]
    calib = str(tmp_path / "scales.npz")
    model = _model(jax_params)
    direct = InferenceEngine(model, batch_buckets=(8,))
    direct.enable_int8(imgs, sample_texts=texts, save_calibration=calib)

    out = str(tmp_path / "srv8")
    aot.export_servable(model, out, batch_buckets=(8,), int8_calibration=calib)
    frozen = aot.load_servable(out, device="cpu")
    assert frozen.path_kinds == {"image": "int8", "text": "int8"} and frozen.frozen
    assert (Path(out) / "servable" / "calibration.npz").read_bytes() == Path(calib).read_bytes()
    want_i, want_t = direct.encode_image_arrays(imgs), direct.encode_text(texts)
    assert np.all(np.isfinite(want_i)) and np.all(np.isfinite(want_t))
    np.testing.assert_array_equal(frozen.encode_image_arrays(imgs), want_i)
    np.testing.assert_array_equal(frozen.encode_text(texts), want_t)
    # the same artifact through enable_int8(calibration=) on a live engine
    live = InferenceEngine(_model(jax_params), batch_buckets=(8,))
    live.enable_int8(calibration=calib)
    np.testing.assert_array_equal(frozen.encode_text(texts), live.encode_text(texts))


def test_int8_export_needs_both_towers(jax_params, tmp_path):
    model = _model(jax_params)
    calib = str(tmp_path / "img_only.npz")
    InferenceEngine(model, batch_buckets=(4,)).enable_int8(_images(4), save_calibration=calib)
    with pytest.raises(ValueError, match="BOTH towers"):
        aot.export_servable(model, str(tmp_path / "x"), int8_calibration=calib)
    assert not (tmp_path / "x").exists()  # refused before the checkpoint write


def test_load_servable_rejects_plain_checkpoint(jax_params, tmp_path):
    from clip_mixer_tpu_torch.api import save_pretrained

    model = _model(jax_params)
    save_pretrained(model, model.cfg, str(tmp_path / "plain"))
    with pytest.raises(FileNotFoundError, match="servable"):
        aot.load_servable(str(tmp_path / "plain"), device="cpu")


def test_manifest_versioning(exports, tmp_path):
    """Plain exports stay version 1; input_hw exports write version 2 and
    serve at that input size; an unknown version fails."""
    model, plain = exports["plain"]
    m = json.loads((Path(plain) / "servable" / "manifest.json").read_text())
    assert m["version"] == 1 and m["platforms"] == ["cpu"] and m["route"] == "plain" and m["mesh"] is None
    assert m["torch_version"] == torch.__version__ and m["input_hw"] is None and m["buckets"] == [4, 8]

    ihw = str(tmp_path / "ihw")
    aot.export_servable(model, ihw, batch_buckets=(4,), input_hw=(40, 48))
    m2 = json.loads((Path(ihw) / "servable" / "manifest.json").read_text())
    assert m2["version"] == 2 and m2["input_hw"] == [40, 48]
    eng = aot.load_servable(ihw, device="cpu")
    assert eng.input_hw == (40, 48)
    src = np.random.default_rng(4).integers(0, 256, (3, 40, 48, 3), dtype=np.uint8)
    live = InferenceEngine(model, batch_buckets=(4,), input_hw=(40, 48))
    np.testing.assert_array_equal(eng.encode_image_arrays(src), live.encode_image_arrays(src))

    m2["version"] = 3
    (Path(ihw) / "servable" / "manifest.json").write_text(json.dumps(m2))
    with pytest.raises(ValueError, match="manifest version"):
        aot.load_servable(ihw, device="cpu")


def test_platforms_and_mesh(jax_params, tmp_path):
    """platforms= takes only the exporting device's type; mesh= only
    devices of that type (tests/test_torch_port_mesh.py runs the mesh
    programs); a device type the programs were not recorded for is refused
    at load unless check_platform=False."""
    model = _model(jax_params)
    with pytest.raises(ValueError, match="recorded on the exporting process's device"):
        aot.export_servable(model, str(tmp_path / "x"), batch_buckets=(2,), platforms=("cuda",))
    with pytest.raises(ValueError, match="mesh= must list devices of the model's type"):
        aot.export_servable(model, str(tmp_path / "y"), batch_buckets=(2,), mesh=["cpu", "cuda"])
    assert not (tmp_path / "x").exists() and not (tmp_path / "y").exists()
    out = str(tmp_path / "cpu")
    aot.export_servable(model, out, batch_buckets=(2,), platforms=("cpu",))
    mpath = Path(out) / "servable" / "manifest.json"
    m = json.loads(mpath.read_text())
    m["platforms"] = ["cuda"]
    mpath.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="recorded for"):
        aot.load_servable(out, device="cpu")
    assert aot.load_servable(out, device="cpu", check_platform=False).buckets == [2]


def test_enable_int8_on_frozen_engine_clears_provenance(exports):
    eng = aot.load_servable(exports["fused_mlp"][1], device="cpu")
    assert eng.frozen is True and eng.path_kinds == {"image": "float", "text": "float"}
    eng.enable_int8(_images(4))
    assert eng.frozen is False and eng.path_kinds["image"] == "int8"


def test_trainer_freeze_serving(tmp_path, monkeypatch):
    """TrainConfig.freeze_serving: the completion export holds programs
    that load_servable serves, fed the exported (EMA) weights. The trainer
    records the default buckets; here they are cut to (1,) to keep the test
    short, and the call is checked to have asked for the defaults."""
    calls = []
    real = aot.freeze_programs

    def spy(model, out_dir, **kw):
        calls.append(kw)
        return real(model, out_dir, **{**kw, "batch_buckets": (1,)})

    monkeypatch.setattr(aot, "freeze_programs", spy)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # as on the card's host (and seconds of TensorFlow here)
    cfg = CLIPConfig(**CFG)
    data = SyntheticSource(batch_size=4, image_size=32, n_batches=2, n_classes=4, context_length=16)
    tcfg = TrainConfig(global_batch_size=4, epochs=1, learning_rate=1e-3, warmup_steps=1,
                       checkpoint_every_steps=2, freeze_serving=True, ema_decay=0.5)
    run = str(tmp_path / "run")
    Trainer(cfg, tcfg, data, run, device="cpu").train()
    eng = aot.load_servable(f"{run}/export", device="cpu")
    m = json.loads((Path(run) / "export" / "servable" / "manifest.json").read_text())
    assert calls == [{}] and m["buckets"] == [1] and not m["int8"]
    feats = eng.encode_text(["a red square"])
    assert feats.shape == (1, CFG["embed_dim"]) and np.all(np.isfinite(feats))
    exported, _, _ = load(f"{run}/export", device="cpu")
    np.testing.assert_array_equal(feats, InferenceEngine(exported, batch_buckets=(1,)).encode_text(["a red square"]))


def test_export_cli(jax_params, tmp_path):
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_export_servable as cli
    from clip_mixer_tpu_torch.api import save_pretrained

    model = _model(jax_params, "fused_mlp")
    src = str(tmp_path / "src")
    save_pretrained(model, model.cfg, src)
    out = str(tmp_path / "out")
    cli.main(["--model", src, "--out", out, "--buckets", "2", "--device", "cpu"])
    eng = aot.load_servable(out, device="cpu")
    assert aot.read_manifest(out)["route"] == "fused_mlp" and aot.serving_route(eng.model) == "fused_mlp"
    feats = eng.encode_text(["hello world"])
    assert feats.shape == (1, CFG["embed_dim"]) and np.all(np.isfinite(feats))
    # --all-devices records the layout of the devices this host sees: the one CPU
    cli.main(["--model", src, "--out", str(tmp_path / "x"), "--buckets", "2", "--all-devices", "--device", "cpu"])
    assert aot.read_manifest(str(tmp_path / "x"))["mesh"] == {"axis_names": ["data"], "shape": [1]}
    assert aot.load_servable(str(tmp_path / "x"), device="cpu").encode_text(["hello world"]).shape == feats.shape
    with pytest.raises(SystemExit, match="records the layout from THIS host"):
        cli.main(["--model", src, "--out", str(tmp_path / "y"), "--all-devices", "--platforms", "cpu", "--device", "cpu"])
    shutil.rmtree(out)
