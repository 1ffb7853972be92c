"""The port's checkpoint, calibration and bank tools
(``scripts/torch_convert_checkpoint.py``, ``torch_calibrate_int8.py``,
``torch_embed_dataset.py``) against the JAX package's, on the CPU at
``mixer-debug`` with JAX-initialised weights.

Bounds: a converted ``.pt`` gives JAX ``api.load`` the original params bit
for bit; calibration trees within 1e-6 relative of JAX's (about 8 f32
ulps, set from the reading: the same f32 chain summed in another order
reads at most 5 ulps, 4.5e-7 relative, with texts and 3 ulps without); bank
features within the JAX suite's atol 5e-5 / rtol 1e-3 (f32 compute), the
same ids and skip count. The JAX side of the bank is its ``scripts/embed_dataset.py``'s
``iter_tar_images`` feeding its ``InferenceEngine``, as its ``main`` does
(whose compilation cache setting would outlive the test).
"""

import importlib.util
import io
import json
import os
import tarfile
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from clip_mixer_tpu import api as japi
from clip_mixer_tpu.config import PRESETS as JAX_PRESETS
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.serving import InferenceEngine as JaxEngine

from clip_mixer_tpu_torch import CLIP, PRESETS, api, load_jax_params
from clip_mixer_tpu_torch.ops import quant_io
from clip_mixer_tpu_torch.serving import InferenceEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 5e-5, 1e-3
SCALE_RTOL = 1e-6


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX params as numpy, the port export of them)."""
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(0), JAX_PRESETS["mixer-debug"]))
    export = str(tmp_path_factory.mktemp("tools") / "export")
    api.save_pretrained(load_jax_params(CLIP(PRESETS["mixer-debug"], device="cpu"), params),
                        PRESETS["mixer-debug"], export)
    return params, export


def test_convert_to_torch_is_read_by_jax_as_the_params(weights, tmp_path):
    params, export = weights
    conv = _script("torch_convert_checkpoint")
    pt = str(tmp_path / "ref.pt")
    conv.main([export, pt, "--to", "torch", "--device", "cpu"])
    got, cfg, _ = japi.load(pt)
    assert cfg.tower == "mixer" and cfg.vision_width == PRESETS["mixer-debug"].vision_width
    flat, want = jax.tree_util.tree_flatten_with_path(got)[0], dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(flat) == len(want)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(leaf), want[path], err_msg=jax.tree_util.keystr(path))
    # and back: the .pt into a port export directory, weights bit for bit
    conv.main([pt, str(tmp_path / "again"), "--device", "cpu"])
    a, _, _ = api.load(str(tmp_path / "again"), device="cpu")
    b, _, _ = api.load(export, device="cpu")
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())


@pytest.mark.parametrize("texts", [False, True], ids=["synthetic_captions", "texts_file"])
def test_calibration_artifact_matches_jax(weights, tmp_path, texts):
    params, export = weights
    captions = None
    if texts:
        captions = str(tmp_path / "captions.txt")
        with open(captions, "w") as f:
            f.write("\n".join(f"a photo of a {w} thing" for w in ("red", "big", "old", "wet", "dark")))
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    model, cfg, _ = api.load(export, device="cpu")
    _script("torch_calibrate_int8").run(model, cfg, ours, texts=captions, n=24)
    _script("calibrate_int8").run(params, JAX_PRESETS["mixer-debug"], theirs, texts=captions, n=24)
    got, want = quant_io.load_calibration(ours), quant_io.load_calibration(theirs)
    assert got["cfg"] == want["cfg"]
    for side in ("image_scales", "text_scales"):
        a, b = jax.tree_util.tree_flatten_with_path(got[side])[0], jax.tree_util.tree_flatten_with_path(want[side])[0]
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=SCALE_RTOL, atol=0, err_msg=jax.tree_util.keystr(path))


def test_calibration_refuses_data(weights, tmp_path):
    """A ``--data`` glob that matches no shard exits, as JAX's tool does."""
    with pytest.raises(SystemExit, match="--data matched no shards: shards/\\*.tar"):
        _script("torch_calibrate_int8").main(["--model", weights[1], "--out", str(tmp_path / "s.npz"),
                                              "--data", "shards/*.tar", "--device", "cpu"])


def _png(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def _npy(img):
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def _write_tar(path, members):
    with tarfile.open(path, "w") as tar:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("input_size", [None, 40], ids=["model_sized", "input_size_40"])
def test_bank_matches_jax_embed_dataset(weights, tmp_path, input_size):
    """Two shards of PNG and ``.npy`` members and one corrupt member. The
    JAX tool reads ``.jpg`` names only, so its copy of the shards holds the
    ``.npy`` images PNG-encoded (lossless) under the same keys."""
    params, export = weights
    size = input_size or PRESETS["mixer-debug"].image_resolution
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (7, size + 5, size + 9, 3), dtype=np.uint8)
    npys = rng.integers(0, 256, (5, size, size, 3), dtype=np.uint8)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir(), jax_dir.mkdir()
    if input_size:  # raw decode: every source at N x N
        images = images[:, :size, :size].copy()
    for shard, (png_idx, npy_idx) in enumerate([(range(0, 4), range(0, 3)), (range(4, 7), range(3, 5))]):
        port_members, jax_members = [], []
        for i in png_idx:
            port_members.append((f"{i:04d}.jpg", _png(images[i])))
            port_members.append((f"{i:04d}.txt", b"a caption"))
        for j in npy_idx:
            port_members.append((f"n{j:03d}.npy", _npy(npys[j])))
            jax_members.append((f"n{j:03d}.jpg", _png(npys[j])))
        if shard == 1:
            port_members.append(("bad.jpg", b"\x89PNG truncated"))
        jax_members = [m for m in port_members if m[0].endswith((".jpg", ".txt"))] + jax_members
        _write_tar(str(port_dir / f"shard{shard}.tar"), port_members)
        _write_tar(str(jax_dir / f"shard{shard}.tar"), jax_members)

    out = str(tmp_path / "bank.npz")
    argv = ["--model", export, "--data", str(port_dir / "*.tar"), "--out", out, "--batch", "4", "--device", "cpu"]
    _script("torch_embed_dataset").main(argv + (["--input-size", str(input_size)] if input_size else []))

    jtool = _script("embed_dataset")
    hw = (input_size, input_size) if input_size else None
    jeng = JaxEngine(params, JAX_PRESETS["mixer-debug"], batch_buckets=(4,), input_hw=hw)
    skipped = []
    rows = list(jtool.iter_tar_images(sorted(str(p) for p in jax_dir.glob("*.tar")), size, skipped=skipped,
                                      raw_hw=hw))
    want = jeng.encode_image_arrays(np.stack([img for _, img in rows]))

    with np.load(out) as z:
        ids, feats = [str(s) for s in z["ids"]], z["features"]
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
    assert sorted(ids) == sorted(i for i, _ in rows) and len(ids) == 12
    order = {i: n for n, (i, _) in enumerate(rows)}
    np.testing.assert_allclose(feats, want[[order[i] for i in ids]], atol=ATOL, rtol=RTOL)
    assert len(skipped) == 1 and skipped[0] == "shard1/bad.jpg"
    assert meta["path"] == "float" and meta["input_hw"] == (None if hw is None else list(hw))
    assert meta["cfg"] == quant_io._cfg_dict(PRESETS["mixer-debug"])
    engine = InferenceEngine(api.load(export, device="cpu")[0], input_hw=hw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a bank of this model, path and input size: no provenance warning
        engine.load_index_file(out)
    jeng.load_index_file(out)  # the JAX server reads it too
