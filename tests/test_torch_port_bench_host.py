"""The port's host-side measuring scripts (``scripts/torch_bench_tokenizer.py``,
``torch_bench_input.py``, ``torch_bench_transfer.py``,
``torch_plot_results.py``) and the int8 front-end variants
(``torch_bench_frontend_variants.py``) against the JAX package's, on the
CPU:

* the tokenizer bench's captions are the JAX script's bit for bit, both
  token legs give the JAX package's ``tokenize`` on them, the oracle leg
  runs with a stand-in ``simple_tokenizer.py`` and, where none is found,
  the record says so with nulls and a reason while the Python == C++ check
  still runs; the record's legs carry the committed
  ``TOKENIZER_BENCH.json``'s keys;
* the input and transfer benches print the JAX scripts' keys at a small n;
* v1-v4's front ends equal the JAX variants written out from
  ``scripts/bench_frontend_variants.py:87-163`` on one uint8 batch: v1
  within a bf16 step of the f32 result (``BF16_STEP``), the int8 patches
  at most one step apart, equal on at least ``INT8_EQUAL_SHARE`` of them;
* both plot modes write the JAX script's files from a port
  ``MetricsWriter`` run, a truncated tail line skipped;
* every new script but the plot (host only) raises without a card when
  ``--device`` is not given, and none loads ``jax`` or ``clip_mixer_tpu``.
"""

import importlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_mixer_tpu.ops.preprocess import CLIP_MEAN, CLIP_STD
from clip_mixer_tpu.ops.preprocess import _cached_matrices as jax_matrices
from clip_mixer_tpu.text.tokenize import tokenize as jax_tokenize

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.train.metrics import MetricsWriter
from torch_port_worlds import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
tok = importlib.import_module("torch_bench_tokenizer")
bench_input = importlib.import_module("torch_bench_input")
transfer = importlib.import_module("torch_bench_transfer")
variants = importlib.import_module("torch_bench_frontend_variants")
plot = importlib.import_module("torch_plot_results")
RECORD = json.loads((REPO / "TOKENIZER_BENCH.json").read_text())
NEW_SCRIPTS = ("torch_bench_loss", "torch_bench_remat_policy", "torch_bench_rn_accum", "torch_bench_frontend_variants",
               "torch_profile_mixer", "torch_bench_transfer", "torch_bench_input", "torch_bench_tokenizer",
               "torch_plot_results")
CARD_SCRIPTS = NEW_SCRIPTS[:-1]  # the plot script runs on the host only
BF16_STEP = 2.0 ** -7  # v1: relative, one bf16 step (8 significant bits)
INT8_EQUAL_SHARE = 0.99  # v2-v4: the share of int8 patch values equal to JAX's (the rest one step away)
STAND_IN = '''"""A stand-in for the reference simple_tokenizer.py: the JAX package's BPE."""
from clip_mixer_tpu.text.bpe import get_tokenizer


class SimpleTokenizer:
    def __init__(self):
        self.bpe = get_tokenizer()
        self.cache = {}

    def encode(self, text):
        return self.bpe.encode(text)
'''


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _caption_tar(path, caps):
    with tarfile.open(path, "w") as tf:
        for i, c in enumerate(caps):
            for name, data in ((f"{i:05d}.txt", c.encode()), (f"{i:05d}.jpg", b"not read")):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("n", [5, 12])
def test_captions_are_jax_scripts(n, tmp_path, monkeypatch):
    """``load_captions`` from shards (all of them, or repeated to n) and the
    synthetic fallback, and ``diverse_captions``, equal JAX's."""
    jtok = _jax_script("bench_tokenizer")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "dress").mkdir()
    _caption_tar(tmp_path / "dress" / "a.tar", [f"a red circle number {i}." for i in range(4)])
    _caption_tar(tmp_path / "dress" / "b.tar", [f"a blue square, #{i}!" for i in range(4)])
    for glob in ("dress/*.tar", str(tmp_path / "dress" / "*.tar"), "none/*.tar"):
        assert tok.load_captions(n, glob) == jtok.load_captions(n, glob)
    assert tok.load_captions(n, "dress/*.tar")[1] == ("tar:dress/*.tar" if n <= 8 else
                                                      "tar:dress/*.tar (repeated x2)")
    assert tok.diverse_captions(n) == jtok.diverse_captions(n)


def test_token_legs_equal_jax_tokenize():
    from clip_mixer_tpu_torch.text import fast
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    caps = tok.load_captions(48, "none/*.tar")[0] + tok.diverse_captions(48)
    caps.append(" ".join(["word"] * 90))  # truncated at 77
    want = jax_tokenize(caps, truncate=True)
    assert np.array_equal(tokenize(caps, truncate=True), want)
    assert np.array_equal(fast.fast_tokenize(caps, truncate=True), want)


def _main(tmp_path, monkeypatch, *extra):
    """The script's main; the identity ftfy it installs and the path it
    adds for the oracle leave with the test."""
    import types

    stub = types.ModuleType("ftfy")
    stub.fix_text = lambda s: s
    monkeypatch.setitem(sys.modules, "ftfy", sys.modules.get("ftfy", stub))
    monkeypatch.setattr(sys, "path", list(sys.path))
    out = tmp_path / "TOKENIZER_BENCH_TORCH.json"
    rec = tok.main(["--n", "64", "--shards", "none/*.tar", "--out", str(out), "--device", "cpu", *extra])
    assert json.loads(out.read_text()) == rec
    return rec


def test_oracle_leg_with_a_stand_in(tmp_path, monkeypatch, capsys):
    ref = tmp_path / "reference"
    ref.mkdir()
    (ref / "simple_tokenizer.py").write_text(STAND_IN)
    rec = _main(tmp_path, monkeypatch, "--reference", str(ref))
    assert list(rec) == ["legs", "oracle", "device", "power_limit"] and rec["oracle"] == str(ref)
    assert list(rec["legs"]) == list(RECORD["legs"])
    for leg, d in rec["legs"].items():
        assert list(d) == list(RECORD["legs"][leg]) and list(d["seconds"]) == list(RECORD["legs"][leg]["seconds"])
        assert d["n_captions"] == 64 and all(d[k] > 0 for k in ("oracle_cps", "speedup_cpp_cold_vs_oracle",
                                                                 "speedup_python_vs_oracle", "cpp_warm_cps"))
    assert rec["legs"]["diverse_captions"]["caption_source"] == "synthetic-diverse"
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(summary) == list(RECORD["legs"]) and all(
        list(v) == ["cpp_cold_cps", "x_vs_python", "x_vs_oracle"] and v["x_vs_oracle"] > 0 for v in summary.values())


def test_oracle_leg_catches_a_wrong_token(tmp_path, monkeypatch):
    ref = tmp_path / "reference"
    ref.mkdir()
    (ref / "simple_tokenizer.py").write_text(STAND_IN.replace("return self.bpe.encode(text)",
                                                              "return self.bpe.encode(text)[::-1]"))
    with pytest.raises(RuntimeError, match="mismatch vs oracle"):
        _main(tmp_path, monkeypatch, "--reference", str(ref))


def test_absent_reference_gives_nulls_with_the_reason(tmp_path, monkeypatch):
    """No simple_tokenizer.py: the oracle's keys and the speedups against
    it are null, the record says why; the Python == C++ check still runs."""
    rec = _main(tmp_path, monkeypatch, "--reference", str(tmp_path / "absent"))
    assert rec["oracle"] == f"absent: no simple_tokenizer.py under {tmp_path / 'absent'}"
    for d in rec["legs"].values():
        assert list(d) == list(RECORD["legs"]["real_captions"])
        assert d["oracle_cps"] is None and d["seconds"]["oracle"] is None
        assert d["speedup_cpp_cold_vs_oracle"] is None and d["speedup_python_vs_oracle"] is None
        assert d["python_cps"] > 0 and d["cpp_cold_cps"] > 0
    from clip_mixer_tpu_torch.text import fast

    real = fast.fast_tokenize
    monkeypatch.setattr(fast, "fast_tokenize", lambda caps, **kw: real(caps, **kw) + 1)
    with pytest.raises(RuntimeError, match="disagree"):
        _main(tmp_path, monkeypatch, "--reference", str(tmp_path / "absent"))


def test_default_reference_is_jax_path_under_the_working_directory():
    jtok = _jax_script("bench_tokenizer")
    assert jtok.REFERENCE_CLIP.endswith("/" + tok.REFERENCE_CLIP) and not Path(tok.REFERENCE_CLIP).is_absolute()


def test_input_prints_jax_keys(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_INPUT_N", "32")
    out = bench_input.main(["--device", "cpu"])
    assert list(out) == ["imgs_per_sec", "n_images", "host_cores", "note", "device", "power_limit"]
    assert list(out["imgs_per_sec"]) == [f"{m}_{w}w" for m in ("thread", "process") for w in (1, 2, 4, 8)]
    assert out["n_images"] == 32 and out["host_cores"] == os.cpu_count() and out["device"] == "cpu"
    assert all(v > 0 for v in out["imgs_per_sec"].values())
    assert f"{len(os.sched_getaffinity(0))} cores" in out["note"] and "usable by this process" in out["note"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def test_transfer_prints_jax_keys(capsys):
    out = transfer.main(["--device", "cpu"], shape=(8, 224, 224, 3))
    assert list(out) == ["metric", "value", "unit", "detail"] and out["unit"] == "MB/s"
    assert list(out["detail"])[:4] == ["runs_mb_per_s", "batch_mb", "device", "implied_imgs_per_sec_at_b2048"]
    assert out["detail"]["batch_mb"] == round(8 * 224 * 224 * 3 / 1e6, 1) and len(out["detail"]["runs_mb_per_s"]) == 4
    assert out["value"] == out["detail"]["runs_mb_per_s"][2] > 0 and out["detail"]["pageable_mb_per_s"] > 0
    assert json.loads(capsys.readouterr().out.strip()) == out


# ---- the int8 front-end variants, written out from bench_frontend_variants.py:87-163 ----------


def _jax_variants(cfg, input_hw, s_patch):
    """v1-v4's front ends as the JAX script's ``main`` defines them."""
    rh_np, rw_np = jax_matrices(*input_hw, cfg.image_resolution)
    mean = jnp.asarray(CLIP_MEAN, jnp.float32) * 255.0
    std_inv = 1.0 / (jnp.asarray(CLIP_STD, jnp.float32) * 255.0)
    p_sz = cfg.vision_patch_size
    g = cfg.image_resolution // p_sz

    def pre_bf16(u8):
        x = u8.astype(jnp.bfloat16)
        x = jnp.einsum("oh,bhwc->bowc", jnp.asarray(rh_np, jnp.bfloat16), x, preferred_element_type=jnp.float32)
        x = jnp.einsum("pw,bowc->bopc", jnp.asarray(rw_np, jnp.bfloat16), x.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
        return ((x - mean) * std_inv).astype(jnp.bfloat16)

    def planar_patches_int8(x_pl):
        B = x_pl.shape[0]
        xq = jnp.clip(jnp.round(x_pl / s_patch), -127, 127).astype(jnp.int8)
        xq = xq.reshape(B, 3, g, p_sz, g, p_sz)
        xq = xq.transpose(0, 2, 4, 1, 3, 5)
        return xq.reshape(B, g * g, 3 * p_sz * p_sz)

    def pre_planar_bf16(u8):
        x = u8.transpose(0, 3, 1, 2).astype(jnp.bfloat16)
        x = jnp.einsum("oh,kchw->kcow", jnp.asarray(rh_np, jnp.bfloat16), x, preferred_element_type=jnp.float32)
        x = jnp.einsum("pw,kcow->kcop", jnp.asarray(rw_np, jnp.bfloat16), x.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
        x = (x - mean.reshape(1, 3, 1, 1)) * std_inv.reshape(1, 3, 1, 1)
        return planar_patches_int8(x)

    def _qrows(w):
        s = np.maximum(np.abs(w).max(axis=1) / 127.0, 1e-8)
        q = np.clip(np.round(w / s[:, None]), -127, 127).astype(np.int8)
        return jnp.asarray(q), jnp.asarray(s.astype(np.float32)), jnp.asarray(
            (128.0 * s * q.sum(axis=1)).astype(np.float32))

    rhq, sh, corr_h = _qrows(rh_np)
    rwq, sw, corr_w = _qrows(rw_np)
    S1 = np.float32(160.0 / 127.0)

    def pre_planar_int8(u8):
        x = u8.transpose(0, 3, 1, 2)
        xs = (x.astype(jnp.int16) - 128).astype(jnp.int8)
        acc = jnp.einsum("oh,kchw->kcow", rhq, xs, preferred_element_type=jnp.int32)
        y1 = acc.astype(jnp.float32) * sh.reshape(1, 1, -1, 1) + corr_h.reshape(1, 1, -1, 1)
        y1q = jnp.clip(jnp.round((y1 - 128.0) / S1), -127, 127).astype(jnp.int8)
        acc2 = jnp.einsum("pw,kcow->kcop", rwq, y1q, preferred_element_type=jnp.int32)
        y2 = (acc2.astype(jnp.float32) * S1) * sw.reshape(1, 1, 1, -1) + corr_w.reshape(1, 1, 1, -1)
        x = (y2 - mean.reshape(1, 3, 1, 1)) * std_inv.reshape(1, 3, 1, 1)
        return planar_patches_int8(x)

    def pre_planar_bf16_notranspose(u8):
        x = u8.astype(jnp.bfloat16)
        x = jnp.einsum("oh,bhwc->bcow", jnp.asarray(rh_np, jnp.bfloat16), x, preferred_element_type=jnp.float32)
        x = jnp.einsum("pw,kcow->kcop", jnp.asarray(rw_np, jnp.bfloat16), x.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
        x = (x - mean.reshape(1, 3, 1, 1)) * std_inv.reshape(1, 3, 1, 1)
        return planar_patches_int8(x)

    return {"v1": pre_bf16, "v2": pre_planar_bf16, "v3": pre_planar_int8, "v4": pre_planar_bf16_notranspose}


@pytest.fixture(scope="module")
def front_ends():
    """One uint8 batch (64 px -> mixer-debug's 32, patch 16) through both
    packages' v1-v4, at a patch scale of 0.02."""
    cfg = tcfg.PRESETS["mixer-debug"]
    u8 = np.random.default_rng(0).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    s_patch = np.float32(0.02)
    want = jax.jit(lambda u: {k: f(u) for k, f in _jax_variants(cfg, (64, 64), s_patch).items()})(u8)
    k = variants.front_end_constants(cfg, (64, 64), torch.tensor(s_patch), torch.device("cpu"))
    x = torch.from_numpy(u8)
    got = {"v1": variants.pre_bf16(x, k), "v2": variants.pre_planar_bf16(x, k), "v3": variants.pre_planar_int8(x, k),
           "v4": variants.pre_planar_bf16_notranspose(x, k)}
    return {name: (got[name], np.asarray(want[name])) for name in got}


def test_v1_is_jax_within_a_bf16_step(front_ends):
    got, want = front_ends["v1"]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (3, 32, 32, 3)
    got, want = got.float().numpy(), want.astype(np.float32)
    assert (np.abs(got - want) <= BF16_STEP * np.maximum(np.abs(want), 1.0)).all()


@pytest.mark.parametrize("name", ["v2", "v3", "v4"])
def test_int8_patches_are_jax_within_one_step(name, front_ends):
    got, want = front_ends[name]
    assert got.dtype == torch.int8 and got.shape == want.shape == (3, 4, 3 * 16 * 16)
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() >= INT8_EQUAL_SHARE, (diff.max(), (diff == 0).mean())


def test_variants_main_prints_jax_keys(capsys):
    out = variants.main(["--device", "cpu"], cfg=tcfg.PRESETS["mixer-debug"], batch=4, chain=(1, 2), runs=1)
    names = ["v0_shipped", "v1_bf16_resize", "v2_planar_bf16", "v3_planar_int8", "v4_planar_fused_transpose"]
    assert list(out) == ["batch", "results", "device", "power_limit"] and list(out["results"]) == names
    for r in out["results"].values():
        assert list(r) == ["ms_per_batch", "ms_runs", "imgs_per_sec", "cos_vs_f32"] and r["cos_vs_f32"] > 0.99
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [list(x) for x in lines[:-1]] == [[n] for n in names] and lines[-1] == out


# ---- the plots ----------------------------------------------------------------------------


def test_plot_both_modes_from_a_port_run(tmp_path, monkeypatch):
    """The training curves from a port ``MetricsWriter``'s metrics.jsonl
    (its truncated tail line skipped) and the reference figures, under the
    JAX script's file names; no card is needed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    writer = MetricsWriter(str(tmp_path / "runs"))
    for s in range(1, 9):
        writer.add_scalar("Loss", 2.0 / s, s)
        writer.add_scalar("Learning rate", 1e-3 * s, s)
    writer.close()
    jsonl = tmp_path / "runs" / "metrics.jsonl"
    with open(jsonl, "a") as f:
        f.write('{"step": 9, "name": "Lo')  # a run killed mid-append
    out = tmp_path / "figs"
    plot.main(["--metrics", str(jsonl), "--out", str(out)])
    assert sorted(os.listdir(out)) == ["training_curves.png"] and (out / "training_curves.png").stat().st_size > 0
    plot.main(["--out", str(out)])
    assert sorted(os.listdir(out)) == ["imagenet.png", "sts.png", "training_curves.png"]
    assert plot.REFERENCE_RESULTS == _jax_script("plot_results").REFERENCE_RESULTS


# ---- every script --------------------------------------------------------------------------


@pytest.mark.parametrize("name", CARD_SCRIPTS)
def test_no_card_without_device_raises(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    script = importlib.import_module(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main([])
    assert list(tmp_path.iterdir()) == []


def test_scripts_load_no_jax():
    code = ("import runpy, sys\n"
            f"for name in {NEW_SCRIPTS!r}:\n"
            "    runpy.run_path(f'scripts/{name}.py', run_name='not_main')\n"
            "left = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'clip_mixer_tpu'))\n"
            "print(left)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout
