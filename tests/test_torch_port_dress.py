"""The port's dress-shard training runs against the JAX package's, on the CPU:
``scripts/torch_make_dress_dataset.py``, ``scripts/torch_dress_rehearsal.py``
and ``scripts/torch_compare_towers.py`` beside ``scripts/make_dress_dataset.py``,
``scripts/dress_rehearsal.py`` and ``scripts/compare_towers.py``.

* ``render_sample`` gives the JAX script's bits for several (seed, index)
  at 64 and 256 px, with the class free and forced; the port's ``main``
  writes the members JAX's ``write_tar_shards`` writes, byte for byte, with
  one render process and with two.
* The rehearsal's distillation (``read_metrics``, ``thin``,
  ``checkpoint_steps``, ``distill``, ``write_result``) and the comparison's
  ``_maybe_equal_device_time`` equal JAX's on the JAX tests' fixtures;
  ``check_fresh_run_dir`` refuses a run directory with checkpoints.
* One supervised rehearsal at ``mixer-debug`` on the CPU in a temporary
  directory: the crash after step 3 resumes from the checkpoint at 2, and
  the record has JAX's keys; nothing is written into the checkout.
* ``measure_step_times`` runs both kinds of tower at small widths; the
  twins' parameter counts equal JAX's record; without ``--device`` on a
  host without a card both training scripts raise; no script imports JAX.
"""

import ast
import importlib
import json
import os
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_worlds import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
PORT_SCRIPTS = ("torch_make_dress_dataset", "torch_dress_rehearsal", "torch_compare_towers")


def _load(name):
    """A script as a module of its own name, importable so (the render
    pool's workers import it by name)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    return importlib.import_module(name)


@pytest.fixture(scope="module")
def make():
    return _load("make_dress_dataset"), _load("torch_make_dress_dataset")


@pytest.mark.parametrize("seed,index,size", [(0, 0, 64), (0, 7, 64), (3, 11, 256), (1, 12345, 256)])
def test_render_sample_bit_for_bit(make, seed, index, size):
    jax_make, port_make = make
    for forced in ({}, {"color": "teal", "shape": "stripe", "backdrop": "ocean"}, {"shape": "ring"}):
        want_img, want_cap = jax_make.render_sample(seed, index, size, **forced)
        got_img, got_cap = port_make.render_sample(seed, index, size, **forced)
        assert got_cap == want_cap
        assert got_img.dtype == np.uint8 and got_img.shape == (size, size, 3)
        np.testing.assert_array_equal(got_img, want_img)


def _members(out_dir):
    got = {}
    for path in sorted(Path(out_dir).glob("*.tar")):
        with tarfile.open(path) as tar:
            got[path.name] = [(m.name, tar.extractfile(m).read()) for m in tar.getmembers()]
    return got


@pytest.mark.parametrize("workers", [1, 2])
def test_shards_byte_for_byte(make, tmp_path, workers):
    from clip_mixer_tpu.data.pipeline import write_tar_shards

    jax_make, port_make = make
    n, size, per_shard, seed = 40, 64, 16, 2
    paths = port_make.main(["--out", str(tmp_path / "port"), "--n", str(n), "--size", str(size), "--seed",
                            str(seed), "--samples-per-shard", str(per_shard), "--workers", str(workers)])
    write_tar_shards((jax_make.render_sample(seed, i, size) for i in range(n)), str(tmp_path / "jax"), per_shard,
                     quality=90)
    got, want = _members(tmp_path / "port"), _members(tmp_path / "jax")
    assert [Path(p).name for p in paths] == list(want) == ["00000.tar", "00001.tar", "00002.tar"]
    assert got == want
    assert sum(len(v) for v in got.values()) == 2 * n


def _metrics_fixture(run):
    """``tests/test_supervise.py::test_dress_rehearsal_distillation``'s run
    directory, with an unfinished ``<step>.tmp`` save beside the checkpoint."""
    (run / "runs").mkdir(parents=True)
    lines = [json.dumps({"step": s, "name": "Loss", "value": 10.0 - s}) for s in range(1, 8)]
    lines.append(json.dumps({"step": 5, "name": "Retrieval I->T R@1", "value": 1.5}))
    lines.append(json.dumps({"step": 4, "name": "Throughput (imgs/s)", "value": 123.0}))
    lines.append('{"step": 8, "name": "Lo')  # crash-truncated tail
    (run / "runs" / "metrics.jsonl").write_text("\n".join(lines))
    (run / "checkpoints" / "4").mkdir(parents=True)
    (run / "checkpoints" / "6.tmp").mkdir()


def test_distillation_matches_jax(tmp_path):
    jax_dr, port_dr = _load("dress_rehearsal"), _load("torch_dress_rehearsal")
    run = tmp_path / "run"
    _metrics_fixture(run)
    series = port_dr.read_metrics(run)
    assert series == jax_dr.read_metrics(run)
    assert series["Loss"][0] == (1, 9.0) and series["Loss"][-1] == (7, 3.0)
    assert port_dr.checkpoint_steps(run) == jax_dr.checkpoint_steps(run) == [4]
    assert port_dr.checkpoint_steps(tmp_path / "missing") == []
    for crash in (0, 5):
        got = port_dr.distill(series, 12.0, 0, crash_after_steps=crash, ckpt_steps=port_dr.checkpoint_steps(run))
        want = jax_dr.distill(series, 12.0, 0, crash_after_steps=crash, ckpt_steps=jax_dr.checkpoint_steps(run))
        assert got == want
    assert got["restarts"] == 1 and got["steps_completed"] == 7 and got["imgs_per_sec_median_steady"] == 123.0
    assert port_dr.distill({}, 1.0, 1) == jax_dr.distill({}, 1.0, 1)
    for keep in (60, 7, 200):
        pts = [(i, float(i)) for i in range(200)]
        assert port_dr.thin(pts, keep) == jax_dr.thin(pts, keep)
    for mod, name in ((port_dr, "port.json"), (jax_dr, "jax.json")):
        out = tmp_path / name
        out.write_text("{not json")  # a torn file is replaced, as JAX's
        mod.write_result(out, {"steps_completed": 12}, leg="batch32k")
        mod.write_result(out, {"steps_completed": 516}, leg="steps500")
        mod.write_result(tmp_path / ("flat_" + name), {"steps_completed": 3})
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())
    assert (tmp_path / "flat_port.json").read_text() == (tmp_path / "flat_jax.json").read_text()


def _leg(steps, r1):
    return {"steps_completed": steps, "loss_last": 2.0,
            "retrieval": {"Retrieval I->T R@1": [[100, 1.0], [steps, r1]]}}


@pytest.mark.parametrize("doc", [
    {"step_time": {"mixer-b32": {"sec_per_step": 0.4}, "transformer-b32": {"sec_per_step": 0.8}},
     "curves": {"mixer-b32": _leg(400, 3.0), "transformer-b32": _leg(400, 5.0), "mixer-b32@800": _leg(800, 6.0)}},
    {"step_time": {"mixer-b32": {"sec_per_step": 0.4}}, "curves": {"mixer-b32": _leg(400, 3.0)}},
], ids=["matched_mixer_leg", "one_tower"])
def test_equal_device_time_matches_jax(doc):
    """``tests/test_bench_scripts.py``'s two fixtures."""
    got, want = json.loads(json.dumps(doc)), json.loads(json.dumps(doc))
    _load("torch_compare_towers")._maybe_equal_device_time(got)
    _load("compare_towers")._maybe_equal_device_time(want)
    assert {k: v for k, v in got.items() if k != "equal_device_time"} == doc
    if "transformer-b32" in doc["step_time"]:
        eq, jeq = got["equal_device_time"], want["equal_device_time"]
        assert {k: v for k, v in eq.items() if k != "note"} == {k: v for k, v in jeq.items() if k != "note"}
        assert eq["mixer"]["steps"] == 800 and eq["device_time_mismatch_pct"] == 0.0
    else:
        assert "equal_device_time" not in got and "equal_device_time" not in want


def test_check_fresh_run_dir(tmp_path, monkeypatch):
    ct = _load("torch_compare_towers")
    monkeypatch.chdir(tmp_path)
    assert ct.check_fresh_run_dir("mixer-b32", 8) == "compare_mixer-b32_8"
    (tmp_path / "outputs" / "compare_transformer-b32_8" / "checkpoints").mkdir(parents=True)
    with pytest.raises(SystemExit, match="already has checkpoints"):
        ct.check_fresh_run_dir("transformer-b32", 8)
    assert ct.check_fresh_run_dir("transformer-b32", 16) == "compare_transformer-b32_16"


def _checkout_state():
    """What a run could leave in the checkout: its top-level names, the
    ``outputs`` tree and the JAX package's two records."""
    top = sorted(os.listdir(REPO))
    outputs = sorted(str(p.relative_to(REPO)) for p in (REPO / "outputs").rglob("*")) \
        if (REPO / "outputs").exists() else []
    records = {n: (REPO / n).read_bytes() for n in ("TRAIN_DRESS.json", "COMPARE_TOWERS.json")}
    return top, outputs, records


def test_supervised_rehearsal_cpu(make, tmp_path, monkeypatch):
    """``main(argv, preset="mixer-debug")`` with ``--device cpu`` in a
    temporary directory: GradCache at 8 rows in 2 microbatches over 2 train
    shards of 16 (4 steps, one epoch), a crash after step 3, checkpoints at 2
    and 4, retrieval on the held-out shard at both."""
    _, port_make = make
    site = tmp_path / "site"
    site.mkdir()  # torch.utils.tensorboard blocked in the children: its TensorFlow costs seconds a process
    (site / "sitecustomize.py").write_text("import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    monkeypatch.setenv("PYTHONPATH", str(site))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # beside the suite's other workers
    monkeypatch.chdir(tmp_path)
    before = _checkout_state()
    port_make.main(["--out", "dress", "--n", "48", "--size", "64", "--samples-per-shard", "16"])
    rc = _load("torch_dress_rehearsal").main(
        ["--data", "dress/0000[0-1].tar", "--val-data", "dress/00002.tar", "--global-batch", "8", "--accum", "2",
         "--n-samples", "32", "--steps", "4", "--checkpoint-every", "2", "--validate-every", "2",
         "--crash-after-steps", "3", "--max-restarts", "1", "--device", "cpu"], preset="mixer-debug")
    assert rc == 0
    doc = json.loads((tmp_path / "TRAIN_DRESS_TORCH.json").read_text())
    jax_keys = set(_load("dress_rehearsal").distill({}, 0.0, 0)) | {"config"}
    assert set(doc) == jax_keys | {"device", "power_limit", "peak_mem_gb"}
    assert doc["supervisor_exit"] == 0 and doc["steps_completed"] == 4 and doc["restarts"] == 1
    assert doc["checkpoint_steps"] == [2, 4] and doc["device"] == "cpu" and doc["peak_mem_gb"] is None
    assert [s for s, _ in doc["loss_curve"]] == [1, 2, 3, 4]  # each step's loss written once
    assert all(np.isfinite(v) for _, v in doc["loss_curve"])
    assert sorted(doc["retrieval"]) == ["Retrieval I->T R@1", "Retrieval I->T R@5", "Retrieval T->I R@1",
                                        "Retrieval T->I R@5"]
    assert all([s for s, _ in v] == [2, 4] for v in doc["retrieval"].values()), doc["retrieval"]
    assert doc["config"]["preset"] == "mixer-debug" and doc["config"]["accum_steps"] == 2
    assert any((tmp_path / "dress_cache").iterdir())
    assert _checkout_state() == before


def test_step_times_both_towers(monkeypatch):
    """``measure_step_times`` at small widths: a mixer and a transformer
    under the twins' names, their parameters counted, the speed-up derived."""
    from clip_mixer_tpu_torch.config import PRESETS

    tiny_vit = PRESETS["mixer-debug"].replace(tower="transformer")
    monkeypatch.setitem(PRESETS, "transformer-debug", tiny_vit)
    out = _load("torch_compare_towers").measure_step_times(4, "cpu", ("mixer-debug", "transformer-debug"))
    for name in ("mixer-b32", "transformer-b32"):
        assert set(out[name]) == {"params", "sec_per_step", "imgs_per_sec"}
        assert out[name]["sec_per_step"] > 0 and np.isfinite(out[name]["imgs_per_sec"])
    assert out["mixer-b32"]["params"] != out["transformer-b32"]["params"]
    t, m = out["transformer-b32"]["sec_per_step"], out["mixer-b32"]["sec_per_step"]
    assert out["mixer_speedup"] == round(t / m - 1.0, 4)


def test_twin_parameter_counts_equal_jax_record():
    """The full-width twins, built on the meta device, hold the parameters
    JAX's ``COMPARE_TOWERS.json`` counted: 111,060,389 and 151,277,313."""
    from clip_mixer_tpu_torch import CLIP, PRESETS

    record = json.loads((REPO / "COMPARE_TOWERS.json").read_text())["step_time"]
    for name in ("mixer-b32", "transformer-b32"):
        with torch.device("meta"):
            model = CLIP(PRESETS[name], device="meta")
        assert sum(p.numel() for p in model.parameters()) == record[name]["params"]


@pytest.mark.parametrize("script,argv", [
    ("torch_dress_rehearsal", ["--data", "none/*.tar"]),
    ("torch_compare_towers", ["--skip-curves", "--step-time-batch", "2"]),
])
def test_no_card_without_device_raises(script, argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("the host has a card")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(script).main(argv)
    assert not any(tmp_path.iterdir())  # raised before anything ran or was written


def test_scripts_import_no_jax():
    for name in PORT_SCRIPTS:
        tree = ast.parse((SCRIPTS / f"{name}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not {"jax", "clip_mixer_tpu", "make_dress_dataset", "dress_rehearsal",
                        "compare_towers"} & set(roots), (name, roots)
