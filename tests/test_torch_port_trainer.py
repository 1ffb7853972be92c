"""The port's ``Trainer`` (``clip_mixer_tpu_torch/train/trainer.py``) on the CPU.

First against the JAX ``Trainer``: f32, the same weights (carried with
``load_jax_params``), the same ``SyntheticSource`` seed, 2 epochs x 3 steps;
each step's Loss, Gradient norm, Learning rate and Logit scale from
``metrics.jsonl`` and the final parameters are held at the JAX suite's
train-step tolerances, the ones ``tests/test_torch_port_train_step.py``
uses (loss and logit scale rtol 2e-5, gradient norm rtol 2e-4, parameters
atol 5e-4; the learning rate is one formula on both sides, rtol 1e-6).

Then the port's own contract: end to end with resume and export (the
counterpart of ``tests/test_data_trainer_api.py``'s), kill and resume bit for
bit through ``crash_after_steps``, a SIGTERM that checkpoints and resumes bit
for bit, the non-finite abort before the checkpoint, ``_pick_trace_start``
against the JAX function, ``profile_steps``, the EMA export, the validation
cadence, the heartbeat, and the JAX package's ``api.load`` reading the
port's export.

TensorBoard is kept out of both packages (the card's host has none, and
importing it here takes seconds); ``metrics.jsonl`` is the record, and one
test holds the TensorBoard wiring with a stand-in writer.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import clip_mixer_tpu as cm
from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.data.pipeline import SyntheticSource as JaxSyntheticSource
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.parallel.mesh import make_mesh
from clip_mixer_tpu.train import trainer as jtrainer

from clip_mixer_tpu_torch import config as tcfg_mod
from clip_mixer_tpu_torch.api import load_pretrained
from clip_mixer_tpu_torch.data.pipeline import Batch, SyntheticSource
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from clip_mixer_tpu_torch.train import metrics as metrics_mod
from clip_mixer_tpu_torch.train.trainer import Trainer, _pick_trace_start

REPO = str(Path(__file__).resolve().parents[1])
# the synthetic captions use the full CLIP vocabulary
MODEL = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64, vision_patch_size=16,
             context_length=16, vocab_size=49408, text_width=64, text_heads=1, text_layers=2, tower="mixer",
             compute_dtype="float32")
CFG = tcfg_mod.CLIPConfig(**MODEL)
# The port-only tests take SMALL and _SmallVocab: the full vocabulary would
# make the embedding 3.2M of this model's 3.35M parameters, and a checkpoint
# with the EMA 54 MB (3.6 MB with 512 ids).
SMALL = CFG.replace(vocab_size=512)
SOT = 49406
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 2e-5, 2e-4, 5e-4  # tests/test_train_step.py:91-100
LR_RTOL = 1e-6
SCALARS = {"Loss": LOSS_RTOL, "Gradient norm": NORM_RTOL, "Learning rate": LR_RTOL, "Logit scale": LOSS_RTOL}


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    for name in ("torch.utils.tensorboard", "tensorboardX"):  # the port's and the JAX package's
        monkeypatch.setitem(sys.modules, name, None)


def _tcfg(**kw):
    base = dict(global_batch_size=8, epochs=2, learning_rate=1e-3, warmup_steps=2, checkpoint_every_steps=3)
    return tcfg_mod.TrainConfig(**{**base, **kw})


class _SmallVocab(SyntheticSource):
    """SyntheticSource with its token ids mapped into SMALL's 512: words to
    id % 510, <sot> to 510, <eot> to 511 (still each row's argmax)."""

    def iter_batches(self, epoch, start_batch=0):
        for b in super().iter_batches(epoch, start_batch):
            t = b["texts"]
            yield Batch(images=b["images"], texts=np.where(t >= SOT, t - SOT + 510, t % 510).astype(np.int32))


def _source(n_batches=3, seed=0, full_vocab=False):
    kind = SyntheticSource if full_vocab else _SmallVocab
    return kind(batch_size=8, image_size=32, n_batches=n_batches, n_classes=4, context_length=16, seed=seed)


def _rows(run):
    with open(os.path.join(run, "runs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _series(rows, name):
    return {r["step"]: r["value"] for r in rows if r["name"] == name}


def _tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for slot in ("mu", "nu", "ema"):
        out.update({f"{slot}.{k}": v for k, v in (getattr(state.opt_state, slot) or {}).items()})
    return out


def _assert_bitwise(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert (a.step, a.opt_state.count) == (b.step, b.opt_state.count)


def test_trainer_tracks_the_jax_trainer(tmp_path):
    jc, jt = jcfg.CLIPConfig(**MODEL), jcfg.TrainConfig(**dataclasses.asdict(_tcfg(ema_decay=0.9)))
    params = jclip.init(jax.random.key(1), jc)
    init = jax.tree.map(np.array, params)
    jdata = JaxSyntheticSource(batch_size=8, image_size=32, n_batches=3, n_classes=4, context_length=16, seed=5)
    jrun = str(tmp_path / "jax")
    jtr = jtrainer.Trainer(jc, jt, jdata, jrun, mesh=make_mesh(n_data=1, devices=jax.devices()[:1]), params=params)
    jtr.train()

    model = load_jax_params(CLIP(CFG, device="cpu"), init)
    run = str(tmp_path / "port")
    tr = Trainer(CFG, _tcfg(ema_decay=0.9), _source(seed=5, full_vocab=True), run, device="cpu", model=model)
    tr.train()
    assert tr.global_step == jtr.global_step == 6

    jrows, rows = _rows(jrun), _rows(run)
    for name, rtol in SCALARS.items():
        want, got = _series(jrows, name), _series(rows, name)
        assert sorted(got) == sorted(want) == list(range(1, 7)), name
        for s in want:
            np.testing.assert_allclose(got[s], want[s], rtol=rtol, err_msg=f"{name}, step {s}")
    assert sorted(_series(rows, "Throughput (imgs/s)")) == sorted(_series(jrows, "Throughput (imgs/s)")) == [3, 6]

    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jax.device_get(jtr.state.params)), jc)
    got = tr.state.model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=PARAM_ATOL, err_msg=name)
    from clip_mixer_tpu.parallel.train_step import ema_params

    want_ema = jax_params_to_state_dict(jax.tree.map(np.asarray, jax.device_get(ema_params(jtr.state))), jc)
    for name, w in want_ema.items():
        np.testing.assert_allclose(tr.state.opt_state.ema[name].numpy(), w.numpy(), atol=PARAM_ATOL, err_msg=name)


def test_end_to_end_with_resume_and_export(tmp_path):
    """tests/test_data_trainer_api.py:143's contract on the port."""
    tcfg = _tcfg(checkpoint_every_steps=5)
    run = str(tmp_path / "runA")
    tr = Trainer(SMALL, tcfg, _source(n_batches=6), run, device="cpu")
    tr.train()
    assert tr.global_step == 12  # 6 batches x 2 epochs
    assert len(tr.writer.history["Loss"]) == 12
    assert tr.checkpointer.all_steps() == [5, 10, 12]  # the cadence, then the final save
    assert os.path.exists(os.path.join(run, "heartbeat-0"))

    tr2 = Trainer(SMALL, tcfg, _source(n_batches=6), run, device="cpu")
    assert (tr2.start_epoch, tr2.start_batch) == (2, 0)  # training complete
    _assert_bitwise(tr.state, tr2.state)
    fresh = Trainer(SMALL, tcfg, _source(n_batches=6), run, device="cpu", resume=False)
    assert (fresh.global_step, fresh.start_epoch, fresh.start_batch) == (0, 0, 0)

    model, cfg = load_pretrained(os.path.join(run, "export"), device="cpu")
    assert cfg == SMALL
    for k, v in tr.state.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    with open(os.path.join(run, "export", "config.json")) as f:
        raw = json.load(f)
    with open(os.path.join(run, "export", "config.json"), "w") as f:
        json.dump(dict(raw, field_of_a_newer_version=1), f)  # ignored, as the JAX loader ignores it
    assert load_pretrained(os.path.join(run, "export"), device="cpu")[1] == SMALL

    rows = _rows(run)
    assert sum(r["name"] == "Loss" for r in rows) == 12
    assert sorted(_series(rows, "Throughput (imgs/s)")) == [5, 10]
    assert all(v > 0 for v in _series(rows, "Throughput (imgs/s)").values())


def test_kill_and_resume_is_bit_for_bit(tmp_path):
    tcfg = _tcfg(epochs=3, ema_decay=0.9)
    a = Trainer(SMALL, tcfg, _source(), str(tmp_path / "a"), device="cpu")
    a.train()

    run = str(tmp_path / "b")
    crash = Trainer(SMALL, dataclasses.replace(tcfg, crash_after_steps=5), _source(), run, device="cpu")
    with pytest.raises(RuntimeError, match="crash_after_steps"):
        crash.train()
    assert crash.checkpointer.latest_step() == 3
    b = Trainer(SMALL, tcfg, _source(), run, device="cpu")
    assert (b.global_step, b.start_epoch, b.start_batch) == (3, 0, 3)  # the cap ends epoch 0 at once
    b.train()
    assert b.global_step == a.global_step == 9
    _assert_bitwise(a.state, b.state)
    loss_a, loss_b = _series(_rows(str(tmp_path / "a")), "Loss"), _series(_rows(run), "Loss")
    assert loss_b == loss_a  # steps 1-5 by the crashed run, 4-9 by the resumed one


_SIGTERM_CHILD = r"""
import dataclasses, os, signal, sys
sys.modules["torch.utils.tensorboard"] = None
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from clip_mixer_tpu_torch.config import CLIPConfig, TrainConfig
from clip_mixer_tpu_torch.data.pipeline import Batch, SyntheticSource
from clip_mixer_tpu_torch.train.trainer import Trainer

cfg = CLIPConfig(**{model!r})
tcfg = TrainConfig(global_batch_size=8, epochs=1, steps_per_epoch=8, learning_rate=1e-3, warmup_steps=2,
                   checkpoint_every_steps=10**6)


class Small(SyntheticSource):
    # token ids mapped into a 512-id vocabulary, <eot> still the argmax
    def iter_batches(self, epoch, start_batch=0):
        for b in super().iter_batches(epoch, start_batch):
            t = b["texts"]
            yield Batch(images=b["images"], texts=np.where(t >= 49406, t - 49406 + 510, t % 510).astype(np.int32))


class TermAt(Small):
    # sends this process SIGTERM as it makes batch 3 (from the prefetch thread)
    def iter_batches(self, epoch, start_batch=0):
        for b, batch in enumerate(super().iter_batches(epoch, start_batch), start_batch):
            if b == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


src = dict(batch_size=8, image_size=32, n_batches=8, n_classes=4, context_length=16)
tr = Trainer(cfg, tcfg, TermAt(**src), {run!r}, device="cpu", verbose=True)
tr.train()
print("EXITED_CLEANLY step", tr.global_step, flush=True)
assert 0 < tr.global_step < 8 and tr.checkpointer.latest_step() == tr.global_step
assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL  # the handler was restored
resumed = Trainer(cfg, tcfg, Small(**src), {run!r}, device="cpu")
assert (resumed.start_epoch, resumed.start_batch) == (0, tr.global_step)
resumed.train()
straight = Trainer(cfg, tcfg, Small(**src), {run!r} + "_straight", device="cpu")
straight.train()
assert resumed.global_step == straight.global_step == 8
for (k, v), w in zip(resumed.state.model.state_dict().items(), straight.state.model.state_dict().values()):
    assert torch.equal(v, w), k
for slot in ("mu", "nu"):
    for k, v in getattr(resumed.state.opt_state, slot).items():
        assert torch.equal(v, getattr(straight.state.opt_state, slot)[k]), (slot, k)
print("RESUMED_BIT_FOR_BIT", flush=True)
"""


def test_sigterm_checkpoints_and_resumes(tmp_path):
    """A SIGTERM mid-run saves the completed step and returns; a new Trainer
    resumes from it and ends bit for bit where an uninterrupted run ends."""
    child = tmp_path / "child.py"
    model = dict(MODEL, vocab_size=SMALL.vocab_size)
    child.write_text(_SIGTERM_CHILD.format(repo=REPO, model=model, run=str(tmp_path / "preempt")))
    p = subprocess.run([sys.executable, str(child)], capture_output=True, text=True, timeout=300)
    out = p.stdout + p.stderr
    assert p.returncode == 0, out[-3000:]
    assert "preemption save: step" in out and "EXITED_CLEANLY" in out and "RESUMED_BIT_FOR_BIT" in out, out[-3000:]


def _poison_step(trainer, at_call):
    real, calls = trainer.step_fn, []

    def poisoned(state, batch):
        state, metrics = real(state, batch)
        calls.append(1)
        if len(calls) == at_call:
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
        return state, metrics

    trainer.step_fn = poisoned


def test_nonfinite_loss_aborts_before_the_checkpoint(tmp_path):
    run = tmp_path / "nan"
    tr = Trainer(SMALL, _tcfg(epochs=1, steps_per_epoch=6), _source(n_batches=6), str(run), device="cpu")
    _poison_step(tr, at_call=5)
    with pytest.raises(FloatingPointError, match="non-finite loss nan at step 5"):
        tr.train()
    assert tr.checkpointer.all_steps() == [3]  # the last good one; step 6 never saved
    assert not (run / "export").exists()
    assert sorted(_series(_rows(str(run)), "Loss")) == [1, 2, 3]

    # the guard is opt-out, for debugging a divergence
    tr2 = Trainer(SMALL, _tcfg(epochs=1, steps_per_epoch=6, abort_on_nonfinite_loss=False), _source(n_batches=6),
                  str(tmp_path / "nan2"), device="cpu")
    _poison_step(tr2, at_call=2)
    tr2.train()
    assert tr2.global_step == 6 and np.isnan(_series(_rows(str(tmp_path / "nan2")), "Loss")[2])


@pytest.mark.parametrize("cadences", [(4, 4), (3, 5), (400, 400), (2, 7), (1, 3), (5, 2)])
def test_pick_trace_start_is_the_jax_function(cadences):
    for step in range(0, 13):
        for n in range(0, 6):
            assert _pick_trace_start(step, n, cadences) == jtrainer._pick_trace_start(step, n, cadences), (step, n)


def test_profile_steps_writes_a_trace(tmp_path):
    run = tmp_path / "prof"
    tr = Trainer(SMALL, _tcfg(epochs=1, steps_per_epoch=5, checkpoint_every_steps=100), _source(n_batches=5),
                 str(run), device="cpu", profile_steps=2)
    tr.train()
    assert tr.global_step == 5 and tr._profiler is None
    with open(run / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("name") == "train_step/update"]
    assert len(steps) == 2  # exactly the N traced steps


def test_ema_export_holds_the_ema(tmp_path):
    run = tmp_path / "ema"
    tr = Trainer(SMALL, _tcfg(epochs=1, ema_decay=0.5), _source(), str(run), device="cpu")
    tr.train()
    exported = torch.load(run / "export" / "model.pt", weights_only=True)
    live = tr.state.model.state_dict()
    assert set(exported) == set(live)
    for k, v in tr.state.opt_state.ema.items():
        assert torch.equal(exported[k], v), k
    assert not torch.equal(exported["visual.proj"], live["visual.proj"])
    model, _ = load_pretrained(str(run / "export"), device="cpu")
    assert torch.equal(model.visual.proj.detach(), tr.state.opt_state.ema["visual.proj"])


def test_jax_api_load_reads_the_port_export(tmp_path):
    tr = Trainer(SMALL, _tcfg(epochs=1), _source(), str(tmp_path / "run"), device="cpu")
    tr.train()
    params, jc, _ = cm.load(str(tmp_path / "run" / "export" / "model.pt"), compute_dtype="float32")
    assert (jc.vision_width, jc.text_width, jc.context_length, jc.vocab_size) == (64, 64, 16, 512)
    batch = next(_source().iter_batches(0))
    images = (batch["images"].astype(np.float32) / 255.0 - 0.5) / 0.25
    with torch.no_grad():
        img, txt, scale = tr.state.model(torch.from_numpy(images), torch.from_numpy(batch["texts"]))
    j_img, j_txt, j_scale = jclip.forward(params, jc, images, batch["texts"])
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(txt.numpy(), np.asarray(j_txt), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(float(scale), float(j_scale), rtol=1e-6)


class _Recorder:
    def __init__(self):
        self.calls = []

    def validate(self, step, verbose=False, params=None):
        self.calls.append((step, params))


def test_validation_cadence_is_its_own_and_sees_the_ema(tmp_path):
    v = _Recorder()
    tr = Trainer(SMALL, _tcfg(epochs=1, steps_per_epoch=6, validate_every_steps=2, ema_decay=0.9),
                 _source(n_batches=6), str(tmp_path / "val"), device="cpu", validators=[v])
    tr.train()
    assert [s for s, _ in v.calls] == [2, 4, 6] and v.writer is tr.writer
    assert tr.checkpointer.all_steps() == [3, 6]
    assert torch.equal(v.calls[-1][1]["visual.proj"], tr.state.opt_state.ema["visual.proj"])


def test_trainer_refuses_what_it_cannot_run(tmp_path):
    class Unsized(SyntheticSource):
        batches_per_epoch = None

    with pytest.raises(ValueError, match="steps_per_epoch unknown"):
        Trainer(SMALL, _tcfg(), Unsized(batch_size=8, image_size=32, context_length=16), str(tmp_path / "u"),
                device="cpu")
    small_vocab = SMALL.replace(vocab_size=256)
    tr = Trainer(small_vocab, _tcfg(), _source(), str(tmp_path / "v"), device="cpu")
    with pytest.raises(ValueError, match="token id 511 >= vocab_size 256"):
        tr.train()
    # FSDP shards over a mesh: one process without a group has none
    with pytest.raises(ValueError, match="TrainConfig.fsdp shards over a mesh"):
        Trainer(SMALL, _tcfg(fsdp=True), _source(), str(tmp_path / "w"), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(SMALL.replace(pipeline_stages=2), _tcfg(fsdp=True), _source(), str(tmp_path / "w"), device="cpu")
    with pytest.raises(ValueError, match="local directory"):
        Trainer(SMALL, _tcfg(), _source(), "gs://bucket/run", device="cpu")


def test_beat_fallback_advances_mtime(tmp_path, monkeypatch):
    """Where os.utime fails on an existing heartbeat file, the beat appends
    a byte, which advances the mtime (a bare open("a") would not)."""
    tr = Trainer.__new__(Trainer)
    tr.run_dir, tr._heartbeat_path, tr._beat_degraded = str(tmp_path), str(tmp_path / "heartbeat-0"), False
    tr._beat()  # the first beat creates the file, and is not a degradation
    assert os.path.exists(tr._heartbeat_path) and not tr._beat_degraded
    old = time.time() - 3600
    os.utime(tr._heartbeat_path, (old, old))
    real_utime = os.utime

    def deny(path, *a, **kw):
        if str(path) == tr._heartbeat_path:
            raise PermissionError("injected EPERM")
        return real_utime(path, *a, **kw)

    monkeypatch.setattr(os, "utime", deny)
    tr._beat()
    assert os.path.getmtime(tr._heartbeat_path) > old + 1800 and tr._beat_degraded


def test_metrics_writer_jsonl_tensorboard_and_remote_dirs(tmp_path, monkeypatch):
    events = []

    class Writer:
        def __init__(self, log_dir):
            events.append(("open", log_dir))

        def add_scalar(self, name, value, step):
            events.append((name, value, step))

        def flush(self):
            events.append("flush")

        def close(self):
            events.append("close")

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", types.SimpleNamespace(SummaryWriter=Writer))
    w = metrics_mod.MetricsWriter(str(tmp_path / "runs"))
    w.add_scalar("Loss", 2.5, 1)
    assert not (tmp_path / "runs" / "metrics.jsonl").exists()  # appended at flush only
    w.close()
    assert events == [("open", str(tmp_path / "runs")), ("Loss", 2.5, 1), "flush", "close"]
    assert _rows(str(tmp_path)) == [{"step": 1, "name": "Loss", "value": 2.5}]
    assert w.history["Loss"] == [(1, 2.5)]
    with pytest.raises(ValueError, match="gs://"):
        metrics_mod.MetricsWriter("gs://bucket/run/runs")
    assert not os.path.exists("gs:")
