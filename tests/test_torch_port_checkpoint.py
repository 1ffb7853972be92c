"""The port's ``Checkpointer`` (``clip_mixer_tpu_torch/train/checkpoint.py``) on the CPU.

The counterparts of ``tests/test_checkpoint.py``: a round trip that resumes
bit for bit, ``None`` on an empty directory, ``max_to_keep``, a leftover
``.tmp`` directory removed and never restored, and a save killed halfway
that resumes from the previous step. Saves carry the parameters, Adam's
moments, the EMA, the update count and the step counter.
"""

import json
import os

import numpy as np
import pytest
import torch

from clip_mixer_tpu_torch.config import CLIPConfig, TrainConfig
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step
from clip_mixer_tpu_torch.train import checkpoint as ckpt_mod
from clip_mixer_tpu_torch.train.checkpoint import Checkpointer
from clip_mixer_tpu_torch.train.optimizer import make_optimizer

CFG = CLIPConfig(embed_dim=16, image_resolution=16, vision_layers=1, vision_width=32, vision_patch_size=8,
                 context_length=8, vocab_size=64, text_width=32, text_heads=1, text_layers=1, tower="mixer",
                 compute_dtype="float32")
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=1, ema_decay=0.9)


def _batch(seed, B=8):
    rng = np.random.default_rng(seed)
    texts = np.concatenate([np.full((B, 1), 62), rng.integers(1, 60, (B, 6)), np.full((B, 1), 63)], axis=1)
    return {"images": rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8), "texts": texts.astype(np.int32)}


def _fresh(seed=0, tcfg=TCFG):
    opt = make_optimizer(tcfg, total_steps=20)
    model = CLIP(CFG, device="cpu", generator=torch.Generator().manual_seed(seed))
    return init_train_state(model, opt), make_train_step(CFG, tcfg, opt)


def _tensors(state):
    """Every tensor the state holds, by a name of its own."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for slot in ("mu", "nu", "ema"):
        out.update({f"{slot}.{k}": v for k, v in getattr(state.opt_state, slot).items()})
    return out


def _assert_bitwise(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert (a.step, a.opt_state.count) == (b.step, b.opt_state.count)


def test_roundtrip_and_resume_determinism(tmp_path):
    state, step = _fresh()
    ck = Checkpointer(str(tmp_path / "ckpt"))
    for i in range(6):
        state, m = step(state, _batch(i))
        if i == 2:
            ck.save(state, epoch=0, step=3)
    loss_a = float(m["loss"])

    state_b, step_b = _fresh(seed=5)  # other weights: all must come from the checkpoint
    restored = Checkpointer(str(tmp_path / "ckpt")).restore(state_b)
    assert restored is not None
    state_b, epoch, batch = restored
    assert (epoch, batch, state_b.step, state_b.opt_state.count) == (0, 3, 3, 3)
    with open(tmp_path / "ckpt" / "3" / "meta.json") as f:
        assert json.load(f) == {"epoch": 0, "step": 3}
    for i in range(3, 6):
        state_b, m_b = step_b(state_b, _batch(i))
    assert float(m_b["loss"]) == loss_a
    _assert_bitwise(state, state_b)


def test_restore_none_when_empty(tmp_path):
    ck = Checkpointer(str(tmp_path / "empty"))
    assert ck.restore(_fresh()[0]) is None
    assert ck.latest_step() is None and ck.all_steps() == []


def test_max_to_keep(tmp_path):
    state, _ = _fresh()
    ck = Checkpointer(str(tmp_path / "k"), max_to_keep=2)
    for s in (1, 2, 3):
        ck.save(state, epoch=0, step=s, step_id=s)
    ck.wait()
    assert ck.latest_step() == 3 and ck.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "k")) == ["2", "3"]


def test_restore_refuses_a_state_of_another_shape(tmp_path):
    state, _ = _fresh()
    Checkpointer(str(tmp_path / "c")).save(state, epoch=0, step=0)
    no_ema, _ = _fresh(tcfg=TrainConfig(learning_rate=1e-3, warmup_steps=1))
    with pytest.raises(ValueError, match="ema"):
        Checkpointer(str(tmp_path / "c")).restore(no_ema)
    with pytest.raises(ValueError, match="local directory"):
        Checkpointer("gs://bucket/run/checkpoints")


def test_leftover_tmp_is_removed_and_never_restored(tmp_path):
    state, step = _fresh()
    ck = Checkpointer(str(tmp_path / "t"))
    ck.save(state, epoch=0, step=0, step_id=2)
    os.makedirs(tmp_path / "t" / "9.tmp")
    (tmp_path / "t" / "9.tmp" / "model.pt").write_bytes(b"partial")
    assert ck.latest_step() == 2 and ck.all_steps() == [2]
    Checkpointer(str(tmp_path / "t"))
    assert sorted(os.listdir(tmp_path / "t")) == ["2"]


def test_crash_during_save_resumes_from_the_previous_step(tmp_path, monkeypatch):
    """A save killed after its first file leaves ``6.tmp`` and no ``6``; a
    fresh Checkpointer removes the tmp, reports 4 and restores the step-4
    state bit for bit; saving step 6 again commits."""
    state, step = _fresh()
    for i in range(4):
        state, _ = step(state, _batch(i))
    ck = Checkpointer(str(tmp_path / "c"))
    ck.save(state, epoch=0, step=4)
    state4 = _fresh(seed=9)[0]
    Checkpointer(str(tmp_path / "c")).restore(state4)
    for i in range(4, 6):
        state, _ = step(state, _batch(i))

    real_save, calls = torch.save, []

    def killed(obj, path, *a, **kw):
        calls.append(path)
        if len(calls) == 2:
            raise KeyboardInterrupt("killed mid-save")
        return real_save(obj, path, *a, **kw)

    monkeypatch.setattr(ckpt_mod.torch, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        ck.save(state, epoch=0, step=6)
    monkeypatch.setattr(ckpt_mod.torch, "save", real_save)
    assert sorted(os.listdir(tmp_path / "c")) == ["4", "6.tmp"]

    ck2 = Checkpointer(str(tmp_path / "c"))
    assert sorted(os.listdir(tmp_path / "c")) == ["4"] and ck2.latest_step() == 4
    resumed, epoch, batch = ck2.restore(_fresh(seed=3)[0])
    assert (epoch, batch) == (0, 4)
    _assert_bitwise(resumed, state4)
    ck2.save(state, epoch=0, step=6)
    assert ck2.all_steps() == [4, 6]
