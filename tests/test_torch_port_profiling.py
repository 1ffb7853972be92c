"""The port's profiling helpers (``utils/profiling.py``) on the CPU, after
``clip_mixer_tpu/utils/profiling.py``: ``slope_time`` (the slope between two
chain lengths cancels a chain's fixed cost), ``chained_train_time`` on a
``mixer-debug`` train step (the state threads through the chain), the
``StepTimer`` meter (warm-up left out, the world size as its card count),
and ``trace`` (a Chrome trace file). Times here are the host's."""

import json
import time

import pytest
import torch

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step
from clip_mixer_tpu_torch.train.optimizer import make_optimizer
from clip_mixer_tpu_torch.utils import profiling

from torch_port_worlds import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_slope_time_cancels_the_fixed_cost():
    calls = []

    def run(n):
        calls.append(n)
        time.sleep(0.05 + 0.01 * n)  # 50 ms fixed, 10 ms an iteration

    t = profiling.slope_time(run, n1=2, n2=12)
    assert calls == [2, 2, 12]  # warm, then the two chains
    assert 0.008 < t < 0.02, t
    calls.clear()
    t = profiling.slope_time(run, n1=1, n2=3, warmup=0)  # a chain that has just run needs no warm-up
    assert calls == [1, 3] and 0.008 < t < 0.02, t
    with pytest.raises(ValueError, match="must exceed"):
        profiling.slope_time(run, n1=5, n2=5)


def test_chained_train_time_threads_the_state():
    cfg = tcfg.PRESETS["mixer-debug"]
    tc = tcfg.TrainConfig(global_batch_size=4, learning_rate=1e-3, warmup_steps=1)
    model = CLIP(cfg, device="cpu")
    opt = make_optimizer(tc, 100)
    state = init_train_state(model, opt)
    g = torch.Generator().manual_seed(0)
    batch = {"images": torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8, generator=g),
             "texts": torch.randint(1, 49407, (4, 16), dtype=torch.int32, generator=g)}
    step = make_train_step(cfg, tc, opt)
    before = model.logit_scale.detach().clone()
    t = profiling.chained_train_time(step, state, batch, n1=1, n2=3)
    assert t > 0 and state.step == 2 + 1 + 3  # warm 2, then chains of 1 and 3, on the same state
    assert not torch.equal(model.logit_scale.detach(), before)


def test_step_timer_leaves_out_warmup(monkeypatch):
    clock = iter([0.0, 1.0, 2.0, 2.5, 3.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(global_batch_size=64, warmup_steps=1)
    assert timer.n_chips == 1  # no process group: one device
    assert timer.tick() is None  # warm-up: the clock restarts at 1.0
    r = timer.tick()  # 1 step in 1.0 s
    assert r == {"steps_per_sec": 1.0, "imgs_per_sec": 64.0, "imgs_per_sec_per_chip": 64.0}
    r = timer.tick()  # 2 steps in 1.5 s
    assert r["steps_per_sec"] == pytest.approx(2 / 1.5)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
