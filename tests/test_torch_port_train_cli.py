"""The port's training command line (``python -m clip_mixer_tpu_torch.train_cli``) on the CPU.

``main([...])`` with ``--device cpu`` trains two steps, runs the default
validators (offline: each skips) and writes the export; every flag whose
machinery is not ported exits with a message
naming its ROADMAP item; a non-finite loss exits with code 13 (the JAX
launcher's ``EXIT_NONFINITE``); ``--init-from`` starts from whatever
``api.load`` takes: a port export, a torch checkpoint, a preset.
"""

import json
import os
import sys

import pytest
import torch

from clip_mixer_tpu.launch import EXIT_NONFINITE as JAX_EXIT_NONFINITE

from clip_mixer_tpu_torch import CLIP, train_cli
from clip_mixer_tpu_torch.config import PRESETS

RUN = ["--synthetic", "--preset", "mixer-debug", "--global-batch-size", "4", "--steps-per-epoch", "2",
       "--epochs", "1", "--checkpoint-every", "2", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the CLI writes outputs/<run-name> under the working directory
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # as on the card's host
    monkeypatch.setitem(sys.modules, "datasets", None)  # every load a DatasetUnavailable at once
    monkeypatch.setenv("CLIP_MIXER_OFFLINE", "1")  # the remote validators skip without a DNS probe
    for var in ("HF_HUB_OFFLINE", "HF_DATASETS_OFFLINE"):  # an explicit _load sets them: restore them after
        monkeypatch.setenv(var, os.environ.get(var, "0"))


def _rows(run):
    with open(os.path.join("outputs", run, "runs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_main_trains_two_steps_and_writes_the_export(capsys):
    train_cli.main(RUN + ["--run-name", "r"])
    out = capsys.readouterr().out
    assert "not ported" not in out
    export = os.path.join("outputs", "r", "export")
    assert os.path.isfile(os.path.join(export, "model.pt"))
    with open(os.path.join(export, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["remat"] is True and cfg["vision_width"] == PRESETS["mixer-debug"].vision_width  # remat by default
    assert sorted(os.listdir(os.path.join("outputs", "r", "checkpoints"))) == ["2"]
    assert sum(r["name"] == "Loss" for r in _rows("r")) == 2

    train_cli.main(RUN + ["--run-name", "q", "--no-remat", "--no-validators", "--loss", "siglip"])
    assert "validators" not in capsys.readouterr().out
    with open(os.path.join("outputs", "q", "export", "config.json")) as f:
        cfg = json.load(f)
    assert cfg["remat"] is False and cfg["logit_bias_init"] == -10.0
    assert sum(r["name"] == "Logit bias" for r in _rows("q")) == 2


UNPORTED = {
    "--fsdp": ["--fsdp"],
    "--tensor-parallel": ["--tensor-parallel", "2"],
    "--pipeline-stages": ["--pipeline-stages", "2"],
}
LAUNCH = {
    "--coordinator": ["--coordinator", "localhost:1234"],
    "--num-processes": ["--num-processes", "2"],
    "--process-id": ["--process-id", "0"],
}


@pytest.mark.parametrize("flag", sorted(UNPORTED))
def test_each_unported_flag_exits_with_its_roadmap_item(flag):
    """Every flag is ported: --fsdp and --tensor-parallel
    (tests/test_torch_port_fsdp.py trains with both in a world of 4) and
    --pipeline-stages (tests/test_torch_port_pp_trainer.py, a world of 2); in
    one process without a group they exit before anything starts, naming
    the launch they need."""
    match = "--fsdp, --tensor-parallel and --pipeline-stages shard over a process group: launch under torchrun"
    with pytest.raises(SystemExit, match=match):
        train_cli.main(RUN + UNPORTED[flag])
    assert not os.path.exists("outputs")


def test_tensor_parallel_must_divide_the_world(monkeypatch):
    """train.py's mesh rule: an N that does not divide the processes exits."""
    args = train_cli.parse_args(RUN + ["--tensor-parallel", "3"])
    monkeypatch.setattr(train_cli.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(train_cli.dist, "get_world_size", lambda: 4)
    with pytest.raises(SystemExit, match="--tensor-parallel 3 does not divide the 4 processes"):
        train_cli.build_mesh(args, "cpu")
    with pytest.raises(SystemExit, match="--tensor-parallel must be >= 1"):
        train_cli.main(RUN + ["--tensor-parallel", "0"])


@pytest.mark.parametrize("flag", sorted(LAUNCH))
def test_each_launch_flag_alone_exits_naming_the_other_two(flag):
    """The explicit rendezvous takes its three flags together
    (tests/test_torch_port_multiprocess.py launches two processes with
    them); one alone exits before anything starts."""
    others = sorted(set(LAUNCH) - {flag})
    with pytest.raises(SystemExit, match=f"{flag} without {others[0]}, {others[1]}"):
        train_cli.main(RUN + LAUNCH[flag])
    assert not os.path.exists("outputs")


def test_cache_data_needs_data():
    with pytest.raises(SystemExit, match="--cache-data needs --data"):
        train_cli.main(RUN + ["--cache-data"])


def test_nonfinite_loss_exits_13(monkeypatch):
    assert train_cli.EXIT_NONFINITE == JAX_EXIT_NONFINITE == 13

    class Diverging(train_cli.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            real = self.step_fn

            def step(state, batch):
                state, metrics = real(state, batch)
                return state, dict(metrics, loss=torch.tensor(float("inf")))

            self.step_fn = step

    monkeypatch.setattr(train_cli, "Trainer", Diverging)
    with pytest.raises(SystemExit) as e:
        train_cli.main(RUN + ["--run-name", "nan"])
    assert e.value.code == 13
    assert not os.path.exists(os.path.join("outputs", "nan", "export"))


def test_init_from_a_port_export():
    train_cli.main(RUN + ["--run-name", "base", "--no-validators"])
    export = os.path.join("outputs", "base", "export")
    want = torch.load(os.path.join(export, "model.pt"), weights_only=True)
    cfg = PRESETS["mixer-debug"].for_siglip().replace(remat=False)
    model, got_cfg = train_cli.init_model(export, cfg, seed=3, device="cpu")
    assert got_cfg.remat is False and got_cfg.logit_bias_init == -10.0  # this run's knobs
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k
    assert float(model.logit_bias.detach()) == -10.0  # an InfoNCE export gains a fresh bias
    train_cli.main(RUN + ["--run-name", "tuned", "--no-validators", "--init-from", export])
    assert os.path.isfile(os.path.join("outputs", "tuned", "export", "model.pt"))
    with pytest.raises(RuntimeError, match="not found; available models"):
        train_cli.main(RUN + ["--run-name", "x", "--init-from", "no-such-model"])


@pytest.mark.parametrize("source", ["pt", "accelerate_dir"])
def test_init_from_a_torch_checkpoint(source):
    """``--init-from`` a reference-keyed fp16 ``.pt`` and an Accelerate
    directory (``pytorch_model.bin``, ``{"state_dict"}`` with ``module.``
    keys): the weights are the file's in f32, the run's knobs its own."""
    src = CLIP(PRESETS["mixer-debug"], device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
    half = {k: v.half() for k, v in src.items()}
    if source == "pt":
        path = "ref.pt"
        torch.save(half, path)
    else:
        path = "acc"
        os.makedirs(path)
        torch.save({"state_dict": {f"module.{k}": v for k, v in half.items()}}, os.path.join(path, "pytorch_model.bin"))
    cfg = PRESETS["mixer-debug"].replace(remat=True, compute_dtype="bfloat16")
    model, got_cfg = train_cli.init_model(path, cfg, seed=0, device="cpu")
    assert got_cfg.remat is True and got_cfg.compute_dtype == "bfloat16"  # this run's knobs
    assert got_cfg.vision_width == PRESETS["mixer-debug"].vision_width
    for k, v in model.state_dict().items():
        assert torch.equal(v, half[k].float()), k
    train_cli.main(RUN + ["--run-name", f"from_{source}", "--no-validators", "--init-from", path])
    assert os.path.isfile(os.path.join("outputs", f"from_{source}", "export", "model.pt"))


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in RUN if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(args + ["--run-name", "nocard", "--no-validators"])
