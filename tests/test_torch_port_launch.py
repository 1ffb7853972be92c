"""The port's launch layer (``launch.py``) and preflight (``scripts/torch_preflight.py``), after
``tests/test_launch.py``.

* ``render_commands``: the upload and ``torchrun`` lines of a preset over
  its hosts, ``python -m clip_mixer_tpu_torch.train_cli`` on every host, the
  data glob arriving as one argument through both shells; the presets
  distinct; a host count that is not the preset's refused.
* ``rehearse_local(2)``: the run line's module and arguments as 2 CPU
  processes over gloo at ``mixer-debug`` with ``--pipeline-stages 2`` (a
  stage a process, each checkpointing its shard; the loss falls), the
  frozen serving programs riding along (a collective gather of the stages,
  then the lead's freeze).
* ``scripts/torch_preflight.py --device cpu``: go, and no-go (a data glob
  that matches nothing; the card's path without a card).
"""

import importlib.util
import json
import shlex
from pathlib import Path

import pytest

from clip_mixer_tpu_torch.launch import MODULE, PRESETS, rehearse_local, render_commands

REPO = Path(__file__).resolve().parents[1]


def test_render_commands_structure():
    cmds = render_commands(PRESETS["mixer-b32-host8"], ["gpu-a"], data_glob="/data/shards/*.tar")
    upload, run = cmds.splitlines()
    assert upload.startswith("rsync -a") and upload.endswith("gpu-a:clip-mixer-tpu/")
    assert run.startswith("ssh gpu-a ")
    remote = shlex.split(run)[2]
    assert "torchrun --nnodes 1 --nproc-per-node 8 --node-rank 0 --master-addr gpu-a" in remote
    assert f"-m {MODULE} --preset mixer-b32 --global-batch-size 32768" in remote
    two = render_commands(PRESETS["mixer-b32-host8"].__class__(name="x", nodes=2, train_args="--preset mixer-b32"),
                          ["h0", "h1"], port=1234).splitlines()
    assert len(two) == 4 and "--node-rank 1 --master-addr h0 --master-port 1234" in two[3]
    with pytest.raises(ValueError, match="runs on 1 host"):
        render_commands(PRESETS["mixer-b32-host8"], ["a", "b"])


def test_render_commands_quoting_survives_both_shells():
    """The run line passes two shells (local, then ssh's remote one): split
    as the local shell does, it is one ssh call; split as the remote shell
    does, ``--data`` gets the glob verbatim, space and star."""
    run = render_commands(PRESETS["mixer-b32-host8"], ["gpu a"], data_glob="/b/sh ards/*.tar").splitlines()[-1]
    argv = shlex.split(run)
    assert argv[:2] == ["ssh", "gpu a"] and len(argv) == 3
    remote = argv[2]
    assert remote.startswith("cd clip-mixer-tpu && torchrun")
    remote_argv = shlex.split(remote.split("&&", 1)[1])
    assert remote_argv[remote_argv.index("--data") + 1] == "/b/sh ards/*.tar"
    assert remote_argv[remote_argv.index("--master-addr") + 1] == "gpu a"


def test_render_all_presets_distinct():
    rendered = {name: render_commands(p, [f"h{i}" for i in range(p.nodes)]) for name, p in PRESETS.items()}
    assert len(set(rendered.values())) == len(rendered) == 3
    assert all("torchrun" in t and MODULE in t for t in rendered.values())
    assert {p.gpus_per_node for p in PRESETS.values()} == {8, 4}


def test_rehearse_local_two_processes(tmp_path, monkeypatch):
    site = tmp_path / "site"
    site.mkdir()  # torch.utils.tensorboard blocked in the children: its TensorFlow costs seconds a process
    (site / "sitecustomize.py").write_text("import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    monkeypatch.setenv("PYTHONPATH", str(site))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # two ranks beside the suite's other workers
    outs = rehearse_local(
        n_processes=2,
        train_args=("--preset mixer-debug --synthetic --global-batch-size 8 --steps-per-epoch 6 --epochs 1 "
                    "--checkpoint-every 3 --learning-rate 1e-3 --no-validators --run-name rehearsal "
                    "--pipeline-stages 2 --pipeline-microbatches 2 --freeze-serving --verbose"),
        cwd=str(tmp_path), timeout=300.0)
    joined = "\n".join(outs)
    assert "process 0/2" in joined and "process 1/2" in joined
    run = tmp_path / "outputs" / "rehearsal"
    assert sorted(p.name for p in (run / "checkpoints" / "6").iterdir()) == [
        "layout.json", "meta.json", "shard-0.pt", "shard-1.pt"]
    assert json.loads((run / "checkpoints" / "6" / "layout.json").read_text())["n_stage"] == 2
    losses = [r["value"] for r in map(json.loads, (run / "runs" / "metrics.jsonl").read_text().splitlines())
              if r["name"] == "Loss"]
    assert len(losses) == 6 and losses[-1] < losses[0], losses
    assert (run / "heartbeat-0").exists() and (run / "heartbeat-1").exists()
    assert (run / "export" / "servable" / "manifest.json").exists()


def _preflight():
    spec = importlib.util.spec_from_file_location("torch_preflight", REPO / "scripts" / "torch_preflight.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_preflight_go_and_no_go(tmp_path, capsys):
    """On the CPU with ``--device cpu``: GO (the kernels' build is a
    warning: the CPU path runs their plain versions; the fast tokenizer
    builds; the plan fits 80 GiB). A glob that matches nothing is one FAIL;
    the card's path on a host without a card fails the device probe and the
    kernels' build (nothing falls back) when nvcc is absent too."""
    assert _preflight().main(["--device", "cpu", "--preset", "mixer-b32", "--devices", "1",
                              "--global-batch", "256"]) == 0
    out = capsys.readouterr().out
    assert "[PASS] C++ fast tokenizer" in out and "[warn] CUDA kernels" in out
    assert "[PASS] capacity plan: dpx1 fits" in out and out.rstrip().endswith("GO: 0 failed check(s)")
    assert _preflight().main(["--device", "cpu", "--data", str(tmp_path / "none-*.tar")]) == 1
    assert "[FAIL] data shards: no shards match" in capsys.readouterr().out
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the no-card probe does not apply")  # pragma: no cover
    failures = _preflight().main(["--device", "cuda", "--device-timeout", "120"])
    out = capsys.readouterr().out
    assert "[FAIL] device: rc=1" in out and "NO-GO" in out
    assert failures == (1 if shutil.which("nvcc") else 2)
