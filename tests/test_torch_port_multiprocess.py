"""Two-process runs of the port over gloo, after ``tests/test_multiprocess.py``.

Each test spawns a world of two ranks (``tests/torch_port_worlds.py``,
torch only, a ``file://`` rendezvous, a deadline) or two ``train_cli``
processes:

* disjoint ``TarShardSource`` shards per rank feeding one data-parallel
  step, whose loss equals JAX's on a 2-device mesh over the same global
  batch;
* a ``Trainer`` across the two: rank 0 alone writes the checkpoints and
  the metrics, each rank its heartbeat, and a run crashed by the drill
  resumes bit for bit the run that went straight through;
* a SIGTERM to one rank: both ranks save at the same step;
* ``train_cli --coordinator --num-processes --process-id`` end to end.
"""

import io
import json
import os
import subprocess
import sys
import tarfile
import time

import numpy as np
import pytest

import jax

from clip_mixer_tpu import config as jcfg
from clip_mixer_tpu.models import clip as jclip
from clip_mixer_tpu.parallel import train_step as jstep
from clip_mixer_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from clip_mixer_tpu.train.optimizer import make_optimizer as jax_make_optimizer

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.models.convert import load_jax_params

from torch_port_worlds import REPO, run_world

MODEL = dict(embed_dim=16, image_resolution=16, vision_layers=1, vision_width=32, vision_patch_size=8,
             context_length=16, vocab_size=49408, text_width=32, text_heads=1, text_layers=1, tower="mixer",
             compute_dtype="float32")
TRAIN = dict(global_batch_size=8, learning_rate=1e-3, warmup_steps=2)


def _write_shards(root, n_shards=4, per_shard=6):
    """Tar shards of ``.npy`` uint8 16x16 images with captions (numpy seed 0)."""
    rng = np.random.default_rng(0)
    paths = []
    for s in range(n_shards):
        path = root / f"shard-{s:02d}.tar"
        with tarfile.open(path, "w") as tar:
            for i in range(per_shard):
                buf = io.BytesIO()
                np.save(buf, rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
                for name, data in ((f"{s:02d}{i:03d}.npy", buf.getvalue()),
                                   (f"{s:02d}{i:03d}.txt", f"a photo of thing {s} {i}".encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
        paths.append(str(path))
    return paths


def test_disjoint_shards_one_step_equals_jax_two_devices(tmp_path):
    shards = _write_shards(tmp_path)
    jc = jcfg.CLIPConfig(**MODEL)
    init = jax.tree.map(np.array, jclip.init(jax.random.key(0), jc))
    sd = load_jax_params(CLIP(tcfg.CLIPConfig(**MODEL), device="cpu"), init).state_dict()
    ranks = run_world("tar_step", 2, tmp_path, dict(model=MODEL, train=TRAIN, shards=shards, local_b=4, init=sd))
    a, b = (set(r["shards"]) for r in ranks)
    assert a and b and not a & b and a | b == set(shards)  # disjoint, and every shard read
    batch = {k: np.concatenate([r["batch"][k] for r in ranks]) for k in ("images", "texts")}
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    jt = jcfg.TrainConfig(**TRAIN)
    opt = jax_make_optimizer(jt, total_steps=10)
    state = replicate(mesh, jstep.init_train_state(jax.tree.map(np.asarray, init), opt))
    _, m = jstep.make_train_step(jc, jt, mesh, opt)(state, shard_batch(mesh, batch))
    for r in ranks:  # the averaged loss, alike on both ranks
        np.testing.assert_allclose(r["loss"], float(m["loss"]), rtol=2e-5)


TRAINER = dict(model=dict(MODEL, vocab_size=49408),
               train=dict(TRAIN, epochs=1, steps_per_epoch=4, checkpoint_every_steps=2, keep_checkpoints=3),
               batches=4, crash=2)


def test_trainer_across_two_processes_leads_from_rank0_and_resumes_bit_for_bit(tmp_path):
    ranks = run_world("trainer_resume", 2, tmp_path, dict(TRAINER, root=str(tmp_path / "runs")))
    for r in ranks:
        assert r["a"]["step"] == r["b"]["step"] == 4
        assert r["b_crashed_at"] == 2 and r["b_resumed_from"] == 2
        assert r["b_checkpoints_after_crash"] == ["2"]
        assert r["b"]["hash"] == r["a"]["hash"], "the resumed run is not the straight run bit for bit"
        assert r["b"]["moments_hash"] == r["a"]["moments_hash"]
    assert ranks[0]["a"]["hash"] == ranks[1]["a"]["hash"], "the replicas drifted apart"
    for run in ("a", "b"):
        d = tmp_path / "runs" / run
        assert sorted(os.listdir(d / "checkpoints")) == ["2", "4"]
        assert {f for f in os.listdir(d) if f.startswith("heartbeat")} == {"heartbeat-0", "heartbeat-1"}
        rows = [json.loads(line) for line in open(d / "runs" / "metrics.jsonl")]
        assert sorted(r["step"] for r in rows if r["name"] == "Loss") == [1, 2, 3, 4]  # written once, by rank 0
        assert (d / "export" / "model.pt").exists()


def test_sigterm_to_one_rank_saves_both_at_the_same_step(tmp_path):
    p = dict(model=MODEL, train=dict(TRAIN, epochs=1, steps_per_epoch=12, checkpoint_every_steps=100,
                                     preemption_sync_every_steps=2),
             batches=12, signal_after=3, root=str(tmp_path / "run"))
    ranks = run_world("trainer_sigterm", 2, tmp_path, p)
    # rank 1's stop at step 3 is agreed at the next sync step, 4, by both
    assert [r["step"] for r in ranks] == [4, 4]
    assert ranks[0]["checkpoints"] == ranks[1]["checkpoints"] == ["4"]


def test_train_cli_launch_flags_end_to_end(tmp_path):
    """Two ``train_cli`` processes joined by ``--coordinator file://...
    --num-processes 2 --process-id I`` train ``mixer-debug`` together: both
    exit 0, rank 0 writes the checkpoints and the export, each rank its
    heartbeat."""
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    # train_cli's main with torch.utils.tensorboard blocked: its import pulls in TensorFlow (seconds a process)
    run = ("import sys; sys.modules['torch.utils.tensorboard'] = None; "
           "from clip_mixer_tpu_torch.train_cli import main; main(sys.argv[1:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", run, "--synthetic", "--preset", "mixer-debug",
         "--global-batch-size", "4", "--steps-per-epoch", "2", "--epochs", "1", "--checkpoint-every", "2",
         "--no-validators", "--fused-mlp", "--device", "cpu", "--run-name", "dp", "--coordinator", f"file://{store}",
         "--num-processes", "2", "--process-id", str(r)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    deadline = time.monotonic() + 180
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    run = tmp_path / "outputs" / "dp"
    assert sorted(os.listdir(run / "checkpoints")) == ["2"]
    assert (run / "export" / "model.pt").exists()
    assert json.loads((run / "export" / "config.json").read_text())["fused_mlp"] is True
    assert {f for f in os.listdir(run) if f.startswith("heartbeat")} == {"heartbeat-0", "heartbeat-1"}
