"""The port's pipeline stages in the trainer and the CLI, on the CPU, after ``tests/test_pp.py``.

* ``train_cli --pipeline-stages 2`` in a world of 2 over gloo
  (``tests/torch_port_worlds.py``): each rank holds and checkpoints its
  stage's blocks only (``shard-{rank}.pt`` + ``layout.json`` with the
  stages); a run crashed by the drill after a save resumes bit for bit
  (shards and export equal to a run straight through); the loss falls; the
  export is the whole model, which ``api.load`` reads like any other; a
  restore into another layout is refused, naming both.
* ``train_cli --pipeline-stages 2`` launched as 2 processes: the
  rehearsal of ``tests/test_torch_port_launch.py``.
* The refusals, as JAX's: FSDP with pipeline stages, a ResNet trunk, a
  depth the stages do not divide, ``--pipeline-stages`` with
  ``--tensor-parallel`` or ``--fsdp``, and stages that do not divide the
  world.
"""

import glob
import os
import types

import pytest
import torch

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch import train_cli
from clip_mixer_tpu_torch.api import load
from clip_mixer_tpu_torch.data.pipeline import SyntheticSource
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.parallel import pp
from clip_mixer_tpu_torch.parallel.dist import maybe_initialize_distributed
from clip_mixer_tpu_torch.train.optimizer import make_optimizer
from clip_mixer_tpu_torch.train.trainer import Trainer

from torch_port_worlds import one_torch_thread, run_world, state_hash  # noqa: F401 (an autouse fixture)

ARGV = ["--synthetic", "--preset", "mixer-debug", "--device", "cpu", "--global-batch-size", "8",
        "--steps-per-epoch", "6", "--epochs", "1", "--checkpoint-every", "2", "--no-validators",
        "--learning-rate", "1e-3", "--pipeline-microbatches", "2"]
CRASH = 3  # the drill after step 3: the run resumes from its checkpoint at step 2


@pytest.fixture(scope="module")
def trainer_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp_trainer")
    ranks = run_world("pp_trainer", 2, root, {"argv": ARGV, "flags": ["--pipeline-stages", "2"], "crash": CRASH,
                                              "other_flags": []})
    (world_dir,) = glob.glob(str(root / "world_pp_trainer_*"))
    return ranks, world_dir


def test_trainer_checkpoints_each_stage_and_resumes_bit_for_bit(trainer_world):
    ranks, _ = trainer_world
    for rank, res in enumerate(ranks):
        assert res["after_crash"] == ["2"]
        assert res["checkpoints"] == {"straight": ["2", "4", "6"], "resumed": ["2", "4", "6"]}
        assert res["files"] == ["layout.json", "meta.json", "shard-0.pt", "shard-1.pt"]
        lay = res["layout"]
        assert (lay["world"], lay["n_data"], lay["n_model"], lay["n_stage"], lay["fsdp"]) == (2, 1, 1, 2, False)
        # this rank's shard holds its stage's block of each tower (mixer-debug: 2 blocks a tower)
        blocks = {int(pp._BLOCK.match(k).group(2)) for k in res["shard_keys"] if pp.is_stage_block(k)}
        assert blocks == {rank}, blocks
        assert "logit_scale" in res["shard_keys"] and "visual.conv1.weight" in res["shard_keys"]
        assert res["shard_hashes"][0] == res["shard_hashes"][1], f"rank {rank}: the resumed shard differs"
        assert res["export_hashes"][0] == res["export_hashes"][1]
        assert "2 pipeline stages" in res["refusal"] and "whole on every rank" in res["refusal"]
    assert ranks[0]["export_hashes"] == ranks[1]["export_hashes"]


def test_loss_falls_and_the_export_loads_whole(trainer_world):
    ranks, world_dir = trainer_world
    losses = ranks[0]["losses"]["straight"]
    assert len(losses) == 6 and losses[-1] < losses[0], losses
    assert ranks[0]["losses"]["straight"] == ranks[1]["losses"]["straight"]
    export = os.path.join(world_dir, "outputs", "straight", "export")
    model, cfg, _ = load(export, device="cpu")
    whole = CLIP(tcfg.PRESETS["mixer-debug"], device="cpu").state_dict()
    sd = model.state_dict()
    assert set(sd) == set(whole) and len(model.visual.transformer.mixBlocks) == 2
    assert state_hash(torch.load(os.path.join(export, "model.pt"), weights_only=True)) == ranks[0]["export_hashes"][0]


# ---- the refusals ----------------------------------------------------------------------------------------


def _stub_mesh(n_data, n_stage):
    return types.SimpleNamespace(mesh_dim_names=("data", "stage"), size=lambda i: (n_data, n_stage)[i])


def test_refusals(tmp_path, monkeypatch):
    cfg = tcfg.PRESETS["mixer-debug"]
    tc = tcfg.TrainConfig(global_batch_size=4, epochs=1, warmup_steps=1, fsdp=True)
    data = SyntheticSource(batch_size=4, image_size=32, n_batches=2, context_length=cfg.context_length)
    # FSDP with pipeline stages, as JAX's trainer (a mesh with a stage dim of 2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(cfg, tc, data, str(tmp_path / "r"), device="cpu", mesh=_stub_mesh(1, 2))
    # a ResNet trunk is no block stack; the depths must divide by the stages
    rn = tcfg.PRESETS["rn50"].replace(vision_layers=(1, 1, 1, 1), vision_width=8)
    opt = make_optimizer(tcfg.TrainConfig(), 2)
    with pytest.raises(NotImplementedError, match="uniform block stack"):
        pp.make_pp_train_step(rn, tcfg.TrainConfig(), _stub_mesh(1, 2), opt, n_micro=2)
    with pytest.raises(ValueError, match="divisible by the stages: 3/2 vs 2"):
        pp.make_pp_train_step(cfg.replace(vision_layers=3), tcfg.TrainConfig(), _stub_mesh(1, 2), opt, n_micro=2)
    # the CLI: stages with tensor parallelism or FSDP, stages that do not divide the world
    for extra, match in ((["--tensor-parallel", "2"], "--pipeline-stages and --tensor-parallel do not compose"),
                         (["--fsdp"], "--pipeline-stages and --fsdp do not compose"),
                         (["--pipeline-microbatches", "0"], "--pipeline-microbatches must be >= 1")):
        with pytest.raises(SystemExit, match=match):
            train_cli.main(ARGV + ["--pipeline-stages", "2"] + extra)
    args = train_cli.parse_args(ARGV + ["--pipeline-stages", "3"])
    monkeypatch.setattr(train_cli.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(train_cli.dist, "get_world_size", lambda: 4)
    with pytest.raises(SystemExit, match="--pipeline-stages 3 does not divide the 4 processes"):
        train_cli.build_mesh(args, "cpu")


def test_world_of_one_mesh_and_microbatch_refusals(tmp_path, monkeypatch):
    """In a world of one: a (1, 1) (data, stage) mesh; a layout that
    strands ranks is refused; a model that is not cut is refused by the step,
    and a batch the microbatches do not divide."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    import torch.distributed as dist

    assert maybe_initialize_distributed("cpu", coordinator=f"file://{tmp_path / 'store'}", num_processes=1,
                                        process_id=0, timeout_s=30)
    try:
        with pytest.raises(ValueError, match="does not cover the 1 ranks"):
            pp.make_pp_mesh(1, 2, device="cpu")
        mesh = pp.make_pp_mesh(1, 1, device="cpu")
        assert mesh.mesh_dim_names == ("data", "stage") and pp.n_stages_of(mesh) == 1
        cfg = tcfg.PRESETS["mixer-debug"]
        tc = tcfg.TrainConfig(global_batch_size=6, warmup_steps=1)
        opt = make_optimizer(tc, 2)
        from clip_mixer_tpu_torch.parallel.train_step import init_train_state

        model = CLIP(cfg, device="cpu")
        step = pp.make_pp_train_step(cfg, tc, mesh, opt, n_micro=4)
        batch = {"images": torch.zeros(6, 32, 32, 3, dtype=torch.uint8), "texts": torch.zeros(6, 16, dtype=torch.int32)}
        with pytest.raises(ValueError, match="shard_model_pp"):
            step(init_train_state(model, opt), batch)
        pp.shard_model_pp(model, mesh)
        with pytest.raises(ValueError, match="must split into 4 pipeline microbatches"):
            step(init_train_state(model, opt), batch)
    finally:
        dist.destroy_process_group()


@pytest.fixture
def world1(tmp_path, monkeypatch):
    import torch.distributed as dist

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize_distributed("cpu", coordinator=f"file://{tmp_path / 'store1'}", num_processes=1,
                                        process_id=0, timeout_s=30)
    yield pp.make_pp_mesh(1, 1, device="cpu")
    dist.destroy_process_group()


WIDE = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=128, vision_patch_size=16,
            context_length=12, vocab_size=256, text_width=128, text_heads=2, text_layers=2, tower="mixer",
            compute_dtype="float32")


@pytest.mark.parametrize("route", ["plain", "fused_mlp", "fused_block"])
def test_one_stage_one_microbatch_is_the_single_device_step_bit_for_bit(world1, route):
    """A stage group of one with one microbatch, on each route (the
    kernels' plain versions on CPU tensors): every loss and, after three
    steps, every parameter, Adam moment and EMA entry bit for bit the
    single-device step's (``chip_smoke.py`` phase 14a holds this on the
    card); with 4 microbatches the losses agree to f32 rounding."""
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step

    rng = torch.Generator().manual_seed(0)
    batches = [{"images": torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8, generator=rng),
                "texts": torch.randint(1, 255, (8, 12), dtype=torch.int32, generator=rng)} for _ in range(3)]
    cfg = tcfg.CLIPConfig(**WIDE, fused_mlp=route == "fused_mlp")
    tc = tcfg.TrainConfig(global_batch_size=8, learning_rate=1e-3, warmup_steps=2, ema_decay=0.9)
    runs = {}
    for name, n_micro in (("single", None), ("pp1", 1), ("pp4", 4)):
        model = CLIP(cfg, device="cpu")
        if route == "fused_block":
            route_towers(model, True)
        opt = make_optimizer(tc, 10)
        if n_micro is None:
            step = make_train_step(cfg, tc, opt)
        else:
            pp.shard_model_pp(model, world1)
            step = pp.make_pp_train_step(cfg, tc, world1, opt, n_micro=n_micro)
        state = init_train_state(model, opt)
        losses = [step(state, b)[1]["loss"] for b in batches]
        runs[name] = (losses, model.state_dict(), state.opt_state)
    (la, pa, oa), (lb, pb, ob) = runs["single"], runs["pp1"]
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for what, a, b in (("params", pa, pb), ("mu", oa.mu, ob.mu), ("nu", oa.nu, ob.nu), ("ema", oa.ema, ob.ema)):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), what
    torch.testing.assert_close(torch.stack(runs["pp4"][0]), torch.stack(la), rtol=1e-5, atol=0)
