"""``scripts/torch_dress_witness.py`` at ``mixer-debug`` on the CPU: the dress
rehearsal's ``steps500`` leg in the JAX package and in the port, part by part.

Over a few 64-pixel shards from the port's writer, each package's rehearsal
script gives its trainer command at the leg's flags, each CLI builds its
cached training source, and:

* the first three batches, after each train step's augmentation hook, are
  bit for bit equal, and a source with another seed is caught at step 0;
* the learning rate of every update agrees within 1e-5 relative (JAX's
  schedule computes in f32), and another warmup is caught;
* JAX's ``init(key(0))`` weights through both train steps give losses
  within the JAX suite's ``LOSS_RTOL`` (2e-5) over three steps, and the
  port's own seed-0 draw has JAX's leaves: the constant ones equal, the
  others of the same mean and spread; a constant leaf moved is caught.
"""

import dataclasses
import importlib
import sys
from pathlib import Path

import pytest

from torch_port_worlds import one_torch_thread  # noqa: F401 (an autouse fixture)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
witness = importlib.import_module("torch_dress_witness")


SCHEDULE_RTOL = 1e-5  # JAX's warmup_cosine computes in f32: read 5.5e-7 here, 1.7e-6 over steps500's 522 updates
BATCH, N_SAMPLES, STEPS = 16, 64, 12  # the leg at mixer-debug: 4 batches an epoch, 3 epochs
DRAW_Z_MAX = 5.0  # two draws of one law: each leaf's mean gap within 5 standard errors
DRAW_STD_RTOL = 0.1  # and the spread of a leaf of 1,024 elements or more within 10%


@pytest.fixture(scope="module")
def leg(tmp_path_factory):
    work = tmp_path_factory.mktemp("dress_witness")
    shards = witness.script("torch_make_dress_dataset").main(
        ["--out", str(work / "dress"), "--n", "80", "--size", "64", "--samples-per-shard", "16"])
    train_glob = str(work / "dress" / "0000[0-3].tar")
    return witness.Leg(witness.rehearsal_commands(work, train_glob, shards[-1], BATCH, N_SAMPLES, STEPS,
                                                  "mixer-debug"))


def test_commands_differ_only_in_cache_and_device(leg):
    diffs = witness.command_differences(leg.commands)
    assert [d[0] for d in diffs] == ["--cache-data", "--device"], diffs
    assert leg.tcfg["port"].augment is False and leg.tcfg["jax"].augment is False


def test_first_batches_bit_for_bit(leg):
    got = witness.data_part(leg, 3)
    assert got["equal"] and got["first_difference"] is None, got
    assert got["batches_per_epoch"] == {"jax": 4, "port": 4}
    assert got["shapes"] == {"images": [BATCH, 32, 32, 3], "texts": [BATCH, 16]}


def test_another_seed_is_caught(leg):
    port = leg.data["port"]
    leg.data["port"] = type(port)(port.inner, seed=port.seed + 1, cache_dir=port.cache_dir)
    try:
        got = witness.data_part(leg, 3)
    finally:
        leg.data["port"] = port
    assert not got["equal"] and got["first_difference"]["step"] == 0, got


def test_schedule_every_update(leg):
    got = witness.schedule_part(leg, N_SAMPLES)
    for pkg in ("jax", "port"):
        assert (got[pkg]["steps_per_epoch"], got[pkg]["epochs"], got[pkg]["total_steps"]) == (4, 3, 12)
        assert len(got[pkg]["lr"]) == 12
    assert got["max_rel_gap"] <= SCHEDULE_RTOL, got
    planted = dataclasses.replace(leg.tcfg["port"], warmup_steps=3)
    real, leg.tcfg["port"] = leg.tcfg["port"], planted
    try:
        assert witness.schedule_part(leg, N_SAMPLES)["max_rel_gap"] > 0.1
    finally:
        leg.tcfg["port"] = real


def test_steps_track_jax_from_its_weights(leg):
    got = witness.step_part(leg, batch=8, steps=3, n_samples=N_SAMPLES)
    assert got["remat"] and got["total_steps"] == 12 and len(got["port_losses"]) == 3
    assert got["within_loss_rtol"] and got["max_loss_rel_gap"] <= witness.LOSS_RTOL, got
    draws = got["init_port_vs_jax"]
    assert draws["same_keys"] and draws["shape_differences"] == [], draws
    assert draws["constant"]["all_equal"] and draws["constant"]["leaves"] > 0, draws
    assert draws["drawn"]["mean_z_max"] < DRAW_Z_MAX, draws
    large = draws["drawn"]["std_ratio_large"]
    assert large["leaves"] > 0 and 1 - DRAW_STD_RTOL < large["min"] <= large["max"] < 1 + DRAW_STD_RTOL, draws


def test_a_moved_constant_leaf_is_caught():
    import torch

    drawn = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    jax_sd = {"ln.weight": torch.ones(8), "ln.bias": torch.zeros(8), "w": drawn}
    port_sd = {k: v.clone() for k, v in jax_sd.items()}
    assert witness.compare_draws(port_sd, jax_sd)["constant"] == {"leaves": 2, "all_equal": True, "differing": []}
    port_sd["ln.bias"][3] = 1e-6
    assert witness.compare_draws(port_sd, jax_sd)["constant"]["differing"] == ["ln.bias"]
