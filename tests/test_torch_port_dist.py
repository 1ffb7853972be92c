"""The port's process-group bootstrap and mesh helpers, after ``tests/test_dist.py``.

The gates of the JAX ``maybe_initialize_distributed``, ported: no hint is a
no-op; an explicit rendezvous initialises; a multi-process environment
whose rendezvous fails raises; a single-process hint that fails is benign;
an initialised group short-circuits. The backend follows the device named.
The groups here are worlds of one over gloo, in this process, with a
``file://`` rendezvous under ``tmp_path``, destroyed after each test.
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.parallel import dist as tdist
from clip_mixer_tpu_torch.parallel import mesh as tmesh

HINTS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in HINTS:
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def world1(clean_env, tmp_path):
    assert tdist.maybe_initialize_distributed("cpu", coordinator=f"file://{tmp_path / 'store'}", num_processes=1,
                                              process_id=0, timeout_s=30)
    return dist.group.WORLD


def test_no_hints_is_noop(clean_env):
    assert tdist.maybe_initialize_distributed("cpu") is False
    assert not dist.is_initialized()


def test_explicit_rendezvous_initialises(world1):
    assert dist.is_initialized() and dist.get_world_size() == 1 and dist.get_rank() == 0
    assert dist.get_backend() == "gloo"  # the CPU named: gloo
    assert tdist.maybe_initialize_distributed("cpu") is True  # already up: short-circuits
    assert tdist.world(world1) == (0, 1) and tdist.world(None) == (0, 1)
    assert tdist.any_across(True, world1) and not tdist.any_across(False, world1)


def test_multi_process_rendezvous_failure_is_fatal(clean_env):
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "2"), ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port))):
        clean_env.setenv(k, v)
    with pytest.raises(RuntimeError, match="multi-process environment"):
        tdist.maybe_initialize_distributed("cpu", timeout_s=2)
    assert not dist.is_initialized()


def test_single_process_hint_failure_is_benign(clean_env):
    clean_env.setenv("RANK", "0")
    clean_env.setenv("WORLD_SIZE", "1")  # no MASTER_ADDR: env:// cannot rendezvous
    assert tdist.maybe_initialize_distributed("cpu", timeout_s=2) is False
    assert not dist.is_initialized()


def test_backend_follows_the_named_device():
    assert tdist.backend_for("cpu") == "gloo"
    assert tdist.backend_for("cuda") == "nccl"
    assert tdist.backend_for(torch.device("cuda", 3)) == "nccl"


def test_explicit_rendezvous_needs_all_three(clean_env):
    with pytest.raises(ValueError, match="together"):
        tdist.maybe_initialize_distributed("cpu", coordinator="127.0.0.1:1234")
    with pytest.raises(ValueError, match="need a coordinator"):
        tdist.maybe_initialize_distributed("cpu", num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="outside"):
        tdist.maybe_initialize_distributed("cpu", coordinator="127.0.0.1:1234", num_processes=2, process_id=2)
    assert not dist.is_initialized()


def test_rank_device_maps_local_rank_and_refuses_one_card_for_many(clean_env):
    """A bare ``cuda`` is the card LOCAL_RANK names; an indexed ``cuda:N``
    in a world of more than one rank, which would bind every rank to one
    card, is refused; a world of one keeps it. No card is needed: devices
    are only named."""
    with clean_env.context() as m:  # a group stands in: the mapping needs no collective
        m.setattr(tdist.dist, "is_initialized", lambda: True)
        m.setattr(tdist.dist, "get_rank", lambda: 3)
        m.setenv("LOCAL_RANK", "1")
        for n in (1, 4):
            m.setattr(tdist.dist, "get_world_size", lambda n=n: n)
            assert tdist.rank_device("cuda") == torch.device("cuda", 1)
            assert tdist.rank_device("cpu") == torch.device("cpu")
        with pytest.raises(ValueError, match="names one card for all 4 ranks"):
            tdist.rank_device("cuda:0")
        m.setattr(tdist.dist, "get_world_size", lambda: 1)
        assert tdist.rank_device("cuda:0") == torch.device("cuda", 0)


def test_mesh_refuses_tensor_parallel_and_stranded_ranks(world1):
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    assert dist.get_world_size(tmesh.data_group(mesh)) == 1
    assert tmesh.data_group(None) is None
    assert tmesh.model_group(mesh) is None and tmesh.data_index(mesh) == (0, 1)
    # a model dimension is taken; one that does not divide the ranks strands them
    with pytest.raises(ValueError, match="not divisible by n_model=2"):
        tmesh.make_mesh(n_model=2, device="cpu")
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.make_mesh(n_data=2, device="cpu")


def test_shard_batch_and_replicate(world1, monkeypatch):
    batch = {"images": np.arange(12).reshape(6, 2), "texts": np.arange(6)}
    for local in (False, True):
        got = tmesh.shard_batch(world1, batch, process_local=local)
        assert all(np.array_equal(got[k], batch[k]) for k in batch)
    with pytest.raises(ValueError, match="leading size"):
        tmesh.shard_batch(None, {"a": np.zeros(3), "b": np.zeros(4)})
    with monkeypatch.context() as m:  # a group of 4 ranks stands in: the split's arithmetic needs no collective
        m.setattr(tmesh, "world", lambda group: (1, 4))
        with pytest.raises(ValueError, match="not divisible"):
            tmesh.shard_batch(object(), batch)
        assert np.array_equal(tmesh.shard_batch(object(), {"t": np.arange(8)})["t"], [2, 3])
    cfg = tcfg.PRESETS["mixer-debug"].replace(compute_dtype="float32")
    model = CLIP(cfg, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert tmesh.replicate(world1, model) is model and tmesh.replicate(None, model) is model
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())  # a world of one: rank 0's own

