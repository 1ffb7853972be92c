"""Process-group bootstrap and the few collectives the trainer needs.

Counterpart of ``clip_mixer_tpu/parallel/dist.py``. JAX discovers a pod
slice from TPU metadata; here a run is told its rendezvous, in one of two
ways, as the reference's ``torchrun`` launch is:

* explicitly: ``coordinator`` (``host:port`` or a ``tcp://`` / ``file://``
  URL), ``num_processes`` and ``process_id``, as ``train_cli``'s flags of
  the same names pass them;
* by a launcher's environment: ``torchrun``'s ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR`` and ``MASTER_PORT``.

With neither, :func:`maybe_initialize_distributed` does nothing and returns
False: one process, one device. The backend follows the device the caller
names: NCCL for ``cuda``, gloo for the CPU; nothing probes for a card and
falls back. JAX's split between benign and fatal failures is kept: where the
environment names more than one process, a failed rendezvous raises, so no
rank goes on to train alone; a single-process hint that fails is skipped.
Every process group gets an explicit timeout, so a rank whose peers are gone
fails instead of waiting for ever.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from clip_mixer_tpu_torch.device import DeviceLike, resolve_device

DEFAULT_TIMEOUT_S = 600.0
# what a launcher sets (torchrun): any of them means "a rendezvous was meant"
ENV_HINTS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def backend_for(device: DeviceLike) -> str:
    """NCCL for a CUDA device, gloo for anything else."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def _init_method(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def maybe_initialize_distributed(
    device: DeviceLike = None,
    verbose: bool = False,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Initialise the default process group when a rendezvous is given or
    a launcher's environment names one; returns True if a group is up
    (already or now), False for a single process."""
    if dist.is_initialized():
        return True
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator is not None:
        backend = backend_for(device)
        if num_processes is None or process_id is None:
            raise ValueError("an explicit rendezvous needs coordinator, num_processes and process_id together")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is outside [0, {num_processes})")
        dist.init_process_group(backend, init_method=_init_method(coordinator), world_size=num_processes,
                                rank=process_id, timeout=timeout)
        _bind_card(device)
        if verbose:
            print(f"torch.distributed initialized (explicit, {backend}): process "
                  f"{dist.get_rank()}/{dist.get_world_size()}", flush=True)
        return True
    if num_processes is not None or process_id is not None:
        raise ValueError("num_processes / process_id need a coordinator")

    if not any(os.environ.get(k) for k in ENV_HINTS):
        return False
    # a launcher that names several processes makes a failed rendezvous
    # fatal: swallowing it would let every rank train alone on its shard
    expect_multi = int(os.environ.get("WORLD_SIZE", "1") or "1") > 1
    backend = backend_for(device)
    try:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    except Exception as e:
        if expect_multi:
            raise RuntimeError(
                f"a multi-process environment (WORLD_SIZE={os.environ.get('WORLD_SIZE')}) was found but "
                f"init_process_group failed: {e}"
            ) from e
        if verbose:
            print(f"init_process_group skipped (single-process hint variables): {e}", flush=True)
        return False
    _bind_card(device)
    if verbose:
        print(f"torch.distributed initialized ({backend}): process {dist.get_rank()}/{dist.get_world_size()}",
              flush=True)
    return True


def rank_device(device: DeviceLike = None) -> torch.device:
    """The device this process trains on: ``device`` as named; a bare
    ``cuda`` under an initialised group is the card ``LOCAL_RANK`` names
    (``torchrun``), else the rank modulo the cards visible. An indexed
    ``cuda:N`` in a world of more than one rank is refused: it would bind
    every rank to the same card, which NCCL does not take."""
    dev = resolve_device(device)
    if dev.type != "cuda" or not dist.is_initialized():
        return dev
    if dev.index is not None:
        if dist.get_world_size() > 1:
            raise ValueError(f"device {dev} names one card for all {dist.get_world_size()} ranks: pass a bare "
                             "'cuda' and each rank takes the card LOCAL_RANK names")
        return dev
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local else dist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", index)


def _bind_card(device: DeviceLike) -> None:
    """Make this rank's card the current one, where NCCL takes it from."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)


def world(group=None) -> tuple:
    """(rank, world size) in ``group``; (0, 1) for ``group=None``."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def collective_device(group) -> torch.device:
    """Where ``group``'s collectives take their tensors: the current card
    under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def any_across(flag: bool, group) -> bool:
    """The OR of every rank's ``flag`` (one all-reduce of a one-element
    tensor)."""
    t = torch.tensor([1.0 if flag else 0.0], device=collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item() > 0)


def barrier(group) -> None:
    """Every rank of ``group`` reaches this point before any leaves it (an
    all-reduce, which NCCL and gloo both order with the other collectives)."""
    t = torch.zeros(1, device=collective_device(group))
    dist.all_reduce(t, group=group)
    t.item()
