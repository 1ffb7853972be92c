"""The parallel layout: a device mesh, the batch split, the replicated model.

Counterpart of ``clip_mixer_tpu/parallel/mesh.py``. JAX holds one global
array sharded over a ``("data", "model")`` mesh; here each process holds its
own rows and its own replica (or slice) of the model, and the mesh is a
``torch.distributed`` :class:`DeviceMesh` with the same dimension names. Its
``"data"`` group carries the loss's gather, the gradients' mean and FSDP's
shards (``parallel/fsdp.py``); its ``"model"`` group carries tensor
parallelism's collectives (``parallel/tp.py``). Ranks are laid out row-major:
rank ``i * n_model + j`` is data row ``i``, model column ``j``; the ranks of
one data row hold the same batch rows, as JAX's ``batch_sharding`` splits the
batch over ``"data"`` only. As in JAX, a layout that would leave ranks idle is
refused.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from clip_mixer_tpu_torch.device import DeviceLike, resolve_device
from clip_mixer_tpu_torch.parallel.dist import collective_device, world

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device: DeviceLike = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over every rank of the default process group
    (which must be up), of ``device``'s type."""
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (parallel/dist.py)")
    n = dist.get_world_size()
    if n_data is None:
        if n % n_model:
            raise ValueError(f"{n} ranks not divisible by n_model={n_model}")
        n_data = n // n_model
    if n_data * n_model != n:
        # a smaller mesh would strand ranks: a paid-for card left idle
        raise ValueError(f"a {n_data} x {n_model} mesh does not cover the {n} ranks")
    return init_device_mesh(resolve_device(device).type, (n_data, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def data_group(mesh: Optional[DeviceMesh]):
    """The process group of the mesh's data dimension; None (one device)
    for no mesh."""
    return None if mesh is None else mesh.get_group(DATA_AXIS)


def model_group(mesh: Optional[DeviceMesh]):
    """The process group of the mesh's model dimension (tensor
    parallelism); None for no mesh, a mesh without one (the pipeline's
    ``(data, stage)`` mesh, ``parallel/pp.py``) or a model dimension of one
    rank."""
    names = () if mesh is None else (mesh.mesh_dim_names or ())
    if MODEL_AXIS not in names or mesh.size(names.index(MODEL_AXIS)) == 1:
        return None
    return mesh.get_group(MODEL_AXIS)


def data_index(mesh: Optional[DeviceMesh]) -> tuple:
    """(this rank's data row, the data rows): the share of the global batch
    it holds, (0, 1) for no mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(DATA_AXIS), mesh.size(0)


def shard_batch(group, batch: Dict[str, np.ndarray], process_local: bool = False) -> Dict[str, np.ndarray]:
    """This rank's rows of a batch. ``process_local=False``: ``batch`` is the
    global batch, the same on every rank, and rank r keeps rows
    ``[r * B / n, (r + 1) * B / n)``. ``process_local=True``: each process
    already holds its own rows (each host's share of the data, as JAX's
    ``make_array_from_process_local_data`` takes them), returned as they
    are after checking that every rank holds as many."""
    rank, n = world(group)
    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"the batch's arrays disagree on their leading size: {sorted(sizes)}")
    (b,) = sizes
    if process_local:
        if group is not None:
            t = torch.tensor([b, -b], device=collective_device(group))
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
            if int(t[0]) != -int(t[1]):
                raise ValueError(f"the ranks hold different local batch sizes ({-int(t[1])}..{int(t[0])})")
        return batch
    if b % n:
        raise ValueError(f"global batch {b} is not divisible by the {n} ranks of the data axis")
    lb = b // n
    return {k: v[rank * lb:(rank + 1) * lb] for k, v in batch.items()}


@torch.no_grad()
def replicate(group, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast the parameters and buffers of ``group``'s first rank to
    every rank of ``group``, in place, so every replica starts from the same
    state whatever seed or checkpoint each rank loaded; a no-op for
    ``group=None``. Over a mesh's data group each model column broadcasts
    within itself."""
    if group is None:
        return module
    src = dist.get_global_rank(group, 0)
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
    return module
