"""Checkpoint save and resume for the single-device trainer.

Counterpart of ``clip_mixer_tpu/train/checkpoint.py``, with its contract:

* a save captures the model's parameters, the optimiser's state (Adam's
  moments, the EMA, the update count) and the step counter, with an
  ``{"epoch": E, "step": S}`` record of where to resume in the data;
* :meth:`Checkpointer.restore` writes them into the live ``TrainState`` on
  its device and returns ``(state, epoch, step)``, or ``None`` when there is
  no checkpoint.

The JAX package writes orbax; the card's host has no orbax, so the format is
``torch.save`` (a stated deviation, ROADMAP.md Queue 3). One directory per
step id holds ``model.pt`` (the model's reference-keyed f32 state dict, the
layout the JAX package's ``models/convert.py::load_torch_checkpoint``
reads), ``train_state.pt`` (``TrainState.step`` and every tensor of
``OptState``) and ``meta.json``. Each save is written to ``<id>.tmp`` and
renamed into place, so an interrupted save is never the latest one; leftover
``.tmp`` directories are removed when a Checkpointer opens the directory.
Saves are synchronous; :meth:`Checkpointer.wait` keeps the JAX call sites.

Across processes every rank holds the same replica, so one writes: a
Checkpointer opened with ``lead=False`` saves nothing and removes nothing
(the trainer's other ranks, which wait at a barrier while the lead saves),
and every rank restores the same files.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import torch

from clip_mixer_tpu_torch.train.metrics import require_local

TMP_SUFFIX = ".tmp"


def _host(tensors: Optional[Dict[str, torch.Tensor]]) -> Optional[Dict[str, torch.Tensor]]:
    return None if tensors is None else {k: v.detach().cpu() for k, v in tensors.items()}


def _copy_into(live: Optional[Dict[str, torch.Tensor]], saved: Optional[Dict[str, torch.Tensor]], what: str) -> None:
    """Copy ``saved`` into the ``live`` tensors in place; the key sets and
    shapes must match."""
    if (live is None) != (saved is None):
        raise ValueError(f"checkpoint {what}: {'absent' if saved is None else 'present'} in the checkpoint, "
                         f"{'absent' if live is None else 'present'} in the live state")
    if live is None:
        return
    if set(live) != set(saved):
        raise ValueError(f"checkpoint {what}: keys differ from the live state's: "
                         f"{sorted(set(live) ^ set(saved))[:5]}")
    with torch.no_grad():
        for k, t in live.items():
            if t.shape != saved[k].shape:
                raise ValueError(f"checkpoint {what}[{k}]: shape {tuple(saved[k].shape)}, live {tuple(t.shape)}")
            t.copy_(saved[k])


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3, lead: bool = True):
        require_local(directory, "checkpoint directory")
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        self.lead = lead
        self.last_save_bytes = 0
        os.makedirs(self.directory, exist_ok=True)
        if lead:
            self._cleanup_interrupted_saves()

    def _cleanup_interrupted_saves(self) -> None:
        """Remove the ``<id>.tmp`` directories a killed save left behind:
        they are never restored, but hold a partial copy of the state."""
        for e in os.listdir(self.directory):
            path = os.path.join(self.directory, e)
            if e.endswith(TMP_SUFFIX) and os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)

    def _path(self, step_id: int) -> str:
        return os.path.join(self.directory, str(step_id))

    def save(self, state, epoch: int, step: int, step_id: Optional[int] = None) -> None:
        """``step``: the batch index to resume from within ``epoch``;
        ``step_id``: the checkpoint's id, by default the state's step counter.
        A save of an id that exists replaces it; a Checkpointer that is not
        the lead writes nothing."""
        if not self.lead:
            return
        if step_id is None:
            step_id = int(state.step)
        final = self._path(step_id)
        tmp = final + TMP_SUFFIX
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        opt = state.opt_state
        torch.save(_host(state.model.state_dict()), os.path.join(tmp, "model.pt"))
        torch.save(
            {"step": int(state.step),
             "opt_state": {"count": int(opt.count), "mu": _host(opt.mu), "nu": _host(opt.nu), "ema": _host(opt.ema)}},
            os.path.join(tmp, "train_state.pt"),
        )
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"epoch": int(epoch), "step": int(step)}, f)
        self.last_save_bytes = sum(os.path.getsize(os.path.join(tmp, n)) for n in os.listdir(tmp))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)

    def all_steps(self) -> List[int]:
        """Retained step ids, ascending (at most ``max_to_keep``)."""
        return sorted(int(e) for e in os.listdir(self.directory)
                      if e.isdigit() and os.path.isdir(self._path(int(e))))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state) -> Optional[Tuple[object, int, int]]:
        """Write the latest checkpoint into ``state`` (its model's
        parameters and its optimiser state, on their devices) and return
        ``(state, epoch, step)``; ``None`` when there is none."""
        step_id = self.latest_step()
        if step_id is None:
            return None
        path = self._path(step_id)
        model_sd = torch.load(os.path.join(path, "model.pt"), map_location="cpu", weights_only=True)
        saved = torch.load(os.path.join(path, "train_state.pt"), map_location="cpu", weights_only=True)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        state.model.load_state_dict(model_sd, strict=True)
        opt, saved_opt = state.opt_state, saved["opt_state"]
        _copy_into(opt.mu, saved_opt["mu"], "mu")
        _copy_into(opt.nu, saved_opt["nu"], "nu")
        _copy_into(opt.ema, saved_opt["ema"], "ema")
        opt.count = int(saved_opt["count"])
        state.step = int(saved["step"])
        return state, int(meta["epoch"]), int(meta["step"])

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release."""
