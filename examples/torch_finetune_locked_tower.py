"""LiT-style fine-tuning with the PyTorch port as a library call: lock one tower, train the other.

Two stages on the tiny model:

1. pretrain a few steps and export (stand-in for any checkpoint you already
   have: a port export dir, a torch ``.pt`` or a registry name all load
   through ``cm.load``);
2. fine-tune from it with the VISUAL tower frozen
   (``TrainConfig(freeze="visual")``): the frozen tower runs without
   gradients (no backward compute) and gets no AdamW moments, as the CLI's
   ``python -m clip_mixer_tpu_torch.train_cli --init-from <ckpt>
   --freeze-tower visual``.

The final export's visual tower is bit for bit the pretrained one; the text
tower moved. Runs on the CUDA card unless ``--device`` names another device.

    python examples/torch_finetune_locked_tower.py [--device cpu]
"""

# Allow running straight from a repo checkout without pip install.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import argparse
import tempfile

import torch

import clip_mixer_tpu_torch as cm
from clip_mixer_tpu_torch.config import PRESETS, TrainConfig
from clip_mixer_tpu_torch.data.pipeline import SyntheticSource
from clip_mixer_tpu_torch.train.optimizer import tower_of
from clip_mixer_tpu_torch.train.trainer import Trainer

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
args = p.parse_args()

cfg = PRESETS["mixer-debug"]


def make_data(tcfg):
    return SyntheticSource(
        batch_size=tcfg.global_batch_size,
        image_size=cfg.image_resolution,
        n_batches=tcfg.steps_per_epoch,
        context_length=cfg.context_length,
    )


def towers(state_dict):
    """Host copies of the ``visual`` and ``text`` tensors of a state dict."""
    out = {"visual": {}, "text": {}}
    for k, v in state_dict.items():
        if tower_of(k) in out:
            out[tower_of(k)][k] = v.detach().cpu().clone()
    return out


# --- stage 1: "pretrain" (any cm.load-able checkpoint works here) ---------
tcfg = TrainConfig(epochs=1, steps_per_epoch=4, global_batch_size=8,
                   checkpoint_every_steps=4)
pre_dir = tempfile.mkdtemp(prefix="lit_pretrain_")
Trainer(cfg, tcfg, make_data(tcfg), pre_dir, device=args.device).train()
pretrained, _, _ = cm.load(f"{pre_dir}/export", device=args.device)

# Host snapshot for the comparison below: the trainer updates the model it
# is given in place.
pre_snapshot = towers(pretrained.state_dict())

# --- stage 2: locked-image fine-tune --------------------------------------
ft_tcfg = TrainConfig(epochs=1, steps_per_epoch=4, global_batch_size=8,
                      checkpoint_every_steps=4, freeze="visual")
ft_dir = tempfile.mkdtemp(prefix="lit_finetune_")
Trainer(cfg, ft_tcfg, make_data(ft_tcfg), ft_dir, model=pretrained).train()

final, _, _ = cm.load(f"{ft_dir}/export", device=args.device)
final_towers = towers(final.state_dict())
v_locked = all(torch.equal(a, final_towers["visual"][k]) for k, a in pre_snapshot["visual"].items())
t_moved = any(not torch.allclose(a, final_towers["text"][k]) for k, a in pre_snapshot["text"].items())
print(f"visual tower locked bitwise: {v_locked}; text tower fine-tuned: {t_moved}")
assert v_locked and t_moved
