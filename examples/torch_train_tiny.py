"""Minimal end-to-end training run with the PyTorch port: synthetic data, tiny model.

The same Trainer / step / checkpoint stack the production CLI uses: this
is `python -m clip_mixer_tpu_torch.train_cli --preset mixer-debug
--synthetic` as a library call, for users embedding training in their own
programs. Completion writes `<run>/export`, loadable by the inference API
(see torch_zero_shot.py). Runs on the CUDA card unless `--device` names
another device.

    python examples/torch_train_tiny.py [--device cpu]
"""

# Allow running straight from a repo checkout without pip install.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import argparse
import tempfile

import clip_mixer_tpu_torch as cm
from clip_mixer_tpu_torch.config import PRESETS, TrainConfig
from clip_mixer_tpu_torch.data.pipeline import SyntheticSource
from clip_mixer_tpu_torch.train.trainer import Trainer

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
args = p.parse_args()

cfg = PRESETS["mixer-debug"]
tcfg = TrainConfig(
    epochs=1,
    steps_per_epoch=4,
    global_batch_size=8,
    checkpoint_every_steps=2,
)

run_dir = tempfile.mkdtemp(prefix="clip_mixer_tiny_")
data = SyntheticSource(
    batch_size=tcfg.global_batch_size,
    image_size=cfg.image_resolution,
    n_batches=tcfg.steps_per_epoch,
    context_length=cfg.context_length,
)
trainer = Trainer(cfg, tcfg, data, run_dir, device=args.device)
trainer.train()

model, loaded_cfg, preprocess = cm.load(f"{run_dir}/export", device=args.device)
print(f"trained + exported to {run_dir}/export; "
      f"embed_dim={loaded_cfg.embed_dim}, params load OK")
