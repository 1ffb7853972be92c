"""Semantic search end to end with the PyTorch port: embed a corpus, index it, query by text.

    python examples/torch_semantic_search.py [model] [--device cpu]

Runs on the CUDA card unless `--device` names another device. Uses
synthetic class-colored images so it runs anywhere; point
`scripts/torch_embed_dataset.py` at real tar shards for a production bank.
"""

# Allow running straight from a repo checkout without pip install.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import argparse

import numpy as np

import clip_mixer_tpu_torch as clip
from clip_mixer_tpu_torch.data.pipeline import SyntheticSource
from clip_mixer_tpu_torch.serving import InferenceEngine, softmax_probs

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("model", nargs="?", default="mixer-debug")
p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
args = p.parse_args()

model, cfg, _ = clip.load(args.model, device=args.device)
engine = InferenceEngine(model, batch_buckets=(32,))

# A tiny "corpus": one batch of class-colored synthetic images. Recover each
# image's class from its caption tokens so the ids are human-checkable.
src = SyntheticSource(batch_size=32, image_size=cfg.image_resolution, n_batches=1)
batch = next(src.iter_batches(epoch=0))
classes = [int(np.argmax((src.tokens == t).all(-1))) for t in batch["texts"]]
ids = [f"{src.captions[c].removeprefix('a photo of a ').rstrip('.')}#{i}" for i, c in enumerate(classes)]
engine.index_images(batch["images"], ids)

for query in ["a photo of a red square.", "a photo of a silver moon."]:
    hits = engine.retrieve([query], top_k=3)[0]
    print(query, "->", [(h["id"], round(h["score"], 3)) for h in hits])

# The reference README demo (logits -> softmax probs) over the same engine:
logits = engine.similarity(batch["images"][:1], ["a red square", "a dog", "a car"])
print("demo probs:", softmax_probs(logits).round(4))
