"""Programmatic serving with the PyTorch port: the InferenceEngine without the HTTP layer.

Bucketed encoders (each request batch padded to its batch bucket),
zero-shot classification against an arbitrary label set, and the
calibrated int8 switch. For the HTTP server, see
`python -m clip_mixer_tpu_torch.serving`; for a host of several cards pass
`devices=` / `--all-devices`. Runs on the CUDA card unless `--device`
names another device.

    python examples/torch_serve_embed.py [model_name] [--device cpu]
"""

# Allow running straight from a repo checkout without pip install.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import argparse

import numpy as np

import clip_mixer_tpu_torch as cm
from clip_mixer_tpu_torch.serving import InferenceEngine

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("model", nargs="?", default="mixer-debug")
p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
args = p.parse_args()

model, cfg, preprocess = cm.load(args.model, device=args.device)
engine = InferenceEngine(model, batch_buckets=(8, 32))

# Text + image embeddings (inputs are padded to the nearest bucket).
texts = ["a photo of a dog", "a photo of a cat"]
text_emb = engine.encode_text(texts)
rng = np.random.default_rng(0)
images = rng.integers(0, 255, (3, cfg.image_resolution, cfg.image_resolution, 3), np.uint8)
image_emb = engine.encode_image_arrays(images)
print("text:", text_emb.shape, "image:", image_emb.shape)

# Zero-shot classifier over custom labels.
engine.load_classifier(
    classnames=["dog", "cat", "car"],
    templates=["a photo of a {}.", "a blurry photo of a {}."],
)
print("top-2:", engine.classify(images[:1], top_k=2)[0])

# Calibrated int8 (W8A8, torch._int_mm); its accuracy is gated by
# evals/quant_gate.py: quantise a tower only once its gate passed.
engine.enable_int8(sample_images_u8=images, sample_texts=texts)
print("int8 image:", engine.encode_image_arrays(images).shape)

# Production path: calibrate once, gate, freeze, serve anywhere:
#   python scripts/torch_release.py --model <ckpt> --out release/ --data '.../*.tar'
# then in the serving process (no calibration data, no model code traced):
#   from clip_mixer_tpu_torch.aot import load_servable
#   engine = load_servable("release/")   # the recorded torch.export programs
#   engine.warmup()                      # run every bucket once
#   serve(engine, port=8000)             # clip_mixer_tpu_torch.serving.serve, then .serve_forever()
# or: python -m clip_mixer_tpu_torch.serving --model release/

# Semantic search (text -> image retrieval over an indexed bank):
#   engine.index_images(image_batch_u8, ids=[...])   # or load_index(features, ids)
#   engine.retrieve(["a dog on a beach"], top_k=5)   # [{"id": ..., "score": ...}]
# over HTTP: POST /index {"images_b64": [...], "ids": [...]}, then
#            POST /retrieve {"texts": [...], "top_k": 5}
