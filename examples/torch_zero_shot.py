"""Zero-shot classification with the PyTorch port, both API styles.

Runs offline with a randomly initialised preset; swap the model name for
"ViT-B/32" (downloads the OpenAI checkpoint) or a trained
`outputs/<run>/export` dir for real predictions. The native style runs on
the CUDA card unless `--device` names another device; the compat style
runs on the CPU in float32, so both lines print the same numbers.

    python examples/torch_zero_shot.py [model_name] [--device cpu]
"""

# Allow running straight from a repo checkout without pip install.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import argparse

import numpy as np
from PIL import Image

LABELS = ["a diagram", "a dog", "a cat"]
_ASSET = os.path.join(os.path.dirname(__file__), "..", "tests", "assets", "CLIP.png")


def demo_image() -> Image.Image:
    try:  # the repo's test asset (the reference's CLIP.png)
        return Image.open(_ASSET).convert("RGB")
    except OSError:
        rng = np.random.default_rng(0)
        return Image.fromarray(rng.integers(0, 255, (224, 224, 3), np.uint8))


def native_style(model_name, device=None):
    """The port's own API: what training, serving and the evals use."""
    import torch

    import clip_mixer_tpu_torch as clip
    from clip_mixer_tpu_torch.ops.preprocess import normalize_images

    # float32 so both styles print the same numbers (the default is bf16)
    model, cfg, preprocess = clip.load(model_name, compute_dtype="float32", device=device)
    image = torch.tensor(preprocess(demo_image()))[None].to(model.device)  # HWC uint8 -> [1,H,W,3]
    tokens = torch.from_numpy(clip.tokenize(LABELS, context_length=cfg.context_length, truncate=True))
    with torch.no_grad():
        per_image, _ = model.logits(normalize_images(image), tokens.to(model.device))
    probs = per_image.softmax(-1).cpu().numpy()  # per row: right for any batch size
    print("native:", dict(zip(LABELS, np.round(probs[0], 4))))


def torch_style(model_name):
    """The reference's torch API, through the compat drop-in."""
    import torch

    import clip_mixer_tpu_torch.compat as clip

    # the device picks the compute dtype as the reference's did (cpu -> f32,
    # a CUDA device -> bf16); "cpu" here so both styles print the same numbers
    model, preprocess = clip.load(model_name, device="cpu")
    image = preprocess(demo_image()).unsqueeze(0)
    text = clip.tokenize(LABELS, context_length=model.context_length, truncate=True)
    with torch.no_grad():
        per_image, _ = model.logits(image, text)
    print("compat:", dict(zip(LABELS, np.round(per_image.softmax(-1).numpy()[0], 4))))


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model", nargs="?", default="mixer-debug")
    p.add_argument("--device", default=None, help="torch device of the native style (default: the CUDA card)")
    args = p.parse_args()
    native_style(args.model, args.device)
    torch_style(args.model)
