#!/usr/bin/env python3
"""One-command acceptance gate against a real (or stand-in) OpenAI checkpoint, on the port.

The counterpart of ``scripts/acceptance.py``. The reference's one automated
quality gate loads a registry model and reproduces the README demo
probabilities (``[[0.9928, 0.0042, 0.0030]]`` on ``CLIP.png`` x {"a
diagram", "a dog", "a cat"}); the port's bar adds ImageNet zero-shot top-1
within 0.1% of its oracle. The oracle is the port's own f32 model of the
same state dict on the CPU (``load_reference_state_dict(sd, device="cpu",
compute_dtype="float32")``), beside the model ``api.load`` puts on the
device; the JAX package holds that oracle in the CPU tests
(``tests/test_torch_port_acceptance.py``). Writes ``ACCEPTANCE_TORCH.json``:

  (a) the demo probabilities on the device against the oracle's, at the
      reference's ``atol=0.01, rtol=0.1``; and against the published
      probabilities when the checkpoint is the real ViT-B/32.
  (b) zero-shot top-1 / top-5 on the device over the class folders, and
      the side-by-side top-1 delta against the oracle on the first
      ``--torch-n-images`` (pass at <= 0.1%).
  (c) the int8 noise-floor gate (``evals/quant_gate.py``) on this
      checkpoint, over images from the dress renderer (seed 777).

``--stand-in`` runs all of it offline: a port CLIP drawn from seed 7 at
JAX's stand-in geometry (ViT, embed 128, 224 px, patch 32, widths 128, 2
layers and 2 heads a tower, the real 49,408-token vocabulary and 77-token
context) saved as a reference-keyed state dict and loaded back through
``api.load``, and 16 (color, shape) class folders of 8 JPEGs each from
``scripts/torch_make_dress_dataset.py::render_sample``. A real run needs
the OpenAI file (``~/.cache/clip`` or a path) and ImageNetV2; without the
file the record carries ``error`` and the exit code is 2:

    python scripts/torch_acceptance.py --checkpoint ViT-B/32 --imagenet datasetImageNet

Runs on the CUDA card unless ``--device`` names another device; TF32 is
off on the card, as in ``chip_smoke.py``. Exit code 0 iff every stage that
ran passed.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from clip_mixer_tpu_torch import compat  # noqa: E402
from clip_mixer_tpu_torch.api import _MODELS, load  # noqa: E402
from clip_mixer_tpu_torch.config import CLIPConfig  # noqa: E402
from clip_mixer_tpu_torch.data.hf_eval import DatasetUnavailable  # noqa: E402
from clip_mixer_tpu_torch.device import card, no_tf32, resolve_device  # noqa: E402
from clip_mixer_tpu_torch.evals.prompts import IMAGENET_CLASSNAMES, PROMPT_TEMPLATES  # noqa: E402
from clip_mixer_tpu_torch.evals.quant_gate import build_float_classifier, noise_floor_gate  # noqa: E402
from clip_mixer_tpu_torch.evals.validators import _imagenetv2_batches  # noqa: E402
from clip_mixer_tpu_torch.evals.zeroshot import (  # noqa: E402
    build_zeroshot_classifier,
    make_image_classifier,
    topk_accuracy,
)
from clip_mixer_tpu_torch.models.clip import CLIP  # noqa: E402
from clip_mixer_tpu_torch.models.convert import load_reference_state_dict, read_torch_checkpoint  # noqa: E402
from clip_mixer_tpu_torch.ops.preprocess import normalize_images, preprocess_pil  # noqa: E402
from clip_mixer_tpu_torch.text.tokenize import tokenize  # noqa: E402
from torch_make_dress_dataset import render_sample  # noqa: E402

DEMO_PROMPTS = ["a diagram", "a dog", "a cat"]
# the reference README's published OpenAI ViT-B/32 output on CLIP.png
PUBLISHED_PROBS = np.array([[0.9927937, 0.00421068, 0.00299572]])
ASSET = REPO / "tests" / "assets" / "CLIP.png"
DEMO_TOL = dict(atol=0.01, rtol=0.1)  # the reference's own (its tests/test_consistency.py)
PARITY_PCT = 0.1  # |top-1 on the device - top-1 of the oracle|, percentage points

# 16 stand-in classes: (color, shape) pairs of the dress renderer
STANDIN_CLASSES = [
    ("red", "circle"), ("green", "square"), ("blue", "triangle"), ("yellow", "ring"),
    ("purple", "diamond"), ("orange", "cross"), ("white", "dot"), ("black", "stripe"),
    ("pink", "circle"), ("brown", "square"), ("teal", "triangle"), ("gray", "ring"),
    ("red", "diamond"), ("green", "cross"), ("blue", "dot"), ("yellow", "stripe"),
]
STANDIN_SEED = 7


def standin_config() -> CLIPConfig:
    """JAX's stand-in geometry: a ViT CLIP cut in width and depth, with the
    real vocabulary and context so real tokenized prompts are in range."""
    return CLIPConfig(embed_dim=128, image_resolution=224, vision_layers=2, vision_width=128, vision_patch_size=32,
                      context_length=77, vocab_size=49408, text_width=128, text_heads=2, text_layers=2,
                      tower="transformer", compute_dtype="float32")


def make_standin_checkpoint(path, seed: int = STANDIN_SEED):
    """A seeded port CLIP at the stand-in geometry, saved as the reference-keyed
    state dict ``compat`` gives (what ``api.load`` reads back)."""
    cfg = standin_config()
    model = CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    torch.save(compat.CLIP(model, cfg).state_dict(), path)
    return path


def make_standin_imagenet(root, per_class: int, size: int, seed: int = 123):
    """Class folders ``<root>/<class>/<k>.jpeg`` (the extracted ImageNetV2
    layout), ``per_class`` renders a class of STANDIN_CLASSES as JPEG at
    quality 92; returns the class names."""
    from PIL import Image

    idx = 0
    for c, (color, shape) in enumerate(STANDIN_CLASSES):
        d = os.path.join(root, str(c))
        os.makedirs(d, exist_ok=True)
        for k in range(per_class):
            img, _ = render_sample(seed, idx, size=size, color=color, shape=shape)
            Image.fromarray(img).save(os.path.join(d, f"{k}.jpeg"), quality=92)
            idx += 1
    return [f"{color} {shape}" for color, shape in STANDIN_CLASSES]


def standin_batches(root, n_classes: int, batch_size: int, image_size: int):
    """(uint8 images, targets) batches over the stand-in class folders, each
    image through ``preprocess_pil``."""
    from PIL import Image

    images, targets = [], []
    for cls in range(n_classes):
        d = os.path.join(root, str(cls))
        for fname in sorted(os.listdir(d)):
            with Image.open(os.path.join(d, fname)) as im:
                images.append(preprocess_pil(im, image_size))
            targets.append(cls)
            if len(images) == batch_size:
                yield np.stack(images), np.asarray(targets)
                images, targets = [], []
    if images:
        yield np.stack(images), np.asarray(targets)


def demo_probs(model, image_u8: np.ndarray) -> np.ndarray:
    """softmax of the model's logits of ``image_u8`` against DEMO_PROMPTS, f64 [1, 3]."""
    text = torch.from_numpy(tokenize(DEMO_PROMPTS, model.cfg.context_length)).to(model.device)
    with torch.inference_mode():
        img = normalize_images(torch.from_numpy(np.array(image_u8[None])).to(model.device), dtype=torch.float32)
        per_image, _ = model.logits(img, text)
        return per_image.double().softmax(-1).cpu().numpy()


def stage_demo_probs(model, preprocess, oracle, check_published: bool) -> dict:
    from PIL import Image

    with Image.open(ASSET) as im:
        image_u8 = preprocess(im)
    ours, theirs = demo_probs(model, image_u8), demo_probs(oracle, image_u8)
    out = {
        "ours": ours.tolist(),
        "oracle": theirs.tolist(),
        "max_abs_diff_vs_oracle": float(np.abs(ours - theirs).max()),
        "passed": bool(np.allclose(ours, theirs, **DEMO_TOL)),
    }
    if check_published:
        out["expected_published"] = PUBLISHED_PROBS.tolist()
        out["published_ok"] = bool(np.allclose(ours, PUBLISHED_PROBS, **DEMO_TOL))
        out["passed"] = out["passed"] and out["published_ok"]
    return out


def prompt_batch(classnames, templates, most: int) -> int:
    """The text batch of a classifier's prompts: ``most``, or all the prompts
    when they are fewer (no rows padded past them: each row's features do
    not depend on the batch)."""
    return min(most, len(classnames) * len(templates))


def stage_imagenet(model, oracle, batches_fn, classnames, templates, n_common: int) -> dict:
    """Top-1 / top-5 on the device over every batch; top-1 of the device
    and of the oracle side by side over the first ``n_common`` images."""
    batch = prompt_batch(classnames, templates, 1024)
    classify = make_image_classifier(model, build_zeroshot_classifier(model, classnames, templates, batch))
    classify_oracle = make_image_classifier(oracle, build_zeroshot_classifier(oracle, classnames, templates, batch))
    n = common = top1 = top5 = oracle_hits = ours_hits = 0
    for images, targets in batches_fn():
        logits = classify(images)
        a1, a5 = topk_accuracy(logits, targets)
        top1 += 100.0 * a1 * len(targets)
        top5 += 100.0 * a5 * len(targets)
        n += len(targets)
        if common < n_common:
            take = min(len(targets), n_common - common)
            oracle_hits += int((classify_oracle(images[:take]).argmax(-1) == targets[:take]).sum())
            ours_hits += int((logits[:take].argmax(-1) == targets[:take]).sum())
            common += take
            print(f"[acceptance]   imagenet: {n} ours / {common} side-by-side", flush=True)
    ours_common = 100.0 * ours_hits / max(common, 1)
    oracle_common = 100.0 * oracle_hits / max(common, 1)
    return {
        "n": int(n),
        "classes": len(classnames),
        "top1_ours": top1 / max(n, 1),
        "top5_ours": top5 / max(n, 1),
        "side_by_side_n": int(common),
        "top1_ours_common": ours_common,
        "top1_oracle_common": oracle_common,
        "delta_pct": abs(ours_common - oracle_common),
        "passed": bool(abs(ours_common - oracle_common) <= PARITY_PCT),
    }


def gate_set(n_images: int, size: int, seed: int = 777) -> np.ndarray:
    """The int8 gate's images: the dress renderer's first ``n_images`` at ``size``."""
    return np.stack([render_sample(seed, i, size=size)[0] for i in range(n_images)])


def stage_int8_gate(model, classnames, templates, n_images: int, seed: int = 777) -> dict:
    images = gate_set(n_images, model.cfg.image_resolution, seed)
    w = build_float_classifier(model, classnames, templates, prompt_batch(classnames, templates, 256))
    res = noise_floor_gate(model, images, w, calibrate_n=min(128, n_images), batch_size=min(256, n_images))
    res["images"] = "rendered-natural-ish"
    return res


def checkpoint_path(name: str) -> str:
    """The file of a registry name in ``~/.cache/clip``, else ``name``."""
    if name in _MODELS:
        return os.path.join(os.path.expanduser("~/.cache/clip"), os.path.basename(_MODELS[name]))
    return name


def write(out, result) -> None:
    with open(out, "w") as f:
        json.dump(result, f, indent=2)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", default="ViT-B/32", help="registry name, .pt path, or port export dir")
    p.add_argument("--imagenet", default="datasetImageNet", help="ImageNetV2 extracted class-folder root")
    p.add_argument("--out", default="ACCEPTANCE_TORCH.json")
    p.add_argument("--stand-in", action="store_true",
                   help="offline: a seeded stand-in checkpoint and generated class folders")
    p.add_argument("--torch-n-images", type=int, default=1024,
                   help="side-by-side parity subset size (the oracle runs on the host CPU)")
    p.add_argument("--gate-images", type=int, default=512)
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)  # no card and no --device: raise before anything runs
    no_tf32()
    t0 = time.time()
    result = {"checkpoint": args.checkpoint, "stand_in": bool(args.stand_in)}
    result["device"], result["power_limit"] = card(device)
    result["tf32"] = False
    workdir = tempfile.mkdtemp(prefix="acceptance_standin_") if args.stand_in else None
    try:
        if args.stand_in:
            ckpt = make_standin_checkpoint(os.path.join(workdir, "standin.pt"))
            result["checkpoint"] = "stand-in (a seeded port CLIP, reference-keyed .pt)"
            model, cfg, preprocess = load(ckpt, compute_dtype="float32", device=device)
            state_dict = torch.load(ckpt, map_location="cpu", weights_only=True)
            root = os.path.join(workdir, "imagenetv2-matched-frequency-format-val")
            classnames = make_standin_imagenet(root, per_class=8, size=256)
            templates = PROMPT_TEMPLATES[:8]
            batches_fn = lambda: standin_batches(root, len(classnames), 64, cfg.image_resolution)  # noqa: E731
            gate_images = min(args.gate_images, 128)
        else:
            try:
                model, cfg, preprocess = load(args.checkpoint, compute_dtype="float32", device=device)
            except Exception as e:  # any failure to load is the record's error: the real run waits for the file
                result["error"] = f"checkpoint unavailable ({e}); seed ~/.cache/clip or pass --stand-in"
                print(json.dumps(result))
                write(args.out, result)
                return 2
            state_dict = read_torch_checkpoint(checkpoint_path(args.checkpoint))
            classnames, templates = IMAGENET_CLASSNAMES, PROMPT_TEMPLATES
            batches_fn = lambda: _imagenetv2_batches(  # noqa: E731
                batch_size=256, location=args.imagenet, image_size=cfg.image_resolution)
            gate_images = args.gate_images
        oracle, _ = load_reference_state_dict(state_dict, device="cpu", compute_dtype="float32")
        oracle.eval()

        print("[acceptance] stage a: README demo probs (device vs the CPU oracle)", flush=True)
        result["demo_probs"] = stage_demo_probs(model, preprocess, oracle,
                                                check_published=(args.checkpoint == "ViT-B/32"
                                                                 and not args.stand_in))
        print("[acceptance] stage b: ImageNet zero-shot parity", flush=True)
        try:
            result["imagenet"] = stage_imagenet(model, oracle, batches_fn, classnames, templates,
                                                args.torch_n_images)
        except DatasetUnavailable as e:
            result["imagenet"] = {"skipped": str(e)}
        print("[acceptance] stage c: int8 noise-floor gate on this checkpoint", flush=True)
        result["int8_gate"] = stage_int8_gate(model, classnames, templates, gate_images)
    finally:
        if workdir:
            shutil.rmtree(workdir, ignore_errors=True)

    executed = [v for v in (result["demo_probs"], result["imagenet"], result["int8_gate"]) if "passed" in v]
    result["stages_executed"] = len(executed)
    result["passed"] = bool(executed) and all(v["passed"] for v in executed)
    result["seconds"] = round(time.time() - t0, 1)
    write(args.out, result)
    print(json.dumps({k: result[k] for k in ("passed", "stages_executed", "seconds")}), flush=True)
    return 0 if result["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
