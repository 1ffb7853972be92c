"""Write the int8 calibration artifact of a model of the PyTorch port.

Measures the per-site activation scales (``ops/quant.py``'s ``calibrate_*``)
on sample data and writes the ``.npz`` artifact (``ops/quant_io.py``, the
JAX package's format) that ``enable_int8(calibration=...)`` and
``python -m clip_mixer_tpu_torch.serving --int8 scales.npz`` load:

    python scripts/torch_calibrate_int8.py --model outputs/run/export --out scales.npz
    python scripts/torch_calibrate_int8.py --model mixer-b32 --texts captions.txt --out scales.npz
    python scripts/torch_calibrate_int8.py --model outputs/run/export --data 'shards/*.tar' --out scales.npz

The images and captions are the first ``--n`` samples of the tar shards
``--data`` matches (``TarShardSource``), else synthetic (``SyntheticSource``,
bit for bit the JAX package's); ``--texts`` replaces the captions. The
counterpart of ``scripts/calibrate_int8.py``; runs on the card unless
``--device`` names another.
"""

import argparse
import glob
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def run(model, cfg, out, data=None, texts=None, n=512, no_text=False):
    """Calibrate ``model`` (a port CLIP on its device) on ``n`` samples a
    tower and write the artifact to ``out``: the library entry point."""
    import torch

    from clip_mixer_tpu_torch.data.pipeline import SyntheticSource, TarShardSource
    from clip_mixer_tpu_torch.device import compute_dtype
    from clip_mixer_tpu_torch.ops import quant_io
    from clip_mixer_tpu_torch.ops.preprocess import normalize_images
    from clip_mixer_tpu_torch.ops.quant import image_quant_fns, text_quant_fns
    from clip_mixer_tpu_torch.serving import _numpy_tree
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    batch = min(n, 256)
    if data:
        shards = sorted(glob.glob(data))
        if not shards:
            raise SystemExit(f"--data matched no shards: {data}")
        source = TarShardSource(shards, batch_size=batch, image_size=cfg.image_resolution,
                                context_length=cfg.context_length, drop_last=False)
    else:
        print("note: no --data given; calibrating on synthetic samples "
              "(real data gives more representative activation scales)")
        source = SyntheticSource(batch, image_size=cfg.image_resolution, n_batches=-(-n // batch),
                                 context_length=cfg.context_length)
    images, token_batches = [], []
    got = 0
    for b in source.iter_batches(epoch=0):
        images.append(b["images"])
        token_batches.append(b["texts"])
        got += len(b["images"])
        if got >= n:
            break
    if got == 0:
        raise SystemExit("calibration source yielded zero samples (empty/undecodable shards?)")
    images_u8 = np.concatenate(images)[:n]
    dev = model.device

    with torch.inference_mode():
        sample = normalize_images(torch.from_numpy(images_u8).to(dev), dtype=compute_dtype(cfg.compute_dtype))
        image_scales = _numpy_tree(image_quant_fns(cfg)[0](model, sample))
        print(f"image tower: calibrated on {len(images_u8)} samples")
        text_scales = None
        if not no_text:
            if texts:
                with open(texts) as f:
                    lines = [line.strip() for line in f if line.strip()][:n]
                if not lines:
                    raise SystemExit(f"--texts {texts} contains no captions")
                tokens = tokenize(lines, cfg.context_length, truncate=True)
            else:
                tokens = np.concatenate(token_batches)[:n]
            text_scales = _numpy_tree(text_quant_fns(cfg)[0](model, torch.from_numpy(tokens).to(dev)))
            print(f"text tower: calibrated on {len(tokens)} samples")
    quant_io.save_calibration(out, cfg, image_scales=image_scales, text_scales=text_scales)
    print(f"wrote {out}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="preset, OpenAI name, .pt, or checkpoint dir")
    p.add_argument("--out", required=True, help="output .npz artifact path")
    p.add_argument("--data", default=None, help="tar-shard glob of calibration images/captions")
    p.add_argument("--texts", default=None, help="file of caption strings (one per line)")
    p.add_argument("--n", type=int, default=512, help="calibration sample count per tower")
    p.add_argument("--no-text", action="store_true", help="skip the text tower")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)

    from clip_mixer_tpu_torch.api import load

    model, cfg, _ = load(args.model, device=args.device)
    run(model, cfg, args.out, data=args.data, texts=args.texts, n=args.n, no_text=args.no_text)


if __name__ == "__main__":
    main()
