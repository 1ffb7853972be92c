"""Checkpoint converter of the PyTorch port: any source ``api.load`` takes
-> a port export directory, or a reference-keyed torch state dict.

Usage:
    # a torch .pt (state dict or TorchScript archive), .safetensors,
    # Accelerate dir, OpenAI name or preset -> a port export directory
    # (config.json + model.pt), which the port's api.load and the CLIs read
    python scripts/torch_convert_checkpoint.py ViT-B-32.pt out/vit_b32

    # -> a reference-keyed state dict .pt, which the reference's
    # build_model and the JAX package's api.load read
    python scripts/torch_convert_checkpoint.py out/vit_b32 vit_b32.pt --to torch

The model is read on the card (``--device cpu`` to read it on the CPU);
without CUDA and without ``--device`` it raises. The counterpart of ``scripts/convert_checkpoint.py``, whose native output is an
orbax directory instead.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src", help="OpenAI model name, preset, .pt / .safetensors file, Accelerate dir or export dir")
    p.add_argument("dst", help="output: a port export directory (default) or a .pt path with --to torch")
    p.add_argument("--to", default="export", choices=["export", "torch"])
    p.add_argument("--compute-dtype", default=None, help="override the saved config's activation dtype")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)

    import torch

    from clip_mixer_tpu_torch.api import load, save_pretrained

    model, cfg, _ = load(args.src, compute_dtype=args.compute_dtype, device=args.device)
    if args.to == "export":
        save_pretrained(model, cfg, args.dst)
        print(f"wrote a port export (config.json + model.pt) to {args.dst}")
    else:
        sd = {k: v.detach().cpu().contiguous() for k, v in model.state_dict().items() if k != "logit_bias"}
        torch.save(sd, args.dst)
        print(f"wrote a reference-keyed state dict ({len(sd)} tensors) to {args.dst}")


if __name__ == "__main__":
    main()
