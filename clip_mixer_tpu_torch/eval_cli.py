"""Evaluation command line of the port: ``python -m clip_mixer_tpu_torch.eval_cli``.

Counterpart of the JAX package's ``eval.py``: loads a model through
``api.load`` (a port export directory, a torch checkpoint, a registry name
or a preset) and runs the named validators on it, printing each result.
``--device`` picks the torch device (the card unless another is named).
The remote-dataset validators skip where their datasets cannot be loaded;
``retrieval`` reads the held-out split ``--val-data`` and needs no network.

Examples::

    python -m clip_mixer_tpu_torch.eval_cli --model outputs/run1/export --validators sts imagenet
    python -m clip_mixer_tpu_torch.eval_cli --model outputs/run1/export --validators retrieval \\
        --val-data 'held_out/*.tar'
"""

from __future__ import annotations

import argparse

from clip_mixer_tpu_torch.api import load
from clip_mixer_tpu_torch.evals.validators import (
    CosineSimValidator,
    ImageNetValidator,
    MNISTValidator,
    RetrievalValidator,
    SST2Validator,
)
from clip_mixer_tpu_torch.train.metrics import MetricsWriter
from clip_mixer_tpu_torch.train_cli import build_single_source

VALIDATORS = {
    "imagenet": ImageNetValidator,
    "sts": CosineSimValidator,
    "sst2": SST2Validator,
    "mnist": MNISTValidator,
    "retrieval": RetrievalValidator,
}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="checkpoint dir / .pt / registry or preset name")
    p.add_argument("--validators", nargs="+", default=["sts"], choices=sorted(VALIDATORS.keys()))
    p.add_argument("--val-data", default=None,
                   help="held-out split for the 'retrieval' validator: tar glob, .csv/.tsv manifest, "
                        "or image directory (fully offline, unlike the remote-dataset validators)")
    p.add_argument("--val-samples", type=int, default=2048, help="retrieval gallery size drawn from --val-data")
    p.add_argument("--caption-from", default="txt", choices=("txt", "dirname", "stem"),
                   help="caption source when --val-data is an image directory")
    p.add_argument("--compute-dtype", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)
    if "retrieval" in args.validators and not args.val_data:
        raise SystemExit("the 'retrieval' validator needs --val-data")

    model, cfg, _ = load(args.model, compute_dtype=args.compute_dtype, device=args.device)
    model.eval()
    writer = MetricsWriter(log_dir=args.log_dir)
    for name in args.validators:
        if name == "retrieval":
            source = build_single_source(args.val_data, args.caption_from, batch_size=min(256, args.val_samples),
                                         image_size=cfg.image_resolution, context_length=cfg.context_length,
                                         drop_last=False)
            v = RetrievalValidator(model, cfg, data_source=source, writer=writer, max_samples=args.val_samples)
        else:
            v = VALIDATORS[name](model, cfg, writer=writer)
        result = v.validate(step=0, verbose=True)
        print(f"[{name}] {result}")
    writer.flush()


if __name__ == "__main__":
    main()
