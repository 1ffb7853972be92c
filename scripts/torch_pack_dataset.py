"""Pack a CSV/TSV manifest or an image folder into webdataset tar shards.

From the files one has (``FileListSource``: a manifest, or a folder of
``.jpg`` / ``.jpeg`` / ``.png`` / ``.npy`` images) to the layout large runs
stream (``TarShardSource``: sequential shard reads). Images are copied as
raw bytes, pixels untouched. The counterpart of ``scripts/pack_dataset.py``
over the PyTorch port's ``write_tar_shards_from_files``; no model, no
device.

    python scripts/torch_pack_dataset.py --data captions.csv --out shards/
    python scripts/torch_pack_dataset.py --data imagedir/ --caption-from dirname \\
        --out shards/ --samples-per-shard 5000 --shuffle
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", required=True,
                   help=".csv/.tsv manifest of (image path, caption) rows, or an image directory "
                        "(see --caption-from)")
    p.add_argument("--out", required=True, help="output shard directory")
    p.add_argument("--samples-per-shard", type=int, default=10000)
    p.add_argument("--caption-from", default="txt", choices=("txt", "dirname", "stem"),
                   help="caption source when --data is a directory")
    p.add_argument("--shuffle", action="store_true",
                   help="seeded permutation of the entries before packing (shards stream in order at "
                        "train time, so a shuffle before packing mixes shard contents)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if "://" in args.out:
        # tarfile needs a real filesystem; open() would create a local "./gs:/..."
        raise SystemExit(f"--out {args.out!r}: pack to a local directory; remote object stores "
                         "are not writable here")

    from clip_mixer_tpu_torch.data.pipeline import FileListSource, write_tar_shards_from_files

    if args.data.lower().endswith((".csv", ".tsv")):
        src = FileListSource.from_csv(args.data, batch_size=1)
    elif os.path.isdir(args.data):
        src = FileListSource.from_folder(args.data, batch_size=1, caption_from=args.caption_from)
    else:
        raise SystemExit(f"--data {args.data!r}: need a .csv/.tsv manifest or a directory")

    entries = src.entries
    if args.shuffle:
        order = np.random.default_rng(args.seed).permutation(len(entries))
        entries = [entries[i] for i in order]

    paths = write_tar_shards_from_files(entries, args.out, args.samples_per_shard)
    print(f"packed {len(entries)} samples into {len(paths)} shard(s) under {args.out}")


if __name__ == "__main__":
    main()
