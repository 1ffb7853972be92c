"""Encode the images of tar shards into a retrieval bank with the PyTorch port.

Writes the ``.npz`` bank (``features`` [N, embed_dim] float32, ``ids`` [N]
and a ``__meta__`` provenance entry) that the port's and the JAX package's
servers load for text -> image retrieval::

    python scripts/torch_embed_dataset.py --model outputs/run/export \\
        --data '/data/shards/*.tar' --out bank.npz [--int8 scales.npz]
    python -m clip_mixer_tpu_torch.serving --model outputs/run/export --index bank.npz

Ids are ``<shard-stem>/<member-key>`` (the webdataset names), so a hit maps
back to its record. The image members are ``.jpg`` and ``.png`` files
(decoded by Pillow, imported only for them) and ``.npy`` uint8 arrays
(decoded without it); a member that does not decode is skipped and
counted. Encoding runs through the port's ``InferenceEngine`` (bf16, or
``--int8``), so bank features are the server's. ``--input-size N`` takes
NxN sources and resizes them on the device, as a server run with the same
flag does. The counterpart of ``scripts/embed_dataset.py``; runs on the
card unless ``--device`` names another.
"""

import argparse
import glob
import io
import json
import sys
import tarfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

IMAGE_SUFFIXES = (".jpg", ".png", ".npy")


def iter_tar_images(shard_paths, decode, limit=None, skipped=None):
    """Yield ``(id, uint8 HWC image)`` over the image members of tar shards
    in order; ``decode`` turns one member's bytes into the image (the
    engine's ``decode_and_preprocess`` of one blob). A member that fails to
    decode is reported, appended to ``skipped`` and passed over: a long
    bank build does not die on one truncated file."""
    count = 0
    for shard in shard_paths:
        stem = Path(shard).stem
        with tarfile.open(shard) as tar:
            for member in tar:
                if not (member.isfile() and member.name.endswith(IMAGE_SUFFIXES)):
                    continue
                try:
                    img = decode(tar.extractfile(member).read())
                except Exception as e:
                    print(f"skipping {stem}/{member.name}: {type(e).__name__}: {e}")
                    if skipped is not None:
                        skipped.append(f"{stem}/{member.name}")
                    continue
                yield f"{stem}/{member.name.rsplit('.', 1)[0]}", img
                count += 1
                if limit is not None and count >= limit:
                    return


def embed(engine, shards, batch=256, limit=None, source=None):
    """The bank of ``shards`` through ``engine``: ``(features [N, D], ids,
    skipped member names, the provenance dict)``."""
    ids, feats, skipped, imgs, batch_ids = [], [], [], [], []

    def flush():
        if imgs:
            feats.append(engine.encode_image_arrays(np.stack(imgs)))
            ids.extend(batch_ids)
            imgs.clear()
            batch_ids.clear()

    def decode(blob):
        return engine.decode_and_preprocess([blob])[0]

    for sid, img in iter_tar_images(shards, decode, limit=limit, skipped=skipped):
        batch_ids.append(sid)
        imgs.append(img)
        if len(imgs) == batch:
            flush()
    flush()
    from clip_mixer_tpu_torch.ops import quant_io

    meta = {"cfg": quant_io._cfg_dict(engine.cfg), "path": engine.path_kinds["image"], "source": source,
            "input_hw": None if engine.input_hw is None else list(engine.input_hw)}
    bank = np.concatenate(feats).astype(np.float32) if feats else np.zeros((0, engine.cfg.embed_dim), np.float32)
    return bank, ids, skipped, meta


def write_bank(path, bank, ids, meta):
    """The bank ``.npz``: ``features``, ``ids`` and the JSON ``__meta__``."""
    from clip_mixer_tpu_torch.ops.quant_io import require_local_file

    require_local_file(path, "retrieval bank")
    buf = io.BytesIO()
    np.savez(buf, features=bank, ids=np.array(ids),
             __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="preset, OpenAI name, .pt, or checkpoint dir")
    p.add_argument("--data", required=True, help="tar-shard glob")
    p.add_argument("--out", required=True, help="output .npz bank path")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--int8", default=None, metavar="CALIB_NPZ",
                   help="encode with the calibrated W8A8 path (calibration artifact)")
    p.add_argument("--limit", type=int, default=None, help="stop after N samples")
    p.add_argument("--input-size", type=int, default=None, metavar="N",
                   help="take NxN sources and resize them on the device (as a server run with the "
                        "same --input-size, for the same features)")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)

    shards = sorted(glob.glob(args.data))
    if not shards:
        p.error(f"--data matched no shards: {args.data}")

    from clip_mixer_tpu_torch.api import load
    from clip_mixer_tpu_torch.serving import InferenceEngine

    model, _, _ = load(args.model, device=args.device)
    input_hw = (args.input_size, args.input_size) if args.input_size else None
    engine = InferenceEngine(model, batch_buckets=(args.batch,), input_hw=input_hw)
    if args.int8:
        engine.enable_int8(calibration=args.int8)
    bank, ids, skipped, meta = embed(engine, shards, batch=args.batch, limit=args.limit, source=args.model)
    if not ids:
        p.error(f"no decodable {'/'.join(IMAGE_SUFFIXES)} members found in the shards")
    write_bank(args.out, bank, ids, meta)
    skip_note = f" ({len(skipped)} corrupt members skipped)" if skipped else ""
    print(f"wrote {len(ids)} x {bank.shape[1]} bank to {args.out}{skip_note}")


if __name__ == "__main__":
    main()
