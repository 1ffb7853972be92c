"""Freeze a model of the PyTorch port into a self-contained serving directory.

The counterpart of ``scripts/export_servable.py`` (``clip_mixer_tpu_torch.aot``):
per-bucket encoder programs are recorded with ``torch.export`` at export
time and run as recorded, so a serving host never traces model code.

    python scripts/torch_export_servable.py --model outputs/run/export --out srv/
    python scripts/torch_export_servable.py --model mixer-b32 --out srv/ \\
        --buckets 1,8,32,128 --int8 scales.npz

Then ``clip_mixer_tpu_torch.aot.load_servable("srv/")`` gives an
``InferenceEngine``, ``python -m clip_mixer_tpu_torch.serving --model srv/``
serves it, and ``api.load("srv/")`` still reads it as a checkpoint. The
programs run the route of the checkpoint's config (``fused_mlp`` or plain;
the fused-block route is ``aot.export_servable`` on a model that
``route_towers`` bound). Runs on the card unless ``--device`` names
another; the programs run on that device type only.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="preset, OpenAI name, .pt, or checkpoint dir")
    p.add_argument("--out", required=True, help="output servable directory")
    p.add_argument("--buckets", default="1,8,32,128", help="comma-separated batch buckets")
    p.add_argument("--int8", default=None, metavar="CALIB_NPZ",
                   help="freeze the calibrated W8A8 encoders (the artifact must hold both towers)")
    p.add_argument("--platforms", default=None,
                   help="comma-separated device types; only the exporting device's type is taken")
    p.add_argument("--all-devices", action="store_true", help="not ported yet (ROADMAP.md item 16)")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)
    if args.all_devices:
        raise SystemExit("--all-devices is not ported to clip_mixer_tpu_torch yet: ROADMAP.md, Queue 1 item 16")

    from clip_mixer_tpu_torch import aot
    from clip_mixer_tpu_torch.api import load

    model, _, _ = load(args.model, device=args.device)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    platforms = None if args.platforms is None else tuple(args.platforms.split(","))
    aot.export_servable(model, args.out, batch_buckets=buckets, int8_calibration=args.int8, platforms=platforms)
    kind = "int8 W8A8" if args.int8 else "float"
    print(f"froze {kind} serving programs ({aot.serving_route(model)} route) for buckets "
          f"{sorted(set(buckets))} -> {args.out}")


if __name__ == "__main__":
    main()
