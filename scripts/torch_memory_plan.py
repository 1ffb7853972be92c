"""Capacity planner of the port: per-card memory for a preset under each parallelism mode.

Usage:
    python scripts/torch_memory_plan.py [--preset vit-l14] [--devices 8]
                                        [--batch 1024] [--accum 1]
    python scripts/torch_memory_plan.py --preset vit-l14 --devices 8 \\
        --suggest --global-batch 32768 [--hbm-gib 80]

Prints the per-card parameters, Adam, gradients and activations for DP,
FSDP, FSDP x TP(2), TP and PP at the device count, from the port's model and
its sharding rules (``clip_mixer_tpu_torch/utils/memory.py``). Shapes only:
the model is built on the ``meta`` device, and no card is touched.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    from clip_mixer_tpu_torch.config import PRESETS
    from clip_mixer_tpu_torch.utils.memory import jax_leaves, param_shapes, plan, suggest

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="mixer-b32", choices=sorted(PRESETS))
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--batch", type=int, default=1024, help="per-card batch")
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--remat-policy", default="none", choices=["none", "mlp_hidden", "all_hidden"],
                   help="include the saved hidden pre-activations in the working set")
    p.add_argument("--no-remat", action="store_true",
                   help="price the towers WITHOUT rematerialisation (train_cli's --no-remat)")
    p.add_argument("--ema", action="store_true", help="price an EMA copy of the parameters (--ema-decay)")
    p.add_argument("--suggest", action="store_true",
                   help="pick the cheapest plan that fits --hbm-gib (dp, fsdp, fsdp+accum, fsdp x tp2, pp2)")
    p.add_argument("--global-batch", type=int, default=None,
                   help="global batch for --suggest (default: --batch x --devices)")
    p.add_argument("--hbm-gib", type=float, default=80.0, help="memory a card for --suggest (H100: 80)")
    args = p.parse_args(argv)

    cfg = PRESETS[args.preset].replace(remat_policy=args.remat_policy, remat=not args.no_remat)
    if args.suggest:
        global_batch = args.global_batch or args.batch * args.devices
        best, tried = suggest(cfg, args.devices, global_batch, hbm_bytes=int(args.hbm_gib * (1 << 30)), ema=args.ema)
        print(f"{args.preset} @ {args.devices} devices, global batch {global_batch}, "
              f"{args.hbm_gib:g} GiB/card (10% headroom), remat_policy {args.remat_policy}")
        for label, pl, fits in tried:
            if pl is None:
                print(f"  {label:<22} n/a ({fits})")
            else:
                star = "  <-- suggested" if best is pl else ""
                print(f"  {pl.row()}  [{'FITS' if fits else 'over'}]{star}")
        if best is None:
            print("no candidate fits; raise --hbm-gib, devices, or accum range")
            return 1
        return 0

    print(f"{args.preset} @ {args.devices} devices, {args.batch}/card, accum {args.accum}, "
          f"remat_policy {args.remat_policy}")
    leaves = jax_leaves(param_shapes(cfg))
    for mode, kw in (("dp", {}), ("fsdp", {}), ("fsdp", {"n_model": 2}), ("tp", {}), ("pp", {})):
        try:
            print(plan(cfg, mode, args.devices, args.batch, accum_steps=args.accum, ema=args.ema, leaves=leaves,
                       **kw).row())
        except ValueError as e:  # divisibility, or a ResNet under pp
            label = mode if not kw else f"{mode} x tp{kw['n_model']}"
            print(f"{label}: n/a ({e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
