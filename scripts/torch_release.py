"""One-command release directory of the PyTorch port: calibrate -> gate -> freeze -> manifest.

The counterpart of ``scripts/release.py``. It builds the directory a serving
fleet consumes from any model source:

    python scripts/torch_release.py --model outputs/run/export --out release/ \\
        --data '/data/shards/*.tar'
    python scripts/torch_release.py --out release/ --verify

Stages, each through the tool or library it wraps:
  1. int8 calibration on the data   (scripts/torch_calibrate_int8.py ``run``)
  2. the accuracy gates on the SHIPPED scales: the noise-floor gates of
     ``evals/quant_gate.py`` for both towers; the release ABORTS, freezing
     nothing, if a gate fails
  3. the frozen serving programs    (``clip_mixer_tpu_torch.aot.export_servable``)
  4. RELEASE.json                   (gates, buckets, provenance)

``--no-int8`` releases the float path (stages 1-2 skipped). ``--verify``
checks an existing release on this host: it loads the programs, runs every
bucket, probes both towers and re-reads the recorded gate verdicts. Serve
with ``python -m clip_mixer_tpu_torch.serving --model release/`` (the
recorded programs) or ``aot.load_servable("release/")``. Runs on the card
unless ``--device`` names another; the programs run on that device type only.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))  # sibling script imports


def verify(release_dir: str, device=None) -> None:
    """Prove that a release directory serves on this host before rollout:
    load the recorded programs, run every bucket on both towers, encode one
    input a tower, and re-check the recorded gate verdicts. Raises
    SystemExit on any failure."""
    from clip_mixer_tpu_torch import aot

    manifest = json.loads((Path(release_dir) / "RELEASE.json").read_text())
    bad_gates = [k for k, g in manifest.get("gates", {}).items() if not g.get("passed")]
    if bad_gates:
        raise SystemExit(f"VERIFY FAILED: RELEASE.json records failed gates {bad_gates}")
    engine = aot.load_servable(release_dir, device=device)  # device type and version checked here
    engine.warmup()  # every bucket, both towers
    R = engine.cfg.image_resolution
    h, w = engine.input_hw or (R, R)
    img = engine.encode_image_arrays(np.zeros((1, h, w, 3), np.uint8))
    txt = engine.encode_text(["release verification probe"])
    if not (np.all(np.isfinite(img)) and np.all(np.isfinite(txt))):
        raise SystemExit("VERIFY FAILED: non-finite features from the recorded programs")
    kind = "int8" if manifest["int8"] else "float"
    print(f"VERIFY OK: {kind} release, buckets {manifest['buckets']}, paths {engine.path_kinds}, "
          f"frozen={engine.frozen}")


def gate(model, calib_path: str, gate_n: int, max_flip_ratio: float) -> dict:
    """Stage 2: both towers' noise-floor gates on the artifact's scales,
    on the JAX release's inputs (procedural images, a 64-class head;
    random-token texts retrieving from a 256-image f32 bank)."""
    import torch

    from clip_mixer_tpu_torch.evals import quant_gate
    from clip_mixer_tpu_torch.evals.prompts import IMAGENET_CLASSNAMES, PROMPT_TEMPLATES
    from clip_mixer_tpu_torch.models.clip import l2_normalize
    from clip_mixer_tpu_torch.ops import quant_io
    from clip_mixer_tpu_torch.ops.preprocess import normalize_images

    cfg = model.cfg
    art = quant_io.load_calibration(calib_path)
    gates = {}
    gate_imgs = quant_gate.synthetic_images(gate_n, cfg.image_resolution, seed=1)
    w = quant_gate.build_float_classifier(model, IMAGENET_CLASSNAMES[:64], PROMPT_TEMPLATES[:4], batch_size=256)
    gates["image"] = quant_gate.noise_floor_gate(model, gate_imgs, w, batch_size=256,
                                                 max_flip_ratio=max_flip_ratio, a_scales=art["image_scales"])
    print(f"image gate: flip_ratio={gates['image']['flip_ratio']:.2f} passed={gates['image']['passed']}")

    rng = np.random.default_rng(1)
    texts = np.zeros((gate_n, cfg.context_length), np.int32)
    texts[:, 0] = min(49406, cfg.vocab_size - 2)  # BOS (in range for tiny vocabs)
    texts[:, 1:8] = rng.integers(1, min(49000, cfg.vocab_size - 2), (gate_n, 7))
    texts[:, 8] = min(49407, cfg.vocab_size - 1)  # EOS
    bank_imgs = quant_gate.synthetic_images(256, cfg.image_resolution, seed=2)
    with torch.inference_mode():
        x = normalize_images(torch.from_numpy(bank_imgs).to(model.device), dtype=torch.float32)
        bank = l2_normalize(quant_gate.float32_twin(model).encode_image(x)).float().cpu().numpy()
    gates["text"] = quant_gate.text_noise_floor_gate(model, texts, bank.T, batch_size=256,
                                                     max_flip_ratio=max_flip_ratio, a_scales=art["text_scales"])
    print(f"text gate: flip_ratio={gates['text']['flip_ratio']:.2f} passed={gates['text']['passed']}")
    return gates


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", help="preset, OpenAI name, .pt, or checkpoint dir")
    p.add_argument("--out", required=True, help="release directory")
    p.add_argument("--verify", action="store_true",
                   help="verify an EXISTING release dir (--out) on this host instead of building one")
    p.add_argument("--data", default=None, help="tar-shard glob for calibration samples")
    p.add_argument("--texts", default=None, help="caption file for text calibration")
    p.add_argument("--n", type=int, default=512, help="calibration sample count")
    p.add_argument("--buckets", default="1,8,32,128")
    p.add_argument("--no-int8", action="store_true", help="release the float path")
    p.add_argument("--skip-gate", action="store_true",
                   help="skip the accuracy gates (NOT recommended for real releases)")
    p.add_argument("--gate-n", type=int, default=768, help="gate sample count")
    p.add_argument("--max-flip-ratio", type=float, default=2.5)
    p.add_argument("--platforms", default=None,
                   help="comma-separated device types; only the serving device's own type is taken")
    p.add_argument("--all-devices", action="store_true",
                   help="record the programs for an engine over every visible device of --device's type "
                        "(the serving --all-devices layout); loading then needs that many")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)

    if args.all_devices and args.platforms:
        raise SystemExit("--all-devices records the layout from THIS host's visible devices; combining it with "
                         "--platforms would freeze the build host's device count, not the serving host's")
    if args.verify:
        verify(args.out, device=args.device)
        return
    if not args.model:
        p.error("--model is required (unless --verify)")

    import torch

    from clip_mixer_tpu_torch import aot
    from clip_mixer_tpu_torch.api import load
    from clip_mixer_tpu_torch.serving import visible_devices

    model, cfg, _ = load(args.model, device=args.device)
    platforms = None if args.platforms is None else tuple(args.platforms.split(","))
    mesh = None
    if args.all_devices:
        mesh = visible_devices(model.device)
        if len(mesh) == 1:
            print("warning: --all-devices on a 1-device host records a 1-device mesh")
    try:
        aot.check_target(model, platforms, mesh)  # before calibration, which takes the longest
    except ValueError as e:
        raise SystemExit(str(e)) from None
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    gates = {}
    calib_path = None

    if not args.no_int8:
        # 1. the calibration artifact (both towers) on the user's data
        import torch_calibrate_int8

        calib_path = str(out / "calibration.npz")
        torch_calibrate_int8.run(model, cfg, calib_path, data=args.data, texts=args.texts, n=args.n)
        if not args.skip_gate:
            # 2. gate the SHIPPED scales
            gates = gate(model, calib_path, args.gate_n, args.max_flip_ratio)
            failed = [k for k, g in gates.items() if not g["passed"]]
            if failed:
                raise SystemExit(f"RELEASE ABORTED: accuracy gate failed for {failed} "
                                 f"(flip ratio over {args.max_flip_ratio}); nothing frozen")

    # 3. the checkpoint and the frozen programs
    buckets = tuple(int(b) for b in args.buckets.split(","))
    aot.export_servable(model, str(out), batch_buckets=buckets, int8_calibration=calib_path, platforms=platforms,
                        mesh=mesh)

    # 4. the release manifest, its buckets and device type read back from the recorded one
    srv = aot.read_manifest(str(out))
    manifest = {
        "source": args.model,
        "int8": not args.no_int8,
        "gates": gates,
        "buckets": srv["buckets"],
        "platforms": srv["platforms"],
        "route": srv["route"],
        "mesh_devices": None if mesh is None else len(mesh),
        "calibration_samples": None if args.no_int8 else args.n,
        "torch_version": torch.__version__,
    }
    (out / "RELEASE.json").write_text(json.dumps(manifest, indent=1))
    kind = "float" if args.no_int8 else "int8"
    print(f"release ({kind}) written to {out}: serve with aot.load_servable({str(out)!r}) or --model {out}")


if __name__ == "__main__":
    main()
