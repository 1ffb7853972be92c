#!/usr/bin/env python3
"""Component profile of the port's Mixer-B/32 vision tower on the card.

The counterpart of ``scripts/profile_mixer.py``. It answers "where does
the time go?" by ablation: preprocess + encode at B = 512 (the bf16
``"torch"`` front end, seed-0 weights, the plain route) is timed, then
timed again with the token-mix branch replaced by identity, then with the
channel-mix branch replaced. The deltas are the cost of each branch as the
card runs it (its memory traffic included), not just its FLOPs.

The encoder is mirrored by hand from the port's own pieces
(``models/towers.py::patchify``, ``models/mixer.py::token_mix``,
``models/layers.py`` ``layer_norm`` / ``quick_gelu``), and the mirror is
held to ``encode_image`` (rtol = atol = 2e-2, JAX's bound) before anything
is timed: a tower change would otherwise profile a different model.

Times are slopes between chains of 5 and 45 calls, each call's input
carrying the one before's result (``utils/profiling.chained``, CUDA
events). Prints one JSON line with the JAX script's keys plus
``power_limit``; ``device`` names the card. Runs on the card unless
``--device`` names another device; TF32 is off.

Usage: python scripts/torch_profile_mixer.py [--device cuda]
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clip_mixer_tpu_torch.config import PRESETS  # noqa: E402
from clip_mixer_tpu_torch.device import card, compute_dtype, no_tf32, resolve_device  # noqa: E402
from clip_mixer_tpu_torch.models.layers import layer_norm, quick_gelu  # noqa: E402
from clip_mixer_tpu_torch.models.mixer import token_mix  # noqa: E402
from clip_mixer_tpu_torch.models.towers import patchify  # noqa: E402

ABLATIONS = ("none", "token", "channel")
MIRROR_TOL = dict(rtol=2e-2, atol=2e-2)  # scripts/profile_mixer.py:94-96


def encode_ablated(visual, x: torch.Tensor, ablate: str) -> torch.Tensor:
    """The vision encoder on preprocessed images ``x`` [B, H, W, 3], with
    one branch of every block replaced by identity (``ablate``: "token",
    "channel" or "none")."""
    dt = compute_dtype(visual.cfg.compute_dtype)
    x = patchify(x.to(dt), visual.cfg.vision_patch_size)
    x = x @ visual.patch_kernel().to(dt)
    cls = visual.class_embedding.to(dt).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = layer_norm(x, visual.ln_pre.weight, visual.ln_pre.bias)
    for block in visual.transformer.mixBlocks:
        if ablate != "token":
            x = x + token_mix(block, x)
        if ablate != "channel":
            y = layer_norm(x, block.layerNorm2.weight, block.layerNorm2.bias)
            cm = block.channel_mix_seq
            hid = quick_gelu(y @ cm.lin3.weight.to(dt).t() + cm.lin3.bias.to(dt))
            # the residual added last, as the model's chain (models/layers.py::channel_mlp) adds it: in
            # bf16 on the card, (x + h W) + b drifts past the mirror's bound over 12 blocks
            x = x + (hid @ cm.lin4.weight.to(dt).t() + cm.lin4.bias.to(dt))
    x = layer_norm(x[:, 0, :], visual.ln_post.weight, visual.ln_post.bias)
    return x @ visual.proj.to(dt)


def main(argv=None, cfg=None, batch: int = 512, chain=(5, 45)) -> dict:
    """The profile; returns its line. ``cfg`` replaces ``mixer-b32``, and
    ``batch`` and ``chain`` (the two chain lengths) cut the work, so tests
    and ``chip_smoke.py`` run small."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    no_tf32()

    from clip_mixer_tpu_torch.models.clip import CLIP
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
    from clip_mixer_tpu_torch.utils.profiling import chained, slope_time

    cfg = PRESETS["mixer-b32"] if cfg is None else cfg
    model = CLIP(cfg, device=device, generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    pre = make_batch_preprocess((256, 256), cfg.image_resolution, normalize=True, dtype=torch.bfloat16)
    images = torch.from_numpy(rng.integers(0, 256, (batch, 256, 256, 3), dtype=np.uint8)).to(device)

    # pin the hand-mirrored encoder to the real one before attributing time
    with torch.no_grad():
        ref = model.encode_image(pre(images[:8])).float().cpu().numpy()
        got = encode_ablated(model.visual, pre(images[:8]), "none").float().cpu().numpy()
    np.testing.assert_allclose(got, ref, **MIRROR_TOL)

    results = {}
    for name in ABLATIONS:
        def fn(u8, _name=name):
            return encode_ablated(model.visual, pre(u8), _name)

        results[name] = slope_time(chained(fn, images), chain[0], chain[1], device) * 1e3  # ms per batch

    full = results["none"]
    out = {
        "batch": batch,
        "e2e_ms": round(full, 3),
        "token_mix_ms": round(full - results["token"], 3),
        "channel_mix_ms": round(full - results["channel"], 3),
        "other_ms": round(results["token"] + results["channel"] - full, 3),
        "token_mix_pct": round(100 * (full - results["token"]) / full, 1),
        "imgs_per_sec_full": round(batch / (full / 1e3), 1),
    }
    out["device"], out["power_limit"] = card(device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
