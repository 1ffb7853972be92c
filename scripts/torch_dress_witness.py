#!/usr/bin/env python3
"""The dress rehearsal's ``steps500`` leg in the JAX package and in the port,
part by part, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_dress_witness.py --workers 4

The two ``steps500`` records (``TRAIN_DRESS.json``, ``TRAIN_DRESS_TORCH.json``)
ran the same flags and end far apart. This script holds each part of the
leg that the two packages share against each other, with each package's own
code, and prints one JSON line a part:

``data``: four dress shards from the port's writer (byte for byte the JAX
writer's); each package's rehearsal script is asked for its ``train_cli`` /
``train.py`` command at the leg's flags (the launch is caught, nothing
trains), each CLI parses it and builds its training source (the tar shards
under the decode-once cache, each package with a cache directory of its
own), and the first 3 batches of epoch 0 go through each train
step's augmentation hook as it applies it. Reports whether they are equal
bit for bit, else the first step, field and row that differ.

``schedule``: each package's learning rate at every update of the leg (its
``TrainConfig``, the epochs its rehearsal derives from 90,000 samples, the
cache's floor(n / batch) batches an epoch) and the largest relative gap.

``step``: the JAX package's ``init(key(0))`` weights, carried into the port
(``load_jax_params``), through both train steps at the leg's
``TrainConfig`` over 4 steps (the batch cut to 32 for the host, the same
batches from the port's source, f32 compute, full width and depth): the
per-step losses and their largest relative gap against the JAX suite's loss
tolerance. Beside it, the port's own seed-0 draw against the JAX draw (the
records' runs each began from its own package's draw), leaf by leaf: the
leaves JAX fills with one value are held element for element, every other
leaf by its mean and its standard deviation.

Like ``scripts/torch_vit_witness.py``, this script imports the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
sys.path.insert(0, str(REPO))

LOSS_RTOL = 2e-5  # tests/test_torch_port_train_step.py, the JAX suite's loss tolerance
LEG = ["--leg", "steps500", "--run-name", "dress500", "--accum", "1", "--checkpoint-every", "400",
       "--validate-every", "100", "--crash-after-steps", "450"]  # README's steps500 command, both packages
LEG_BATCH, LEG_SAMPLES, LEG_STEPS = 1024, 90000, 510  # its global batch, training samples and requested steps
N_WRITTEN = 4096  # dress samples written at 256 px, 1,024 a shard; the last shard is the held-out one
STEP_BATCH = 32  # the step part's batch, cut for the host


def script(name):
    """A script of ``scripts/`` as a module of its own name."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    return importlib.import_module(name)


@contextlib.contextmanager
def caught_launch(cmds):
    """``subprocess.run`` records its command in ``cmds`` and returns exit 1
    without running it; standard output is dropped."""
    real = subprocess.run

    def run(cmd, *args, **kw):
        cmds.append(list(cmd))
        return subprocess.CompletedProcess(cmd, 1)

    subprocess.run = run
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            yield
    finally:
        subprocess.run = real


def rehearsal_commands(work: Path, data: str, val: str, batch: int, n_samples: int, steps: int, preset: str):
    """{package: the trainer's argument list} as each rehearsal script builds
    it for the leg, each with a cache directory of its own under ``work``;
    the preset is set to ``preset`` (JAX's script names mixer-b32 itself)."""
    common = [*LEG, "--global-batch", str(batch), "--steps", str(steps), "--n-samples", str(n_samples),
              "--data", data, "--val-data", val]
    out = {}
    for pkg, name in (("jax", "dress_rehearsal"), ("port", "torch_dress_rehearsal")):
        argv = [*common, "--cache-dir", str(work / f"cache_{pkg}"), "--out", str(work / f"{pkg}.json")]
        cmds = []
        with caught_launch(cmds):
            if pkg == "port":
                script(name).main([*argv, "--device", "cpu"], preset=preset)
            else:
                old, sys.argv = sys.argv, [name, *argv]
                try:
                    script(name).main()
                finally:
                    sys.argv = old
        (cmd,) = cmds
        args = cmd[cmd.index("--") + 1:]
        args[args.index("--preset") + 1] = preset
        out[pkg] = args
    return out


def command_differences(commands):
    """[flag, JAX's value, the port's value] wherever the two trainer
    argument lists differ (each has its own cache directory; only the
    port's CLI takes ``--device``)."""
    def flags(args):
        out, i = {}, 0
        while i < len(args):
            takes = i + 1 < len(args) and not args[i + 1].startswith("--")
            out[args[i]] = args[i + 1] if takes else True
            i += 2 if takes else 1
        return out

    j, p = flags(commands["jax"]), flags(commands["port"])
    return [[f, j.get(f), p.get(f)] for f in sorted(set(j) | set(p)) if j.get(f) != p.get(f)]


def train_config(TrainConfig, siglip_max, a):
    """The ``TrainConfig`` both CLIs build from their parsed arguments."""
    return TrainConfig(
        seed=a.seed, logit_scale_max=siglip_max if a.loss == "siglip" else TrainConfig.logit_scale_max,
        global_batch_size=a.global_batch_size, epochs=a.epochs, steps_per_epoch=a.steps_per_epoch,
        learning_rate=a.learning_rate, checkpoint_every_steps=a.checkpoint_every,
        validate_every_steps=a.validate_every, keep_checkpoints=a.keep_checkpoints, accum_steps=a.accum_steps,
        max_inflight_steps=a.max_inflight_steps, pipeline_microbatches=a.pipeline_microbatches,
        crash_after_steps=a.crash_after_steps, hang_after_steps=a.hang_after_steps, loss=a.loss,
        ema_decay=a.ema_decay, freeze=a.freeze_tower, augment=a.augment, freeze_serving=a.freeze_serving,
        fsdp=a.fsdp,
    )


def jax_source(train, a, cfg):
    """``train.py``'s training source for one host reading ``--data`` (one
    pattern) under ``--cache-data``, as its ``main`` builds it."""
    from clip_mixer_tpu.data.pipeline import CacheSource

    if a.synthetic or a.data is None or len(a.data) != 1 or a.cache_data is None or a.augment:
        raise ValueError("the witness reads one --data pattern under --cache-data, without --augment")
    pattern, _ = train.parse_data_spec(a.data[0])
    data = train.build_single_source(
        pattern, a.caption_from, batch_size=a.global_batch_size, image_size=cfg.image_resolution,
        context_length=cfg.context_length, n_hosts=1, host_index=0, shuffle_buffer=a.shuffle_buffer,
        on_decode_error=a.on_decode_error, seed=a.seed)
    data.shuffle_buffer = 0
    return CacheSource(data, cache_dir=a.cache_data if isinstance(a.cache_data, str) else None, seed=a.seed)


class Leg:
    """Each package's parsed trainer arguments, model config, ``TrainConfig``
    and training source for one argument list each."""

    def __init__(self, commands):
        import train  # the repository's train.py: the JAX package's trainer CLI

        from clip_mixer_tpu import config as jconfig
        from clip_mixer_tpu_torch import config as pconfig
        from clip_mixer_tpu_torch import train_cli
        from clip_mixer_tpu_torch.ops.augment import source_size

        self.commands = commands
        old, sys.argv = sys.argv, ["train.py", *commands["jax"]]
        try:
            ja = train.parse_args()
        finally:
            sys.argv = old
        pa = train_cli.parse_args(commands["port"])
        self.args = {"jax": ja, "port": pa}
        self.cfg = {
            "jax": jconfig.PRESETS[ja.preset].replace(remat=not ja.no_remat, remat_policy=ja.remat_policy),
            "port": pconfig.PRESETS[pa.preset].replace(remat=not pa.no_remat, remat_policy=pa.remat_policy,
                                                       fused_mlp=pa.fused_mlp),
        }
        self.tcfg = {"jax": train_config(jconfig.TrainConfig, jconfig.SIGLIP_LOGIT_SCALE_MAX, ja),
                     "port": train_config(pconfig.TrainConfig, pconfig.SIGLIP_LOGIT_SCALE_MAX, pa)}
        port_res = source_size(self.cfg["port"].image_resolution) if pa.augment else self.cfg["port"].image_resolution
        self.data = {"jax": jax_source(train, ja, self.cfg["jax"]),
                     "port": train_cli.build_data(pa, self.cfg["port"], port_res)}


def augmented(leg, pkg, step, images):
    """``images`` through the package's train-step augmentation hook at
    ``step`` (the state's count before the step), as uint8 numpy."""
    if pkg == "jax":
        import jax.numpy as jnp

        from clip_mixer_tpu.ops.augment import maybe_augment

        return np.asarray(maybe_augment(leg.tcfg["jax"], leg.cfg["jax"], step, jnp.asarray(images)))
    import torch

    from clip_mixer_tpu_torch.ops.augment import maybe_augment

    return maybe_augment(leg.tcfg["port"], leg.cfg["port"], step, torch.from_numpy(np.array(images))).numpy()


def data_part(leg, n_batches=3) -> dict:
    """The first ``n_batches`` training batches of each package, after the
    augmentation hook, compared bit for bit."""
    got = {}
    for pkg in ("jax", "port"):
        it = leg.data[pkg].iter_batches(0, 0)
        got[pkg] = []
        for step in range(n_batches):
            b = next(it)
            got[pkg].append({"images": augmented(leg, pkg, step, b["images"]), "texts": np.asarray(b["texts"])})
    out = {"part": "data", "batches": n_batches, "augment": {p: leg.tcfg[p].augment for p in got},
           "batches_per_epoch": {p: leg.data[p].batches_per_epoch for p in got},
           "shapes": {f: list(got["port"][0][f].shape) for f in ("images", "texts")},
           "command_differences": command_differences(leg.commands), "first_difference": None}
    for step, (j, p) in enumerate(zip(got["jax"], got["port"])):
        for field in ("images", "texts"):
            if j[field].shape != p[field].shape or j[field].dtype != p[field].dtype:
                out["first_difference"] = {"step": step, "field": field, "row": None,
                                           "jax": [list(j[field].shape), str(j[field].dtype)],
                                           "port": [list(p[field].shape), str(p[field].dtype)]}
                break
            rows = np.flatnonzero((j[field] != p[field]).reshape(j[field].shape[0], -1).any(-1))
            if rows.size:
                out["first_difference"] = {"step": step, "field": field, "row": int(rows[0]),
                                           "rows_differing": int(rows.size)}
                break
        if out["first_difference"]:
            break
    out["equal"] = out["first_difference"] is None
    return out


def leg_updates(tcfg, n_samples: int):
    """(steps an epoch, epochs, updates) of a leg over ``n_samples`` cached
    samples, as both trainers count them: ``tcfg.steps_per_epoch``, else the
    cache's floor(n / batch) batches."""
    per_epoch = tcfg.steps_per_epoch or n_samples // tcfg.global_batch_size
    return per_epoch, tcfg.epochs, per_epoch * tcfg.epochs


def schedule_part(leg, n_samples: int) -> dict:
    """Each package's learning rate at every update of the leg: its optimiser's
    schedule over (steps a cached epoch) x epochs updates."""
    from clip_mixer_tpu.train.schedule import warmup_cosine as jax_warmup_cosine
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    out = {"part": "schedule", "n_samples": n_samples}
    for pkg in ("jax", "port"):
        out[pkg] = dict(zip(("steps_per_epoch", "epochs", "total_steps"), leg_updates(leg.tcfg[pkg], n_samples)))
    jt, pt = leg.tcfg["jax"], leg.tcfg["port"]
    # the schedule JAX's make_optimizer hands optax, which reads it at the update count before the update
    jax_lr = jax_warmup_cosine(jt.learning_rate, jt.learning_rate * jt.min_lr_ratio, jt.warmup_steps,
                               out["jax"]["total_steps"])
    port_lr = make_optimizer(pt, out["port"]["total_steps"]).schedule
    n = max(out["jax"]["total_steps"], out["port"]["total_steps"])
    out["jax"]["lr"] = [float(jax_lr(i)) for i in range(n)]
    out["port"]["lr"] = [float(port_lr(i)) for i in range(n)]
    gaps = [abs(p - j) / j for p, j in zip(out["port"]["lr"], out["jax"]["lr"])]
    out["max_rel_gap"] = max(gaps)
    out["at_update"] = int(np.argmax(gaps))
    return out


LARGE_NUMEL = 1024  # leaves this large or larger: their std is read to a few percent


def compare_draws(port_sd, jax_sd) -> dict:
    """Two seed-0 draws of one model, by reference key. A leaf that JAX fills
    with one value (LayerNorms, ``logit_scale``, zero biases) must be equal
    element for element; every other leaf is held by its mean, as a z-score
    of the two means' sampling error, and by the ratio of its standard
    deviations (the ratios over leaves of LARGE_NUMEL elements or more apart:
    a small leaf's std is read to ~1 / sqrt(2 numel) only)."""
    import torch

    if set(port_sd) != set(jax_sd):
        return {"same_keys": False, "only_port": sorted(set(port_sd) - set(jax_sd)),
                "only_jax": sorted(set(jax_sd) - set(port_sd))}
    shapes = [k for k in jax_sd if tuple(port_sd[k].shape) != tuple(jax_sd[k].shape)]
    const, differing, z, ratio = [], [], {}, {}
    for k, j in jax_sd.items():
        p = port_sd[k]
        if k in shapes:
            continue
        if not j.is_floating_point() or bool((j == j.flatten()[0]).all()):
            const.append(k)
            if p.dtype != j.dtype or not torch.equal(p, j):
                differing.append(k)
            continue
        p, j = p.double(), j.double()
        sp, sj = float(p.std()), float(j.std())
        z[k] = abs(float(p.mean() - j.mean())) / ((sp * sp + sj * sj) / j.numel()) ** 0.5
        ratio[k] = sp / sj
    large = {k: r for k, r in ratio.items() if jax_sd[k].numel() >= LARGE_NUMEL}
    small = {k: r for k, r in ratio.items() if jax_sd[k].numel() < LARGE_NUMEL}
    worst_z = max(z, key=z.get)
    return {"same_keys": True, "shape_differences": shapes,
            "constant": {"leaves": len(const), "all_equal": not differing, "differing": differing},
            "drawn": {"leaves": len(ratio), "mean_z_max": z[worst_z], "mean_z_max_at": worst_z,
                      "std_ratio_large": {"leaves": len(large), "min_numel": LARGE_NUMEL,
                                          "min": min(large.values()), "max": max(large.values())},
                      "std_ratio_small": {"leaves": len(small), "min": min(small.values(), default=None),
                                          "max": max(small.values(), default=None),
                                          "min_numel": min((jax_sd[k].numel() for k in small), default=None)}}}


def step_part(leg, batch: int, steps: int, n_samples: int, seed: int = 0) -> dict:
    """The JAX package's ``init(key(seed))`` through both train steps on the
    port source's first ``steps`` batches of ``batch`` rows, in f32, each
    optimiser scheduled over the leg's updates (``n_samples``)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch

    from clip_mixer_tpu.models import clip as jclip
    from clip_mixer_tpu.parallel import train_step as jstep
    from clip_mixer_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from clip_mixer_tpu.train.optimizer import make_optimizer as jax_make_optimizer
    from clip_mixer_tpu_torch import CLIP, load_jax_params
    from clip_mixer_tpu_torch.data.pipeline import CacheSource
    from clip_mixer_tpu_torch.models.convert import jax_params_to_state_dict
    from clip_mixer_tpu_torch.parallel import train_step as pstep
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    jc, pc = (leg.cfg[p].replace(compute_dtype="float32") for p in ("jax", "port"))
    jt = dataclasses.replace(leg.tcfg["jax"], global_batch_size=batch)
    pt = dataclasses.replace(leg.tcfg["port"], global_batch_size=batch)
    src = leg.data["port"]
    cut = CacheSource(src.inner, seed=src.seed, cache_dir=src.cache_dir)
    cut.batch_size = batch
    it = cut.iter_batches(0, 0)
    batches = [{k: np.array(v) for k, v in next(it).items()} for _ in range(steps)]

    params = jax.tree.map(np.asarray, jax.jit(lambda k: jclip.init(k, jc))(jax.random.key(seed)))
    own = CLIP(pc, device="cpu", generator=torch.Generator().manual_seed(seed))
    draws = compare_draws(own.state_dict(), jax_params_to_state_dict(params, jc))
    model = load_jax_params(own, params)
    del own

    total_steps = leg_updates(leg.tcfg["port"], n_samples)[2]
    mesh = make_mesh(n_data=1, devices=jax.devices()[:1])
    jopt = jax_make_optimizer(jt, total_steps=total_steps)
    state = replicate(mesh, jstep.init_train_state(jax.tree.map(jnp.asarray, params), jopt))
    jfn = jstep.make_train_step(jc, jt, mesh, jopt, accum_steps=jt.accum_steps)
    jax_losses = []
    for b in batches:
        state, m = jfn(state, shard_batch(mesh, b))
        jax_losses.append(float(jax.device_get(m["loss"])))
    del state, jfn

    popt = make_optimizer(pt, total_steps=total_steps)
    pstate = pstep.init_train_state(model, popt)
    pfn = pstep.make_train_step(pc, pt, popt, accum_steps=pt.accum_steps)
    port_losses = []
    for b in batches:
        pstate, m = pfn(pstate, b)
        port_losses.append(float(m["loss"]))
    gaps = [abs(p - j) / abs(j) for p, j in zip(port_losses, jax_losses)]
    return {"part": "step", "preset": leg.args["port"].preset, "compute_dtype": "float32", "batch": batch,
            "steps": steps, "remat": pc.remat, "total_steps": total_steps, "learning_rate": pt.learning_rate,
            "jax_losses": jax_losses, "port_losses": port_losses, "loss_rel_gap": gaps,
            "max_loss_rel_gap": max(gaps), "loss_rtol": LOSS_RTOL, "within_loss_rtol": max(gaps) <= LOSS_RTOL,
            "init_port_vs_jax": draws}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workers", type=int, default=1, help="processes rendering the shards")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    result = {}
    with tempfile.TemporaryDirectory(prefix="dress_witness_") as work:
        work = Path(work)
        shards = script("torch_make_dress_dataset").main(
            ["--out", str(work / "dress"), "--n", str(N_WRITTEN), "--size", "256",
             "--samples-per-shard", "1024", "--workers", str(args.workers)])
        train_glob = str(work / "dress" / f"0000[0-{len(shards) - 2}].tar")
        leg = Leg(rehearsal_commands(work, train_glob, shards[-1], LEG_BATCH, LEG_SAMPLES, LEG_STEPS, "mixer-b32"))
        parts = {"data": lambda: data_part(leg, 3), "schedule": lambda: schedule_part(leg, LEG_SAMPLES),
                 "step": lambda: step_part(leg, STEP_BATCH, 4, LEG_SAMPLES)}
        for name in parts:
            t = time.perf_counter()
            result[name] = {**parts[name](), "s": time.perf_counter() - t}
            print(json.dumps(result[name]), flush=True)
    result["s"] = time.perf_counter() - t0
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
