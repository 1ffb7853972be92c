"""Training command line of the port: ``python -m clip_mixer_tpu_torch.train_cli``.

Counterpart of the JAX package's ``train.py`` on one device, with its flags'
names and defaults (remat on unless ``--no-remat``), ``--device`` in place of
``--platform`` (the card unless another is named). It builds the model from
a preset or from ``--init-from`` (whatever ``api.load`` takes: a port
export directory, a torch checkpoint, a registry name or a preset), the data
source (``--data``: a tar-shard glob, local or ``scheme://``, a ``.csv`` /
``.tsv`` manifest or an image directory; several ``--data GLOB::WEIGHT``
tar globs blend into a mixture; ``--cache-data`` serves ``--data`` from host
RAM; else synthetic), the validators (the four remote ones unless
``--no-validators``, retrieval over ``--val-data`` always) and the
:class:`~clip_mixer_tpu_torch.train.trainer.Trainer`, which writes to
``outputs/<run-name>`` and exports to ``outputs/<run-name>/export``.

Data-parallel runs start one process per card, told their rendezvous by
``--coordinator HOST:PORT --num-processes N --process-id I`` or by
``torchrun``'s environment (``parallel/dist.py``); NCCL joins them on the
card, gloo with ``--device cpu``. Each process reads
``--global-batch-size / N`` rows a step: its own shards of ``--data``
(``n_hosts = N``, ``host_index = I``), or its rows of each synthetic global
batch). Rank 0 writes the run's files.

``--tensor-parallel N`` lays the processes out as a (world / N) data x N
model mesh (``parallel/mesh.py``; an N that does not divide the world
exits): the blocks' MLPs and attention heads are split over each model
group (``parallel/tp.py``), and the ranks of one data row read the same
rows. ``--fsdp`` shards the parameters and Adam's state over the data
dimension (``parallel/fsdp.py``) and trains the exact global loss. Both
need a process group (a world of one will do).

Flags whose machinery is not ported yet exit with a message naming the
ROADMAP item. A non-finite loss exits with code 13, as the JAX launcher's
``EXIT_NONFINITE``: under bitwise resume that failure repeats, so a
supervisor must not restart it.

Examples::

    python -m clip_mixer_tpu_torch.train_cli --synthetic --preset mixer-b32 \\
        --global-batch-size 256 --steps-per-epoch 50 --epochs 2 --run-name run1
    torchrun --nproc-per-node 8 -m clip_mixer_tpu_torch.train_cli --synthetic \\
        --global-batch-size 2048 --steps-per-epoch 50 --epochs 2 --run-name run8
    torchrun --nproc-per-node 8 -m clip_mixer_tpu_torch.train_cli --synthetic --fsdp \\
        --tensor-parallel 2 --global-batch-size 2048 --steps-per-epoch 50 --run-name fsdp_tp
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import sys
import traceback

import torch
import torch.distributed as dist

from clip_mixer_tpu_torch.api import load
from clip_mixer_tpu_torch.config import PRESETS, SIGLIP_LOGIT_SCALE_MAX, TrainConfig
from clip_mixer_tpu_torch.data.pipeline import (
    CacheSource,
    FileListSource,
    MixtureSource,
    RankRowsSource,
    SyntheticSource,
    TarShardSource,
    expand_shard_pattern,
)
from clip_mixer_tpu_torch.evals.validators import (
    CosineSimValidator,
    ImageNetValidator,
    MNISTValidator,
    RetrievalValidator,
    SST2Validator,
)
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.ops.augment import source_size
from clip_mixer_tpu_torch.parallel.dist import maybe_initialize_distributed, rank_device
from clip_mixer_tpu_torch.parallel.mesh import data_index, make_mesh
from clip_mixer_tpu_torch.train.trainer import Trainer

EXIT_NONFINITE = 13  # clip_mixer_tpu/launch.py:169

# flag -> the ROADMAP.md item that ports its machinery
NOT_PORTED = {
    "--pipeline-stages": "Queue 1 item 16b, pipeline stages (GPipe)",
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="mixer-b32", choices=sorted(PRESETS.keys()))
    p.add_argument("--data", action="append", default=None,
                   help="tar-shard glob (local or scheme://), .csv/.tsv manifest or image directory; "
                        "repeat as GLOB::WEIGHT for a mixture of tar globs")
    p.add_argument("--val-data", default=None,
                   help="held-out split for the retrieval validator (any --data form but a mixture)")
    p.add_argument("--val-samples", type=int, default=2048)
    p.add_argument("--caption-from", default="txt", choices=("txt", "dirname", "stem"))
    p.add_argument("--synthetic", action="store_true", help="synthetic data (smoke runs)")
    p.add_argument("--run-name", default="run", help="output directory name under outputs/")
    p.add_argument("--epochs", type=int, default=32)
    p.add_argument("--global-batch-size", type=int, default=32768)
    p.add_argument("--learning-rate", type=float, default=5e-4)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=400)
    p.add_argument("--validate-every", type=int, default=None,
                   help="validation cadence in steps (default: --checkpoint-every)")
    p.add_argument("--keep-checkpoints", type=int, default=3, help="retention window (last N checkpoints)")
    p.add_argument("--grad-through-gather", action="store_true")
    p.add_argument("--chunk-size", type=int, default=None, help="chunked logits")
    p.add_argument("--accum-steps", type=int, default=1, help="exact (GradCache) accumulation microbatches")
    p.add_argument("--max-inflight-steps", type=int, default=2,
                   help="dispatch depth: the host waits on the step this many back")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3: shard params + Adam moments over the data axis; trains with the exact global "
                        "InfoNCE gradient; composes with --tensor-parallel (storage sharded over the full grid)")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="model-axis size: MLP hidden dims and attention heads split over this many processes; "
                        "the mesh becomes (processes/N) data x N model")
    p.add_argument("--pipeline-stages", type=int, default=1, help="not ported yet beyond 1")
    p.add_argument("--pipeline-microbatches", type=int, default=8)
    p.add_argument("--cache-data", nargs="?", const=True, default=None, metavar="DIR",
                   help="serve every epoch from a host-RAM cache (needs --data)")
    p.add_argument("--shuffle-buffer", type=int, default=10000)
    p.add_argument("--on-decode-error", default="raise", choices=["raise", "substitute"])
    p.add_argument("--freeze-serving", action="store_true",
                   help="also record the frozen serving programs into the export (aot.freeze_programs)")
    p.add_argument("--loss", default="info_nce", choices=["info_nce", "siglip"])
    p.add_argument("--init-from", default=None, metavar="PATH",
                   help="initialise from whatever api.load takes (a port export directory, a torch "
                        ".pt / .safetensors, an Accelerate dir, a registry name or a preset); "
                        "a checkpoint of this run still wins")
    p.add_argument("--freeze-tower", default=None, choices=["visual", "text"])
    p.add_argument("--augment", action="store_true", help="in-step random crop and flip")
    p.add_argument("--ema-decay", type=float, default=None)
    p.add_argument("--seed", type=int, default=0, help="init and data seed (TrainConfig.seed)")
    p.add_argument("--no-validators", action="store_true")
    p.add_argument("--no-remat", action="store_true", help="disable gradient rematerialisation")
    p.add_argument("--remat-policy", default="none", choices=["none", "mlp_hidden", "all_hidden"])
    p.add_argument("--fused-mlp", action="store_true",
                   help="the Mixer towers' channel MLPs through the ln_mlp kernel (CLIPConfig.fused_mlp)")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="trace this many steady steps to outputs/<run>/profile")
    p.add_argument("--crash-after-steps", type=int, default=None, help="fault injection: crash after N steps")
    p.add_argument("--hang-after-steps", type=int, default=None, help="fault injection: hang after N steps")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    p.add_argument("--coordinator", default=None, help="host:port (or a tcp:// / file:// URL) of the rendezvous")
    p.add_argument("--num-processes", type=int, default=None, help="processes in the run (with --coordinator)")
    p.add_argument("--process-id", type=int, default=None, help="this process's rank (with --coordinator)")
    return p.parse_args(argv)


def refuse_unported(args: argparse.Namespace) -> None:
    """SystemExit for the first flag set whose machinery is not ported."""
    if args.pipeline_stages > 1:
        flag = "--pipeline-stages"
        raise SystemExit(f"{flag} is not ported to clip_mixer_tpu_torch yet: ROADMAP.md, {NOT_PORTED[flag]}")
    if args.tensor_parallel < 1:
        raise SystemExit(f"--tensor-parallel must be >= 1, got {args.tensor_parallel}")
    if args.cache_data is not None and (args.synthetic or args.data is None):
        raise SystemExit("--cache-data needs --data (synthetic data is already RAM-speed)")
    launch = {"--coordinator": args.coordinator, "--num-processes": args.num_processes,
              "--process-id": args.process_id}
    given = [f for f, v in launch.items() if v is not None]
    if given and len(given) < len(launch):
        raise SystemExit(f"{', '.join(given)} without {', '.join(f for f in launch if f not in given)}: "
                         "an explicit rendezvous needs --coordinator, --num-processes and --process-id")


def parse_data_spec(spec):
    """A ``--data`` value -> (glob pattern, weight). ``::WEIGHT`` is a weight
    only if the tail parses as a float (paths may contain ``::``); an
    explicit weight that is not positive and finite exits."""
    pattern, sep, w = spec.rpartition("::")
    if sep and pattern:
        try:
            weight = float(w)
        except ValueError:
            return spec, 1.0
        if not (weight > 0 and math.isfinite(weight)):
            raise SystemExit(f"--data {spec!r}: weight after '::' must be a positive number, got {w!r}")
        return pattern, weight
    return spec, 1.0


def build_single_source(pattern, caption_from="txt", **source_kwargs):
    """One source from a spec: a ``.csv`` / ``.tsv`` manifest or an image
    directory (:class:`FileListSource`; a directory holding ``.tar`` files
    is read as shards), else a tar-shard glob, local or remote
    (:class:`TarShardSource`)."""
    if pattern.lower().endswith((".csv", ".tsv")):
        return FileListSource.from_csv(pattern, **source_kwargs)
    if "://" in pattern:
        shards = expand_shard_pattern(pattern)
        if not shards:
            raise SystemExit(f"no shards match {pattern}")
        return TarShardSource(shards, **source_kwargs)
    if os.path.isdir(pattern):
        tars = sorted(glob.glob(os.path.join(pattern, "**", "*.tar"), recursive=True))
        if tars:
            return TarShardSource(tars, **source_kwargs)
        return FileListSource.from_folder(pattern, caption_from=caption_from, **source_kwargs)
    shards = sorted(glob.glob(pattern))
    if not shards:
        raise SystemExit(f"no shards match {pattern}")
    return TarShardSource(shards, **source_kwargs)


def per_host_batch(global_batch: int, n_hosts: int) -> int:
    """The rows each process reads a step; an indivisible global batch
    exits (the batch trained would not be the one configured)."""
    if global_batch % n_hosts:
        raise SystemExit(f"--global-batch-size {global_batch} is not divisible by {n_hosts} processes: the "
                         "actual batch would silently differ from the configured one")
    return global_batch // n_hosts


def build_data(args, cfg, image_size, n_hosts=1, host_index=0):
    """The training source ``--data`` / ``--cache-data`` / ``--synthetic`` ask
    for, for process ``host_index`` of ``n_hosts``: its shards of ``--data``,
    or its rows of each synthetic global batch (so a run trains on the same
    global batches whatever its number of processes)."""
    batch = per_host_batch(args.global_batch_size, n_hosts)
    if args.synthetic or args.data is None:
        data = SyntheticSource(batch_size=args.global_batch_size, image_size=image_size,
                               n_batches=args.steps_per_epoch or 100, context_length=cfg.context_length)
        return data if n_hosts == 1 else RankRowsSource(data, n_hosts, host_index)
    source_kwargs = dict(batch_size=batch, image_size=image_size, context_length=cfg.context_length,
                         n_hosts=n_hosts, host_index=host_index, shuffle_buffer=args.shuffle_buffer,
                         on_decode_error=args.on_decode_error, seed=args.seed)
    if len(args.data) == 1:
        data = build_single_source(parse_data_spec(args.data[0])[0], args.caption_from, **source_kwargs)
    else:
        components, weights = [], []
        for spec in args.data:
            pattern, weight = parse_data_spec(spec)
            if pattern.lower().endswith((".csv", ".tsv")) or os.path.isdir(pattern):
                raise SystemExit("--data mixtures support tar-shard globs only; a .csv/.tsv manifest or "
                                 "image directory must be the sole --data argument")
            shards = expand_shard_pattern(pattern)
            if not shards:
                raise SystemExit(f"no shards match {pattern}")
            components.append(shards)
            weights.append(weight)
        if args.steps_per_epoch is None:
            raise SystemExit("a --data mixture streams indefinitely (small components repeat to hold "
                             "the ratio): set --steps-per-epoch")
        data = MixtureSource(components, weights=weights, **source_kwargs)
    if args.cache_data is None:
        return data
    if isinstance(data, MixtureSource):
        raise SystemExit("--cache-data does not compose with --data mixtures (a mixture streams "
                         "indefinitely; cache the packed components instead)")
    data.shuffle_buffer = 0  # cached epochs are full permutations
    cache_dir = args.cache_data if isinstance(args.cache_data, str) else None
    return CacheSource(data, cache_dir=cache_dir, seed=args.seed)


def build_validators(args, cfg, device):
    """The four remote validators unless ``--no-validators``, and retrieval
    over ``--val-data`` whenever it is given; each holds no model: the
    trainer hands it the host weights."""
    validators = []
    if not args.no_validators:
        validators = [ImageNetValidator(None, cfg, device=device), CosineSimValidator(None, cfg, device=device),
                      SST2Validator(None, cfg, device=device), MNISTValidator(None, cfg, device=device)]
    if args.val_data:
        # the model's resolution (no augmentation headroom), the tail batch kept
        val_source = build_single_source(args.val_data, args.caption_from, batch_size=min(256, args.val_samples),
                                         image_size=cfg.image_resolution, context_length=cfg.context_length,
                                         drop_last=False, on_decode_error=args.on_decode_error)
        validators.append(RetrievalValidator(None, cfg, data_source=val_source, max_samples=args.val_samples,
                                             device=device))
    return validators


def init_model(path: str, cfg, seed: int, device):
    """The fine-tuning entry: the architecture and weights of what
    ``api.load`` makes of ``path`` (read on the host), this run's runtime
    knobs. A SigLIP run from an InfoNCE checkpoint keeps its fresh
    ``logit_bias``."""
    loaded, loaded_cfg, _ = load(path, device="cpu", seed=seed)
    cfg = loaded_cfg.replace(
        remat=cfg.remat, remat_policy=cfg.remat_policy, fused_mlp=cfg.fused_mlp,
        compute_dtype=cfg.compute_dtype, logit_bias_init=cfg.logit_bias_init,
    )
    model = CLIP(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    missing, unexpected = model.load_state_dict(loaded.state_dict(), strict=False)
    if unexpected or set(missing) - {"logit_bias"}:
        raise SystemExit(f"--init-from {path}: weights do not fit the loaded config "
                         f"(missing {missing[:5]}, unexpected {unexpected[:5]})")
    return model, cfg


def main(argv=None) -> None:
    args = parse_args(argv)
    refuse_unported(args)
    launched = not dist.is_initialized() and maybe_initialize_distributed(
        args.device, verbose=args.verbose, coordinator=args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id)
    try:
        run(args)
    finally:
        if launched:
            dist.destroy_process_group()


def build_mesh(args, device):
    """The mesh of the run: None for one process without a group; else
    (world / N) data x N model for ``--tensor-parallel N`` (train.py's
    layout), refusing an N that does not divide the world. ``--fsdp`` and
    ``--tensor-parallel`` need a process group."""
    if not dist.is_initialized():
        if args.fsdp or args.tensor_parallel > 1:
            raise SystemExit("--fsdp and --tensor-parallel shard over a process group: launch under torchrun or "
                             "with --coordinator / --num-processes / --process-id (a world of one will do)")
        return None
    n = dist.get_world_size()
    if n % args.tensor_parallel:
        raise SystemExit(f"--tensor-parallel {args.tensor_parallel} does not divide the {n} processes "
                         "(stranded ranks / an empty mesh)")
    return make_mesh(n_data=n // args.tensor_parallel, n_model=args.tensor_parallel, device=device)


def run(args: argparse.Namespace) -> None:
    """One process's run, under a process group when one is up."""
    device = rank_device(args.device) if dist.is_initialized() else args.device
    mesh = build_mesh(args, device)
    host, n_hosts = data_index(mesh)  # the ranks of one data row read the same rows
    cfg = PRESETS[args.preset].replace(remat=not args.no_remat, remat_policy=args.remat_policy,
                                       fused_mlp=args.fused_mlp)
    if args.loss == "siglip":
        cfg = cfg.for_siglip()
    model = None
    if args.init_from:
        model, cfg = init_model(args.init_from, cfg, args.seed, device)
    tcfg = TrainConfig(
        seed=args.seed,
        logit_scale_max=SIGLIP_LOGIT_SCALE_MAX if args.loss == "siglip" else TrainConfig.logit_scale_max,
        global_batch_size=args.global_batch_size,
        epochs=args.epochs,
        steps_per_epoch=args.steps_per_epoch,
        learning_rate=args.learning_rate,
        checkpoint_every_steps=args.checkpoint_every,
        validate_every_steps=args.validate_every,
        keep_checkpoints=args.keep_checkpoints,
        accum_steps=args.accum_steps,
        max_inflight_steps=args.max_inflight_steps,
        pipeline_microbatches=args.pipeline_microbatches,
        crash_after_steps=args.crash_after_steps,
        hang_after_steps=args.hang_after_steps,
        loss=args.loss,
        ema_decay=args.ema_decay,
        freeze=args.freeze_tower,
        augment=args.augment,
        freeze_serving=args.freeze_serving,
        fsdp=args.fsdp,
    )
    # with augmentation the source is larger and the step crops it back
    source_res = source_size(cfg.image_resolution) if args.augment else cfg.image_resolution
    data = build_data(args, cfg, source_res, n_hosts, host)
    trainer = Trainer(
        cfg, tcfg, data,
        run_dir=os.path.join("outputs", args.run_name),
        device=device,
        grad_through_gather=args.grad_through_gather,
        chunk_size=args.chunk_size,
        model=model,
        validators=build_validators(args, cfg, device),
        verbose=args.verbose,
        profile_steps=args.profile_steps,
        mesh=mesh,
    )
    try:
        trainer.train()
    except FloatingPointError:
        # the trainer's non-finite-loss abort, the last good checkpoint kept
        traceback.print_exc()
        sys.exit(EXIT_NONFINITE)


if __name__ == "__main__":
    main()
