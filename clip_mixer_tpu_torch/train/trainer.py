"""Trainer orchestration: epochs, checkpoints, validation, metrics, on one device or data-parallel.

Counterpart of ``clip_mixer_tpu/train/trainer.py``. The
step is ``parallel/train_step.py``'s; the data come from a
:class:`~clip_mixer_tpu_torch.data.pipeline.DataSource` through
:func:`~clip_mixer_tpu_torch.data.pipeline.prefetch` (a host thread) and
:func:`~clip_mixer_tpu_torch.data.pipeline.device_prefetch` (pinned copies on
a side stream); the state is checkpointed by
:class:`~clip_mixer_tpu_torch.train.checkpoint.Checkpointer` and resumes bit
for bit: batch ``b`` of epoch ``e`` is a pure function of the source's seed,
and the augmentation is keyed on the step.

What the loop keeps of the JAX one: the resume point ``(epoch, batch)``
with the per-epoch cap checked before stepping; the first batch's token ids
against ``vocab_size``; dispatch bounded by ``max_inflight_steps`` (on CUDA an
event a step, and the host waits on the oldest, never on the state); metrics
kept as device tensors until a cadence boundary; a heartbeat file a step;
SIGTERM / SIGINT saved at the next step boundary (a second SIGINT raises
``KeyboardInterrupt``, and a stop also ends a blocked data wait); the
non-finite-loss abort before the boundary's save; the ``crash_after_steps``
and ``hang_after_steps`` drills; a validation cadence of its own; the
throughput scalar at each checkpoint boundary; a profiler trace of
``profile_steps`` steady steps; the final save and the export.

Across processes (a process group initialised by ``parallel/dist.py``),
each process trains one replica on its own card and its own share of the
data, the step averaging the gradients over the mesh's data axis. Rank 0
leads, as JAX's process 0 does: it alone writes the checkpoints, the
metrics, the validators' results, the export and its frozen programs,
while the others wait at a barrier, so no rank reads a half-written step;
each rank writes its own heartbeat, ``heartbeat-{rank}``. A stop (SIGTERM
to any rank) is agreed every ``preemption_sync_every_steps`` by an OR over
the ranks, so every rank saves at the same step. Every rank restores the
same checkpoint, so a resume is bit for bit.

A mesh with a model dimension cuts the blocks over it (tensor parallelism,
``parallel/tp.py``), and ``TrainConfig.fsdp`` shards the parameters and the
optimiser state over its data dimension (``parallel/fsdp.py``). Such a
state is split over the ranks: every rank writes its own shards into each
checkpoint (``train/checkpoint.py``), and the export and the validators get
the whole parameters, gathered by every rank before rank 0 writes or
validates. A mesh with a ``stage`` dimension of more than one rank
(``parallel/pp.py::make_pp_mesh``) cuts the towers' blocks into pipeline
stages and trains through the GPipe step with
``tcfg.pipeline_microbatches`` microbatches, as JAX's trainer selects it;
its checkpoints hold each rank's stage as a shard, restored only into the
same layout.
"""

from __future__ import annotations

import contextlib
import math
import os
import signal
import threading
import time
from collections import deque
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from clip_mixer_tpu_torch.api import save_pretrained
from clip_mixer_tpu_torch.config import CLIPConfig, TrainConfig
from clip_mixer_tpu_torch.data.pipeline import DataSource, device_prefetch, pinned, prefetch
from clip_mixer_tpu_torch.device import DeviceLike, resolve_device
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.parallel.dist import any_across, barrier, rank_device, world
from clip_mixer_tpu_torch.parallel.fsdp import apply_fsdp, gather_full, is_sharded, make_fsdp_train_step
from clip_mixer_tpu_torch.parallel.mesh import data_group, make_mesh, model_group, replicate
from clip_mixer_tpu_torch.parallel.pp import make_pp_train_step, n_stages_of, shard_model_pp
from clip_mixer_tpu_torch.parallel.tp import shard_model_tp
from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step
from clip_mixer_tpu_torch.train.checkpoint import Checkpointer
from clip_mixer_tpu_torch.train.metrics import MetricsWriter, require_local
from clip_mixer_tpu_torch.train.optimizer import make_optimizer


def _pick_trace_start(step: int, n: int, cadences) -> int:
    """Step value S after which the profile trace starts.

    The trace covers the N whole steps S+1..S+N and the host-side
    checkpoint / validation blocks of steps S..S+N-1. S is the smallest
    value >= step+1 whose block range [S, S+N-1] holds no multiple of any
    cadence, so no save or validation pass lands in the "N steady steps";
    where no such window exists (n >= a cadence), step+1."""
    if not n:
        return step + 1
    for s0 in range(step + 1, step + 2 + max(cadences)):
        if all(s % c for c in cadences for s in range(s0, s0 + n)):
            return s0
    return step + 1


class Trainer:
    """Trains ``cfg`` under ``tcfg`` on ``data``, writing to ``run_dir``:
    ``checkpoints/``, ``runs/metrics.jsonl``, ``heartbeat-{rank}``,
    ``profile/`` and, when done, ``export/``.

    ``device``: where the model trains, the card unless another is named
    (under a process group, a bare ``cuda`` is this rank's card).
    ``mesh``: the parallel layout (``parallel/mesh.py``); by default every
    rank of an initialised process group on the data dimension, else one
    device. A model dimension above one splits the blocks over it;
    ``tcfg.fsdp`` (which needs a mesh) shards over the data dimension; a
    stage dimension above one (``make_pp_mesh``) cuts the blocks into
    pipeline stages.
    ``data`` yields this rank's rows of each global batch (the ranks of one
    data row hold the same rows).
    ``model``: a :class:`CLIP` to train in place of one initialised from
    ``tcfg.seed`` (the JAX ``params=``). ``validators``: objects with
    ``validate(step, verbose=, params=)``, called every
    ``validate_every_steps`` with the host state dict (the EMA when on).
    ``timings`` collects what the loop measures: each batch's wait for the
    data, each save's seconds and bytes, each validator pass's seconds, the
    restore's and the export's seconds."""

    def __init__(
        self,
        cfg: CLIPConfig,
        tcfg: TrainConfig,
        data: DataSource,
        run_dir: str,
        device: DeviceLike = None,
        validators: Sequence = (),
        resume: bool = True,
        grad_through_gather: bool = False,
        chunk_size: Optional[int] = None,
        model: Optional[CLIP] = None,
        verbose: bool = False,
        profile_steps: int = 0,
        mesh=None,
    ):
        require_local(run_dir, "run_dir")
        if tcfg.fsdp and (cfg.pipeline_axis or cfg.pipeline_stages > 1):
            raise ValueError("fsdp and pipeline parallelism are mutually exclusive")
        self.cfg, self.tcfg, self.data = cfg, tcfg, data
        if mesh is None and dist.is_initialized():
            mesh = make_mesh(device=device)
        if tcfg.fsdp and mesh is None:
            raise ValueError("TrainConfig.fsdp shards over a mesh's data group: initialise a process group "
                             "(parallel/dist.py; a world of one will do) or pass mesh=")
        self.mesh = mesh
        self.use_pp = n_stages_of(mesh) > 1
        if self.use_pp and tcfg.fsdp:
            raise ValueError("fsdp and pipeline parallelism are mutually exclusive")
        self.group = data_group(mesh)
        self.model_group = model_group(mesh)
        # every rank of the mesh: barriers, the agreed stop, the whole-model broadcast
        self.world_group = None if mesh is None else dist.group.WORLD
        self.rank, self.world = world(self.world_group)
        self.is_lead = self.rank == 0
        self.verbose = verbose and self.is_lead
        self.profile_steps = profile_steps if self.is_lead else 0  # the lead's trace
        self.run_dir = run_dir
        self._profile_dir = os.path.join(run_dir, "profile")
        self._profiler = None
        # liveness for a stall watchdog: its mtime advances every step
        self._heartbeat_path = os.path.join(run_dir, f"heartbeat-{self.rank}")
        self._beat_degraded = False

        steps_per_epoch = tcfg.steps_per_epoch or data.batches_per_epoch
        if steps_per_epoch is None:
            raise ValueError("steps_per_epoch unknown: set tcfg.steps_per_epoch or use a sized DataSource")
        self.steps_per_epoch = steps_per_epoch
        self.total_steps = steps_per_epoch * tcfg.epochs
        self.optimizer = make_optimizer(tcfg, self.total_steps)
        self._schedule = self.optimizer.schedule
        if self.use_pp:
            self.step_fn = make_pp_train_step(cfg, tcfg, mesh, self.optimizer, tcfg.pipeline_microbatches,
                                              grad_through_gather, chunk_size, accum_steps=tcfg.accum_steps)
        elif tcfg.fsdp:  # the exact global loss, always, as JAX's FSDP step
            self.step_fn = make_fsdp_train_step(cfg, tcfg, self.optimizer, mesh, chunk_size,
                                                accum_steps=tcfg.accum_steps)
        else:
            self.step_fn = make_train_step(cfg, tcfg, self.optimizer, grad_through_gather, chunk_size,
                                           accum_steps=tcfg.accum_steps, group=self.group)
        # the other ranks keep the history only
        self.writer = MetricsWriter(log_dir=os.path.join(run_dir, "runs") if self.is_lead else None)
        self.checkpointer = Checkpointer(os.path.join(run_dir, "checkpoints"), max_to_keep=tcfg.keep_checkpoints,
                                         lead=self.is_lead, group=self.world_group)
        self.validators = list(validators)
        self.validate_every_steps = tcfg.validate_every_steps or tcfg.checkpoint_every_steps
        for v in self.validators:
            if getattr(v, "writer", None) is None:
                v.writer = self.writer

        if model is None:
            self.device = rank_device(device)
            model = CLIP(cfg, device=self.device, generator=torch.Generator().manual_seed(tcfg.seed))
        else:
            self.device = model.device if device is None else resolve_device(device)
            model = model.to(self.device)
        # every replica starts from rank 0's weights (before the EMA copies
        # them), then is cut to this rank's slices and shards
        replicate(self.world_group, model)
        if self.model_group is not None:
            shard_model_tp(model, self.model_group)
        if tcfg.fsdp:
            apply_fsdp(model, mesh)
        if self.use_pp:
            shard_model_pp(model, mesh)
        self.sharded = is_sharded(model)
        self.state = init_train_state(model, self.optimizer)
        self.timings = {"data_wait_s": [], "save_s": [], "save_bytes": [], "validate_s": [], "restore_s": None,
                        "export_s": None}
        self.start_epoch, self.start_batch = 0, 0
        if resume and self.checkpointer.latest_step() is not None:
            t0 = time.perf_counter()
            self.state, self.start_epoch, self.start_batch = self.checkpointer.restore(self.state)
            self._sync()
            self.timings["restore_s"] = time.perf_counter() - t0
            if self.verbose:
                print(f"Resuming from epoch {self.start_epoch}, batch {self.start_batch}")
        # the step of the newest checkpoint, known alike on every rank (the
        # disk is not: the lead may be renaming a save into place)
        self._saved_step = self.checkpointer.latest_step()
        if self.world_group is not None:
            barrier(self.world_group)  # every rank has read the checkpoint before the lead may write one

    @property
    def global_step(self) -> int:
        return self.state.step

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self) -> None:
        # A SIGTERM (preemption) or SIGINT marks a stop; the loop saves the
        # completed step at the next boundary and returns. Handlers install
        # only in the main thread and are restored on exit; a second SIGINT
        # raises KeyboardInterrupt, so Ctrl-C Ctrl-C still kills a wedged run.
        stop_requested = threading.Event()
        prev_handlers = {}
        if threading.current_thread() is threading.main_thread():
            def _request_stop(signum, frame):
                if stop_requested.is_set() and signum == signal.SIGINT:
                    raise KeyboardInterrupt
                stop_requested.set()

            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, _request_stop)
        try:
            self._train_loop(stop_requested)
        finally:
            if self._profiler is not None:  # the loop left mid-capture
                self._stop_profile()
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)

    def _beat(self) -> None:
        """Touch the heartbeat file. Failures are swallowed: liveness
        reporting must never kill the training it reports on."""
        try:
            os.utime(self._heartbeat_path, None)
            return
        except FileNotFoundError:  # the first beat creates the file
            created = True
        except OSError:
            created = False
        try:
            os.makedirs(self.run_dir, exist_ok=True)
            # append a byte: where utime fails on an existing file (EPERM, a
            # read-only remount) a bare open("a") would not advance the
            # mtime, and a watchdog would kill a healthy run
            with open(self._heartbeat_path, "a") as f:
                f.write(".")
                f.flush()
            if not created and not self._beat_degraded:
                self._beat_degraded = True
                print(f"trainer: heartbeat degraded to append-writes (os.utime failed on {self._heartbeat_path})")
        except OSError:
            pass

    def _stop_agreed(self, stop_requested: threading.Event, step: int) -> bool:
        """Whether to act on a pending stop at this step. One process: at
        once. Across processes: every ``preemption_sync_every_steps``, the
        OR of the ranks' flags, a collective every rank runs at the same
        step, so a True commits every rank to the same preemption save."""
        if self.world_group is None:
            return stop_requested.is_set()
        if step % self.tcfg.preemption_sync_every_steps:
            return False
        return any_across(stop_requested.is_set(), self.world_group)

    def _preemption_exit(self, pending, epoch: int, batch_idx: int, step: int) -> None:
        """Save the completed step and leave; ``batch_idx`` already points
        at the next batch, as at a cadence save."""
        self._flush_metrics(pending)
        if self._saved_step != step:
            self.save(epoch, batch_idx)
        self.checkpointer.wait()
        self.writer.flush()
        if self.verbose:
            print(f"preemption save: step {step} (epoch {epoch}, batch {batch_idx})", flush=True)

    def _start_profile(self) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()

    def _stop_profile(self) -> None:
        self._sync()
        prof, self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self._profile_dir, "trace.json"))
        if self.verbose:
            print(f"profile: {self.profile_steps} steps traced to {self._profile_dir}")

    def _timed(self, batches):
        """``batches``, appending the time each one took to arrive to
        ``timings["data_wait_s"]``."""
        it = iter(batches)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.timings["data_wait_s"].append(time.perf_counter() - t0)
            yield batch

    def _train_loop(self, stop_requested: threading.Event) -> None:
        tcfg = self.tcfg
        first_caption_logged = -1  # the epoch whose first batch was reported
        step = self.global_step
        resume_step = step  # for the drills: steps this process ran
        self._trace_start_after = _pick_trace_start(
            step, self.profile_steps, (tcfg.checkpoint_every_steps, self.validate_every_steps)
        )
        cuda = self.device.type == "cuda"
        self._beat()  # init or restore done: the stall clock starts here
        for epoch in range(self.start_epoch, tcfg.epochs):
            start_batch = self.start_batch if epoch == self.start_epoch else 0
            batch_idx = start_batch
            t0 = time.monotonic()
            steps_since_t0 = 0
            pending = []  # (step, metrics on the device) until the boundary
            # Each in-flight step pins its batch; the host waits on the
            # event of the step max_inflight_steps back, never on the state.
            inflight: deque = deque()
            # closed on every way out, so the prefetch thread ends with the epoch
            source = self.data.iter_batches(epoch, start_batch)
            if cuda:
                source = pinned(source)  # pinned in the prefetch thread
            # one process: a stop also ends a blocked data wait; across
            # processes every rank must reach the agreed step, so it does not
            local_stop = stop_requested if self.world_group is None else None
            with contextlib.closing(prefetch(source, stop=local_stop)) as host, \
                    contextlib.closing(device_prefetch(host, self.device)) as on_device:
                for batch in self._timed(on_device):
                    # the per-epoch cap before stepping: a resume from an
                    # epoch-boundary checkpoint must not train an extra step
                    if batch_idx >= self.steps_per_epoch:
                        break
                    if batch_idx == start_batch:
                        # an out-of-range id would index past the embedding
                        max_id = int(batch["texts"].max())
                        if max_id >= self.cfg.vocab_size:
                            raise ValueError(
                                f"token id {max_id} >= vocab_size {self.cfg.vocab_size}: "
                                "the data pipeline tokenizes with the full 49408-token CLIP "
                                "vocabulary; configure the model accordingly"
                            )
                    if self.verbose and first_caption_logged < epoch:
                        first_caption_logged = epoch
                        print(f"epoch {epoch}: first batch images {tuple(batch['images'].shape)}")
                    self.state, metrics = self.step_fn(self.state, batch)
                    batch_idx += 1
                    step += 1
                    steps_since_t0 += 1
                    pending.append((step, metrics))
                    if cuda:
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(self.device))
                        inflight.append(done)
                        if len(inflight) > tcfg.max_inflight_steps:
                            inflight.popleft().synchronize()
                    self._beat()  # after the throttle: a wedged device stops the beats
                    if self.profile_steps:
                        if step == self._trace_start_after and self._profiler is None:
                            self._start_profile()
                        elif self._profiler is not None and step == self._trace_start_after + self.profile_steps:
                            self._stop_profile()

                    if step % tcfg.checkpoint_every_steps == 0:
                        self._flush_metrics(pending)
                        pending = []
                        dt = time.monotonic() - t0
                        if steps_since_t0 and dt > 0:
                            # wall clock over the window, data waits included
                            ips = steps_since_t0 * tcfg.global_batch_size / dt
                            self.writer.add_scalar("Throughput (imgs/s)", ips, step)
                            if self.verbose:
                                print(f"step {step}: loss {float(metrics['loss']):.4f}  {ips:.0f} imgs/s")
                        if cuda:  # this process's allocator peak so far (no JAX counterpart)
                            self.writer.add_scalar("Peak memory (GB)",
                                                   torch.cuda.max_memory_allocated(self.device) / 1e9, step)
                        self.writer.flush()  # metrics.jsonl stays live mid-run
                        self.save(epoch, batch_idx)
                        t0 = time.monotonic()
                        steps_since_t0 = 0
                    if tcfg.crash_after_steps is not None and step - resume_step == tcfg.crash_after_steps:
                        # recovery drill: a hard crash after this process ran N steps
                        self.checkpointer.wait()
                        raise RuntimeError(
                            f"fault injection: crashing at step {step} after {tcfg.crash_after_steps} "
                            "steps this process (crash_after_steps)"
                        )
                    if tcfg.hang_after_steps is not None and step - resume_step == tcfg.hang_after_steps:
                        # stall drill: alive, no progress, no heartbeats, never exits
                        self.checkpointer.wait()
                        if self.verbose:
                            print(f"fault injection: hanging at step {step} (hang_after_steps)", flush=True)
                        while True:
                            time.sleep(3600)
                    # the stop check comes before validation, which can take
                    # longer than a preemption's grace window
                    if self._stop_agreed(stop_requested, step):
                        self._preemption_exit(pending, epoch, batch_idx, step)
                        return
                    if step % self.validate_every_steps == 0:
                        self.validate(step)
                        if self._saved_step == step:
                            # a resume starts after this step and never validates it again:
                            # write its rows now, or a crash before the next boundary loses them
                            self.writer.flush()
                        self._beat()  # a long validation pass is not a stall
            self._flush_metrics(pending)
            if local_stop is not None and stop_requested.is_set():
                # the data wait was interrupted: save mid-epoch rather than
                # start the next epoch's iterator
                self._preemption_exit([], epoch, batch_idx, step)
                return
            self.start_batch = 0
        # the final save, unless the cadence save holds this step already
        if self._saved_step != step:
            self.save(tcfg.epochs, 0)
        self.checkpointer.wait()
        self.export()
        self.writer.flush()

    def _flush_metrics(self, pending) -> None:
        """Fetch the buffered per-step metrics in one copy and write them;
        a non-finite loss raises first, before the caller's save, so the
        last good checkpoint survives."""
        if not pending:
            return
        names = list(pending[0][1])
        rows = torch.stack([torch.stack([m[n].detach().float().reshape(()) for n in names])
                            for _, m in pending]).cpu().tolist()
        values = [dict(zip(names, row)) for row in rows]
        if self.tcfg.abort_on_nonfinite_loss:
            for (s, _), m in zip(pending, values):
                if not math.isfinite(m["loss"]):
                    raise FloatingPointError(
                        f"non-finite loss {m['loss']} at step {s}; aborting before "
                        "this boundary's checkpoint so the last good one survives. "
                        "Resume from it with a lower lr / longer warmup "
                        "(set abort_on_nonfinite_loss=False to train through)."
                    )
        for (s, _), m in zip(pending, values):
            self.writer.add_scalar("Loss", m["loss"], s)
            self.writer.add_scalar("Learning rate", self._schedule(s - 1), s)
            self.writer.add_scalar("Gradient norm", m["grad_norm"], s)
            self.writer.add_scalar("Logit scale", m["logit_scale"], s)
            if "logit_bias" in m:
                self.writer.add_scalar("Logit bias", m["logit_bias"], s)

    def save(self, epoch: int, batch_idx: int) -> None:
        """The lead writes the checkpoint (every rank its shards, when the
        state is split); every rank then waits at a barrier, so none reads a
        half-written step."""
        t0 = time.perf_counter()
        self.checkpointer.save(self.state, epoch=epoch, step=batch_idx)
        if self.world_group is not None:
            barrier(self.world_group)
        self._saved_step = self.state.step
        self.timings["save_s"].append(time.perf_counter() - t0)
        self.timings["save_bytes"].append(self.checkpointer.last_save_bytes)

    def export(self, path: Optional[str] = None) -> str:
        """Write the inference export (``api.save_pretrained``: config.json
        and the reference-keyed ``model.pt``) to ``path``, by default
        ``{run_dir}/export``; returns the path. Checkpoints hold the
        optimiser state too and are not what serving loads. With
        ``tcfg.freeze_serving`` the export also gets the frozen serving
        programs (``aot.freeze_programs``), which ``aot.load_servable``
        feeds the exported weights. A split state is gathered by every
        rank first; the lead then records the programs of a whole model
        built from the export's weights."""
        path = path or os.path.join(self.run_dir, "export")
        t0 = time.perf_counter()
        params = self._host_params() if self.is_lead or self.sharded else None
        if self.is_lead:  # the replicas are alike: one writes, the others wait
            save_pretrained(params, self.cfg, path)
            if self.tcfg.freeze_serving:
                from clip_mixer_tpu_torch.aot import freeze_programs

                model = self.state.model
                if self.sharded:
                    model = CLIP(self.cfg, device=self.device)
                    model.load_state_dict(params)
                freeze_programs(model, path)
        if self.world_group is not None:
            barrier(self.world_group)
        self.timings["export_s"] = time.perf_counter() - t0
        return path

    def _host_params(self) -> dict:
        """The evaluation weights on the host: the EMA when
        ``tcfg.ema_decay`` is set (validation and the export see the
        average; the raw parameters train on), else the live ones. A split
        state is gathered whole (a collective: every rank calls this)."""
        model, ema = self.state.model, self.state.opt_state.ema
        use_ema = self.tcfg.ema_decay and ema is not None
        if self.sharded:
            sd = gather_full(model)
            if use_ema:
                sd.update(gather_full(model, ema))
        else:
            sd = dict(model.state_dict())
            if use_ema:
                sd.update(ema)
        return {k: v.detach().cpu() for k, v in sd.items()}

    def validate(self, step: int) -> None:
        """Run every validator on the host weights, on the lead (the other
        ranks wait at a barrier); each pass's seconds go to
        ``timings["validate_s"]`` as ``(step, validator, s)``."""
        if not self.validators:
            return
        params = self._host_params() if self.is_lead or self.sharded else None
        if self.is_lead:
            for v in self.validators:
                t0 = time.perf_counter()
                v.validate(step, verbose=self.verbose, params=params)
                s = time.perf_counter() - t0
                self.timings["validate_s"].append((step, type(v).__name__, s))
                if self.verbose:
                    print(f"validate step {step}: {type(v).__name__} {s:.3f} s", flush=True)
        if self.world_group is not None:
            barrier(self.world_group)
