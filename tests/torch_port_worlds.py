"""Spawned worlds of the port's ranks for the CPU tests, over gloo.

``run_world(task, n, tmp_path, payload)`` starts ``n`` processes of this
file, each of which joins a process group through the port's
``parallel/dist.py`` (a ``file://`` rendezvous under ``tmp_path``, so
parallel test workers never race for a port), runs ``TASKS[task](rank,
n, payload)`` and writes its result back. The ranks import torch and the
port only, never JAX. The world runs under a deadline: a rank that fails
or hangs fails the test with every rank's output.
"""

from __future__ import annotations

import hashlib
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = str(Path(__file__).resolve().parents[1])
DEADLINE_S = 240.0
GLOO_TIMEOUT_S = 60.0


def run_world(task: str, n: int, tmp_path, payload=None, timeout: float = DEADLINE_S):
    """Every rank's result, in rank order."""
    d = Path(tmp_path) / f"world_{task}_{n}_{time.monotonic_ns()}"
    d.mkdir(parents=True)
    torch.save(payload, d / "in.pt")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, task, str(r), str(n), str(d)], cwd=str(d), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    failed = None
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline:
            failed = f"world {task!r} of {n} passed its {timeout:.0f} s deadline"
            break
        if any(p.poll() not in (None, 0) for p in procs):
            time.sleep(2.0)  # let the others print their side before they go
            failed = f"a rank of world {task!r} of {n} failed"
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
    logs = [p.communicate()[0] for p in procs]
    if failed or any(p.returncode for p in procs):
        report = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{log[-6000:]}"
                           for r, (p, log) in enumerate(zip(procs, logs)))
        raise AssertionError(f"{failed or 'a rank failed'}\n{report}")
    return [torch.load(d / f"out{r}.pt", weights_only=False) for r in range(n)]


def state_hash(tensors) -> str:
    """A digest of a state dict's bytes, in key order."""
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _group():
    import torch.distributed as dist

    return dist.group.WORLD


# ---- tasks: each (rank, n, payload) -> a picklable result ---------------------------------------------


def _losses(rank, n, p):
    """Every cross-device loss on this rank's rows of global features: the
    per-rank loss and the gradients of the local features and the scalars."""
    from clip_mixer_tpu_torch.ops import losses

    group = _group()
    b = p["img"].shape[0] // n
    rows = slice(rank * b, (rank + 1) * b)
    out = {}

    def run(name, fn, with_bias=False):
        img = torch.tensor(p["img"][rows], requires_grad=True)
        txt = torch.tensor(p["txt"][rows], requires_grad=True)
        scale = torch.tensor(p["scale"], requires_grad=True)
        bias = torch.tensor(p["bias"], requires_grad=True)
        loss = fn(img, txt, scale, bias)
        loss.backward()
        out[name] = {"loss": loss.item(), "img": img.grad.numpy(), "txt": txt.grad.numpy(),
                     "scale": scale.grad.item(), "bias": bias.grad.item() if with_bias else None}

    for gtg in (False, True):
        for chunk in (None, p["chunk"]):
            run(f"info_nce_gtg{int(gtg)}_chunk{chunk}",
                lambda i, t, s, _b, gtg=gtg, chunk=chunk: losses.info_nce(
                    i, t, s, group=group, grad_through_gather=gtg, chunk_size=chunk))
    run("siglip", lambda i, t, s, bb: losses.siglip_loss(i, t, s, bb, group=group), with_bias=True)
    # the planted fault: the ring's backward sends each cotangent on, not back
    losses._RingPass.backward = staticmethod(lambda ctx, g: (losses._pass_to(g, ctx.group, 1), None))
    run("siglip_fault_backward_forward", lambda i, t, s, bb: losses.siglip_loss(i, t, s, bb, group=group),
        with_bias=True)
    return out


def _moments(rank, n, p):
    """SyncBN's batch_moments on this rank's rows: the moments and the
    gradient of this rank's rows normalised by them and weighted by its
    rows of ``c``, right and with the planted fault (the all-reduce outside
    the graph)."""
    from clip_mixer_tpu_torch.models import resnet

    group = _group()
    b = p["x"].shape[0] // n
    rows = slice(rank * b, (rank + 1) * b)
    out = {}
    for name in ("right", "fault_detached"):
        if name == "fault_detached":
            resnet._MeanAcross.backward = staticmethod(lambda ctx, g: (g, None))
        x = torch.tensor(p["x"][rows], requires_grad=True)
        mean, var = resnet.batch_moments(x, group)
        ((x - mean) * torch.rsqrt(var + 1e-5) * torch.tensor(p["c"][rows])).sum().backward()
        out[name] = {"mean": mean.detach().numpy(), "var": var.detach().numpy(), "grad": x.grad.numpy()}
    return out


def _dp_run(rank, n, case, group):
    """One case of the data-parallel step: three steps from the payload's
    weights on this rank's rows of the three global batches."""
    from clip_mixer_tpu_torch import config as tcfg
    from clip_mixer_tpu_torch.models import resnet
    from clip_mixer_tpu_torch.models.clip import CLIP
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
    from clip_mixer_tpu_torch.parallel import train_step as tstep
    from clip_mixer_tpu_torch.parallel.mesh import replicate, shard_batch
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    cfg = tcfg.CLIPConfig(**case["model"])
    if case.get("siglip"):
        cfg = cfg.for_siglip()
    tc = tcfg.TrainConfig(**case["train"])
    model = CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(100 + rank))  # differs by rank
    if rank == 0:
        model.load_state_dict(case["init"])
    replicate(group, model)  # every rank starts from rank 0's weights
    if case.get("fused_block"):
        route_towers(model, True)
    saved = {}
    if case.get("fault") == "sum":
        saved["avg"] = tstep.average_gradients

        def summed(params, loss, g):
            import torch.distributed as dist

            grads = [q.grad for q in params.values() if q.grad is not None]
            for t in grads + [loss]:
                dist.all_reduce(t, group=g)
            return loss

        tstep.average_gradients = summed
    if case.get("fault") == "bn_detached":
        saved["bn"] = resnet._grad_moments_across
        resnet._grad_moments_across = lambda t, g: t
    try:
        opt = make_optimizer(tc, total_steps=case["total_steps"])
        state = tstep.init_train_state(model, opt)
        step = tstep.make_train_step(cfg, tc, opt, group=group if case.get("group", True) else None,
                                     **case.get("step", {}))
        metrics = []
        for batch in case["batches"]:
            state, m = step(state, shard_batch(group if case.get("group", True) else None, batch))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        if "avg" in saved:
            tstep.average_gradients = saved["avg"]
        if "bn" in saved:
            resnet._grad_moments_across = saved["bn"]
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    ema = state.opt_state.ema
    out = {"metrics": metrics, "hash": state_hash(sd), "ema_hash": None if ema is None else state_hash(ema)}
    if rank == 0:
        out["state"] = sd
        out["ema"] = None if ema is None else {k: v.clone() for k, v in ema.items()}
    return out


def _dp_steps(rank, n, p):
    group = _group()
    return {name: _dp_run(rank, n, case, group) for name, case in p.items()}


def _trainer_resume(rank, n, p):
    """A Trainer across the ranks: run A straight through; run B crashed by
    the drill after 2 steps and resumed by a new Trainer. Returns the
    hashes of A's and B's final states, the files each rank saw."""
    from clip_mixer_tpu_torch import config as tcfg
    from clip_mixer_tpu_torch.data.pipeline import RankRowsSource, SyntheticSource
    from clip_mixer_tpu_torch.train.trainer import Trainer

    cfg = tcfg.CLIPConfig(**p["model"])
    out = {}
    for run, crash in (("a", None), ("b", p["crash"])):
        tc = tcfg.TrainConfig(**p["train"], crash_after_steps=crash)

        def source():
            return RankRowsSource(SyntheticSource(batch_size=tc.global_batch_size, image_size=cfg.image_resolution,
                                                  n_batches=p["batches"], context_length=cfg.context_length), n, rank)

        run_dir = os.path.join(p["root"], run)
        tr = Trainer(cfg, tc, source(), run_dir, device="cpu")
        if crash is None:
            tr.train()
        else:
            try:
                tr.train()
            except RuntimeError as e:
                assert "fault injection" in str(e), e
            else:
                raise AssertionError("the crash drill did not raise")
            out["b_crashed_at"] = tr.global_step
            out["b_checkpoints_after_crash"] = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
            tr = Trainer(cfg, tcfg.TrainConfig(**p["train"]), source(), run_dir, device="cpu")
            out["b_resumed_from"] = tr.global_step
            tr.train()
        sd = {k: v.detach().clone() for k, v in tr.state.model.state_dict().items()}
        out[run] = {"hash": state_hash(sd), "step": tr.global_step,
                    "moments_hash": state_hash({**tr.state.opt_state.mu, **{f"nu.{k}": v for k, v in
                                                                           tr.state.opt_state.nu.items()}})}
    return out


def _trainer_sigterm(rank, n, p):
    """A Trainer across the ranks in which rank 1 alone gets a SIGTERM after
    its 3rd step; returns the step each rank stopped and saved at."""
    from clip_mixer_tpu_torch import config as tcfg
    from clip_mixer_tpu_torch.data.pipeline import RankRowsSource, SyntheticSource
    from clip_mixer_tpu_torch.train.trainer import Trainer

    cfg = tcfg.CLIPConfig(**p["model"])
    tc = tcfg.TrainConfig(**p["train"])
    src = RankRowsSource(SyntheticSource(batch_size=tc.global_batch_size, image_size=cfg.image_resolution,
                                         n_batches=p["batches"], context_length=cfg.context_length), n, rank)
    tr = Trainer(cfg, tc, src, p["root"], device="cpu")
    real = tr.step_fn

    def step(state, batch):
        state, m = real(state, batch)
        if rank == 1 and state.step == p["signal_after"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return state, m

    tr.step_fn = step
    tr.train()
    return {"step": tr.global_step, "checkpoints": sorted(os.listdir(os.path.join(p["root"], "checkpoints")))}


def _tar_step(rank, n, p):
    """One data-parallel step on this rank's own TarShardSource shards."""
    from clip_mixer_tpu_torch import config as tcfg
    from clip_mixer_tpu_torch.data.pipeline import TarShardSource
    from clip_mixer_tpu_torch.models.clip import CLIP
    from clip_mixer_tpu_torch.parallel import train_step as tstep
    from clip_mixer_tpu_torch.parallel.mesh import replicate, shard_batch
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    group = _group()
    cfg = tcfg.CLIPConfig(**p["model"])
    tc = tcfg.TrainConfig(**p["train"])
    src = TarShardSource(p["shards"], batch_size=p["local_b"], image_size=cfg.image_resolution,
                         context_length=cfg.context_length, n_hosts=n, host_index=rank, drop_last=True,
                         shuffle_buffer=0)
    batch = shard_batch(group, dict(next(src.iter_batches(epoch=0))), process_local=True)
    model = CLIP(cfg, device="cpu")
    if rank == 0:
        model.load_state_dict(p["init"])
    replicate(group, model)
    opt = make_optimizer(tc, total_steps=10)
    state = tstep.init_train_state(model, opt)
    _, m = tstep.make_train_step(cfg, tc, opt, group=group)(state, batch)
    return {"shards": list(src.shards), "batch": {k: np.asarray(v) for k, v in batch.items()},
            "loss": float(m["loss"])}


def _sharded_run(rank, n, case):
    """One case of the sharded steps (tensor parallelism over a model
    dimension of ``case["n_model"]``, FSDP when ``case["fsdp"]``): three
    steps from the payload's weights on this rank's data row of the global
    batches. Returns the metrics, the gathered whole state and EMA (rank 0),
    their hash, each parameter's local shape and FSDP placement, and (with
    ``grads``) this rank's local gradients after the last step."""
    from clip_mixer_tpu_torch import config as tcfg
    from clip_mixer_tpu_torch.models.clip import CLIP
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
    from clip_mixer_tpu_torch.parallel import fsdp as tfsdp
    from clip_mixer_tpu_torch.parallel import tp as ttp
    from clip_mixer_tpu_torch.parallel import train_step as tstep
    from clip_mixer_tpu_torch.parallel.mesh import data_group, make_mesh, model_group, replicate, shard_batch
    from clip_mixer_tpu_torch.train.optimizer import local, make_optimizer

    cfg = tcfg.CLIPConfig(**case["model"])
    if case.get("siglip"):
        cfg = cfg.for_siglip()
    tc = tcfg.TrainConfig(**case["train"])
    n_model = case.get("n_model", 1)
    mesh = make_mesh(n_data=n // n_model, n_model=n_model, device="cpu")
    model = CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(100 + rank))  # differs by rank
    if rank == 0:
        model.load_state_dict(case["init"])
    replicate(_group(), model)
    if case.get("fused_block"):
        route_towers(model, True)
    if n_model > 1:
        ttp.shard_model_tp(model, model_group(mesh))
    if case.get("fsdp"):
        tfsdp.apply_fsdp(model, mesh)
    saved = {}
    if case.get("fault") == "f_psum_no_allreduce":
        saved["f"] = ttp._FPsum.backward
        ttp._FPsum.backward = staticmethod(lambda ctx, g: (g, None))
    if case.get("fault") == "logit_scale_unreduced":
        saved["avg"] = tstep.average_gradients
        tstep.average_gradients = lambda params, loss, g: saved["avg"](
            {k: v for k, v in params.items() if k != "logit_scale"}, loss, g)
    try:
        opt = make_optimizer(tc, total_steps=case["total_steps"])
        state = tstep.init_train_state(model, opt)
        if case.get("fsdp"):
            step = tfsdp.make_fsdp_train_step(cfg, tc, opt, mesh, **case.get("step", {}))
        else:
            step = tstep.make_train_step(cfg, tc, opt, group=data_group(mesh), **case.get("step", {}))
        metrics = []
        for batch in case["batches"]:
            state, m = step(state, shard_batch(data_group(mesh), batch))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        if "f" in saved:
            ttp._FPsum.backward = saved["f"]
        if "avg" in saved:
            tstep.average_gradients = saved["avg"]
    whole = {k: v.clone() for k, v in tfsdp.gather_full(model).items()}
    ema = state.opt_state.ema
    ema = None if ema is None else {k: v.clone() for k, v in tfsdp.gather_full(model, ema).items()}
    params = dict(model.named_parameters())
    out = {"metrics": metrics, "hash": state_hash(whole), "ema_hash": None if ema is None else state_hash(ema),
           "shapes": {k: tuple(local(p).shape) for k, p in params.items()},
           "fsdp_dims": {k: p.placements[0].dim for k, p in params.items() if hasattr(p, "placements")},
           "moment_shapes": {k: tuple(v.shape) for k, v in state.opt_state.mu.items()}}
    if case.get("grads"):
        out["grads"] = {k: local(p.grad).clone() for k, p in params.items() if p.grad is not None}
        out["grad_kinds"] = {k: type(p.grad).__name__ for k, p in params.items() if p.grad is not None}
    if rank == 0:
        out["state"], out["ema"] = whole, ema
    return out


def _sharded_steps(rank, n, p):
    return {name: _sharded_run(rank, n, case) for name, case in p.items()}


def _sharded_trainer(rank, n, p):
    """``train_cli`` in each rank (the process group is up already) with
    ``p["flags"]``: run "straight" through, run "resumed" crashed by the
    drill after a save and resumed; both runs' last checkpoint shard of this
    rank and the export compared bit for bit. Then a restore of the
    straight run's checkpoint in another layout (``p["other_flags"]``)."""
    from clip_mixer_tpu_torch import train_cli

    base = p["argv"] + p["flags"]
    out = {}
    train_cli.main(base + ["--run-name", "straight"])
    try:
        train_cli.main(base + ["--run-name", "resumed", "--crash-after-steps", str(p["crash"])])
    except RuntimeError as e:
        assert "fault injection" in str(e), e
    else:
        raise AssertionError("the crash drill did not raise")
    out["after_crash"] = sorted(os.listdir(os.path.join("outputs", "resumed", "checkpoints")))
    train_cli.main(base + ["--run-name", "resumed"])
    runs = {r: os.path.join("outputs", r) for r in ("straight", "resumed")}
    out["checkpoints"] = {r: sorted(os.listdir(os.path.join(d, "checkpoints"))) for r, d in runs.items()}
    last = out["checkpoints"]["straight"][-1]
    out["files"] = sorted(os.listdir(os.path.join(runs["straight"], "checkpoints", last)))
    shard = [torch.load(os.path.join(d, "checkpoints", last, f"shard-{rank}.pt"), weights_only=True)
             for d in runs.values()]
    flat = [{**{f"model.{k}": v for k, v in s["model"].items()},
             **{f"{w}.{k}": v for w in ("mu", "nu") for k, v in s["opt_state"][w].items()}} for s in shard]
    out["shard_hashes"] = [state_hash(f) for f in flat]
    out["shard_steps"] = [s["step"] for s in shard]
    exports = [torch.load(os.path.join(d, "export", "model.pt"), weights_only=True) for d in runs.values()]
    out["export_hashes"] = [state_hash(e) for e in exports]
    out["export_shapes"] = {k: tuple(v.shape) for k, v in exports[0].items()}
    try:
        train_cli.main(p["argv"] + p["other_flags"] + ["--run-name", "straight", "--epochs", "2"])
    except ValueError as e:
        out["refusal"] = str(e)
    train_cli.main(p["argv"] + p["other_flags"] + ["--run-name", "other"])  # that layout, straight through
    other = os.path.join("outputs", "other")
    out["other_files"] = sorted(os.listdir(os.path.join(other, "checkpoints", last)))
    out["other_export_shapes"] = {k: tuple(v.shape) for k, v in torch.load(
        os.path.join(other, "export", "model.pt"), weights_only=True).items()}
    return out


TASKS = {"losses": _losses, "moments": _moments, "dp_steps": _dp_steps, "trainer_resume": _trainer_resume,
         "trainer_sigterm": _trainer_sigterm, "tar_step": _tar_step, "sharded_steps": _sharded_steps,
         "sharded_trainer": _sharded_trainer}


def _main(argv):
    task, rank, n, d = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    sys.path.insert(0, REPO)
    sys.modules["torch.utils.tensorboard"] = None  # its import pulls in TensorFlow: seconds a rank
    torch.set_num_threads(1)
    import torch.distributed as dist

    from clip_mixer_tpu_torch.parallel.dist import maybe_initialize_distributed

    assert maybe_initialize_distributed("cpu", coordinator=f"file://{d / 'store'}", num_processes=n,
                                        process_id=rank, timeout_s=GLOO_TIMEOUT_S)
    try:
        out = TASKS[task](rank, n, torch.load(d / "in.pt", weights_only=False))
        torch.save(out, d / f"out{rank}.pt.tmp")
        os.replace(d / f"out{rank}.pt.tmp", d / f"out{rank}.pt")
        assert "jax" not in sys.modules, "a rank imported jax"
        dist.barrier()  # no rank leaves while another is still talking to it
    finally:
        dist.destroy_process_group()
    # a rank that got here succeeded; leave without the interpreter's
    # teardown, where a gloo thread left joinable has aborted a loaded host
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    _main(sys.argv[1:])
