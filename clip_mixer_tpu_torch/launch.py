"""Cluster launch and supervision: presets, ``torchrun`` commands, a local rehearsal, the supervisor.

Counterpart of ``clip_mixer_tpu/launch.py`` (which renders ``gcloud``
commands for TPU slices) for hosts of 8 H100 cards, the reference's 8 cards
a host: every host runs one ``torchrun`` that starts a process per card, and
the processes meet at the first host's rendezvous
(``parallel/dist.py`` reads ``torchrun``'s environment). It imports only the
standard library, so the supervisor never waits on a wedged card or
collective.

* :data:`PRESETS` and :func:`render_commands`: the upload and run lines of
  a preset's run over named hosts (``ssh`` + ``torchrun -m
  clip_mixer_tpu_torch.train_cli``), quoted for both shells.
* :func:`rehearse_local`: the run line's module and arguments as N local
  CPU processes over gloo, every pipe drained at once.
* :func:`supervise`: elastic recovery around a ``train_cli`` command line,
  with a progress-aware restart budget, the non-finite abort
  (:data:`EXIT_NONFINITE`) never restarted, stop signals forwarded and not
  restarted, a stall watchdog on the trainer's ``heartbeat-{rank}`` files
  and an RSS hygiene restart.

    python -m clip_mixer_tpu_torch.launch --preset mixer-b32-host8 --hosts gpu-a
    python -m clip_mixer_tpu_torch.launch --rehearse 2
"""

from __future__ import annotations

import dataclasses
import shlex
from typing import Dict, Optional, Sequence

MODULE = "clip_mixer_tpu_torch.train_cli"


@dataclasses.dataclass
class LaunchPreset:
    name: str
    nodes: int  # hosts
    train_args: str  # train_cli's arguments
    gpus_per_node: int = 8
    workdir: str = "clip-mixer-tpu"  # the checkout on every host, under its home directory


# The JAX package's three runs (the mixer and transformer twins at the
# reference's global batch of 32768, and a synthetic smoke run) on hosts of
# 8 cards; the smoke run takes half a host, as JAX's takes a v5litepod-4.
PRESETS: Dict[str, LaunchPreset] = {
    "mixer-b32-host8": LaunchPreset(
        name="clip-mixer-b32",
        nodes=1,
        train_args="--preset mixer-b32 --global-batch-size 32768 --epochs 32 --run-name mixer_b32",
    ),
    "transformer-b32-host8": LaunchPreset(
        name="clip-transformer-b32",
        nodes=1,
        train_args="--preset transformer-b32 --global-batch-size 32768 --epochs 32 --run-name transformer_b32",
    ),
    "mixer-b32-smoke": LaunchPreset(
        name="clip-mixer-smoke",
        nodes=1,
        gpus_per_node=4,
        train_args="--preset mixer-b32 --synthetic --steps-per-epoch 20 --epochs 1 --run-name smoke",
    ),
}


def render_commands(preset: LaunchPreset, hosts: Sequence[str], data_glob: Optional[str] = None,
                    port: int = 29500) -> str:
    """The command sequence of ``preset`` on ``hosts`` (one per node, the
    first holding the rendezvous): upload this checkout to every host, then
    start every host's ``torchrun``. ``data_glob`` is quoted for the remote
    shell, and the whole remote command once more for the local one (a
    nested quote inside an already quoted string would cancel the outer
    quotes and let the host's shell expand the glob)."""
    if len(hosts) != preset.nodes:
        raise ValueError(f"preset {preset.name} runs on {preset.nodes} host(s), got {len(hosts)}: {list(hosts)}")
    train_args = preset.train_args
    if data_glob:
        train_args += f" --data {shlex.quote(data_glob)}"
    lines = [f"rsync -a --exclude outputs --exclude build ./ {shlex.quote(h + ':' + preset.workdir + '/')}"
             for h in hosts]
    for rank, host in enumerate(hosts):
        remote = (f"cd {shlex.quote(preset.workdir)} && torchrun --nnodes {preset.nodes} "
                  f"--nproc-per-node {preset.gpus_per_node} --node-rank {rank} --master-addr {shlex.quote(hosts[0])} "
                  f"--master-port {port} -m {MODULE} {train_args}")
        lines.append(f"ssh {shlex.quote(host)} {shlex.quote(remote)}")
    return "\n".join(lines)


def rehearse_local(
    n_processes: int = 2,
    train_args: str = (
        "--preset mixer-debug --synthetic --global-batch-size 8 "
        "--steps-per-epoch 2 --epochs 1 --checkpoint-every 2 "
        "--no-validators --run-name rehearsal"
    ),
    cwd: Optional[str] = None,
    timeout: float = 600.0,
) -> list:
    """A multi-host launch rehearsed on this host: the run line's module
    and arguments as ``n_processes`` local CPU processes over gloo, told
    their rendezvous by ``--coordinator`` / ``--num-processes`` /
    ``--process-id`` in place of ``torchrun``'s environment. It exercises
    the CLI, the rendezvous, each process's rows of the data, the step's
    collectives and the checkpoint with no card. Returns every process's
    output; raises on a non-zero exit or the timeout (killing them all)."""
    import os
    import socket
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo, env.get("PYTHONPATH")) if p)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)  # the explicit rendezvous, not a launcher's
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", MODULE, *shlex.split(train_args), "--device", "cpu",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n_processes), "--process-id", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=cwd, text=True,
        )
        for i in range(n_processes)
    ]
    # Drain every process's pipe at once: reaping them one by one deadlocks
    # once a later process fills its pipe mid-collective (it blocks writing,
    # the first blocks in the collective). Kill them all on any failure.
    try:
        with ThreadPoolExecutor(n_processes) as ex:
            futures = [ex.submit(lambda p=p: p.communicate(timeout=timeout)) for p in procs]
            outs = [f.result()[0] for f in futures]
    except Exception:
        for p in procs:
            if p.poll() is None:
                p.kill()
        raise
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"rehearsal process rc={p.returncode}:\n{out[-3000:]}")
    return outs


# Exit code of train_cli's non-finite-loss abort (the trainer raises before
# the boundary's checkpoint). Never restarted: resume is bit for bit, so a
# restarted run recomputes the same non-finite loss.
EXIT_NONFINITE = 13


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    """The newest finished checkpoint id under ``ckpt_dir`` (a save is
    renamed from ``<id>.tmp`` to ``<id>`` when done), or None. A scan of the
    directory only, so the supervisor never touches a card; a remote
    (``scheme://``) directory reads as None, and supervision falls back to
    the plain restart budget."""
    import os

    try:
        entries = os.listdir(ckpt_dir)
    except OSError:
        return None
    steps = [int(e) for e in entries if e.isdigit() and os.path.isdir(os.path.join(ckpt_dir, e))]
    return max(steps) if steps else None


def _tree_rss_bytes(root_pid: int) -> int:
    """The RSS (bytes) of ``root_pid`` and every descendant, by one walk of
    ``/proc`` (the data loaders' threads and any worker processes count
    toward their trainer's). Vanished pids read as 0."""
    import os

    page = os.sysconf("SC_PAGESIZE")
    children: dict = {}
    rss: dict = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat", "rb") as f:
                stat = f.read().decode("ascii", "replace")
        except OSError:
            continue
        # the fields after the parenthesised comm (which may hold spaces)
        rest = stat.rsplit(")", 1)[-1].split()
        if len(rest) < 22:
            continue
        pid = int(entry)
        children.setdefault(int(rest[1]), []).append(pid)  # ppid -> pids
        rss[pid] = int(rest[21]) * page  # field 24: rss pages
    total = 0
    stack = [root_pid]
    seen = set()
    while stack:
        pid = stack.pop()
        if pid in seen:
            continue
        seen.add(pid)
        total += rss.get(pid, 0)
        stack.extend(children.get(pid, []))
    return total


def _kill_child(proc, grace, log):
    """SIGTERM (the trainer's preemption save runs), then after ``grace``
    seconds SIGKILL to the child's process group (or the child). Returns
    the exit code."""
    import os
    import signal as _signal
    import subprocess

    proc.terminate()
    try:
        return proc.wait(timeout=grace)
    except subprocess.TimeoutExpired:
        pass
    try:
        if os.getpgid(proc.pid) != os.getpgid(0):
            os.killpg(proc.pid, _signal.SIGKILL)
        else:
            proc.kill()
    except OSError:
        proc.kill()
    return proc.wait()


def _wait_watching_stall(proc, stall_timeout, heartbeat_path, grace, log, max_rss_bytes=None, rss_grace=600.0):
    """Wait for the child; kill it when its heartbeat is stale for
    ``stall_timeout`` seconds or its process tree's RSS passes
    ``max_rss_bytes``. Returns ``(rc, hygiene)``: ``hygiene`` means the RSS
    watch made the kill (the run is not done, even when the child exited 0
    from its preemption save).

    A stall is a live child that makes no progress (a collective whose peer
    is gone, a wedged card): a plain ``wait()`` never returns. The trainer
    touches ``heartbeat-{rank}`` every step, after its dispatch throttle,
    so a stale mtime is a stall. ``heartbeat_path`` may be a glob
    (``outputs/run/heartbeat-*``): the newest mtime of the matches counts,
    for a host whose ranks the supervisor cannot name. The clock never
    starts before the launch, so an old heartbeat of the previous run kills
    nothing at once. The kill is SIGTERM first (a stalled child can still
    write its preemption checkpoint), SIGKILL after ``grace``.

    RSS hygiene: a leak is not a crash, so a child over the budget gets a
    planned restart while it can still exit cleanly: SIGTERM, the
    preemption checkpoint (``rss_grace`` seconds), and a resume that loses
    nothing."""
    import glob as _glob
    import os
    import subprocess
    import time

    is_glob = heartbeat_path is not None and any(c in heartbeat_path for c in "*?[")
    launched = time.time()
    poll = max(0.1, min(5.0, (stall_timeout or 20.0) / 4))
    while True:
        try:
            return proc.wait(timeout=poll), False
        except subprocess.TimeoutExpired:
            pass
        if max_rss_bytes is not None:
            rss = _tree_rss_bytes(proc.pid)
            if rss > max_rss_bytes:
                log(f"supervise: child RSS {rss / 2**30:.1f}GiB over the {max_rss_bytes / 2**30:.1f}GiB hygiene "
                    "budget; SIGTERM for a graceful preemption checkpoint + restart")
                return _kill_child(proc, rss_grace, log), True
        if stall_timeout is None or heartbeat_path is None:
            continue
        paths = _glob.glob(heartbeat_path) if is_glob else [heartbeat_path]
        last = launched
        for hb in paths:
            try:
                last = max(last, os.path.getmtime(hb))
            except OSError:
                pass
        stale = time.time() - max(last, launched)
        if stale <= stall_timeout:
            continue
        log(f"supervise: no heartbeat for {stale:.0f}s (budget {stall_timeout:.0f}s, {heartbeat_path}); "
            "killing the stalled child")
        return _kill_child(proc, grace, log), False


def supervise(
    cmd: list,
    ckpt_dir: str,
    max_restarts: int = 3,
    backoff: float = 5.0,
    backoff_cap: float = 300.0,
    sleep=None,
    log=print,
    stall_timeout: Optional[float] = None,
    heartbeat_path: Optional[str] = None,
    stall_grace: float = 30.0,
    max_child_rss_gb: Optional[float] = None,
    rss_grace: float = 600.0,
    env: Optional[dict] = None,
    cwd: Optional[str] = None,
) -> int:
    """Run ``cmd`` (a ``train_cli`` command line) and restart it after
    transient failures; returns the final exit code.

    ``max_restarts`` bounds the consecutive restarts without progress: a
    launch that advances the newest checkpoint in ``ckpt_dir`` resets the
    count, so a run that keeps moving through crashes restarts for ever and
    a crash loop that cannot reach its next checkpoint spends the budget.

    * exit 0: done.
    * :data:`EXIT_NONFINITE`: deterministic; returned without a restart.
    * SIGTERM / SIGINT to the supervisor: forwarded to the child (its
      preemption save runs) and not restarted, at any moment (a signal
      between launches stops the loop before the next one). The child runs
      in its own session, so a terminal's Ctrl-C reaches it once, through
      the forward, not twice (a second SIGINT is the trainer's hard abort).
    * any other exit: a restart after ``backoff * 2^k`` seconds (at most
      ``backoff_cap``) while the budget holds.
    * a stall (``stall_timeout`` and ``heartbeat_path``): the child is
      killed and the exit goes to the same budget. Set ``stall_timeout``
      above the worst start-up (restore, the kernels' build, the first
      steps) and a validation pass.
    * RSS hygiene (``max_child_rss_gb``): a planned restart, taken even on
      exit 0 (a preempted child exits 0 after its save).

    Across hosts: one supervisor per host, each around its host's
    ``torchrun``; when a rank dies its peers' collectives fail at the
    process group's timeout, every supervisor restarts its host and the
    rendezvous forms again from the last checkpoint."""
    import signal
    import subprocess
    import threading

    if stall_timeout is not None and stall_timeout <= 0:
        stall_timeout = None  # 0 or negative switches the watch off
    failures_without_progress = 0
    attempt = 0
    stop_event = threading.Event()
    # "handoff": the handler has forwarded the signal to the current child,
    # so the loop's catch-up send stays quiet (a second delivery would be
    # the trainer's hard abort). Handlers run on the main thread between
    # the loop's bytecodes, so plain flags do.
    state = {"proc": None, "sig": None, "handoff": False}

    def _forward(signum, frame):
        state["sig"] = signum
        stop_event.set()  # wake a backoff wait at once
        p = state["proc"]
        if p is not None and p.poll() is None:
            state["handoff"] = True
            p.send_signal(signum)

    prev_handlers = {}
    installed = threading.current_thread() is threading.main_thread()
    if installed:
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _forward)
    if sleep is None:
        sleep = stop_event.wait  # returns early when _forward fires
    try:
        while True:
            if state["sig"] is not None:
                log("supervise: stop signal received between launches; not restarting")
                return 128 + int(state["sig"])
            start_step = latest_checkpoint_step(ckpt_dir)
            attempt += 1
            state["handoff"] = False
            # its own session only where this process forwards the signals
            proc = subprocess.Popen(cmd, start_new_session=installed, env=env, cwd=cwd)
            state["proc"] = proc
            if state["sig"] is not None and not state["handoff"] and proc.poll() is None:
                # a signal that came before the child was published
                proc.send_signal(state["sig"])
            max_rss_bytes = max_child_rss_gb * 2**30 if max_child_rss_gb else None
            if (stall_timeout is not None and heartbeat_path is not None) or max_rss_bytes is not None:
                rc, hygiene = _wait_watching_stall(proc, stall_timeout, heartbeat_path, stall_grace, log,
                                                   max_rss_bytes=max_rss_bytes, rss_grace=rss_grace)
            else:
                rc, hygiene = proc.wait(), False
            state["proc"] = None
            if rc == 0 and not hygiene:
                log(f"supervise: run complete after {attempt} launch(es)")
                return 0
            if state["sig"] is not None:
                log(f"supervise: stop signal received; not restarting (child rc={rc})")
                return rc
            if rc == EXIT_NONFINITE:
                log("supervise: non-finite-loss abort is deterministic; not restarting")
                return rc
            end_step = latest_checkpoint_step(ckpt_dir)
            progressed = end_step is not None and (start_step is None or end_step > start_step)
            if progressed:
                failures_without_progress = 0
            else:
                failures_without_progress += 1
            if failures_without_progress > max_restarts:
                log(f"supervise: {failures_without_progress} consecutive failures with no checkpoint progress "
                    f"(budget {max_restarts}); giving up with rc={rc}")
                # a hygiene-killed child exits 0 from its save: giving up must
                # not read as success (75 = EX_TEMPFAIL)
                return rc if rc != 0 else 75
            delay = min(backoff * 2 ** max(0, failures_without_progress - 1), backoff_cap)
            kind = "hygiene-restarting" if hygiene else "restarting"
            log(f"supervise: child rc={rc} (checkpoint {start_step}->{end_step}, progressed={progressed}); "
                f"{kind} in {delay:.0f}s [{failures_without_progress}/{max_restarts} budget used]")
            sleep(delay)
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", choices=sorted(PRESETS))
    p.add_argument("--hosts", nargs="+", default=None, help="the preset's hosts, the rendezvous first")
    p.add_argument("--port", type=int, default=29500, help="the rendezvous port on the first host")
    p.add_argument("--data", default=None)
    p.add_argument("--execute", action="store_true", help="run the commands instead of printing them")
    p.add_argument("--rehearse", type=int, default=None, metavar="N",
                   help="instead: rehearse an N-process launch on this host's CPU")
    args = p.parse_args(argv)
    if args.rehearse:
        outs = rehearse_local(args.rehearse)
        print(f"rehearsal ok: {args.rehearse} processes")
        print(outs[0][-500:])
        return
    if not (args.preset and args.hosts):
        p.error("--preset and --hosts are required (or use --rehearse N)")
    cmds = render_commands(PRESETS[args.preset], args.hosts, args.data, args.port)
    print(cmds)
    if args.execute:
        import subprocess

        lines = cmds.splitlines()
        uploads, runs = lines[:len(args.hosts)], lines[len(args.hosts):]
        for cmd in uploads:
            subprocess.run(cmd, shell=True, check=True)
        procs = [subprocess.Popen(cmd, shell=True) for cmd in runs]  # every host's torchrun at once
        raise SystemExit(max(p.wait() for p in procs))


if __name__ == "__main__":
    main()
