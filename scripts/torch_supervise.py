"""Elastic-recovery supervisor of the port: keep a ``train_cli`` run alive across crashes.

    python scripts/torch_supervise.py [--max-restarts 3] [--backoff 5] -- \\
        --preset mixer-b32 --data '/data/shards/*.tar' --run-name run1

Everything after ``--`` is a ``python -m clip_mixer_tpu_torch.train_cli``
command line; the supervisor starts it, in this directory, and starts it
again after a transient failure (a host OOM kill, a lost peer, a data fault:
any non-zero exit). The trainer's own checkpoints resume it bit for bit, so
a restart costs at most ``--checkpoint-every`` steps.

The restart budget is progress-aware (``clip_mixer_tpu_torch.launch.
supervise``): ``--max-restarts`` bounds the consecutive restarts without a
new checkpoint. Two exits are never restarted: the non-finite-loss abort
(``launch.EXIT_NONFINITE``) and a SIGTERM / SIGINT to the supervisor
(forwarded to the child, so its preemption save runs).

Across hosts, run one supervisor per host around that host's processes; when
a rank dies, its peers fail at the process group's timeout and every
supervisor restarts its own.

Drill it on the CPU without waiting for a failure:

    python scripts/torch_supervise.py -- --preset mixer-debug --synthetic \\
        --device cpu --global-batch-size 8 --steps-per-epoch 8 --epochs 1 \\
        --checkpoint-every 2 --crash-after-steps 5 --no-validators
"""

import argparse
import os
import sys
from pathlib import Path

REPO = str(Path(__file__).resolve().parents[1])
sys.path.insert(0, REPO)

from clip_mixer_tpu_torch.launch import MODULE, supervise  # noqa: E402


def derive_flag_value(train_args, flag, default):
    """The value ``flag`` takes in a train_cli command line, as argparse
    reads it ('--flag VALUE' and '--flag=VALUE', the last one winning); None
    for a flag without its value (the caller exits: a wrong guess would
    watch the wrong checkpoints and heartbeats)."""
    value = default
    for i, a in enumerate(train_args):
        if a == flag:
            if i + 1 >= len(train_args):
                return None
            value = train_args[i + 1]
        elif a.startswith(flag + "="):
            value = a.split("=", 1)[1]
    return value


def derive_run_name(train_args):
    return derive_flag_value(train_args, "--run-name", "run")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--" in argv:
        split = argv.index("--")
        sup_args, train_args = argv[:split], argv[split + 1:]
    else:
        sup_args, train_args = argv, []

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--max-restarts", type=int, default=3,
                   help="consecutive restarts allowed WITHOUT checkpoint progress")
    p.add_argument("--backoff", type=float, default=5.0, help="base restart delay, doubled per no-progress failure")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint dir watched for progress (default: outputs/<--run-name>/checkpoints)")
    p.add_argument("--stall-timeout", type=float, default=None, metavar="SEC",
                   help="kill + restart the child when the trainer's per-step heartbeat goes stale this long "
                        "(set it above start-up: restore, the kernels' build, the first steps, and above a "
                        "validation pass). Default off; 0 or negative also disables.")
    p.add_argument("--stall-grace", type=float, default=30.0, metavar="SEC",
                   help="seconds between the stall SIGTERM and the SIGKILL")
    p.add_argument("--max-child-rss-gb", type=float, default=None, metavar="GB",
                   help="RSS hygiene restart: past this resident-set budget of the child's process tree, "
                        "SIGTERM it (its preemption checkpoint runs) and start it again, even on exit 0. "
                        "0 or negative disables.")
    p.add_argument("--rss-grace", type=float, default=600.0, metavar="SEC",
                   help="seconds the hygiene SIGTERM waits before SIGKILL: a whole preemption save")
    p.add_argument("--heartbeat", default=None,
                   help="heartbeat file the stall watch reads (default: outputs/<run>/heartbeat-<--process-id>, "
                        "or the glob outputs/<run>/heartbeat-* without --process-id (torchrun's ranks): the "
                        "newest mtime wins)")
    args = p.parse_args(sup_args)
    if not train_args:
        p.error("pass the train_cli arguments after '--'")

    run_name = derive_run_name(train_args)
    if run_name is None:
        p.error("--run-name in the train args is missing its value")
    ckpt_dir = args.ckpt_dir or str(Path("outputs") / run_name / "checkpoints")

    kwargs = {}
    if args.stall_timeout is not None and args.stall_timeout > 0:
        heartbeat = args.heartbeat
        if heartbeat is None:
            if any(a == "--process-id" or a.startswith("--process-id=") for a in train_args):
                process_id = derive_flag_value(train_args, "--process-id", "0")
                if process_id is None:
                    p.error("--process-id in the train args is missing its value")
                heartbeat = str(Path("outputs") / run_name / f"heartbeat-{process_id}")
            else:
                heartbeat = str(Path("outputs") / run_name / "heartbeat-*")
        if "://" in heartbeat:
            p.error("--stall-timeout needs a LOCAL run dir (the heartbeat's mtime is read off the local disk)")
        kwargs = dict(stall_timeout=args.stall_timeout, heartbeat_path=heartbeat, stall_grace=args.stall_grace)
    if args.max_child_rss_gb is not None and args.max_child_rss_gb > 0:
        kwargs.update(max_child_rss_gb=args.max_child_rss_gb, rss_grace=args.rss_grace)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(x for x in (REPO, env.get("PYTHONPATH")) if x)
    cmd = [sys.executable, "-m", MODULE, *train_args]
    return supervise(cmd, ckpt_dir, max_restarts=args.max_restarts, backoff=args.backoff, env=env, **kwargs)


if __name__ == "__main__":
    sys.exit(main())
