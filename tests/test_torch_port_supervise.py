"""The port's supervisor (``launch.supervise`` and ``scripts/torch_supervise.py``), after
``tests/test_supervise.py`` and ``tests/test_stall.py``.

The policy: a crash is restarted under a progress-aware budget, the
non-finite abort (exit 13) never, a stop signal is forwarded and not
restarted (during a child's run and between launches); a stalled child
(its heartbeat stale) is killed, a beating one is not, an old heartbeat of
a previous run kills nothing at once, and a glob of heartbeats counts the
newest; a child over its RSS budget gets a planned restart that is not read
as the run's end. The children are tiny ``python -c`` programs with
timeouts of about a second; one drill runs the real ``train_cli`` at
``mixer-debug`` under ``scripts/torch_supervise.py``.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from clip_mixer_tpu_torch.launch import EXIT_NONFINITE, _tree_rss_bytes, latest_checkpoint_step, supervise

REPO = Path(__file__).resolve().parents[1]


def _script():
    spec = importlib.util.spec_from_file_location("torch_supervise", REPO / "scripts" / "torch_supervise.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_latest_checkpoint_step(tmp_path):
    assert latest_checkpoint_step(tmp_path / "missing") is None
    ck = tmp_path / "checkpoints"
    ck.mkdir()
    assert latest_checkpoint_step(ck) is None
    (ck / "2").mkdir()
    (ck / "10").mkdir()
    (ck / "12.tmp").mkdir()  # a save in flight (train/checkpoint.py renames it when done)
    (ck / "99").write_text("a file, not a step dir")
    assert latest_checkpoint_step(ck) == 10


def _stub_cmd(tmp_path, body: str):
    """A child that appends a line to starts.txt per launch, then runs
    ``body`` (which decides its exit)."""
    script = tmp_path / "child.py"
    script.write_text(
        "import sys\nfrom pathlib import Path\n"
        f"starts = Path({str(tmp_path)!r}) / 'starts.txt'\n"
        "starts.open('a').write('x\\n')\n"
        "n_starts = len(starts.read_text().splitlines())\n" + body)
    return [sys.executable, "-S", str(script)]


def _n_starts(tmp_path):
    f = tmp_path / "starts.txt"
    return len(f.read_text().splitlines()) if f.exists() else 0


@pytest.mark.parametrize("case", ["success", "crash_loop", "nonfinite", "progress"])
def test_restart_policy(tmp_path, case):
    """Success first try; a crash loop spends its budget (the first launch
    and 2 restarts); exit 13 is never restarted; a run that reaches a new
    checkpoint every launch restarts past a budget of 1."""
    ck = tmp_path / "ck"
    if case == "success":
        assert supervise(_stub_cmd(tmp_path, "sys.exit(0)\n"), str(ck), max_restarts=3, backoff=0) == 0
        assert _n_starts(tmp_path) == 1
    elif case == "crash_loop":
        assert supervise(_stub_cmd(tmp_path, "sys.exit(7)\n"), str(ck), max_restarts=2, backoff=0) == 7
        assert _n_starts(tmp_path) == 3
    elif case == "nonfinite":
        rc = supervise(_stub_cmd(tmp_path, f"sys.exit({EXIT_NONFINITE})\n"), str(ck), max_restarts=5, backoff=0)
        assert rc == EXIT_NONFINITE == 13 and _n_starts(tmp_path) == 1
    else:
        ck.mkdir()
        cmd = _stub_cmd(tmp_path, f"Path({str(ck)!r}, str(n_starts)).mkdir()\nsys.exit(0 if n_starts >= 4 else 1)\n")
        assert supervise(cmd, str(ck), max_restarts=1, backoff=0) == 0
        assert _n_starts(tmp_path) == 4


_RUNNER = """
import sys
sys.path.insert(0, {repo!r})
from clip_mixer_tpu_torch.launch import supervise
rc = supervise([sys.executable, "-S", {child!r}], {ck!r}, max_restarts=5, backoff={backoff})
print("SUPERVISE_RC", rc, flush=True)
"""


@pytest.mark.parametrize("when", ["during_the_child", "between_launches"])
def test_stop_signal_is_forwarded_and_not_restarted(tmp_path, when):
    """SIGTERM to the supervisor while its child runs: forwarded (the child
    dies of it) and no relaunch; while it waits to relaunch a crashed child:
    the loop stops, 128 + SIGTERM."""
    child = tmp_path / "child.py"
    body = "import time\ntime.sleep(120)\n" if when == "during_the_child" else "import sys\nsys.exit(1)\n"
    child.write_text("from pathlib import Path\n"
                     f"Path({str(tmp_path)!r}, 'starts.txt').open('a').write('x\\n')\n" + body)
    runner = tmp_path / "runner.py"
    runner.write_text(_RUNNER.format(repo=str(REPO), child=str(child), ck=str(tmp_path / "ck"),
                                     backoff=0 if when == "during_the_child" else 30))
    proc = subprocess.Popen([sys.executable, str(runner)], stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while _n_starts(tmp_path) < 1:
            assert time.monotonic() < deadline, "the child never started"
            assert proc.poll() is None, "the runner died early"
            time.sleep(0.05)
        time.sleep(0.5)  # the child asleep, or the supervisor in its backoff
        os.kill(proc.pid, signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    want = -signal.SIGTERM if when == "during_the_child" else 128 + signal.SIGTERM
    assert f"SUPERVISE_RC {want}" in out, out
    assert _n_starts(tmp_path) == 1


_CHILD = r"""
import os, sys, time
hb, n, hang = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
for _ in range(n):
    open(hb, "a").close()
    os.utime(hb, None)
    time.sleep(0.1)
if hang:
    time.sleep(600)
"""
STALL_S = 1.5  # against beats 0.1 s apart


def _child_cmd(hb_path, beats, hang):
    return [sys.executable, "-S", "-c", _CHILD, str(hb_path), str(beats), str(int(hang))]


@pytest.mark.parametrize("case", ["stalled", "beating", "stale_old_heartbeat", "glob_beating", "glob_stalled",
                                  "zero_disables"])
def test_stall_watch(tmp_path, case):
    """A child that stops beating is killed and the no-progress budget
    gives up (two kills on a budget of one); a beating child passes; an old
    heartbeat left by a previous run starts no clock before the launch; a
    worker beating ``heartbeat-3`` under the ``heartbeat-*`` glob is alive,
    and the glob still sees a stall; a timeout of 0 switches the watch off."""
    hb = tmp_path / ("heartbeat-3" if case.startswith("glob") else "heartbeat-0")
    watched = str(tmp_path / "heartbeat-*") if case.startswith("glob") else str(hb)
    if case == "stale_old_heartbeat":
        hb.touch()
        old = time.time() - 3600
        os.utime(hb, (old, old))
    hang = case in ("stalled", "glob_stalled")
    logs = []
    rc = supervise(_child_cmd(hb, beats=2 if hang else 8, hang=hang), ckpt_dir=str(tmp_path / "ck"),
                   max_restarts=1 if case == "stalled" else 0, backoff=0.05, log=logs.append,
                   stall_timeout=0.0 if case == "zero_disables" else STALL_S, heartbeat_path=watched,
                   stall_grace=0.5)
    stalls = [m for m in logs if "killing the stalled child" in m]
    if hang:
        assert rc != 0 and len(stalls) == (2 if case == "stalled" else 1), logs
        assert any("giving up" in m for m in logs)
    else:
        assert rc == 0 and not stalls, logs


def test_rss_hygiene(tmp_path):
    """``_tree_rss_bytes`` counts this interpreter and reads a vanished pid
    as 0; a child over its RSS budget is SIGTERMed, its graceful save (exit
    0) is not the run's end: the relaunch, resumed from that save, is."""
    assert _tree_rss_bytes(os.getpid()) > 10 * 2**20
    assert _tree_rss_bytes(2**22 + 12345) == 0
    ck = tmp_path / "ck"
    ck.mkdir()
    cmd = _stub_cmd(tmp_path, (
        "import signal, time\n"
        "if n_starts > 1:\n    sys.exit(0)\n"
        "def _save(sig, frame):\n"
        f"    Path({str(ck)!r}, '7').mkdir(exist_ok=True)\n    sys.exit(0)\n"
        "signal.signal(signal.SIGTERM, _save)\n"
        "ballast = bytearray(300 * 2**20)\n"
        "time.sleep(120)\n"))
    assert supervise(cmd, str(ck), max_restarts=2, backoff=0, max_child_rss_gb=0.15, rss_grace=30.0) == 0
    assert _n_starts(tmp_path) == 2 and latest_checkpoint_step(ck) == 7


def test_script_derives_the_run_and_the_heartbeat(monkeypatch):
    """``--run-name`` in both spellings (the last wins; a dangling one is
    None); ``--process-id`` pins ``heartbeat-<id>``, its absence (torchrun's
    ranks) watches the ``heartbeat-*`` glob; a stall timeout of 0 watches
    nothing; the child is ``python -m clip_mixer_tpu_torch.train_cli``."""
    mod = _script()
    d = mod.derive_run_name
    assert (d([]), d(["--run-name", "a"]), d(["--run-name=a"]), d(["--run-name", "a", "--run-name=b"])) == \
        ("run", "a", "a", "b")
    assert d(["--preset", "mixer-b32", "--run-name"]) is None
    captured = {}
    monkeypatch.setattr(mod, "supervise", lambda cmd, ckpt_dir, **kw: captured.update(kw, cmd=cmd, ckpt=ckpt_dir) or 0)
    base = ["--stall-timeout", "60", "--", "--preset", "mixer-debug", "--run-name", "podrun"]
    mod.main(base + ["--process-id", "1"])
    assert captured["heartbeat_path"] == str(Path("outputs") / "podrun" / "heartbeat-1")
    assert captured["cmd"][1:3] == ["-m", "clip_mixer_tpu_torch.train_cli"]
    assert captured["ckpt"] == str(Path("outputs") / "podrun" / "checkpoints")
    captured.clear()
    mod.main(base)
    assert captured["heartbeat_path"] == str(Path("outputs") / "podrun" / "heartbeat-*")
    captured.clear()
    mod.main(["--stall-timeout", "0", "--", "--run-name", "podrun"])
    assert "heartbeat_path" not in captured


def test_supervised_train_cli_crash_drill(tmp_path, monkeypatch):
    """The real ``train_cli`` under ``scripts/torch_supervise.py``: the
    drill crashes it after step 3, the one restart resumes from its
    checkpoint at step 2, and the run ends, saved at step 4 and exported,
    each step's loss written once."""
    site = tmp_path / "site"
    site.mkdir()  # torch.utils.tensorboard blocked in the children: its TensorFlow costs seconds a process
    (site / "sitecustomize.py").write_text("import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    monkeypatch.setenv("PYTHONPATH", str(site))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # beside the suite's other workers
    monkeypatch.chdir(tmp_path)
    rc = _script().main(["--max-restarts", "1", "--backoff", "0", "--",
                         "--preset", "mixer-debug", "--synthetic", "--device", "cpu",
                         "--global-batch-size", "8", "--steps-per-epoch", "4", "--epochs", "1",
                         "--checkpoint-every", "2", "--crash-after-steps", "3", "--no-validators",
                         "--run-name", "drill"])
    assert rc == 0
    run = tmp_path / "outputs" / "drill"
    assert latest_checkpoint_step(run / "checkpoints") == 4 and (run / "export" / "model.pt").exists()
    steps = [r["step"] for r in map(json.loads, (run / "runs" / "metrics.jsonl").read_text().splitlines())
             if r["name"] == "Loss"]
    assert sorted(steps) == list(range(1, 5)), steps
