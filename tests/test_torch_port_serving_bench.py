"""The port's serving benchmarks (``scripts/torch_serving_bench.py``,
``scripts/torch_bench_serving.py``) against the JAX package's
(``scripts/serving_bench.py``, ``scripts/bench_serving.py``), on the CPU.

* ``stats`` gives JAX's dicts on the same latency lists.
* ``load_payloads`` tops up with JAX's JPEG bytes byte for byte, and reads
  the same members of a shard.
* The quick suite, against a port server of ``mixer-debug`` built in this
  process (``build_server``, port 0, ``--device cpu``), gives every
  endpoint the keys of the committed ``SERVING_BENCH.json``'s legs and no
  error; the server's ``/metrics`` counts the client's requests.
* The raw baseline at ``mixer-debug`` prints the keys of the record's
  ``raw_engine_no_http``, and ``power_limit``.
* ``main`` passes ``--device`` to every child and ``--data`` to the
  calibration; it stops its server children; without a card and without
  ``--device`` both scripts raise.
"""

import importlib
import io
import json
import subprocess
import sys
import tarfile
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from clip_mixer_tpu_torch.serving import build_server
from torch_port_worlds import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
port = importlib.import_module("torch_serving_bench")
raw = importlib.import_module("torch_bench_serving")
jax_bench = importlib.import_module("serving_bench")
RECORD = json.loads((REPO / "SERVING_BENCH.json").read_text())
ENDPOINTS = ("encode_image_b32", "encode_image_b128", "encode_image_b1_coalesced_8clients", "encode_text_b64",
             "classify_b32_top5", "retrieve_b8_top5", "similarity_8x8")
SERVER_PATHS = {"encode_image_b32": "/encode_image", "encode_text_b64": "/encode_text",
                "classify_b32_top5": "/classify", "retrieve_b8_top5": "/retrieve", "similarity_8x8": "/similarity"}


@pytest.mark.parametrize("lat,wall,items,errs", [
    ([0.1, 0.25, 0.05, 0.4, 0.3], 1.7, 32, []),
    ([0.0123] * 7 + [0.9], 2.0, 1, ["ConnectionResetError()", "HTTPError 500"]),
    ([], 1.0, 8, ["ServingError(500)", "timeout", "third"]),
])
def test_stats_equal_jax(lat, wall, items, errs):
    assert port.stats(lat, wall, items, errs) == jax_bench.stats(lat, wall, items, errs)


def _jax_payloads(monkeypatch, shard_dir, n_imgs, n_caps):
    """JAX's ``load_payloads`` reading ``shard_dir`` where it reads its
    fixed shard directory (``<data root>/dress``)."""
    monkeypatch.setattr(jax_bench, "Path", lambda p: shard_dir if str(p).endswith("/data/dress") else Path(p))
    return jax_bench.load_payloads(n_imgs, n_caps)


def test_load_payloads_top_up_bit_for_bit(tmp_path, monkeypatch):
    got = port.load_payloads(6, 5, data=str(tmp_path / "*.tar"))
    assert got == _jax_payloads(monkeypatch, tmp_path, 6, 5)
    assert got[2] == 0 and len(got[0]) == 6 and got[0][0][:2] == b"\xff\xd8"  # JPEG


def test_load_payloads_reads_the_shard_members(tmp_path, monkeypatch):
    members = {"00000.jpg": port.load_payloads(1, 0, data="")[0][0][::-1], "00000.txt": b"a red circle"}
    with tarfile.open(tmp_path / "00000.tar", "w") as tf:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    got = port.load_payloads(3, 2, data=str(tmp_path / "*.tar"))
    assert got == _jax_payloads(monkeypatch, tmp_path, 3, 2)
    assert got[0][0] == members["00000.jpg"] and got[1][0] == "a red circle" and got[2] == 1


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port server of mixer-debug on the CPU in this process, with a
    classifier, as the bench's legs run it."""
    names = tmp_path_factory.mktemp("serving_bench") / "classnames.txt"
    names.write_text("".join(f"class number {i}\n" for i in range(4)))
    server, engine = build_server(["--model", "mixer-debug", "--port", "0", "--device", "cpu", "--warmup",
                                   "--classifier", str(names)])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    client = port.ServingClient(f"http://127.0.0.1:{server.server_address[1]}", timeout=120.0, retries=0)
    yield types.SimpleNamespace(client=client, startup_seconds=0.0, healthz=client.healthz())
    server.shutdown()
    server.server_close()


def test_quick_suite_has_jax_keys_and_no_error(served):
    jpegs, caps, _ = port.load_payloads(data="")
    leg = port.run_suite(served, jpegs, caps, quick=True)
    want = RECORD["live_bf16"]
    assert list(leg) == list(want)
    for ep in ENDPOINTS:
        assert list(leg[ep]) == list(want[ep]), (ep, leg[ep])  # no "errors", "error" or "skipped"
        assert leg[ep]["requests"] > 0
    assert set(leg["healthz"]) >= set(want["healthz"]) and leg["healthz"]["paths"] == {"image": "float",
                                                                                       "text": "float"}
    metrics = leg["server_metrics"]
    assert set(metrics) == set(want["server_metrics"])
    for ep, path in SERVER_PATHS.items():
        assert metrics[path]["count"] >= leg[ep]["requests"] and metrics[path]["errors"] == 0, (path, metrics)
    image_requests = sum(leg[ep]["requests"] for ep in ENDPOINTS[:3])
    assert metrics["/encode_image"]["count"] >= image_requests


def test_raw_baseline_prints_jax_keys(capsys):
    line = raw.main(["--device", "cpu"], preset="mixer-debug")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert list(line) == list(RECORD["raw_engine_no_http"]) + ["power_limit"]
    assert line["device"] == "cpu" and line["note"] == raw.NOTE and "not a tunnel" in line["note"]
    assert all(np.isfinite(v) and v > 0 for k, v in line.items() if k not in ("note", "device", "power_limit"))


class _FakeServer:
    """Records each leg's command line in place of a server child."""

    started = []

    def __init__(self, extra_args, log_name, startup_deadline=1200):
        self.started.append([str(a) for a in extra_args])
        self.client = types.SimpleNamespace(encode_image_files=lambda images: None)
        self.startup_seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def test_main_passes_device_and_data_to_every_child(tmp_path, monkeypatch):
    """The preparation, the probes, the legs and the raw baseline, their
    children replaced by recorders: every command line carries
    ``--device``; the calibration reads ``--data``; the record names the
    device; a failed raw baseline is recorded as an ``error``."""
    (tmp_path / "shards").mkdir()
    (tmp_path / "shards" / "00000.tar").write_bytes(b"")
    commands = []
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port, "sh", lambda cmd, log_name, timeout=1800: commands.append([str(c) for c in cmd]))
    monkeypatch.setattr(port, "Server", _FakeServer)
    monkeypatch.setattr(port, "run_suite", lambda srv, jpegs, caps, quick=False: {"quick": quick})
    monkeypatch.setattr(port, "load_payloads", lambda data: ([b"\xff\xd8"] * 512, ["a caption"] * 256, 0))
    _FakeServer.started.clear()
    data = str(tmp_path / "shards" / "*.tar")
    assert port.main(["--quick", "--device", "cpu", "--data", data, "--out", "rec.json"]) == 0
    assert len(commands) == 5 and len(_FakeServer.started) == 6
    for cmd in commands[1:] + _FakeServer.started:
        assert cmd[-2:] == ["--device", "cpu"], cmd
    assert commands[1][commands[1].index("--data") + 1] == data
    assert commands[4][1].endswith("torch_bench_serving.py")
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec["device"] == "cpu" and rec["live_int8"] == {"quick": True}
    assert rec["raw_engine_no_http"]["error"].startswith("torch_bench_serving.py failed")


def test_stop_children_kills_and_reaps():
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    port._CHILDREN.append(proc)
    port.stop_children()
    assert proc.returncode is not None


@pytest.mark.parametrize("module,argv", [(port, ["--quick"]), (raw, [])])
def test_no_card_without_device_raises(module, argv, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    assert list(tmp_path.iterdir()) == []
