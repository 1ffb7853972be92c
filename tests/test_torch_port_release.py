"""scripts/torch_release.py (calibrate -> gate the shipped scales -> freeze ->
RELEASE.json) and the serving CLI on its output, on the CPU, on the model
of tests/test_release.py, at ``mixer-debug`` (the port's seed-0 weights)."""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from clip_mixer_tpu_torch import aot
from clip_mixer_tpu_torch.serving import build_server

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import torch_release  # noqa: E402

CPU = ["--device", "cpu"]
TEXTS = ["a photo of a cat", "a red car", "two dogs"]


def _release(out, *extra):
    torch_release.main(["--model", "mixer-debug", "--out", str(out), "--n", "16", "--gate-n", "64",
                        "--buckets", "4", *extra, *CPU])
    return str(out)


@pytest.fixture(scope="module")
def releases(tmp_path_factory):
    root = tmp_path_factory.mktemp("rel")
    return {"int8": _release(root / "int8"), "float": _release(root / "float", "--no-int8")}


def test_release_int8_end_to_end(releases):
    out = releases["int8"]
    manifest = json.loads((Path(out) / "RELEASE.json").read_text())
    assert manifest["int8"] is True and manifest["buckets"] == [4] and manifest["platforms"] == ["cpu"]
    assert manifest["gates"]["image"]["passed"] and manifest["gates"]["text"]["passed"]
    assert manifest["calibration_samples"] == 16 and manifest["route"] == "plain"
    eng = aot.load_servable(out, device="cpu")
    assert eng.path_kinds == {"image": "int8", "text": "int8"} and eng.frozen
    feats = eng.encode_image_arrays(np.zeros((3, 32, 32, 3), np.uint8))
    assert feats.shape == (3, 32) and np.all(np.isfinite(feats))
    # the programs are the artifact's W8A8 encoders: a live engine on the same artifact gives the same bits
    live = aot.load_servable(out, device="cpu")
    live.enable_int8(calibration=str(Path(out) / "servable" / "calibration.npz"))
    assert live.frozen is False
    np.testing.assert_array_equal(eng.encode_text(TEXTS), live.encode_text(TEXTS))


def test_release_float_path(releases):
    manifest = json.loads((Path(releases["float"]) / "RELEASE.json").read_text())
    assert manifest["int8"] is False and manifest["gates"] == {} and manifest["calibration_samples"] is None
    eng = aot.load_servable(releases["float"], device="cpu")
    assert eng.path_kinds == {"image": "float", "text": "float"}


def test_release_aborts_on_failed_gate(tmp_path, monkeypatch):
    """A failing gate aborts before anything is frozen."""
    from clip_mixer_tpu_torch.evals import quant_gate

    real_gate = quant_gate.text_noise_floor_gate

    def failing_gate(*a, **kw):
        return dict(real_gate(*a, **kw), passed=False)

    monkeypatch.setattr(quant_gate, "text_noise_floor_gate", failing_gate)
    out = tmp_path / "bad"
    with pytest.raises(SystemExit, match=r"RELEASE ABORTED: accuracy gate failed for \['text'\].*nothing frozen"):
        _release(out)
    assert not (out / "servable").exists() and not (out / "RELEASE.json").exists()


def test_release_verify(releases, tmp_path, capsys):
    """--verify passes on a good release and fails on a recorded failed gate."""
    torch_release.main(["--out", releases["int8"], "--verify", *CPU])
    assert "VERIFY OK: int8 release, buckets [4]" in capsys.readouterr().out
    bad = tmp_path / "tampered"
    shutil.copytree(releases["int8"], bad)
    manifest = json.loads((bad / "RELEASE.json").read_text())
    manifest["gates"]["image"]["passed"] = False
    (bad / "RELEASE.json").write_text(json.dumps(manifest))
    with pytest.raises(SystemExit, match="VERIFY FAILED"):
        torch_release.main(["--out", str(bad), "--verify", *CPU])


@pytest.mark.parametrize("flags, match", [
    (["--all-devices", "--platforms", "cpu"], "records the layout from THIS host"),
    (["--platforms", "cuda"], "recorded on the exporting process's device"),
])
def test_release_refusals(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        _release(tmp_path / "x", "--no-int8", *flags)
    assert not (tmp_path / "x" / "servable").exists()


def test_cli_serves_a_release_frozen_by_default(releases, capsys):
    """The CLI's engine on a release runs the recorded programs; with
    --no-frozen it runs the live model on the recorded route, with the
    same bits."""
    server, engine = build_server(["--model", releases["float"], "--port", "0", *CPU])
    server.server_close()
    assert engine.frozen and "frozen programs loaded from" in capsys.readouterr().out
    want = aot.load_servable(releases["float"], device="cpu").encode_text(TEXTS)
    np.testing.assert_array_equal(engine.encode_text(TEXTS), want)
    server, live = build_server(["--model", releases["float"], "--port", "0", "--no-frozen", *CPU])
    server.server_close()
    assert not live.frozen and aot.serving_route(live.model) == "plain"
    np.testing.assert_array_equal(live.encode_text(TEXTS), want)


@pytest.mark.parametrize("flag", [["--int8", "scales.npz"], ["--input-size", "64"]])
def test_cli_refuses_retracing_flags_on_a_frozen_dir(releases, flag):
    with pytest.raises(SystemExit, match=f"{flag[0]} would re-trace the encoders.*--no-frozen"):
        build_server(["--model", releases["float"], "--port", "0", *flag, *CPU])
