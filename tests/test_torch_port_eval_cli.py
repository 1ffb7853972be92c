"""The port's command lines over real data: ``train_cli --data`` (a tar glob,
a ``::weight`` mixture, ``--cache-data``) with ``--val-data``, and
``python -m clip_mixer_tpu_torch.eval_cli``, at ``mixer-debug`` with
``--device cpu`` on the CPU.

``CLIP_MIXER_OFFLINE=1`` and no ``datasets`` importable: the four remote
validators skip at once, and retrieval over the held-out split
is the one that scores. The shards hold ``.npy`` members, which need no
Pillow. The retrieval scalars the run writes must be those of the port's
``RetrievalValidator`` on the run's export.
"""

import io
import json
import os
import sys
import tarfile

import numpy as np
import pytest

from clip_mixer_tpu_torch import api, eval_cli, train_cli
from clip_mixer_tpu_torch.data.pipeline import TarShardSource
from clip_mixer_tpu_torch.evals.validators import RetrievalValidator

RUN = ["--preset", "mixer-debug", "--global-batch-size", "4", "--steps-per-epoch", "2", "--epochs", "1",
       "--checkpoint-every", "2", "--device", "cpu"]
RETRIEVAL = ("Retrieval I->T R@1", "Retrieval I->T R@5", "Retrieval T->I R@1", "Retrieval T->I R@5")


def _npy_tar(path, n, seed, word, res=32):
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tar:
        for i in range(n):
            buf = io.BytesIO()
            np.save(buf, rng.integers(0, 256, (res, res, 3), dtype=np.uint8))
            for name, data in ((f"{i:05d}.npy", buf.getvalue()), (f"{i:05d}.txt", f"{word} sample {i}".encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))


@pytest.fixture
def data(tmp_path, monkeypatch):
    """Two training corpora and a held-out split, 8 samples a shard."""
    monkeypatch.chdir(tmp_path)  # the CLI writes outputs/<run-name> under the working directory
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # as on the card's host
    monkeypatch.setitem(sys.modules, "datasets", None)  # its import alone costs seconds
    monkeypatch.setenv("CLIP_MIXER_OFFLINE", "1")
    for var in ("HF_HUB_OFFLINE", "HF_DATASETS_OFFLINE"):  # an explicit _load sets them: restore them after
        monkeypatch.setenv(var, os.environ.get(var, "0"))
    for name, shards, seed in (("a", 2, 0), ("b", 1, 10), ("val", 2, 20)):
        os.makedirs(name)
        for s in range(shards):
            _npy_tar(f"{name}/{s:03d}.tar", 8, seed + s, name)
    return tmp_path


def _rows(run):
    with open(os.path.join("outputs", run, "runs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_on_a_mixture_with_retrieval_and_the_default_validators(data, capsys):
    train_cli.main(RUN + ["--data", "a/*.tar::2", "--data", "b/*.tar::1", "--validate-every", "1",
                          "--val-data", "val/*.tar", "--val-samples", "12", "--run-name", "mix", "--verbose"])
    out = capsys.readouterr().out
    for tag in ("[imagenet] skipped", "[sts:sick] skipped", "[sst2] skipped", "[mnist] skipped"):
        assert tag in out
    for name in ("ImageNetValidator", "CosineSimValidator", "SST2Validator", "MNISTValidator",
                 "RetrievalValidator"):
        assert out.count(f": {name} ") == 2  # a timed pass at steps 1 and 2
    rows = _rows("mix")
    scored = {(r["step"], r["name"]): r["value"] for r in rows if r["name"].startswith("Retrieval")}
    assert set(scored) == {(s, n) for s in (1, 2) for n in RETRIEVAL}
    assert not any(r["name"].startswith(("Top-", "MNIST", "Accuracy on SST-2")) for r in rows)

    # step 2's pass saw the exported weights
    model, cfg, _ = api.load(os.path.join("outputs", "mix", "export"), device="cpu")
    held_out = TarShardSource(["val/000.tar", "val/001.tar"], batch_size=4, image_size=32, context_length=16,
                              drop_last=False)
    res = RetrievalValidator(model, cfg, data_source=held_out, max_samples=12).validate(step=0)
    assert res["n"] == 12.0
    for name in RETRIEVAL:
        direction = "image_to_text" if "I->T" in name else "text_to_image"
        assert scored[(2, name)] == res[f"{direction}_r@{name[-1]}"]


def test_train_from_a_cache_over_one_glob(data):
    train_cli.main(RUN + ["--data", "a/*.tar", "--cache-data", "cache", "--no-validators", "--run-name", "cached"])
    assert sorted(f.split("-")[0] for f in os.listdir("cache")) == ["images", "texts"]
    assert sum(r["name"] == "Loss" for r in _rows("cached")) == 2
    assert os.path.isfile(os.path.join("outputs", "cached", "export", "model.pt"))


@pytest.mark.parametrize("argv, message", [
    (["--data", "a/*.tar::2", "--data", "b/*.tar::1"], "set --steps-per-epoch"),
    (["--data", "a/*.tar::2", "--data", "b/*.tar::1", "--cache-data"], "does not compose with --data mixtures"),
    (["--data", "a/*.tar", "--data", "m.csv"], "tar-shard globs only"),
    (["--data", "none/*.tar"], "no shards match none/\\*.tar"),
], ids=["mixture_needs_steps", "mixture_cache", "mixture_manifest", "no_match"])
def test_data_flags_refuse_what_jax_refuses(data, argv, message):
    i = RUN.index("--steps-per-epoch")
    argv = (RUN[:i] + RUN[i + 2:] if "--steps-per-epoch" in message else RUN) + argv
    with pytest.raises(SystemExit, match=message):
        train_cli.main(argv + ["--no-validators"])


def test_eval_cli_runs_every_validator_on_an_export(data, capsys):
    train_cli.main(RUN + ["--data", "a/*.tar", "--no-validators", "--run-name", "base"])
    export = os.path.join("outputs", "base", "export")
    capsys.readouterr()
    eval_cli.main(["--model", export, "--validators", "sts", "sst2", "mnist", "imagenet", "retrieval",
                   "--val-data", "val", "--val-samples", "16", "--device", "cpu", "--log-dir", "evals"])
    out = capsys.readouterr().out
    for name in ("sts", "sst2", "mnist", "imagenet"):
        assert f"[{name}] {{}}" in out
    model, cfg, _ = api.load(export, device="cpu")
    held_out = TarShardSource(["val/000.tar", "val/001.tar"], batch_size=16, image_size=32, context_length=16,
                              drop_last=False)
    want = RetrievalValidator(model, cfg, data_source=held_out, max_samples=16).validate(step=0)
    assert f"[retrieval] {want}" in out
    with open(os.path.join("evals", "metrics.jsonl")) as f:
        assert sorted(json.loads(line)["name"] for line in f) == sorted(RETRIEVAL)
    with pytest.raises(SystemExit, match="needs --val-data"):
        eval_cli.main(["--model", export, "--validators", "retrieval", "--device", "cpu"])
