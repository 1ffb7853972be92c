"""The port's tar, file-list and mixture sources (``clip_mixer_tpu_torch/data/pipeline.py``),
``train_cli``'s ``parse_data_spec`` / ``build_single_source`` and the two
tools over them (``scripts/torch_pack_dataset.py``,
``scripts/torch_calibrate_int8.py --data``) against the JAX package's, on
the CPU.

The same shards and files go through both packages: every batch must be
bit for bit JAX's (uint8 images, int32 tokens), and the written shards
byte for byte. Shards hold at most 8 samples. The port's one deviation,
``.npy`` members holding the model-sized uint8 image, is tested on its own,
as is a host without Pillow: an ``ImportError`` naming it, never a
substituted record.
"""

import importlib.util
import io
import os
import sys
import tarfile

import numpy as np
import pytest
from PIL import Image

import jax

from clip_mixer_tpu.config import PRESETS as JAX_PRESETS
from clip_mixer_tpu.data import pipeline as J
from clip_mixer_tpu.models import clip as jclip

from clip_mixer_tpu_torch import CLIP, PRESETS, api, load_jax_params, train_cli
from clip_mixer_tpu_torch.data import pipeline as P
from clip_mixer_tpu_torch.ops import quant_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(batch_size=4, image_size=16, context_length=16)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _samples(n, seed, res=24, word="caption"):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (res, res, 3), dtype=np.uint8), f"{word} number {seed} {i}") for i in range(n)]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Four JPEG shards of 6 samples each (the JAX writer's)."""
    return J.write_tar_shards(iter(_samples(24, 0)), str(tmp_path_factory.mktemp("shards")), samples_per_shard=6)


def _equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a["images"].dtype == b["images"].dtype == np.uint8
        assert a["texts"].dtype == b["texts"].dtype == np.int32
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["texts"], b["texts"])


def _write_tar(path, members):
    with tarfile.open(path, "w") as tar:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def _npy(img):
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


CASES = {
    "epoch0": (dict(), 0, 0),
    "shuffle_buffer": (dict(shuffle_buffer=5, seed=3), 1, 0),
    "host_1_of_3": (dict(n_hosts=3, host_index=1), 0, 0),
    "resume": (dict(shuffle_buffer=5), 2, 2),
    "tail_kept": (dict(drop_last=False, batch_size=5), 0, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tar_source_matches_jax(shards, case):
    kw, epoch, start = CASES[case]
    kw = dict(KW, **kw)
    _equal(P.TarShardSource(shards, **kw).iter_batches(epoch, start),
           J.TarShardSource(shards, **kw).iter_batches(epoch, start))


def test_process_decode_matches_jax_thread_decode(shards):
    got = P.TarShardSource(shards, decode_mode="process", decode_workers=2, **KW)
    _equal(got.iter_batches(1), J.TarShardSource(shards, **KW).iter_batches(1))
    with pytest.raises(ValueError, match="decode_mode"):
        P.TarShardSource(shards, decode_mode="fork", **KW)


def test_uneven_shards_split_equally_across_hosts(shards):
    for h in range(3):
        assert P.TarShardSource(shards, n_hosts=3, host_index=h, **KW).shards == \
            J.TarShardSource(shards, n_hosts=3, host_index=h, **KW).shards
    with pytest.raises(ValueError, match="4 shards cannot feed 5 hosts"):
        P.TarShardSource(shards, n_hosts=5, **KW)


@pytest.fixture
def corrupt_shard(tmp_path):
    """Two shards of 4 JPEG samples, the second's records 1 and 2 corrupt."""
    good = J.write_tar_shards(iter(_samples(8, 1)), str(tmp_path / "s"), samples_per_shard=4)
    with tarfile.open(good[1]) as tar:
        members = [(m.name, tar.extractfile(m).read()) for m in tar]
    members = [(n, b"not an image" if n.startswith(("000000005", "000000006")) and n.endswith(".jpg") else d)
               for n, d in members]
    _write_tar(good[1], members)
    return good


def test_corrupt_records_raise_or_substitute_as_jax(corrupt_shard):
    for src in (P, J):
        with pytest.raises(RuntimeError, match="2/4 samples failed to decode"):
            list(src.TarShardSource(corrupt_shard, **KW).iter_batches(0))
    got = P.TarShardSource(corrupt_shard, on_decode_error="substitute", **KW)
    want = J.TarShardSource(corrupt_shard, on_decode_error="substitute", **KW)
    _equal(got.iter_batches(0), want.iter_batches(0))
    assert got.decode_errors == want.decode_errors == 2


def test_missing_pillow_raises_even_under_substitute(corrupt_shard, monkeypatch):
    """No Pillow: an ``ImportError`` naming it, not 8 decode errors
    substituted into a batch."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    src = P.TarShardSource(corrupt_shard, on_decode_error="substitute", **KW)
    with pytest.raises(ImportError, match="needs Pillow"):
        list(src.iter_batches(0))
    assert src.decode_errors == 0


def test_npy_members_are_read_without_pillow(tmp_path, monkeypatch):
    """The deviation: ``.npy`` members holding uint8 [16, 16, 3] are used as
    they are; another shape is a decode error under ``on_decode_error``."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    imgs = [s[0] for s in _samples(6, 2, res=16)]
    members = []
    for i, img in enumerate(imgs):
        members += [(f"{i:03d}.npy", _npy(img if i != 4 else img[:8])), (f"{i:03d}.txt", f"a caption {i}".encode())]
    _write_tar(str(tmp_path / "a.tar"), members)
    batches = list(P.TarShardSource([str(tmp_path / "a.tar")], batch_size=3, image_size=16, context_length=16,
                                    on_decode_error="substitute").iter_batches(0))
    np.testing.assert_array_equal(batches[0]["images"], np.stack(imgs[:3]))
    np.testing.assert_array_equal(batches[1]["images"], np.stack([imgs[3], imgs[3], imgs[5]]))
    with pytest.raises(RuntimeError, match=r"holds uint8 \(8, 16, 3\)"):
        list(P.TarShardSource([str(tmp_path / "a.tar")], batch_size=3, image_size=16,
                              context_length=16).iter_batches(0))


@pytest.fixture
def image_dir(tmp_path):
    """``root/<class>/<stem>.png`` with sidecar captions, 10 images."""
    root = tmp_path / "imgs"
    for i, (img, caption) in enumerate(_samples(10, 3, res=20)):
        d = root / ("red_cars" if i % 2 else "big-dogs")
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(d / f"photo_{i:02d}.png")
        (d / f"photo_{i:02d}.txt").write_text(f"  {caption}\n")
    return root


@pytest.mark.parametrize("caption_from", ["txt", "dirname", "stem"])
def test_from_folder_matches_jax(image_dir, caption_from):
    kw = dict(KW, caption_from=caption_from, drop_last=False, seed=4)
    got, want = P.FileListSource.from_folder(str(image_dir), **kw), J.FileListSource.from_folder(str(image_dir), **kw)
    assert got.entries == want.entries and got.batches_per_epoch == want.batches_per_epoch == 3
    _equal(got.iter_batches(1, 1), want.iter_batches(1, 1))


def test_from_csv_matches_jax(image_dir, tmp_path):
    files = sorted(str(p.relative_to(image_dir)) for p in image_dir.rglob("*.png"))
    tsv = tmp_path / "m.tsv"  # a header in another column order, tab-separated, paths relative to image_root
    tsv.write_text("caption\tignored\tfilepath\n" + "".join(f"cap {i}\tx\t{f}\n" for i, f in enumerate(files)))
    kw = dict(KW, image_root=str(image_dir))
    got, want = P.FileListSource.from_csv(str(tsv), **kw), J.FileListSource.from_csv(str(tsv), **kw)
    assert got.entries == want.entries and len(got.entries) == 10
    _equal(got.iter_batches(0), want.iter_batches(0))

    csv = image_dir / "plain.csv"  # no header, paths relative to the manifest
    csv.write_text("".join(f"{f},caption {i}\n" for i, f in enumerate(files)))
    assert P.FileListSource.from_csv(str(csv), **KW).entries == J.FileListSource.from_csv(str(csv), **KW).entries

    bad = tmp_path / "bad.csv"
    bad.write_text("image_file,desc\na.png,x\n")
    with pytest.raises(ValueError, match="first row is not a recognised header"):
        P.FileListSource.from_csv(str(bad), **KW)
    remote = tmp_path / "remote.csv"
    remote.write_text("url,caption\nhttps://example.com/a.jpg,x\n")
    with pytest.raises(ValueError, match="remote URLs are not supported"):
        P.FileListSource.from_csv(str(remote), **KW)


def test_unreadable_file_is_substituted_as_jax(image_dir):
    entries = J.FileListSource.from_folder(str(image_dir), **KW).entries
    entries[3] = (entries[3][0] + ".missing", entries[3][1])
    got = P.FileListSource(entries, on_decode_error="substitute", **KW)
    want = J.FileListSource(entries, on_decode_error="substitute", **KW)
    _equal(got.iter_batches(0), want.iter_batches(0))
    assert got.decode_errors == want.decode_errors == 1
    with pytest.raises(FileNotFoundError):
        list(P.FileListSource(entries, **KW).iter_batches(0))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Two corpora, 8 and 4 samples in shards of 4."""
    root = tmp_path_factory.mktemp("mix")
    return [J.write_tar_shards(iter(_samples(n, 10 + k, word=w)), str(root / f"c{k}"), samples_per_shard=4)
            for k, (n, w) in enumerate(((8, "alpha"), (4, "omega")))]


def test_mixture_matches_jax_and_resumes(corpora):
    kw = dict(KW, weights=[2.0, 1.0], shuffle_buffer=6, seed=5)
    got, want = P.MixtureSource(corpora, **kw), J.MixtureSource(corpora, **kw)
    assert [c.shuffle_buffer for c in got.children] == [c.shuffle_buffer for c in want.children] == [4, 2]

    def take(src, start, n):
        it = src.iter_batches(1, start)
        return [next(it) for _ in range(n)]

    _equal(take(got, 0, 6), take(want, 0, 6))
    _equal(take(got, 4, 2), take(got, 0, 6)[4:])  # resume by count
    # the realised share of corpus 0, whose captions start "alpha"
    tokens = np.concatenate([b["texts"] for b in take(got, 0, 16)])
    share = float((tokens[:, 1] == P.tokenize(["alpha"], 16)[0, 1]).mean())
    assert abs(share - 2 / 3) < 0.12, share


@pytest.mark.parametrize("bad", [dict(components=[]), dict(weights=[1.0]), dict(weights=[1.0, 0.0])])
def test_mixture_validation_matches_jax(corpora, bad):
    kw = dict(dict(components=corpora), **bad)
    msgs = []
    for src in (P, J):
        with pytest.raises(ValueError) as e:
            src.MixtureSource(batch_size=4, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_written_shards_are_jax_bytes(tmp_path, image_dir):
    samples = _samples(7, 4)
    got = P.write_tar_shards(iter(samples), str(tmp_path / "p"), samples_per_shard=3)
    want = J.write_tar_shards(iter(samples), str(tmp_path / "j"), samples_per_shard=3)
    assert [os.path.basename(p) for p in got] == ["00000.tar", "00001.tar", "00002.tar"]
    assert [open(p, "rb").read() for p in got] == [open(p, "rb").read() for p in want]
    entries = J.FileListSource.from_folder(str(image_dir), **KW).entries
    got = P.write_tar_shards_from_files(entries, str(tmp_path / "fp"), samples_per_shard=4)
    want = J.write_tar_shards_from_files(entries, str(tmp_path / "fj"), samples_per_shard=4)
    assert [open(p, "rb").read() for p in got] == [open(p, "rb").read() for p in want]
    # the round trip: the packed shards read as the folder did, entry order aside
    packed = list(P.TarShardSource(got, drop_last=False, **KW).iter_batches(0))
    assert sum(len(b["images"]) for b in packed) == 10
    with pytest.raises(ValueError, match="only .jpg/.jpeg/.png/.npy can be packed"):
        P.write_tar_shards_from_files([(str(image_dir / "x.gif"), "c")], str(tmp_path / "g"))


def test_pack_dataset_tool_packs_npy_files_and_matches_jax_on_pngs(tmp_path, image_dir):
    pack = _script("torch_pack_dataset")
    pack.main(["--data", str(image_dir), "--out", str(tmp_path / "png"), "--samples-per-shard", "4",
               "--shuffle", "--seed", "2"])
    entries = J.FileListSource.from_folder(str(image_dir), **KW).entries
    order = np.random.default_rng(2).permutation(len(entries))
    want = J.write_tar_shards_from_files([entries[i] for i in order], str(tmp_path / "j"), samples_per_shard=4)
    got = sorted(str(p) for p in (tmp_path / "png").glob("*.tar"))
    assert [open(p, "rb").read() for p in got] == [open(p, "rb").read() for p in want]

    npy_dir = tmp_path / "npy"
    npy_dir.mkdir()
    imgs = [s[0] for s in _samples(5, 5, res=16)]
    for i, img in enumerate(imgs):
        np.save(npy_dir / f"im_{i}.npy", img)
    pack.main(["--data", str(npy_dir), "--out", str(tmp_path / "npy_shards"), "--caption-from", "stem"])
    batch = next(P.TarShardSource(sorted(str(p) for p in (tmp_path / "npy_shards").glob("*.tar")), batch_size=5,
                                  image_size=16, context_length=16).iter_batches(0))
    np.testing.assert_array_equal(batch["images"], np.stack(imgs))
    np.testing.assert_array_equal(batch["texts"], P.tokenize([f"im {i}" for i in range(5)], 16))
    with pytest.raises(SystemExit, match="remote object stores"):
        pack.main(["--data", str(npy_dir), "--out", "gs://bucket/shards"])


def test_remote_streaming_matches_jax(shards):
    import fsspec

    pattern = f"file://{os.path.dirname(shards[0])}/*.tar"
    remote = P.expand_shard_pattern(pattern)
    assert remote == J.expand_shard_pattern(pattern) and all(p.startswith("file://") for p in remote)
    assert P.expand_shard_pattern(os.path.join(os.path.dirname(shards[0]), "*.tar")) == shards
    _equal(P.TarShardSource(remote, **KW).iter_batches(0), J.TarShardSource(shards, **KW).iter_batches(0))
    mem = fsspec.filesystem("memory")
    for p in shards:
        with open(p, "rb") as src, mem.open(f"/port_shards/{os.path.basename(p)}", "wb") as dst:
            dst.write(src.read())
    mem_paths = P.expand_shard_pattern("memory://port_shards/*.tar")
    assert len(mem_paths) == 4
    _equal(P.TarShardSource(mem_paths, **KW).iter_batches(1), J.TarShardSource(shards, **KW).iter_batches(1))


def test_retrying_stream_resumes_at_offset():
    payload = bytes(range(256)) * 512

    class Flaky:
        opened = 0

        def __init__(self):
            Flaky.opened += 1
            self.pos, self.served = 0, 0

        def seek(self, pos):
            self.pos = pos

        def read(self, n):
            if Flaky.opened <= 2 and self.served >= 40000:
                raise ConnectionResetError("dropped")
            data = payload[self.pos : self.pos + min(n, 10000)]
            self.pos += len(data)
            self.served += len(data)
            return data

        def close(self):
            pass

    stream = io.BufferedReader(P._RetryingStream("mem://x", backoff=0.0, open_fn=Flaky), buffer_size=4096)
    assert stream.read() == payload and Flaky.opened == 3


def test_parse_data_spec_and_build_single_source(shards, image_dir, tmp_path):
    for spec, want in (("shards/*.tar", ("shards/*.tar", 1.0)), ("shards/*.tar::3", ("shards/*.tar", 3.0)),
                       ("shards/*.tar::0.25", ("shards/*.tar", 0.25)), ("/mnt/ds::v2/*.tar", ("/mnt/ds::v2/*.tar", 1.0)),
                       ("shards/*.tar::", ("shards/*.tar::", 1.0))):  # tests/test_data_trainer_api.py's cases
        assert train_cli.parse_data_spec(spec) == want
    for bad in ("a::0", "a::-1", "a::nan", "a::inf"):
        with pytest.raises(SystemExit, match="must be a positive number"):
            train_cli.parse_data_spec(bad)
    kw = dict(KW, drop_last=False)
    shard_dir = os.path.dirname(shards[0])
    built = {
        "glob": train_cli.build_single_source(os.path.join(shard_dir, "*.tar"), **kw),
        "tar_dir": train_cli.build_single_source(shard_dir, **kw),
        "folder": train_cli.build_single_source(str(image_dir), "dirname", **kw),
    }
    assert type(built["glob"]) is type(built["tar_dir"]) is P.TarShardSource
    assert built["glob"].shards == built["tar_dir"].shards == shards
    assert isinstance(built["folder"], P.FileListSource)
    assert built["folder"].entries == J.FileListSource.from_folder(str(image_dir), caption_from="dirname",
                                                                  **KW).entries
    with pytest.raises(SystemExit, match="no shards match"):
        train_cli.build_single_source(str(tmp_path / "none" / "*.tar"), **kw)


def test_cache_source_over_a_tar_source_matches_jax(shards, tmp_path):
    got = P.CacheSource(P.TarShardSource(shards, **KW), seed=2, cache_dir=str(tmp_path / "p"))
    want = J.CacheSource(J.TarShardSource(shards, **KW), seed=2, cache_dir=str(tmp_path / "j"))
    assert got._fingerprint() == want._fingerprint()
    _equal(got.iter_batches(1, 1), want.iter_batches(1, 1))
    assert got.n_samples == 24 and got.inner.drop_last


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    params = jax.tree.map(np.asarray, jclip.init(jax.random.key(0), JAX_PRESETS["mixer-debug"]))
    path = str(tmp_path_factory.mktemp("calib") / "export")
    api.save_pretrained(load_jax_params(CLIP(PRESETS["mixer-debug"], device="cpu"), params),
                        PRESETS["mixer-debug"], path)
    return params, path


def test_calibration_on_tar_shards_matches_jax(export, tmp_path):
    params, path = export
    glob = os.path.join(os.path.dirname(
        J.write_tar_shards(iter(_samples(20, 6, res=40)), str(tmp_path / "s"), samples_per_shard=8)[0]), "*.tar")
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    _script("torch_calibrate_int8").main(["--model", path, "--out", ours, "--data", glob, "--n", "12",
                                          "--device", "cpu"])
    _script("calibrate_int8").run(params, JAX_PRESETS["mixer-debug"], theirs, data=glob, n=12)
    got, want = quant_io.load_calibration(ours), quant_io.load_calibration(theirs)
    for side in ("image_scales", "text_scales"):
        a, b = jax.tree_util.tree_flatten_with_path(got[side])[0], jax.tree_util.tree_flatten_with_path(want[side])[0]
        assert [p for p, _ in a] == [p for p, _ in b]
        for (p, x), (_, y) in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=jax.tree_util.keystr(p))
