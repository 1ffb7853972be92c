"""Validators: ImageNetV2 and MNIST zero-shot, STS similarity, the SST-2 probe, retrieval.

Counterpart of ``clip_mixer_tpu/evals/validators.py``, with its scalar
names, skip messages and result keys. Each validator has
``validate(step, verbose=False, params=None) -> dict``. A dataset that
cannot be loaded (no egress, no ``datasets``) makes the validator return
``{}`` and, when verbose, print the skip.

The port's signature is ``Validator(model, cfg, writer=None, ...,
device=None)``. ``validate`` runs ``model`` unless ``params`` is given: a
state dict (the trainer's host weights), which is loaded into an eval
:class:`CLIP` the validator builds once from ``cfg`` on ``device`` (by
default the model's device, or the card when ``model`` is None) and keeps
for every later pass. The caller's model is never written to.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.data import hf_eval
from clip_mixer_tpu_torch.data.hf_eval import STS_SETS, DatasetUnavailable, mnist_batches, sst2_split, sts_pairs
from clip_mixer_tpu_torch.device import DeviceLike, resolve_device
from clip_mixer_tpu_torch.evals.prompts import IMAGENET_CLASSNAMES, MNIST_CLASSNAMES, PROMPT_TEMPLATES
from clip_mixer_tpu_torch.evals.zeroshot import encode_images_batched, encode_texts_batched, zero_shot_eval
from clip_mixer_tpu_torch.text.tokenize import tokenize


class _Validator:
    """The model a pass runs: ``model``, or the kept eval model holding ``params``."""

    def __init__(self, model, cfg: CLIPConfig, writer, device: DeviceLike):
        self.model, self.cfg, self.writer = model, cfg, writer
        self.device = device
        self._eval_model = None

    def _model(self, params=None):
        if params is None:
            if self.model is None:
                raise ValueError(f"{type(self).__name__} has no model: pass one, or params= to validate()")
            return self.model
        if self._eval_model is None:
            from clip_mixer_tpu_torch.models.clip import CLIP

            device = self.device if self.device is not None or self.model is None else self.model.device
            self._eval_model = CLIP(self.cfg, device=resolve_device(device)).eval()
        self._eval_model.load_state_dict(params)
        return self._eval_model

    def _tokens(self, texts):
        return tokenize(texts, self.cfg.context_length, truncate=True)


class ImageNetValidator(_Validator):
    """Zero-shot ImageNetV2 top-1 / top-5. ``image_batches_fn`` yields
    (uint8 [B, res, res, 3], targets), by default ImageNetV2 from local
    class folders (fetched when there is egress) at the model's resolution."""

    def __init__(self, model, cfg: CLIPConfig, writer=None,
                 image_batches_fn: Optional[Callable[[], Iterable]] = None, device: DeviceLike = None):
        super().__init__(model, cfg, writer, device)
        self.image_batches_fn = image_batches_fn or (lambda: _imagenetv2_batches(image_size=cfg.image_resolution))

    def validate(self, step: int, verbose: bool = False, params=None) -> Dict[str, float]:
        try:
            batches = self.image_batches_fn()
            res = zero_shot_eval(self._model(params), IMAGENET_CLASSNAMES, PROMPT_TEMPLATES, batches)
        except DatasetUnavailable as e:
            if verbose:
                print(f"[imagenet] skipped: {e}")
            return {}
        if verbose:
            print(f"Top-1 accuracy: {res['top1']:.2f}%\nTop-5 accuracy: {res['top5']:.2f}%")
        if self.writer is not None:
            self.writer.add_scalar("Top-1 accuracy", res["top1"], step)
            self.writer.add_scalar("Top-5 accuracy", res["top5"], step)
        return res


# ImageNetV2 matched-frequency, as the imagenetv2_pytorch package serves it;
# extraction gives "imagenetv2-matched-frequency-format-val/<class 0..999>/*.jpeg"
_IMAGENETV2_URLS = (
    "https://huggingface.co/datasets/vaishaal/ImageNetV2/resolve/main/imagenetv2-matched-frequency.tar.gz",
    "https://imagenetv2public.s3-us-west-2.amazonaws.com/imagenetv2-matched-frequency.tar.gz",
)


def _find_imagenetv2_root(location: str):
    for cand in (os.path.join(location, "imagenetv2-matched-frequency-format-val"), location):
        if os.path.isdir(cand) and os.path.isdir(os.path.join(cand, "0")):
            return cand
    return None


def fetch_imagenetv2(location: str = "datasetImageNet") -> str:
    """Download and extract ImageNetV2 matched-frequency into ``location``
    and return the class-folder root. Gated by ``hf_eval.host_reachable``;
    processes fetching together are serialised by an ``flock`` (the losers
    find the extracted tree), and the download goes through a ``.partial``
    file, so an interrupted fetch is never taken for an archive."""
    import fcntl

    existing = _find_imagenetv2_root(location)
    if existing is not None:
        return existing
    os.makedirs(location, exist_ok=True)
    lock = open(os.path.join(location, ".imagenetv2.lock"), "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    try:
        existing = _find_imagenetv2_root(location)
        if existing is not None:
            return existing
        return _fetch_imagenetv2_locked(location)
    finally:
        fcntl.flock(lock, fcntl.LOCK_UN)
        lock.close()


def _fetch_imagenetv2_locked(location: str) -> str:
    import tarfile
    import urllib.request

    last_err = "no URL reachable (offline)"
    for url in _IMAGENETV2_URLS:
        host = url.split("/")[2]
        if not hf_eval.host_reachable(host):
            continue
        tmp = os.path.join(location, ".imagenetv2.tar.gz.partial")
        try:
            with urllib.request.urlopen(url, timeout=60) as src, open(tmp, "wb") as out:
                done = 0
                while True:
                    buf = src.read(1 << 20)
                    if not buf:
                        break
                    out.write(buf)
                    done += len(buf)
                    if done % (200 << 20) < (1 << 20):
                        print(f"[imagenetv2] {done >> 20} MiB from {host}", flush=True)
            with tarfile.open(tmp, "r:gz") as tar:
                tar.extractall(location, filter="data")
            os.remove(tmp)
            root = _find_imagenetv2_root(location)
            if root is not None:
                return root
            last_err = f"{url}: archive extracted but no class folders found"
        except Exception as e:  # this URL failed: try the next, report the last
            last_err = f"{url}: {e}"
            try:
                os.remove(tmp)
            except OSError:
                pass
    raise DatasetUnavailable(f"ImageNetV2 fetch failed: {last_err}")


def _imagenetv2_batches(batch_size: int = 256, location: str = "datasetImageNet", image_size: int = 224):
    """ImageNetV2 batches from the class folders (0..999) under
    ``location``, fetched when missing (``DatasetUnavailable`` offline).
    Pillow is imported when the first image is decoded, so a host without
    it still skips offline; with the dataset present it raises."""
    from clip_mixer_tpu_torch.ops.preprocess import preprocess_pil

    root = _find_imagenetv2_root(location)
    if root is None:
        root = fetch_imagenetv2(location)
    classes = sorted(int(d) for d in os.listdir(root) if d.isdigit())
    if not classes:
        raise DatasetUnavailable(f"ImageNetV2 under {root} has no class folders")

    def gen():
        from PIL import Image

        images, targets = [], []
        yielded = False
        for cls in classes:
            d = os.path.join(root, str(cls))
            try:
                fnames = sorted(os.listdir(d))
            except OSError as e:  # a partly extracted tree skips, it does not end the run
                raise DatasetUnavailable(f"ImageNetV2 class dir unreadable: {e}")
            for fname in fnames:
                with Image.open(os.path.join(d, fname)) as im:
                    images.append(preprocess_pil(im, image_size))
                targets.append(cls)
                if len(images) == batch_size:
                    yield np.stack(images), np.asarray(targets)
                    yielded = True
                    images, targets = [], []
        if images:
            yield np.stack(images), np.asarray(targets)
            yielded = True
        if not yielded:
            raise DatasetUnavailable(f"ImageNetV2 under {root} contains no images")

    return gen()


class CosineSimValidator(_Validator):
    """STS: Spearman and Pearson of text-feature similarities against gold
    scores over six datasets, and with ``figures=True`` (when matplotlib
    imports) histograms with KDE overlays by gold-score bucket. An entry of
    ``datasets`` is a dataset name or a ``(name, pairs)`` tuple."""

    def __init__(self, model, cfg: CLIPConfig, writer=None, datasets=None, figures: bool = False,
                 device: DeviceLike = None):
        super().__init__(model, cfg, writer, device)
        self.datasets = datasets if datasets is not None else STS_SETS
        self.figures = figures

    def _validate_pairs(self, name: str, pairs, step, verbose, params=None) -> Dict[str, float]:
        from scipy.stats import pearsonr, spearmanr

        model = self._model(params)
        gold = np.asarray([p[2] for p in pairs], np.float64)
        fa = encode_texts_batched(model, self._tokens([p[0] for p in pairs]), normalize=False)
        fb = encode_texts_batched(model, self._tokens([p[1] for p in pairs]), normalize=False)
        linf = np.max(np.abs(fa - fb), axis=1)
        l2 = np.linalg.norm(fa - fb, axis=1)
        cos = (fa * fb).sum(1) / (np.linalg.norm(fa, axis=1) * np.linalg.norm(fb, axis=1))
        out = {
            "srcc_linf": float(spearmanr(linf, gold).correlation),
            "srcc_cosine": float(spearmanr(cos, gold).correlation),
            "pc_cosine": float(pearsonr(cos, gold).statistic),
            "l2_mean": float(l2.mean()),
        }
        if verbose:
            print(f"[{name}] SRCC Linf {out['srcc_linf']:.3f}  SRCC Cosine {out['srcc_cosine']:.3f}  "
                  f"PC Cosine {out['pc_cosine']:.3f}")
        if self.writer is not None and step is not None:
            self.writer.add_scalar(f"{name}/SRCC Linf", out["srcc_linf"], step)
            self.writer.add_scalar(f"{name}/SRCC Cosine", out["srcc_cosine"], step)
            self.writer.add_scalar(f"{name}/PC Cosine", out["pc_cosine"], step)
        if self.figures:
            self._log_figures(name, l2, cos, gold, step, verbose)
        return out

    def _log_figures(self, name: str, l2, cos, gold, step, verbose: bool) -> None:
        """Per-gold-bucket histograms with KDE overlays of the L2 and cosine
        distances; nothing without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            from scipy import stats
        except ImportError:
            return
        colors = ["red", "green", "blue", "orange", "purple"]
        legend = ["0 - 1", "1 - 2", "2 - 3", "3 - 4", "4 - 5"]
        for tag, values, bins in (
            ("neighborContinuousHistogramL2", l2, np.linspace(0, max(float(l2.max()), 1e-6), 100)),
            ("neighborContinuousHistogramCosine", cos, np.linspace(-1, 1, 100)),
        ):
            fig, ax = plt.subplots()
            for g, (c, label) in enumerate(zip(colors, legend)):
                ix = np.where((g <= gold) & (gold < g + 1))[0]
                if ix.size == 0:
                    continue
                _, xs, _ = ax.hist(values[ix], bins=bins, histtype="step", density=True, alpha=0.5, color=c)
                if np.unique(values[ix]).size > 1:
                    density = stats.gaussian_kde(values[ix])
                    ax.plot(xs, density(xs), c=c, label=label)
            ax.legend()
            ax.get_yaxis().set_visible(False)
            ax.set_xlabel(f"{'L2' if 'L2' in tag else 'Cosine'} Distance between pair")
            ax.set_title("Distances for duplicate and non-duplicate pairs")
            if self.writer is not None and step is not None:
                self.writer.add_figure(f"{name}/{tag}", fig, step)
            if verbose:
                fig.savefig(f"{tag}.png")
            plt.close(fig)

    def validate(self, step: int, verbose: bool = False, params=None) -> Dict[str, Dict[str, float]]:
        results = {}
        for name in self.datasets:
            try:
                pairs = sts_pairs(name) if isinstance(name, str) else name[1]
                key = name if isinstance(name, str) else name[0]
            except DatasetUnavailable as e:
                if verbose:
                    print(f"[sts:{name}] skipped: {e}")
                continue
            results[key] = self._validate_pairs(key, pairs, step, verbose, params=params)
        return results


class SST2Validator(_Validator):
    """Linear probe on SST-2: the train split's text features (not
    normalised) fit a one-layer classifier, zero-initialised, by Adam at lr
    1e-3 on mean softmax cross-entropy, 10 epochs of minibatches of 32 in
    order (the tail minibatch too), in f32 on the model's device; reports
    the validation accuracy."""

    def __init__(self, model, cfg: CLIPConfig, writer=None, train_data=None, test_data=None,
                 device: DeviceLike = None):
        super().__init__(model, cfg, writer, device)
        self._train, self._test = train_data, test_data

    def _embed(self, data, model):
        feats = encode_texts_batched(model, self._tokens([d[0] for d in data]), normalize=False)
        return feats, np.asarray([d[1] for d in data], np.int64)

    def fit_probe(self, xtr: np.ndarray, ytr: np.ndarray, device) -> Dict[str, torch.Tensor]:
        """The probe's ``{"w": [D, 2], "b": [2]}`` after its 10 epochs."""
        x = torch.as_tensor(xtr, dtype=torch.float32, device=device)
        y = torch.as_tensor(ytr, device=device).long()
        w = torch.zeros(x.shape[1], 2, device=device, requires_grad=True)
        b = torch.zeros(2, device=device, requires_grad=True)
        opt = torch.optim.Adam([w, b], lr=1e-3)  # optax.adam's defaults and update
        with torch.enable_grad():
            for _ in range(10):
                for i in range(0, x.shape[0], 32):
                    loss = torch.nn.functional.cross_entropy(x[i : i + 32] @ w + b, y[i : i + 32])
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    opt.step()
        return {"w": w.detach(), "b": b.detach()}

    def validate(self, step: int, verbose: bool = False, params=None) -> Dict[str, float]:
        try:
            train = self._train if self._train is not None else sst2_split("train")
            test = self._test if self._test is not None else sst2_split("validation")
        except DatasetUnavailable as e:
            if verbose:
                print(f"[sst2] skipped: {e}")
            return {}
        model = self._model(params)
        xtr, ytr = self._embed(train, model)
        xte, yte = self._embed(test, model)
        probe = self.fit_probe(xtr, ytr, model.device)
        logits = (torch.as_tensor(xte, device=model.device) @ probe["w"] + probe["b"]).cpu().numpy()
        acc = 100.0 * float((logits.argmax(-1) == yte).mean())
        if verbose:
            print(f"Accuracy on SST-2: {acc:.2f}%")
        if self.writer is not None:
            self.writer.add_scalar("Accuracy on SST-2", acc, step)
        return {"accuracy": acc}


class MNISTValidator(_Validator):
    """Zero-shot MNIST with the digit words and the 80 templates."""

    def __init__(self, model, cfg: CLIPConfig, writer=None, image_batches_fn=None, device: DeviceLike = None):
        super().__init__(model, cfg, writer, device)
        self.image_batches_fn = image_batches_fn or (lambda: mnist_batches("test", 256, self.cfg.image_resolution))

    def validate(self, step: int, verbose: bool = False, params=None) -> Dict[str, float]:
        try:
            res = zero_shot_eval(self._model(params), MNIST_CLASSNAMES, PROMPT_TEMPLATES, self.image_batches_fn())
        except DatasetUnavailable as e:
            if verbose:
                print(f"[mnist] skipped: {e}")
            return {}
        if verbose:
            print(f"MNIST Top-1: {res['top1']:.2f}%")
        if self.writer is not None:
            self.writer.add_scalar("MNIST Top-1 accuracy", res["top1"], step)
            self.writer.add_scalar("MNIST Top-5 accuracy", res["top5"], step)
        return res


class RetrievalValidator(_Validator):
    """Image <-> text retrieval (R@1/5/10 and median rank, both directions)
    over the first ``max_samples`` pairs of a held-out ``DataSource`` (tar
    shards, a CSV manifest, an image folder, synthetic), which needs no
    remote dataset. Ranks are within that gallery; a duplicate caption may
    sort above the true pair, so a split with distinct captions reads best.
    """

    def __init__(self, model, cfg: CLIPConfig, data_source=None, writer=None, max_samples: int = 2048,
                 device: DeviceLike = None):
        super().__init__(model, cfg, writer, device)
        self.data_source = data_source
        self.max_samples = max_samples

    def validate(self, step: int, verbose: bool = False, params=None) -> Dict[str, float]:
        if self.data_source is None:
            return {}
        images, texts, n = [], [], 0
        for batch in self.data_source.iter_batches(epoch=0):
            images.append(batch["images"])
            texts.append(batch["texts"])
            n += batch["images"].shape[0]
            if n >= self.max_samples:
                break
        if n == 0:
            if verbose:
                print("[retrieval] skipped: validation source yielded no batches")
            return {}
        model = self._model(params)
        img_f = encode_images_batched(model, np.concatenate(images)[: self.max_samples])
        txt_f = encode_texts_batched(model, np.concatenate(texts)[: self.max_samples])
        sim = img_f @ txt_f.T  # [N, N]; row i's true match is column i

        res: Dict[str, float] = {"n": float(sim.shape[0])}
        eye = np.arange(sim.shape[0])
        for name, s in (("image_to_text", sim), ("text_to_image", sim.T)):
            order = np.argsort(-s, axis=-1, kind="stable")
            ranks = np.argmax(order == eye[:, None], axis=-1)
            for k in (1, 5, 10):
                res[f"{name}_r@{k}"] = float((ranks < k).mean() * 100.0)
            res[f"{name}_median_rank"] = float(np.median(ranks) + 1.0)
        if verbose:
            print(
                f"Retrieval (n={sim.shape[0]}): "
                f"I->T R@1 {res['image_to_text_r@1']:.2f}% "
                f"R@5 {res['image_to_text_r@5']:.2f}% | "
                f"T->I R@1 {res['text_to_image_r@1']:.2f}% "
                f"R@5 {res['text_to_image_r@5']:.2f}%"
            )
        if self.writer is not None:
            for key in ("image_to_text_r@1", "image_to_text_r@5", "text_to_image_r@1", "text_to_image_r@5"):
                direction = "I->T" if key.startswith("image") else "T->I"
                self.writer.add_scalar(f"Retrieval {direction} R@{key.rsplit('@', 1)[1]}", res[key], step)
        return res
