"""Zero-shot classification: the prompt-ensemble head, batched encoders and top-k.

Counterpart of ``clip_mixer_tpu/evals/zeroshot.py``. Per class, every
filled template is encoded and L2-normalised, the class's features are
averaged and normalised again, and the columns stack into W [embed_dim,
n_classes]; an image's logits are ``100 * normalised features @ W``. All
prompts are tokenized at once and encoded in fixed-size batches (the last
zero-padded, as the JAX package pads to its one compiled shape), on the
model's device under ``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from clip_mixer_tpu_torch.device import compute_dtype
from clip_mixer_tpu_torch.models.clip import l2_normalize
from clip_mixer_tpu_torch.ops.preprocess import normalize_images
from clip_mixer_tpu_torch.text.tokenize import tokenize


def _padded_chunks(arr: np.ndarray, batch_size: int):
    """(chunk zero-padded to ``batch_size`` rows, its real row count) over ``arr``."""
    for i in range(0, arr.shape[0], batch_size):
        chunk = arr[i : i + batch_size]
        n = chunk.shape[0]
        if n < batch_size:
            chunk = np.concatenate([chunk, np.zeros((batch_size - n,) + chunk.shape[1:], chunk.dtype)])
        yield chunk, n


@torch.inference_mode()
def encode_texts_batched(model, tokens: np.ndarray, batch_size: int = 1024, normalize: bool = True) -> np.ndarray:
    """[N, context_length] token ids through ``model.encode_text`` in batches
    of ``batch_size``, as f32 numpy [N, embed_dim], L2-normalised unless
    ``normalize=False``."""
    out: List[np.ndarray] = []
    for chunk, n in _padded_chunks(np.asarray(tokens), batch_size):
        feats = model.encode_text(torch.from_numpy(chunk).to(model.device))
        out.append(feats.float().cpu().numpy()[:n])
    feats = np.concatenate(out)
    if normalize:
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    return feats


def _image_features(model, images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] on the model's device -> f32 L2-normalised features."""
    images = normalize_images(images_u8, dtype=compute_dtype(model.cfg.compute_dtype))
    return l2_normalize(model.encode_image(images)).float()


@torch.inference_mode()
def encode_images_batched(model, images_u8: np.ndarray, batch_size: int = 256) -> np.ndarray:
    """[N, H, W, 3] uint8 images through ``model.encode_image`` in batches of
    ``batch_size`` (normalised in ``cfg.compute_dtype``), as L2-normalised
    f32 numpy [N, embed_dim]."""
    out: List[np.ndarray] = []
    for chunk, n in _padded_chunks(np.asarray(images_u8), batch_size):
        out.append(_image_features(model, torch.from_numpy(chunk).to(model.device)).cpu().numpy()[:n])
    return np.concatenate(out)


def class_embeddings(feats: np.ndarray, n_classes: int, n_templates: int) -> np.ndarray:
    """Normalised prompt features [n_classes * n_templates, D] (class-major)
    -> W: f32 [D, n_classes], norm(mean over templates) per class."""
    class_emb = feats.reshape(n_classes, n_templates, -1).mean(axis=1)
    class_emb /= np.linalg.norm(class_emb, axis=-1, keepdims=True)
    return class_emb.T.astype(np.float32)


def build_zeroshot_classifier(model, classnames: Sequence[str], templates: Sequence[str],
                              batch_size: int = 1024) -> np.ndarray:
    """W: f32 [embed_dim, n_classes], norm(mean(norm(encode(prompts)))) per class."""
    prompts = [t.format(c) for c in classnames for t in templates]
    tokens = tokenize(prompts, model.cfg.context_length, truncate=True)
    feats = encode_texts_batched(model, tokens, batch_size)
    return class_embeddings(feats, len(classnames), len(templates))


def make_image_classifier(model, classifier_weights: np.ndarray) -> Callable:
    """uint8 images [B, H, W, 3] -> f32 numpy logits ``100 * feats @ W``,
    with W held on the model's device."""
    w = torch.as_tensor(np.asarray(classifier_weights, np.float32), device=model.device)

    @torch.inference_mode()
    def classify(images_u8) -> np.ndarray:
        feats = _image_features(model, torch.as_tensor(np.asarray(images_u8)).to(model.device))
        return (100.0 * feats @ w).cpu().numpy()

    return classify


def topk_accuracy(logits: np.ndarray, targets: np.ndarray, ks: Tuple[int, ...] = (1, 5)) -> List[float]:
    """Fraction correct at each k."""
    order = np.argsort(-logits, axis=-1)
    out = []
    for k in ks:
        hit = (order[:, :k] == targets[:, None]).any(axis=1)
        out.append(float(hit.mean()))
    return out


def zero_shot_eval(model, classnames: Sequence[str], templates: Sequence[str], image_batches,
                   batch_size: int = 256) -> dict:
    """The zero-shot pipeline over (uint8 images [B, H, W, 3], int targets
    [B]) batches, each zero-padded to ``batch_size`` rows. Returns
    ``{"top1": %, "top5": %}``."""
    w = build_zeroshot_classifier(model, classnames, templates)
    classify = make_image_classifier(model, w)
    top1 = top5 = n = 0.0
    for images, targets in image_batches:
        images = np.asarray(images)
        b = images.shape[0]
        pad = (-b) % batch_size
        if pad:
            images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
        logits = classify(images)[:b]
        a1, a5 = topk_accuracy(logits, np.asarray(targets), (1, 5))
        top1 += a1 * b
        top5 += a5 * b
        n += b
    if n == 0:
        raise ValueError("image_batches yielded no batches")
    return {"top1": 100.0 * top1 / n, "top5": 100.0 * top5 / n}
