"""int8 serving accuracy gates: zero-shot top-1 agreement against the float path.

Counterpart of ``clip_mixer_tpu/evals/quant_gate.py``. Without real eval
data, the gates run on a deterministic procedural image set
(:func:`synthetic_images`, bit for bit the JAX package's for the same seed)
against a prompt-ensemble zero-shot classifier built in the float model.
Random-init weights give the smallest decision margins, where even bf16
flips top-1 predictions against f32, so the gate is relative:

    flip(int8 vs f32)  <=  max_flip_ratio * flip(bf16 vs f32)

the int8 path may add at most a bounded multiple of the top-1 instability
bf16 numerics already introduce. The three paths run one set of weights:
the f32 path is a second :class:`CLIP` with ``compute_dtype="float32"``
that loads the model's state dict.

The gates take a port ``CLIP`` (the model's ``cfg`` is the config) and
uint8 images or token ids as numpy; they run on the model's device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from clip_mixer_tpu_torch.device import compute_dtype
from clip_mixer_tpu_torch.models.clip import CLIP, l2_normalize
from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess, normalize_images
from clip_mixer_tpu_torch.ops.quant import (
    calibrate_vision_tower,
    encode_image_q,
    encode_image_q_patches,
    image_quant_fns,
    make_planar_front_end,
    quantize_vision_tower,
    text_quant_fns,
)


def synthetic_images(n: int, res: int, seed: int = 0) -> np.ndarray:
    """Deterministic structured uint8 image set [n, res, res, 3].

    Mixes low-frequency gradients, oriented stripes, checkerboards, radial
    blobs and filtered noise so patch statistics span the range a natural
    preprocessing front-end sees (not just iid noise, which under-excites
    the outlier activations that stress int8 scales).
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
    imgs = np.empty((n, res, res, 3), np.float32)
    for i in range(n):
        kind = i % 5
        if kind == 0:  # linear gradient, random direction per channel
            d = rng.normal(size=(3, 2))
            base = np.stack([d[c, 0] * xx + d[c, 1] * yy for c in range(3)], -1)
        elif kind == 1:  # oriented stripes
            f = rng.uniform(2, 24)
            th = rng.uniform(0, np.pi)
            s = np.sin(2 * np.pi * f * (np.cos(th) * xx + np.sin(th) * yy))
            base = np.stack([s * rng.uniform(0.5, 1.0) for _ in range(3)], -1)
        elif kind == 2:  # checkerboard
            k = int(rng.integers(4, 32))
            s = ((np.floor(xx * k) + np.floor(yy * k)) % 2) * 2 - 1
            base = np.stack([s, -s, s * rng.uniform(-1, 1)], -1)
        elif kind == 3:  # radial blobs
            cx, cy = rng.uniform(0.2, 0.8, 2)
            r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
            base = np.stack([np.exp(-r / rng.uniform(0.05, 0.4)) for _ in range(3)], -1)
        else:  # smoothed noise (k x k box filter via integral image)
            k = int(rng.integers(1, 8))
            z = rng.normal(size=(res + k, res + k, 3)).astype(np.float32)
            pad = np.zeros((res + k + 1, res + k + 1, 3), np.float32)
            pad[1:, 1:] = np.cumsum(np.cumsum(z, 0), 1)
            base = (
                pad[k : res + k, k : res + k]
                - pad[:res, k : res + k]
                - pad[k : res + k, :res]
                + pad[:res, :res]
            ) / (k * k)
        lo, hi = base.min(), base.max()
        imgs[i] = (base - lo) / max(hi - lo, 1e-6)
    return (imgs * 255).astype(np.uint8)


def build_float_classifier(model, classnames: Sequence[str], templates: Sequence[str],
                           batch_size: int = 256) -> np.ndarray:
    """Prompt-ensemble classifier [embed_dim, n_classes] in the float model,
    shared by every path: the gates isolate the image encoder."""
    from clip_mixer_tpu_torch.evals.zeroshot import build_zeroshot_classifier

    return build_zeroshot_classifier(model, list(classnames), list(templates), batch_size)


def float32_twin(model) -> CLIP:
    """A CLIP with ``compute_dtype="float32"`` on ``model``'s device holding
    ``model``'s weights: the gates' f32 reference path."""
    twin = CLIP(model.cfg.replace(compute_dtype="float32"), device=model.device)
    twin.load_state_dict(model.state_dict())
    return twin.eval()


@torch.inference_mode()
def _batched_feats(fn, module, inputs: np.ndarray, batch_size: int, device) -> np.ndarray:
    """``fn(module, batch)`` over ``inputs`` at one batch shape (the tail
    zero-padded, then sliced), as f32 numpy."""
    outs: List[np.ndarray] = []
    for i in range(0, inputs.shape[0], batch_size):
        chunk = inputs[i : i + batch_size]
        take = chunk.shape[0]
        if take < batch_size:
            chunk = np.concatenate([chunk, np.zeros((batch_size - take,) + chunk.shape[1:], chunk.dtype)])
        feats = fn(module, torch.from_numpy(np.ascontiguousarray(chunk)).to(device))
        outs.append(feats.float().cpu().numpy()[:take])
    return np.concatenate(outs)


def _image_fn(dtype, encode=None):
    """uint8 -> normalise in ``dtype`` -> ``encode(module, images)`` (the
    float model's own encoder when None) -> L2-normalised."""

    def fn(module, images_u8):
        x = normalize_images(images_u8, dtype=dtype)
        return l2_normalize(module.encode_image(x) if encode is None else encode(module, x))

    return fn


def zeroshot_top1_agreement(model, images_u8: np.ndarray, classifier: np.ndarray, calibrate_n: int = 128,
                            batch_size: int = 256) -> Dict[str, float]:
    """Float against calibrated-int8 zero-shot predictions: {agreement, n,
    min_cosine, mean_cosine, median_margin, flip_margin_max}. ``margin`` is
    the float top1-top2 logit gap; ``flip_margin_max`` the largest float
    margin among disagreeing images."""
    dt = compute_dtype(model.cfg.compute_dtype)
    calibrate, quantize, encode_q = image_quant_fns(model.cfg)
    dev = model.device
    with torch.inference_mode():
        scales = calibrate(model, normalize_images(torch.from_numpy(images_u8[:calibrate_n]).to(dev), dtype=dt))
    qvis = quantize(model, scales)
    ff = _batched_feats(_image_fn(dt), model, images_u8, batch_size, dev)
    fq = _batched_feats(_image_fn(dt, encode_q), qvis, images_u8, batch_size, dev)

    cos = (ff * fq).sum(-1)
    logits_f = 100.0 * ff @ classifier
    logits_q = 100.0 * fq @ classifier
    agree = logits_f.argmax(-1) == logits_q.argmax(-1)
    sorted_f = np.sort(logits_f, -1)
    margin = sorted_f[:, -1] - sorted_f[:, -2]
    flips = margin[~agree]
    return {
        "agreement": float(agree.mean()),
        "n": int(images_u8.shape[0]),
        "min_cosine": float(cos.min()),
        "mean_cosine": float(cos.mean()),
        "median_margin": float(np.median(margin)),
        "flip_margin_max": float(flips.max()) if flips.size else 0.0,
    }


def noise_floor_gate(model, images_u8: np.ndarray, classifier: np.ndarray, calibrate_n: int = 128,
                     batch_size: int = 256, max_flip_ratio: float = 2.5, a_scales=None) -> Dict[str, float]:
    """The int8 image gate relative to the numerics noise floor, on
    model-sized uint8 images. ``a_scales``: gate these activation scales
    (an artifact's) instead of calibrating on the first ``calibrate_n``
    images. Returns the flip rates, their ratio with Wilson intervals, and
    ``passed``."""
    dt = compute_dtype(model.cfg.compute_dtype)
    dev = model.device
    calibrate, quantize, encode_q = image_quant_fns(model.cfg)
    if a_scales is None:
        with torch.inference_mode():
            sample = normalize_images(torch.from_numpy(images_u8[:calibrate_n]).to(dev), dtype=dt)
            a_scales = calibrate(model, sample)
    qvis = quantize(model, a_scales)
    ff32 = _batched_feats(_image_fn(torch.float32), float32_twin(model), images_u8, batch_size, dev)
    fbf = _batched_feats(_image_fn(dt), model, images_u8, batch_size, dev)
    fq = _batched_feats(_image_fn(dt, encode_q), qvis, images_u8, batch_size, dev)
    return _flip_stats(ff32, fbf, fq, classifier, max_flip_ratio)


def _wilson(k: int, n: int, z: float = 1.959964) -> tuple:
    """Wilson 95% score interval for a binomial proportion k/n."""
    if n == 0:
        return (0.0, 1.0)
    z2 = z * z
    center = (k + z2 / 2.0) / (n + z2)
    half = (z / (n + z2)) * np.sqrt(k * (n - k) / n + z2 / 4.0)
    return (max(0.0, center - half), min(1.0, center + half))


def _flip_verdict(t32, t16, tq, cos_q, max_flip_ratio: float) -> Dict[str, float]:
    """The shared noise-floor verdict from three top-1 prediction vectors:
    flip(int8 vs f32) <= max_flip_ratio * flip(bf16 vs f32).

    The flip counts are binomial draws, so the dict carries Wilson 95% CIs
    on both flip rates plus a conservative interval on the ratio itself
    (numerator upper / denominator lower, with the same 1/n floor as the
    point estimate) and ``margin_to_budget`` = budget - ratio, so drift
    toward the budget shows before a hard failure. ``flip_ratio_ci_high`` >
    budget with ``passed`` still true means the pass is not statistically
    resolved at this n."""
    n = int(t32.shape[0])
    k_bf16 = int((t32 != t16).sum())
    k_int8 = int((t32 != tq).sum())
    flip_bf16 = k_bf16 / n
    flip_int8 = k_int8 / n
    # +1 pseudo-flip in the denominator guards div-by-zero on tiny sets.
    floor = 1.0 / n
    ratio = flip_int8 / max(flip_bf16, floor)
    lo_q, hi_q = _wilson(k_int8, n)
    lo_b, hi_b = _wilson(k_bf16, n)
    ratio_lo = lo_q / max(hi_b, floor)
    ratio_hi = hi_q / max(lo_b, floor)
    return {
        "n": n,
        "flips_bf16": k_bf16,
        "flips_int8": k_int8,
        "flip_bf16_vs_f32": float(flip_bf16),
        "flip_int8_vs_f32": float(flip_int8),
        "flip_bf16_ci95": [float(lo_b), float(hi_b)],
        "flip_int8_ci95": [float(lo_q), float(hi_q)],
        "flip_ratio": float(ratio),
        "flip_ratio_ci_low": float(ratio_lo),
        "flip_ratio_ci_high": float(ratio_hi),
        "max_flip_ratio": float(max_flip_ratio),
        "margin_to_budget": float(max_flip_ratio - ratio),
        "agreement_int8_vs_bf16": float((t16 == tq).mean()),
        "min_cosine_int8_vs_f32": float(cos_q.min()),
        "passed": bool(ratio <= max_flip_ratio),
    }


def _flip_stats(ff32, fbf, fq, classifier, max_flip_ratio: float) -> Dict[str, float]:
    """:func:`_flip_verdict` from three feature banks + a classifier."""
    t32 = (100.0 * ff32 @ classifier).argmax(-1)
    t16 = (100.0 * fbf @ classifier).argmax(-1)
    tq = (100.0 * fq @ classifier).argmax(-1)
    cos_q = (ff32 * fq).sum(-1)
    return _flip_verdict(t32, t16, tq, cos_q, max_flip_ratio)


def frontend_noise_floor_gate(model, images_u8_src: np.ndarray, classifier: np.ndarray, calibrate_n: int = 128,
                              batch_size: int = 256, max_flip_ratio: float = 2.5, a_scales=None,
                              front_end: str = "planar") -> Dict[str, float]:
    """:func:`noise_floor_gate` with the resize front end inside every path,
    from uint8 at the source resolution [N, H, W, 3]:

      f32:  f32 resize + normalise            -> f32 tower
      bf16: the bf16 preprocess               -> bf16 tower
      int8: ``front_end="planar"``: the planar front end (bf16 resize ->
            int8 patches, ``ops/quant.py``) -> int8 tower;
            ``front_end="nhwc"``: the bf16 preprocess -> ``encode_image_q``.

    Mixer towers only, as the JAX package's: a ViT or ResNet tower's image
    gate is :func:`noise_floor_gate`, through the float front end."""
    if front_end not in ("planar", "nhwc"):
        raise ValueError(f"front_end must be 'planar' or 'nhwc', got {front_end!r}")
    cfg, dev = model.cfg, model.device
    if cfg.is_resnet or cfg.use_transformer:
        raise ValueError("the front-end gate serves Mixer towers; gate a ViT or ResNet tower with noise_floor_gate")
    dt = compute_dtype(cfg.compute_dtype)
    hw = tuple(images_u8_src.shape[1:3])
    pre32 = make_batch_preprocess(hw, cfg.image_resolution, normalize=True, dtype=torch.float32)
    pre = make_batch_preprocess(hw, cfg.image_resolution, normalize=True, dtype=dt)
    if a_scales is None:
        with torch.inference_mode():
            a_scales = calibrate_vision_tower(model, pre(torch.from_numpy(images_u8_src[:calibrate_n]).to(dev)))
    qvis = quantize_vision_tower(model, a_scales)
    if front_end == "planar":
        front = make_planar_front_end(cfg, hw, qvis.a_patch)

        def f_int8(q, x):
            return l2_normalize(encode_image_q_patches(q, front(x)))
    else:
        def f_int8(q, x):
            return l2_normalize(encode_image_q(q, pre(x)))

    ff32 = _batched_feats(lambda m, x: l2_normalize(m.encode_image(pre32(x))), float32_twin(model), images_u8_src,
                          batch_size, dev)
    fbf = _batched_feats(lambda m, x: l2_normalize(m.encode_image(pre(x))), model, images_u8_src, batch_size, dev)
    fq = _batched_feats(f_int8, qvis, images_u8_src, batch_size, dev)
    return _flip_stats(ff32, fbf, fq, classifier, max_flip_ratio)


def text_noise_floor_gate(model, texts: np.ndarray, image_bank: np.ndarray, calibrate_n: int = 128,
                          batch_size: int = 256, max_flip_ratio: float = 2.5, a_scales=None) -> Dict[str, float]:
    """The noise-floor gate of the text tower: each tokenized text [N,
    context_length] retrieves its top-1 image from a float image-feature
    bank ``image_bank`` [embed_dim, M], and the int8 path's flip rate
    against f32 must stay within ``max_flip_ratio`` times bf16's."""
    dev = model.device
    calibrate, quantize, encode_q = text_quant_fns(model.cfg)
    if a_scales is None:
        with torch.inference_mode():
            a_scales = calibrate(model, torch.from_numpy(np.ascontiguousarray(texts[:calibrate_n])).to(dev))
    qtext = quantize(model, a_scales)

    def f_float(m, t):
        return l2_normalize(m.encode_text(t))

    ff32 = _batched_feats(f_float, float32_twin(model), texts, batch_size, dev)
    fbf = _batched_feats(f_float, model, texts, batch_size, dev)
    fq = _batched_feats(lambda q, t: l2_normalize(encode_q(q, t)), qtext, texts, batch_size, dev)
    t32 = (100.0 * ff32 @ image_bank).argmax(-1)
    t16 = (100.0 * fbf @ image_bank).argmax(-1)
    tq = (100.0 * fq @ image_bank).argmax(-1)
    return _flip_verdict(t32, t16, tq, (ff32 * fq).sum(-1), max_flip_ratio)
