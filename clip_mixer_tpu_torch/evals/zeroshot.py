"""Zero-shot classifier: the prompt-ensemble head.

Counterpart of ``build_zeroshot_classifier`` in
``clip_mixer_tpu/evals/zeroshot.py``: per class, encode every filled
template, L2-normalise, average, normalise again. The rest of that module
(the top-k validation loop) waits for ROADMAP.md Slice E.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from clip_mixer_tpu_torch.text.tokenize import tokenize


@torch.inference_mode()
def encode_texts_batched(model, tokens: np.ndarray, batch_size: int = 1024) -> np.ndarray:
    """[N, context_length] token ids through ``model.encode_text`` in batches
    of ``batch_size`` (the last zero-padded), as f32 numpy [N, embed_dim],
    not normalised."""
    out = []
    for i in range(0, tokens.shape[0], batch_size):
        chunk = tokens[i : i + batch_size]
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.zeros((pad, chunk.shape[1]), chunk.dtype)])
        feats = model.encode_text(torch.from_numpy(chunk).to(model.device))
        out.append(feats.float().cpu().numpy()[: batch_size - pad])
    return np.concatenate(out)


def build_zeroshot_classifier(model, classnames: Sequence[str], templates: Sequence[str],
                              batch_size: int = 1024) -> np.ndarray:
    """W: f32 [embed_dim, n_classes], norm(mean(norm(encode(prompts)))) per class."""
    prompts = [t.format(c) for c in classnames for t in templates]
    tokens = tokenize(prompts, model.cfg.context_length, truncate=True)
    feats = encode_texts_batched(model, tokens, batch_size)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    class_emb = feats.reshape(len(classnames), len(templates), -1).mean(axis=1)
    class_emb /= np.linalg.norm(class_emb, axis=-1, keepdims=True)
    return class_emb.T.astype(np.float32)
