"""Contrastive losses on one device: InfoNCE and SigLIP.

Counterpart of ``clip_mixer_tpu/ops/losses.py``:

* :func:`info_nce` is the reference's symmetric softmax loss. The keys of
  each logit matrix (the other modality's features) are detached unless
  ``grad_through_gather``, as the reference detaches its gathered features:
  the default gradient flows only through the query side, on one device as
  on many. ``chunk_size`` streams the keys in chunks with an online
  logsumexp, so the full [B, B] f32 matrix is never held.
* :func:`siglip_loss` is the pairwise sigmoid loss with a learnable bias.

The JAX functions take a mesh axis name and gather across it; the port's
take a process group, and only ``None`` (one device) is ported: the
multi-device forms wait for the parallel layer (ROADMAP.md, Slice F).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _single_device(group) -> None:
    if group is not None:
        raise NotImplementedError(
            "the cross-device contrastive losses are not ported yet (ROADMAP.md, Slice F); pass group=None"
        )


def _cross_entropy_rows(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row CE in f32: logsumexp(row) - row[label]."""
    logits = logits.float()
    picked = logits.gather(1, labels[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - picked


def _chunked_ce(queries, keys, scale, labels, chunk: int) -> torch.Tensor:
    """CE over rows of scale * queries @ keys.T without the full [Q, K]
    matrix: a loop over K-chunks with a streaming logsumexp."""
    Q, K = queries.shape[0], keys.shape[0]
    if K % chunk:
        raise ValueError(f"global batch {K} not divisible by chunk {chunk}")
    q32 = queries.float()
    m = torch.full((Q,), float("-inf"), device=queries.device)
    s = torch.zeros(Q, device=queries.device)
    picked = torch.zeros(Q, device=queries.device)
    for idx in range(K // chunk):
        kc = keys[idx * chunk:(idx + 1) * chunk]
        logits = scale * (q32 @ kc.float().t())  # [Q, chunk]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
        # the positive logit, where it lives in this chunk
        local = labels - idx * chunk
        in_chunk = (local >= 0) & (local < chunk)
        got = logits.gather(1, local.clamp(0, chunk - 1)[:, None])[:, 0]
        picked = torch.where(in_chunk, got, picked)
        m = m_new
    return m + torch.log(s) - picked


def info_nce(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    group=None,
    grad_through_gather: bool = False,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """Symmetric InfoNCE over L2-normalised features; ``logit_scale`` is the
    temperature itself (exp of the parameter). Returns the mean loss."""
    _single_device(group)
    scale = logit_scale.float()
    keys_img, keys_txt = image_features, text_features
    if not grad_through_gather:
        keys_img, keys_txt = keys_img.detach(), keys_txt.detach()
    labels = torch.arange(image_features.shape[0], device=image_features.device)
    if chunk_size is None:
        logits_t2i = scale * text_features.float() @ keys_img.float().t()
        logits_i2t = scale * image_features.float() @ keys_txt.float().t()
        loss_t = _cross_entropy_rows(logits_t2i, labels)
        loss_i = _cross_entropy_rows(logits_i2t, labels)
    else:
        loss_t = _chunked_ce(text_features, keys_img, scale, labels, chunk_size)
        loss_i = _chunked_ce(image_features, keys_txt, scale, labels, chunk_size)
    return 0.5 * (loss_t.mean() + loss_i.mean())


def siglip_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    logit_bias: torch.Tensor,
    group=None,
) -> torch.Tensor:
    """Pairwise sigmoid loss, -1/B sum_ij log sigmoid(z_ij (t x_i.y_j + b))
    with z_ij = +1 iff i == j; ``logit_scale`` is t = exp(parameter) and
    ``logit_bias`` the raw bias b. Exact gradient on both sides."""
    _single_device(group)
    local_b = image_features.shape[0]
    logits = logit_scale.float() * (image_features.float() @ text_features.float().t()) + logit_bias.float()
    eye = torch.eye(local_b, dtype=torch.bool, device=logits.device)
    z = torch.where(eye, 1.0, -1.0)
    return -F.logsigmoid(z * logits).sum() / local_b


def loss_param_keys(kind: str) -> tuple:
    """The scalar parameters the objective differentiates directly."""
    return ("logit_scale", "logit_bias") if kind == "siglip" else ("logit_scale",)


def contrastive_loss(
    kind: str,
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    scale: torch.Tensor,
    logit_bias: Optional[torch.Tensor] = None,
    group=None,
    grad_through_gather: bool = False,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """The one objective dispatch of the train step (``TrainConfig.loss``):
    ``grad_through_gather`` and ``chunk_size`` are InfoNCE's, ``logit_bias``
    is SigLIP's."""
    if kind == "info_nce":
        return info_nce(image_features, text_features, scale, group=group,
                        grad_through_gather=grad_through_gather, chunk_size=chunk_size)
    if kind == "siglip":
        if logit_bias is None:
            raise ValueError(
                "siglip loss needs a learnable 'logit_bias' param: init the model with "
                "CLIPConfig(logit_bias_init=-10.0)"
            )
        return siglip_loss(image_features, text_features, scale, logit_bias, group=group)
    raise ValueError(f"unknown contrastive loss {kind!r} (info_nce|siglip)")
