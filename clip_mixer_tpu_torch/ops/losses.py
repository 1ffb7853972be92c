"""Contrastive losses, on one device and across a process group: InfoNCE and SigLIP.

Counterpart of ``clip_mixer_tpu/ops/losses.py``:

* :func:`info_nce` is the reference's symmetric softmax loss. The keys of
  each logit matrix (the other modality's features) are detached unless
  ``grad_through_gather``, as the reference detaches its gathered features:
  the default gradient flows only through the query side, on one device as
  on many. ``chunk_size`` streams the keys in chunks with an online
  logsumexp, so the full [B, B] f32 matrix is never held.
* :func:`siglip_loss` is the pairwise sigmoid loss with a learnable bias.

The JAX functions take a mesh axis name; the port's take a process group
(``None``: one device, the global batch is the local one). Across a group
each rank holds its rows of the global batch and returns its own loss, a
mean over its rows, whose average over the ranks is the global loss:

* :func:`info_nce` all-gathers both feature matrices (tiled, rank order)
  and scores its rows against every column, labels ``arange(local_b) +
  rank * local_b``. Without ``grad_through_gather`` the gathered keys are
  detached (JAX's ``stop_gradient``); with it the gather stays in the
  graph, and its backward is a reduce-scatter by SUM, the transpose of
  JAX's ``all_gather``;
* :func:`siglip_loss` runs the paper's section 3.3 ring: at each of the
  ``n`` ticks a rank scores its images against the text chunk it holds,
  then passes the chunk to the next rank (:class:`_RingPass`, whose
  backward sends the cotangents back the other way, as the transpose of
  JAX's ``ppermute``). The positives are at the first tick only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from clip_mixer_tpu_torch.parallel.dist import world


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n * b, ...]: every rank's ``x`` in rank order."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    """:func:`_gather_rows` in the graph: the backward sums every rank's
    cotangent of this rank's rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // dist.get_world_size(ctx.group),) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def gather_features(x: torch.Tensor, group, grad: bool) -> torch.Tensor:
    """Every rank's features in rank order; ``grad``: gradients reach the
    ranks that own the rows, else the result is detached."""
    if grad:
        return _GatherRows.apply(x, group)
    with torch.no_grad():
        return _gather_rows(x.detach(), group)


def _pass_to(x: torch.Tensor, group, hop: int) -> torch.Tensor:
    """Send ``x`` to rank ``(r + hop) % n`` and return what rank
    ``(r - hop) % n`` sent (one ``batch_isend_irecv`` pair)."""
    rank, n = world(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (rank + hop) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (rank - hop) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingPass(torch.autograd.Function):
    """One hop of the ring: a chunk goes to the next rank; its cotangent
    goes back to the rank it came from."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _pass_to(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _pass_to(g, ctx.group, -1), None


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
    temperature itself (exp of the parameter). Returns this rank's mean
    loss over its rows (the mean over the ranks is the global loss)."""
    scale = logit_scale.float()
    rank, _ = world(group)
    if group is None:
        keys_img, keys_txt = image_features, text_features
        if not grad_through_gather:
            keys_img, keys_txt = keys_img.detach(), keys_txt.detach()
    else:
        keys_img = gather_features(image_features, group, grad_through_gather)
        keys_txt = gather_features(text_features, group, grad_through_gather)
    local_b = image_features.shape[0]
    labels = torch.arange(local_b, device=image_features.device) + rank * local_b
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
    ``logit_bias`` the raw bias b. Exact gradient on both sides. Across a
    group, this rank's rows against every rank's texts through the ring,
    normalised by the local batch (the mean over the ranks is the global
    loss)."""
    local_b = image_features.shape[0]
    img = image_features.float()
    eye = torch.eye(local_b, dtype=torch.bool, device=img.device)

    def block_loss(txt, positives):
        logits = logit_scale.float() * (img @ txt.float().t()) + logit_bias.float()
        z = torch.where(positives, 1.0, -1.0)
        return -F.logsigmoid(z * logits).sum()

    total = block_loss(text_features, eye)
    _, n = world(group)
    txt = text_features
    for _ in range(1, n):  # JAX's last hop, which returns each chunk to its owner, is left out
        txt = _RingPass.apply(txt, group)
        total = total + block_loss(txt, torch.zeros_like(eye))
    return total / local_b


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
