"""int8 (W8A8) serving path for the Mixer towers.

Counterpart of the Mixer part of ``clip_mixer_tpu/ops/quant.py``. The
FLOPs-heavy products, the patch embed and both channel-mix linears of every
block, run int8 x int8 -> int32 (``torch._int_mm``) with symmetric
per-output-channel weight scales. The token mixes, the LayerNorms, the
residuals and both final projections stay in the compute dtype, as in the
JAX package: the projections are a sliver of the FLOPs but carry much of the
int8 feature error.

Activation scales are static (calibrated: :func:`calibrate_vision_tower` and
:func:`calibrate_text_tower` measure the 0.9999 quantile of |activation| at
each quantisation site on sample inputs) or, without them, dynamic (per-row
max). The quantised towers are modules, :class:`QuantVisionTower` and
:class:`QuantTextTower`, that hold the int8 weights, the f32 weight scales
and the activation scales as buffers and share the float model's token
mixes, LayerNorms, embeddings and projections by reference.

Rounding follows the JAX package: quantisation divides by the scale (no
reciprocal), rounds half to even, clips to [-127, 127]; the int32
accumulator goes to f32, is multiplied by the activation scale, then by the
weight scale, and is cast to the compute dtype before a bias is added.

Weights are stored ``[out, in]`` (``nn.Linear``'s layout) and handed to
``torch._int_mm`` as the transposed view, the layout it runs fastest on the
H100. On CUDA ``_int_mm`` wants more than 16 rows and K, N multiples of 8,
which every Mixer-B/32 shape meets.

The planar front end (:func:`make_planar_front_end`) takes uint8 NHWC at a
source resolution to the int8 c-major patches the vision tower's int8 patch
embed reads (:func:`encode_image_q_patches`): the resize of
``ops/preprocess.py`` as two products over channel planes, then normalise,
quantise and patchify in int8.

Transformer and ResNet towers have no int8 path here yet (ROADMAP.md,
Slice D).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.device import compute_dtype
from clip_mixer_tpu_torch.models.layers import layer_norm, quick_gelu, token_mix_branch
from clip_mixer_tpu_torch.models.mixer import MixerBlock, token_mix
from clip_mixer_tpu_torch.models.towers import patchify

QMAX = 127.0


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d``, correctly rounded on every device. PyTorch's CUDA division
    by a Python (CPU) scalar multiplies by the scalar's reciprocal, which can
    land one ulp away; dividing by a tensor on ``x``'s device does not."""
    if isinstance(d, torch.Tensor):
        return x / d.to(x.device)  # a 0-d CPU tensor would count as a scalar too
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[in, out] float -> {"q": int8 [in, out], "scale": f32 [out]}, symmetric
    per output channel."""
    w = w.float()
    scale = torch.clamp_min(true_div(w.abs().amax(dim=0), QMAX), 1e-8)
    q = torch.clamp(torch.round(w / scale), -QMAX, QMAX).to(torch.int8)
    return {"q": q, "scale": scale}


def quantize_activation(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` -> int8 at ``x_scale``: divide, round half to even, clip."""
    return torch.clamp(torch.round(true_div(x, x_scale)), -QMAX, QMAX).to(torch.int8)


def int8_matmul(
    x: torch.Tensor,
    wq: Mapping[str, torch.Tensor],
    x_scale: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """y = x @ dequant(wq) computed as int8 x int8 -> int32 on x [..., in].

    ``wq["q"]`` is int8 [in, out] in any layout (the quant modules pass the
    transposed view of their [out, in] buffers). ``x_scale`` None quantises
    each row by its own max (dynamic); a scalar tensor is the calibrated
    static scale."""
    lead, k = x.shape[:-1], x.shape[-1]
    x32 = x.reshape(-1, k).float()
    if x_scale is None:
        x_scale = torch.clamp_min(true_div(x32.abs().amax(dim=-1, keepdim=True), QMAX), 1e-8)
    acc = torch._int_mm(quantize_activation(x32, x_scale), wq["q"])
    out = (acc.float() * x_scale * wq["scale"]).to(out_dtype)
    return out.reshape(*lead, out.shape[-1])


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of all of ``x``, as ``numpy.quantile`` computes it
    on float32 data (its default linear interpolation, in float32 with q
    cast to float32, as ``jnp.quantile`` too), as an f32 0-d tensor on
    ``x``'s device.

    ``torch.quantile`` refuses inputs above 2^24 elements; this selects the
    two order statistics it needs with ``topk`` over the largest
    ``n - floor(q (n - 1))`` values, few for a high quantile."""
    f32 = np.float32
    flat = x.reshape(-1).float()
    n = flat.numel()
    pos = f32(n - 1) * f32(q)
    lo = min(int(np.floor(pos)), n - 1)
    hi = min(lo + 1, n - 1)
    t = f32(pos - f32(lo))
    # the (n - lo) largest values, descending: the last is order statistic
    # lo, the one before it order statistic lo + 1
    top = torch.topk(flat, n - lo, sorted=True).values
    a, b = f32(top[-1].item()), f32(top[-1 - (hi - lo)].item())
    d = f32(b - a)
    # numpy's _lerp: a + (b - a) t, taken from b's side when t >= 0.5
    out = f32(b - f32(d * f32(f32(1) - t))) if t >= 0.5 else f32(a + f32(d * t))
    return torch.tensor(out, dtype=torch.float32, device=x.device)


def _site_scale(x: torch.Tensor, q: float) -> torch.Tensor:
    """A quantisation site's static scale: max(quantile(|x|, q) / 127, 1e-8)."""
    return torch.clamp_min(true_div(quantile(x.float().abs(), q), QMAX), 1e-8)


def _as_scales(a_scales: Optional[Mapping], names, device) -> Optional[Dict[str, torch.Tensor]]:
    """Scale trees (numpy, as an artifact loads them, or tensors) -> f32
    tensors on ``device``."""
    if a_scales is None:
        return None
    return {
        k: (v.detach().to(device, torch.float32).clone() if isinstance(v, torch.Tensor)
            else torch.tensor(np.asarray(v, np.float32), device=device))
        for k, v in ((k, a_scales[k]) for k in names)
    }


def _register_pack(module: nn.Module, name: str, w_in_out: torch.Tensor) -> None:
    """Quantise an [in, out] weight into ``module``'s buffers ``{name}_q``
    (int8, stored [out, in]: ``_int_mm`` reads its transposed view several
    times faster than an [in, out] buffer on the H100, ``chip_smoke.py``
    phase 6) and ``{name}_scale``."""
    with torch.no_grad():
        pack = quantize_weight(w_in_out)
    module.register_buffer(f"{name}_q", pack["q"].t().contiguous())
    module.register_buffer(f"{name}_scale", pack["scale"])


class QuantMixerBlock(nn.Module):
    """A :class:`MixerBlock` with its channel mix in int8. The token mix and
    both LayerNorms are the float block's modules; the channel-mix biases are
    its parameters."""

    def __init__(self, block: MixerBlock):
        super().__init__()
        self.layerNorm1 = block.layerNorm1
        self.token_mix_seq = block.token_mix_seq
        self.layerNorm2 = block.layerNorm2
        cm = block.channel_mix_seq
        self.b_in = cm.lin3.bias
        self.b_out = cm.lin4.bias
        _register_pack(self, "w_in", cm.lin3.weight.t())
        _register_pack(self, "w_out", cm.lin4.weight.t())

    def wq(self, name: str) -> Dict[str, torch.Tensor]:
        """``int8_matmul``'s pack for ``"w_in"`` or ``"w_out"``."""
        return {"q": getattr(self, f"{name}_q").t(), "scale": getattr(self, f"{name}_scale")}

    def forward(self, x: torch.Tensor, s_in=None, s_hidden=None) -> torch.Tensor:
        dt = x.dtype
        ln1, tm, ln2 = self.layerNorm1, self.token_mix_seq, self.layerNorm2
        x = x + token_mix_branch(x, ln1.weight, ln1.bias, tm.lin1.weight, tm.lin1.bias, tm.lin2.weight, tm.lin2.bias)
        y = layer_norm(x, ln2.weight, ln2.bias)
        h = int8_matmul(y, self.wq("w_in"), s_in, dt) + self.b_in.to(dt)
        h = quick_gelu(h)
        return x + int8_matmul(h, self.wq("w_out"), s_hidden, dt) + self.b_out.to(dt)


class _QuantTower(nn.Module):
    """What both quantised towers share: the int8 blocks and the per-layer
    activation scales (buffers ``a_ch_in`` / ``a_ch_hidden`` [L], absent
    for dynamic scales)."""

    SITES = ("ch_in", "ch_hidden")

    def _init_blocks(self, cfg: CLIPConfig, blocks, a_scales: Optional[Mapping], device) -> None:
        self.cfg = cfg
        self.blocks = nn.ModuleList(QuantMixerBlock(b) for b in blocks)
        scales = _as_scales(a_scales, self.SITES, device)
        self.static = scales is not None
        for k in self.SITES:
            self.register_buffer(f"a_{k}", None if scales is None else scales[k])

    def a_scales(self) -> Optional[Dict[str, torch.Tensor]]:
        """The activation scales under the JAX package's keys (None: dynamic)."""
        if not self.static:
            return None
        return {k: getattr(self, f"a_{k}") for k in self.SITES}

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        for i, block in enumerate(self.blocks):
            if self.static:
                x = block(x, self.a_ch_in[i], self.a_ch_hidden[i])
            else:
                x = block(x)
        return x


class QuantVisionTower(_QuantTower):
    """The Mixer vision tower with an int8 patch embed and int8 channel
    mixes. ``a_scales``: ``{"patch": (), "ch_in": [L], "ch_hidden": [L]}``
    from :func:`calibrate_vision_tower` (None: dynamic scales)."""

    SITES = ("patch", "ch_in", "ch_hidden")

    def __init__(self, visual, a_scales: Optional[Mapping] = None):
        super().__init__()
        device = visual.proj.device
        self._init_blocks(visual.cfg, visual.transformer.mixBlocks, a_scales, device)
        self.class_embedding = visual.class_embedding
        self.ln_pre = visual.ln_pre
        self.ln_post = visual.ln_post
        self.proj = visual.proj  # compute dtype by design
        _register_pack(self, "patch", visual.patch_kernel())
        self.register_buffer("patch_q_planar", None)
        self.set_planar()

    def set_planar(self) -> None:
        """Refresh the c-major copy of the patch kernel that
        :func:`encode_image_q_patches` reads (after ``patch_q`` changes)."""
        perm = torch.from_numpy(patch_perm(self.cfg.vision_patch_size)).to(self.patch_q.device)
        self.patch_q_planar = self.patch_q[:, perm].contiguous()

    def tail(self, x: torch.Tensor) -> torch.Tensor:
        """After the patch embed: CLS, ln_pre, the int8 blocks, ln_post on
        CLS, the projection. x: [B, tokens - 1, width] in the compute dtype."""
        dt = x.dtype
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, x.shape[-1])
        x = self.ln_pre(torch.cat([cls, x], dim=1))
        x = self.run_blocks(x)
        x = self.ln_post(x[:, 0, :])
        return x @ self.proj.to(dt)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return encode_image_q(self, images)


class QuantTextTower(_QuantTower):
    """The Mixer text tower with int8 channel mixes; the token embedding is
    a lookup and the projection stays in the compute dtype. ``a_scales``:
    ``{"ch_in": [L], "ch_hidden": [L]}`` from :func:`calibrate_text_tower`."""

    def __init__(self, model, a_scales: Optional[Mapping] = None):
        super().__init__()
        self._init_blocks(model.cfg, model.transformer.mixBlocks, a_scales, model.device)
        self.token_embedding = model.token_embedding
        self.ln_final = model.ln_final
        self.text_projection = model.text_projection

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        return encode_text_q(self, text)


def _require_mixer_quant(cfg: CLIPConfig) -> None:
    if cfg.is_resnet or cfg.use_transformer:
        raise NotImplementedError(
            "the int8 path of transformer and ResNet towers is not ported yet (ROADMAP.md, Slice D)"
        )


def quantize_vision_tower(model, a_scales: Optional[Mapping] = None) -> QuantVisionTower:
    """int8 copy of ``model``'s (a port CLIP) vision tower."""
    _require_mixer_quant(model.cfg)
    return QuantVisionTower(model.visual, a_scales)


def quantize_text_tower(model, a_scales: Optional[Mapping] = None) -> QuantTextTower:
    """int8 copy of ``model``'s text tower."""
    _require_mixer_quant(model.cfg)
    return QuantTextTower(model, a_scales)


@torch.no_grad()
def encode_image_q(qvis: QuantVisionTower, images: torch.Tensor) -> torch.Tensor:
    """int8 counterpart of ``VisionEncoder.forward``. images: normalised
    [B, H, W, 3]."""
    cfg = qvis.cfg
    dt = compute_dtype(cfg.compute_dtype)
    x = patchify(images.to(dt), cfg.vision_patch_size)
    x = int8_matmul(x, {"q": qvis.patch_q.t(), "scale": qvis.patch_scale}, qvis.a_patch, dt)
    return qvis.tail(x)


@torch.no_grad()
def encode_text_q(qtext: QuantTextTower, text: torch.Tensor) -> torch.Tensor:
    """int8 counterpart of the text encoder. text: int [B, context_length];
    pooled at the EOT token (the argmax id)."""
    dt = compute_dtype(qtext.cfg.compute_dtype)
    x = qtext.token_embedding.weight[text.long()].to(dt)
    x = qtext.run_blocks(x)
    x = qtext.ln_final(x).to(dt)
    eot = text.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return pooled @ qtext.text_projection.to(dt)


def _channel_sites(block: MixerBlock, h: torch.Tensor, q: float):
    """One float block as the JAX calibration runs it: (its output, the
    ch_in and ch_hidden site scales)."""
    dt = h.dtype
    cm, ln2 = block.channel_mix_seq, block.layerNorm2
    h = h + token_mix(block, h)
    y = layer_norm(h, ln2.weight, ln2.bias)
    hidden = quick_gelu(y @ cm.lin3.weight.to(dt).t() + cm.lin3.bias.to(dt))
    out = h + hidden @ cm.lin4.weight.to(dt).t() + cm.lin4.bias.to(dt)
    return out, _site_scale(y, q), _site_scale(hidden, q)


def _tower_sites(blocks, x: torch.Tensor, q: float) -> Dict[str, torch.Tensor]:
    s_in, s_hidden = [], []
    for block in blocks:
        x, a, b = _channel_sites(block, x, q)
        s_in.append(a)
        s_hidden.append(b)
    return {"ch_in": torch.stack(s_in), "ch_hidden": torch.stack(s_hidden)}


@torch.no_grad()
def calibrate_vision_tower(model, sample_images: torch.Tensor, quantile: float = 0.9999) -> Dict[str, torch.Tensor]:
    """Static activation scales of the vision tower from sample (normalised)
    images: ``{"patch": (), "ch_in": [L], "ch_hidden": [L]}``, each site's
    |activation| ``quantile`` over 127."""
    _require_mixer_quant(model.cfg)
    v, cfg = model.visual, model.cfg
    dt = compute_dtype(cfg.compute_dtype)
    x = patchify(sample_images.to(dt), cfg.vision_patch_size)
    s_patch = _site_scale(x, quantile)
    x = x @ v.patch_kernel().to(dt)
    cls = v.class_embedding.to(dt).expand(x.shape[0], 1, x.shape[-1])
    x = v.ln_pre(torch.cat([cls, x], dim=1))
    return {"patch": s_patch, **_tower_sites(v.transformer.mixBlocks, x, quantile)}


@torch.no_grad()
def calibrate_text_tower(model, sample_text: torch.Tensor, quantile: float = 0.9999) -> Dict[str, torch.Tensor]:
    """Static activation scales of the text tower from sample token ids:
    ``{"ch_in": [L], "ch_hidden": [L]}``."""
    _require_mixer_quant(model.cfg)
    dt = compute_dtype(model.cfg.compute_dtype)
    x = model.token_embedding.weight[sample_text.long()].to(dt)
    return _tower_sites(model.transformer.mixBlocks, x, quantile)


# ---- the planar front end ----------------------------------------------------


def patch_perm(patch: int) -> np.ndarray:
    """Row permutation from ``patchify``'s (ph, pw, c) patch-vector order to
    the (c, ph, pw) order the planar front end emits:
    ``kernel_planar = kernel[patch_perm(p), :]``."""
    return np.arange(patch * patch * 3).reshape(patch, patch, 3).transpose(2, 0, 1).reshape(-1)


def make_planar_front_end(cfg: CLIPConfig, input_hw, patch_scale=None):
    """The int8 serving front end: uint8 NHWC [B, H, W, 3] at ``input_hw``
    -> int8 c-major patches [B, (n_px / p)^2, 3 p p] for
    :func:`encode_image_q_patches`.

    As the JAX package computes it: the uint8 channel planes in bf16 (exact
    for 0..255), R_h applied with an f32 sum that is rounded to bf16, R_w
    applied with an f32 result (both inputs bf16 values, summed in f32:
    TF32 must be off), mean / std normalisation, quantisation at the
    calibrated ``patch_scale`` (the ``"patch"`` activation scale), then
    patchify as an int8 relayout. The returned function takes
    ``patch_scale`` as a keyword too (the engine passes its tower's); the
    resize matrices are cached on each device the function meets."""
    from clip_mixer_tpu_torch.ops.preprocess import _cached_matrices, norm_constants

    h, w = input_hw
    n_px, p = cfg.image_resolution, cfg.vision_patch_size
    g = n_px // p
    rh_np, rw_np = _cached_matrices(h, w, n_px)
    consts = {}
    default_scale = patch_scale

    def front_end(images_u8: torch.Tensor, patch_scale=None) -> torch.Tensor:
        scale = default_scale if patch_scale is None else patch_scale
        dev = images_u8.device
        if dev not in consts:
            mean, std_inv = norm_constants(dev)
            consts[dev] = (
                torch.from_numpy(rh_np).to(dev, torch.bfloat16),
                torch.from_numpy(rw_np).to(dev, torch.bfloat16).float(),
                mean.reshape(1, 3, 1, 1),
                std_inv.reshape(1, 3, 1, 1),
            )
        rh, rw32, mean, std_inv = consts[dev]
        B = images_u8.shape[0]
        x = images_u8.permute(0, 3, 1, 2).to(torch.bfloat16)  # [B, 3, H, W]
        x = torch.matmul(rh, x)  # [B, 3, n_px, W]: f32 sums, rounded to bf16
        x = torch.matmul(x.float(), rw32.t())  # [B, 3, n_px, n_px], f32
        x = (x - mean) * std_inv
        xq = quantize_activation(x, scale)
        xq = xq.reshape(B, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)  # [B, gh, gw, c, ph, pw]
        return xq.reshape(B, g * g, 3 * p * p)

    return front_end


@torch.no_grad()
def encode_image_q_patches(qvis: QuantVisionTower, patches_q: torch.Tensor) -> torch.Tensor:
    """:func:`encode_image_q` from :func:`make_planar_front_end`'s int8
    c-major patches [B, tokens - 1, 3 p p]; needs static scales (the front
    end quantised with ``a_patch``). The patch kernel's rows are read in
    c-major order from the tower's ``patch_q_planar``."""
    if not qvis.static:
        raise ValueError("encode_image_q_patches needs calibrated activation scales")
    dt = compute_dtype(qvis.cfg.compute_dtype)
    B, n, k = patches_q.shape
    acc = torch._int_mm(patches_q.reshape(B * n, k), qvis.patch_q_planar.t())
    x = (acc.float() * qvis.a_patch * qvis.patch_scale).to(dt).reshape(B, n, -1)
    return qvis.tail(x)


def image_quant_fns(cfg: CLIPConfig):
    """(calibrate, quantize, encode_q) for ``cfg``'s vision tower: the one
    dispatch the gates (``evals/quant_gate.py``) and
    ``InferenceEngine.enable_int8`` share."""
    _require_mixer_quant(cfg)
    return calibrate_vision_tower, quantize_vision_tower, encode_image_q


def text_quant_fns(cfg: CLIPConfig):
    """(calibrate, quantize, encode_q) for ``cfg``'s text tower."""
    _require_mixer_quant(cfg)
    return calibrate_text_tower, quantize_text_tower, encode_text_q
