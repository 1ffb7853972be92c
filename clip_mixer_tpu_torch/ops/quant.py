"""int8 (W8A8) serving path for the Mixer, transformer (ViT) and ResNet towers.

Counterpart of ``clip_mixer_tpu/ops/quant.py``. The
FLOPs-heavy products run int8 x int8 -> int32 (``torch._int_mm``) with
symmetric per-output-channel weight scales: the patch embed, and in every
block both channel-mix linears (Mixer) or the QKV, attention-out and both
MLP products (transformer). The token mixes, the scores and softmax, the
LayerNorms, the residuals and both final projections stay in the compute
dtype, as in the JAX package: the projections are a sliver of the FLOPs but
carry much of the int8 feature error.

Activation scales are static (calibrated: ``calibrate_*`` measure the 0.9999
quantile of |activation| at each quantisation site on sample inputs) or,
without them, dynamic (per-row max). The quantised towers are modules,
:class:`QuantVisionTower` and :class:`QuantTextTower`, that hold the int8
weights, the f32 weight scales and the activation scales as buffers and
share the float model's token mixes, LayerNorms, biases, embeddings and
projections by reference; their blocks are :class:`QuantMixerBlock` or
:class:`QuantAttentionBlock` after the float tower's kind, so
:func:`encode_image_q` and :func:`encode_text_q` serve both kinds.

Rounding follows the JAX package: quantisation divides by the scale (no
reciprocal), rounds half to even, clips to [-127, 127]; the int32
accumulator goes to f32, is multiplied by the activation scale, then by the
weight scale, and is cast to the compute dtype before a bias is added.

Weights are stored ``[out, in]`` (``nn.Linear``'s layout) and handed to
``torch._int_mm`` as the transposed view, the layout it runs fastest on the
H100. On CUDA ``_int_mm`` wants more than 16 rows and K, N multiples of 8;
a K that is not (ViT-L/14's patch, 588; the ResNet stem's first conv, 27)
is padded with zero columns, which add nothing to the integer sums: the
modules' weights once, when they are quantised, the activations at each
call.

The planar front end (:func:`make_planar_front_end`) takes uint8 NHWC at a
source resolution to the int8 c-major patches the vision tower's int8 patch
embed reads (:func:`encode_image_q_patches`): the resize of
``ops/preprocess.py`` as two products over channel planes, then normalise,
quantise and patchify in int8.

The planar front end serves Mixer towers only, as in the JAX package; a ViT
or ResNet int8 engine takes the float front end.

The ResNet tower (:class:`QuantResNet`) folds each convolution's inference
BatchNorm into its kernel and a bias (:func:`fold_bn_into_conv`), quantises
the folded kernel per output channel and its input at a calibrated static
scale (:func:`calibrate_resnet_tower`), and convolves int8 x int8 -> int32
(:func:`int8_conv`). PyTorch has no int8 convolution on CUDA and
``F.unfold`` refuses int8, so the patches are gathered from padded, shifted,
strided views of the NHWC int8 input (an im2col in (kh, kw, cin) order) and
multiplied by ``torch._int_mm``: the int32 sums of the JAX package's
``conv_general_dilated(..., preferred_element_type=int32)``. The int32
sums become ``acc * (a * scale) + bias`` in f32, then the compute dtype.
The attention pool stays in the compute dtype, shared with the float tower.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from clip_mixer_tpu_torch.config import CLIPConfig
from clip_mixer_tpu_torch.device import compute_dtype
from clip_mixer_tpu_torch.models.layers import layer_norm, quick_gelu, token_mix_branch
from clip_mixer_tpu_torch.models.mixer import MixerBlock, token_mix
from clip_mixer_tpu_torch.models.resnet import BN_EPS, attention_pool, avg_pool, conv
from clip_mixer_tpu_torch.models.towers import embed_patches, embed_text, patchify, pool_text
from clip_mixer_tpu_torch.models.transformer import ResidualAttentionBlock, attention_core

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
    acc = int_mm(quantize_activation(x32, x_scale), wq["q"])
    out = (acc.float() * x_scale * wq["scale"]).to(out_dtype)
    return out.reshape(*lead, out.shape[-1])


def pad_k(q_out_in: torch.Tensor) -> torch.Tensor:
    """An int8 [out, in] weight with zero columns up to a multiple of 8 in."""
    return nn.functional.pad(q_out_in, (0, -q_out_in.shape[1] % 8))


def int_mm(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int32 sums of int8 xq [M, k] and w [K, N] (K >= k, the rows past k
    zero: a weight padded at quantisation, :func:`pad_k`); xq takes zero
    columns up to K. A weight whose K is no multiple of 8 (a caller's
    unpadded pack) is padded here, on every call. On the card, M <= 16
    (``_int_mm`` wants more rows: a small ResNet's last stage at a small
    batch) is padded with zero rows, which are dropped from the sums."""
    if w.shape[0] % 8:  # the padded [out, in] keeps w a transposed view
        w = pad_k(w.t()).t()
    m = xq.shape[0]
    pad_m = 32 - m if xq.is_cuda and m <= 16 else 0
    if xq.shape[1] != w.shape[0] or pad_m:
        xq = nn.functional.pad(xq, (0, w.shape[0] - xq.shape[1], 0, pad_m))
    return torch._int_mm(xq, w)[:m]


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
    phase 6; ``in`` padded to a multiple of 8, :func:`pad_k`) and
    ``{name}_scale``."""
    with torch.no_grad():
        pack = quantize_weight(w_in_out)
    module.register_buffer(f"{name}_q", pad_k(pack["q"].t()).contiguous())
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


class QuantAttentionBlock(nn.Module):
    """A ``ResidualAttentionBlock`` with its QKV, attention-out and both MLP
    products in int8; the LayerNorms are the float block's modules, the
    biases its parameters, and ``mask`` its tower's (None: unmasked)."""

    def __init__(self, block: ResidualAttentionBlock, mask: Optional[torch.Tensor]):
        super().__init__()
        self.n_heads = block.n_heads
        self.ln_1, self.ln_2 = block.ln_1, block.ln_2
        attn, mlp = block.attn, block.mlp
        self.qkv_bias, self.out_bias = attn.in_proj_bias, attn.out_proj.bias
        self.b_in, self.b_out = mlp.c_fc.bias, mlp.c_proj.bias
        for name, w in (("qkv", attn.in_proj_weight), ("out", attn.out_proj.weight), ("w_in", mlp.c_fc.weight),
                        ("w_out", mlp.c_proj.weight)):
            _register_pack(self, name, w.t())
        self.register_buffer("mask", mask, persistent=False)

    wq = QuantMixerBlock.wq

    def forward(self, x: torch.Tensor, s_qkv=None, s_attn_out=None, s_in=None, s_hidden=None) -> torch.Tensor:
        dt = x.dtype
        y = layer_norm(x, self.ln_1.weight, self.ln_1.bias)
        qkv = int8_matmul(y, self.wq("qkv"), s_qkv, dt) + self.qkv_bias.to(dt)
        out = attention_core(qkv, self.n_heads, self.mask)
        x = x + int8_matmul(out, self.wq("out"), s_attn_out, dt) + self.out_bias.to(dt)
        y = layer_norm(x, self.ln_2.weight, self.ln_2.bias)
        h = quick_gelu(int8_matmul(y, self.wq("w_in"), s_in, dt) + self.b_in.to(dt))
        return x + int8_matmul(h, self.wq("w_out"), s_hidden, dt) + self.b_out.to(dt)


# Each block's activation-scale sites, in the order its forward takes them.
MIXER_SITES = ("ch_in", "ch_hidden")
ATTN_SITES = ("qkv_in", "attn_out_in", "mlp_in", "mlp_hidden")


class _QuantTower(nn.Module):
    """What both quantised towers share: the int8 blocks of the float
    ``tower`` (a Mixer or a transformer tower) and the activation scales
    (buffers ``a_<site>``: ``[L]`` for each block site, ``()`` for a tower
    site such as ``patch``; absent for dynamic scales)."""

    TOWER_SITES: tuple = ()

    def _init_blocks(self, cfg: CLIPConfig, tower, a_scales: Optional[Mapping], device) -> None:
        self.cfg = cfg
        if cfg.use_transformer:
            self.layer_sites = ATTN_SITES
            self.blocks = nn.ModuleList(QuantAttentionBlock(b, tower.attn_mask) for b in tower.resblocks)
        else:
            self.layer_sites = MIXER_SITES
            self.blocks = nn.ModuleList(QuantMixerBlock(b) for b in tower.mixBlocks)
        self.sites = self.TOWER_SITES + self.layer_sites
        scales = _as_scales(a_scales, self.sites, device)
        self.static = scales is not None
        for k in self.sites:
            self.register_buffer(f"a_{k}", None if scales is None else scales[k])

    def a_scales(self) -> Optional[Dict[str, torch.Tensor]]:
        """The activation scales under the JAX package's keys (None: dynamic)."""
        if not self.static:
            return None
        return {k: getattr(self, f"a_{k}") for k in self.sites}

    def layer_scales(self, i: int) -> list:
        """Block ``i``'s static scales in its forward's order ([]: dynamic)."""
        return [getattr(self, f"a_{k}")[i] for k in self.layer_sites] if self.static else []

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        for i, block in enumerate(self.blocks):
            x = block(x, *self.layer_scales(i))
        return x


class QuantVisionTower(_QuantTower):
    """The vision tower with an int8 patch embed and int8 blocks.
    ``a_scales``: ``{"patch": (), <each block site>: [L]}`` from
    :func:`calibrate_vision_tower` or :func:`calibrate_vit_vision_tower`
    (None: dynamic scales)."""

    TOWER_SITES = ("patch",)

    def __init__(self, visual, a_scales: Optional[Mapping] = None):
        super().__init__()
        device = visual.proj.device
        self._init_blocks(visual.cfg, visual.transformer, a_scales, device)
        self.class_embedding = visual.class_embedding
        if visual.cfg.use_transformer:
            self.positional_embedding = visual.positional_embedding
        self.ln_pre = visual.ln_pre
        self.ln_post = visual.ln_post
        self.proj = visual.proj  # compute dtype by design
        _register_pack(self, "patch", visual.patch_kernel())
        self.register_buffer("patch_q_planar", None)
        self.set_planar()

    def set_planar(self) -> None:
        """Refresh the c-major copy of the patch kernel that
        :func:`encode_image_q_patches` reads (after ``patch_q`` changes)."""
        perm = torch.from_numpy(patch_perm(self.cfg.vision_patch_size)).to(self.patch_q.device)  # drops K's pad
        self.patch_q_planar = self.patch_q[:, perm].contiguous()

    def tail(self, x: torch.Tensor) -> torch.Tensor:
        """After the patch embed: CLS (+ positional embedding), ln_pre, the
        int8 blocks, ln_post on CLS, the projection. x: [B, tokens - 1,
        width] in the compute dtype."""
        dt = x.dtype
        x = self.run_blocks(embed_patches(self, x))
        x = self.ln_post(x[:, 0, :])
        return x @ self.proj.to(dt)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return encode_image_q(self, images)


class QuantTextTower(_QuantTower):
    """The text tower with int8 blocks; the token (and positional)
    embeddings are lookups and the projection stays in the compute dtype.
    ``a_scales``: ``{<each block site>: [L]}`` from
    :func:`calibrate_text_tower` or :func:`calibrate_vit_text_tower`."""

    def __init__(self, model, a_scales: Optional[Mapping] = None):
        super().__init__()
        self._init_blocks(model.cfg, model.transformer, a_scales, model.device)
        self.token_embedding = model.token_embedding
        if model.cfg.use_transformer:
            self.positional_embedding = model.positional_embedding
        self.ln_final = model.ln_final
        self.text_projection = model.text_projection

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        return encode_text_q(self, text)


def tower_kind(cfg: CLIPConfig, text: bool) -> str:
    """``"resnet"``, ``"transformer"`` or ``"mixer"``: the kind of ``cfg``'s
    text or vision tower (a ResNet config's text tower is a transformer)."""
    if cfg.is_resnet and not text:
        return "resnet"
    return "transformer" if cfg.use_transformer else "mixer"


def _require_tower(cfg: CLIPConfig, kind: str, text: bool) -> None:
    """Raise unless ``cfg``'s text or vision tower is of the kind a function serves."""
    if tower_kind(cfg, text) != kind:
        raise ValueError(f"this int8 function serves {kind} {'text' if text else 'vision'} towers; "
                         "use image_quant_fns / text_quant_fns")


def quantize_vision_tower(model, a_scales: Optional[Mapping] = None) -> QuantVisionTower:
    """int8 copy of ``model``'s (a port CLIP) Mixer vision tower."""
    _require_tower(model.cfg, "mixer", text=False)
    return QuantVisionTower(model.visual, a_scales)


def quantize_text_tower(model, a_scales: Optional[Mapping] = None) -> QuantTextTower:
    """int8 copy of ``model``'s Mixer text tower."""
    _require_tower(model.cfg, "mixer", text=True)
    return QuantTextTower(model, a_scales)


def quantize_vit_vision_tower(model, a_scales: Optional[Mapping] = None) -> QuantVisionTower:
    """int8 copy of ``model``'s ViT vision tower: the patch embed and the
    QKV, attention-out and MLP products of every block."""
    _require_tower(model.cfg, "transformer", text=False)
    return QuantVisionTower(model.visual, a_scales)


def quantize_vit_text_tower(model, a_scales: Optional[Mapping] = None) -> QuantTextTower:
    """int8 copy of ``model``'s causally masked transformer text tower (a
    ViT's, or a ResNet config's)."""
    _require_tower(model.cfg, "transformer", text=True)
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
    return pool_text(qtext, qtext.run_blocks(embed_text(qtext, text, dt)), text, dt)


# The quant modules carry their blocks' kind, so one encoder serves both;
# these are the JAX package's ViT names for them.
encode_image_vit_q = encode_image_q
encode_text_vit_q = encode_text_q


def _channel_sites(block: MixerBlock, h: torch.Tensor, q: float):
    """One float Mixer block as the JAX calibration runs it: (its output,
    the ch_in and ch_hidden site scales)."""
    dt = h.dtype
    cm, ln2 = block.channel_mix_seq, block.layerNorm2
    h = h + token_mix(block, h)
    y = layer_norm(h, ln2.weight, ln2.bias)
    hidden = quick_gelu(y @ cm.lin3.weight.to(dt).t() + cm.lin3.bias.to(dt))
    out = h + hidden @ cm.lin4.weight.to(dt).t() + cm.lin4.bias.to(dt)
    return out, (_site_scale(y, q), _site_scale(hidden, q))


def _attention_sites(block: ResidualAttentionBlock, h: torch.Tensor, q: float, mask: Optional[torch.Tensor]):
    """One float transformer block as the JAX calibration runs it: (its
    output, the qkv_in, attn_out_in, mlp_in and mlp_hidden site scales)."""
    dt = h.dtype
    attn, mlp = block.attn, block.mlp
    y1 = layer_norm(h, block.ln_1.weight, block.ln_1.bias)
    qkv = y1 @ attn.in_proj_weight.to(dt).t() + attn.in_proj_bias.to(dt)
    ao = attention_core(qkv, block.n_heads, mask)  # the attn_out_in site
    h = h + ao @ attn.out_proj.weight.to(dt).t() + attn.out_proj.bias.to(dt)
    y2 = layer_norm(h, block.ln_2.weight, block.ln_2.bias)
    hidden = quick_gelu(y2 @ mlp.c_fc.weight.to(dt).t() + mlp.c_fc.bias.to(dt))
    out = h + hidden @ mlp.c_proj.weight.to(dt).t() + mlp.c_proj.bias.to(dt)
    return out, tuple(_site_scale(a, q) for a in (y1, ao, y2, hidden))


def _tower_sites(cfg: CLIPConfig, tower, x: torch.Tensor, q: float) -> Dict[str, torch.Tensor]:
    """Every block site's scale [L] over the float ``tower`` fed ``x``."""
    if cfg.use_transformer:
        sites, blocks = ATTN_SITES, tower.resblocks
        step = functools.partial(_attention_sites, mask=tower.attn_mask)
    else:
        sites, blocks, step = MIXER_SITES, tower.mixBlocks, _channel_sites
    per_site = [[] for _ in sites]
    for block in blocks:
        x, scales = step(block, x, q)
        for col, scale in zip(per_site, scales):
            col.append(scale)
    return {k: torch.stack(col) for k, col in zip(sites, per_site)}


def _calibrate_vision(model, sample_images: torch.Tensor, q: float) -> Dict[str, torch.Tensor]:
    v, cfg = model.visual, model.cfg
    dt = compute_dtype(cfg.compute_dtype)
    x = patchify(sample_images.to(dt), cfg.vision_patch_size)
    s_patch = _site_scale(x, q)
    x = embed_patches(v, x @ v.patch_kernel().to(dt))
    return {"patch": s_patch, **_tower_sites(cfg, v.transformer, x, q)}


def _calibrate_text(model, sample_text: torch.Tensor, q: float) -> Dict[str, torch.Tensor]:
    dt = compute_dtype(model.cfg.compute_dtype)
    return _tower_sites(model.cfg, model.transformer, embed_text(model, sample_text, dt), q)


@torch.no_grad()
def calibrate_vision_tower(model, sample_images: torch.Tensor, quantile: float = 0.9999) -> Dict[str, torch.Tensor]:
    """Static activation scales of the Mixer vision tower from sample
    (normalised) images: ``{"patch": (), "ch_in": [L], "ch_hidden": [L]}``,
    each site's |activation| ``quantile`` over 127."""
    _require_tower(model.cfg, "mixer", text=False)
    return _calibrate_vision(model, sample_images, quantile)


@torch.no_grad()
def calibrate_text_tower(model, sample_text: torch.Tensor, quantile: float = 0.9999) -> Dict[str, torch.Tensor]:
    """Static activation scales of the Mixer text tower from sample token
    ids: ``{"ch_in": [L], "ch_hidden": [L]}``."""
    _require_tower(model.cfg, "mixer", text=True)
    return _calibrate_text(model, sample_text, quantile)


@torch.no_grad()
def calibrate_vit_vision_tower(model, sample_images: torch.Tensor,
                               quantile: float = 0.9999) -> Dict[str, torch.Tensor]:
    """Static activation scales of the ViT vision tower: ``{"patch": (),
    "qkv_in", "attn_out_in", "mlp_in", "mlp_hidden": [L]}``."""
    _require_tower(model.cfg, "transformer", text=False)
    return _calibrate_vision(model, sample_images, quantile)


@torch.no_grad()
def calibrate_vit_text_tower(model, sample_text: torch.Tensor, quantile: float = 0.9999) -> Dict[str, torch.Tensor]:
    """Static activation scales of the transformer text tower (causal mask):
    ``{"qkv_in", "attn_out_in", "mlp_in", "mlp_hidden": [L]}``."""
    _require_tower(model.cfg, "transformer", text=True)
    return _calibrate_text(model, sample_text, quantile)


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


# ---- the ResNet tower: W8A8 convolutions with BatchNorm folded -----------------


def fold_bn_into_conv(weight: torch.Tensor, bn, eps: float = BN_EPS):
    """An inference conv + BN -> one conv with a bias, in f32:
    ``(kernel * g, bias - mean * g)``, ``g = scale * rsqrt(var + eps)``;
    ``weight`` OIHW, ``bn`` a ``BatchNorm`` (its running statistics)."""
    g = bn.weight.float() * torch.rsqrt(bn.running_var.float() + eps)
    kernel = weight.float() * g[:, None, None, None]
    bias = bn.bias.float() - bn.running_mean.float() * g
    return kernel, bias


def quantize_conv_weight(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """OIHW float -> {"q": int8 OIHW, "scale": f32 [out]}, symmetric per
    output channel."""
    k = kernel.float()
    scale = torch.clamp_min(true_div(k.abs().amax(dim=(1, 2, 3)), QMAX), 1e-8)
    q = torch.clamp(torch.round(k / scale[:, None, None, None]), -QMAX, QMAX).to(torch.int8)
    return {"q": q, "scale": scale}


def _scalar(v, device) -> torch.Tensor:
    """A scale leaf (numpy, as an artifact loads it, or a tensor) -> f32 0-d on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device, torch.float32).reshape(())
    return torch.tensor(np.asarray(v, np.float32).reshape(()), device=device)


class QuantConv(nn.Module):
    """One conv site of the int8 ResNet: buffers ``q`` (int8 [out, kh kw
    cin] in an NHWC patch's (kh, kw, cin) order, padded to a multiple of 8,
    :func:`pad_k`), ``scale`` [out], ``bias`` [out] (the folded BN's, f32)
    and ``a`` (the input's static scale)."""

    def __init__(self, conv_module: nn.Conv2d, bn, a):
        super().__init__()
        self.kernel_size = conv_module.kernel_size[0]
        with torch.no_grad():
            kernel, bias = fold_bn_into_conv(conv_module.weight, bn)
            pack = quantize_conv_weight(kernel)
        self.register_buffer("q", pad_k(pack["q"].permute(0, 2, 3, 1).reshape(pack["q"].shape[0], -1)).contiguous())
        self.register_buffer("scale", pack["scale"])
        self.register_buffer("bias", bias)
        self.register_buffer("a", _scalar(a, bias.device))


def conv_sums(xq: torch.Tensor, q: torch.Tensor, k: int, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """The int32 sums of a convolution of int8 NHWC ``xq`` [B, H, W, C] with
    ``q`` [out, >= k k C] (a :class:`QuantConv`'s): the patches, gathered
    from ``k * k`` shifted, strided views of the zero-padded input, times
    the weight by ``torch._int_mm``. -> int32 [B, H', W', out]."""
    B, H, W, C = xq.shape
    if padding:
        xq = nn.functional.pad(xq, (0, 0, padding, padding, padding, padding))
    ho, wo = (H + 2 * padding - k) // stride + 1, (W + 2 * padding - k) // stride + 1
    if k == 1 and stride == 1:
        patches = xq.reshape(B * H * W, C)
    else:
        taps = [xq[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
                for i in range(k) for j in range(k)]
        patches = torch.stack(taps, dim=3).reshape(B * ho * wo, k * k * C)
    return int_mm(patches, q.t()).reshape(B, ho, wo, -1)


def int8_conv(x: torch.Tensor, qc: QuantConv, stride: int = 1, padding: int = 0,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = conv(x, dequant(qc)) + bias as s8 x s8 -> s32 on NHWC ``x``: the
    input quantised at ``qc.a``, the sums dequantised as
    ``acc * (a * scale) + bias`` in f32, then cast to ``out_dtype``."""
    xq = quantize_activation(x.float(), qc.a)
    acc = conv_sums(xq, qc.q, qc.kernel_size, stride, padding)
    return (acc.float() * (qc.a * qc.scale) + qc.bias).to(out_dtype)


class QuantBottleneck(nn.Module):
    """A ``Bottleneck``'s convs as :class:`QuantConv` (``downsample``: the
    branch's conv, None without one)."""

    def __init__(self, block, scales: Mapping):
        super().__init__()
        self.stride = block.stride
        self.conv1 = QuantConv(block.conv1, block.bn1, scales["conv1"])
        self.conv2 = QuantConv(block.conv2, block.bn2, scales["conv2"])
        self.conv3 = QuantConv(block.conv3, block.bn3, scales["conv3"])
        self.downsample = None
        if block.downsample is not None:
            self.downsample = QuantConv(block.downsample[0], block.downsample[1], scales["downsample"])


class QuantResNet(nn.Module):
    """The int8 ResNet vision tower of a float ``ModifiedResNet``: every
    conv's BN folded and quantised (:class:`QuantConv`), the attention pool
    the float tower's module. ``a_scales``: the tree of
    :func:`calibrate_resnet_tower` (tensor or numpy leaves; required, as
    in the JAX package)."""

    def __init__(self, visual, a_scales: Mapping):
        super().__init__()
        self.cfg = visual.cfg
        for i in (1, 2, 3):
            setattr(self, f"conv{i}", QuantConv(getattr(visual, f"conv{i}"), getattr(visual, f"bn{i}"),
                                                a_scales[f"conv{i}"]))
        for i in range(1, 5):
            stage = getattr(visual, f"layer{i}")
            setattr(self, f"layer{i}", nn.ModuleList(QuantBottleneck(blk, a_scales[f"layer{i}"][b])
                                                     for b, blk in enumerate(stage)))
        self.attnpool = visual.attnpool

    def blocks(self):
        return [blk for i in range(1, 5) for blk in getattr(self, f"layer{i}")]

    def a_scales(self) -> Dict:
        """The activation scales as the calibration's tree."""
        tree: Dict = {f"conv{i}": getattr(self, f"conv{i}").a for i in (1, 2, 3)}
        for i in range(1, 5):
            tree[f"layer{i}"] = [
                {k: getattr(blk, k).a for k in ("conv1", "conv2", "conv3", "downsample") if getattr(blk, k) is not None}
                for blk in getattr(self, f"layer{i}")]
        return tree

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return encode_image_rn_q(self, images)


def quantize_resnet_tower(model, a_scales: Mapping) -> QuantResNet:
    """int8 copy of ``model``'s ResNet vision tower at the static scales
    ``a_scales`` (:func:`calibrate_resnet_tower`)."""
    _require_tower(model.cfg, "resnet", text=False)
    return QuantResNet(model.visual, a_scales)


@torch.no_grad()
def encode_image_rn_q(qvis: QuantResNet, images: torch.Tensor) -> torch.Tensor:
    """The int8 ResNet forward (``ModifiedResNet.forward`` with every conv +
    BN an :func:`int8_conv`). images: normalised NHWC [B, R, R, 3]."""
    dt = compute_dtype(qvis.cfg.compute_dtype)
    relu = nn.functional.relu
    x = images.to(dt)
    x = relu(int8_conv(x, qvis.conv1, stride=2, padding=1, out_dtype=dt))
    x = relu(int8_conv(x, qvis.conv2, padding=1, out_dtype=dt))
    x = relu(int8_conv(x, qvis.conv3, padding=1, out_dtype=dt))
    x = avg_pool(x, 2)
    for blk in qvis.blocks():
        out = relu(int8_conv(x, blk.conv1, out_dtype=dt))
        out = relu(int8_conv(out, blk.conv2, padding=1, out_dtype=dt))
        if blk.stride > 1:
            out = avg_pool(out, blk.stride)
        out = int8_conv(out, blk.conv3, out_dtype=dt)
        identity = x
        if blk.downsample is not None:
            identity = x if blk.stride == 1 else avg_pool(x, blk.stride)
            identity = int8_conv(identity, blk.downsample, out_dtype=dt)
        x = relu(out + identity)
    return attention_pool(qvis.attnpool, x)


@torch.no_grad()
def calibrate_resnet_tower(model, sample_images: torch.Tensor, quantile: float = 0.9999) -> Dict:
    """The |input| ``quantile`` / 127 at every conv site, running the float
    inference forward on sample (normalised) images: ``{"conv1", "conv2",
    "conv3": (), "layer{i}": [{"conv1", "conv2", "conv3"[, "downsample"]}
    per block]}``, the JAX package's tree."""
    _require_tower(model.cfg, "resnet", text=False)
    v = model.visual
    relu = nn.functional.relu
    q = functools.partial(_site_scale, q=quantile)
    scales: Dict = {}
    x = sample_images.to(compute_dtype(model.cfg.compute_dtype))
    scales["conv1"] = q(x)
    x = relu(v.bn1(conv(v.conv1.weight, x, stride=2, padding=1)))
    scales["conv2"] = q(x)
    x = relu(v.bn2(conv(v.conv2.weight, x, padding=1)))
    scales["conv3"] = q(x)
    x = relu(v.bn3(conv(v.conv3.weight, x, padding=1)))
    x = avg_pool(x, 2)
    for i in range(1, 5):
        stage = []
        for blk in getattr(v, f"layer{i}"):
            site = {"conv1": q(x)}
            out = relu(blk.bn1(conv(blk.conv1.weight, x)))
            site["conv2"] = q(out)
            out = relu(blk.bn2(conv(blk.conv2.weight, out, padding=1)))
            if blk.stride > 1:
                out = avg_pool(out, blk.stride)
            site["conv3"] = q(out)
            out = blk.bn3(conv(blk.conv3.weight, out))
            identity = x
            if blk.downsample is not None:
                identity = x if blk.stride == 1 else avg_pool(x, blk.stride)
                site["downsample"] = q(identity)
                identity = blk.downsample[1](conv(blk.downsample[0].weight, identity))
            x = relu(out + identity)
            stage.append(site)
        scales[f"layer{i}"] = stage
    return scales


def image_quant_fns(cfg: CLIPConfig):
    """(calibrate, quantize, encode_q) for ``cfg``'s vision tower: the one
    dispatch the gates (``evals/quant_gate.py``) and
    ``InferenceEngine.enable_int8`` share. ``is_resnet`` is tested before
    ``use_transformer``: a ResNet config carries ``tower="transformer"``
    for its text side."""
    kind = tower_kind(cfg, text=False)
    if kind == "resnet":
        return calibrate_resnet_tower, quantize_resnet_tower, encode_image_rn_q
    if kind == "transformer":
        return calibrate_vit_vision_tower, quantize_vit_vision_tower, encode_image_vit_q
    return calibrate_vision_tower, quantize_vision_tower, encode_image_q


def text_quant_fns(cfg: CLIPConfig):
    """(calibrate, quantize, encode_q) for ``cfg``'s text tower: the ViT
    text functions for a ResNet config, as in the JAX package."""
    if tower_kind(cfg, text=True) == "transformer":
        return calibrate_vit_text_tower, quantize_vit_text_tower, encode_text_vit_q
    return calibrate_text_tower, quantize_text_tower, encode_text_q
