"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a CUDA
device. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from clip_mixer_tpu_torch.models.layers import channel_mlp
from clip_mixer_tpu_torch.models.mixer import MixerBlock, init_mixer_block
from clip_mixer_tpu_torch.ops.kernels import ln_mlp as kln
from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre
from clip_mixer_tpu_torch.ops.kernels import mixer_block as kmb
from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp, ln_mlp_plain
from clip_mixer_tpu_torch.ops.kernels.mixer_block import (
    fused_mixer_block_tbd,
    mixer_block_fused,
    mixer_block_plain,
    mixer_tower_fused,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _ln_mlp_args(R, W, dtype, device, seed):
    rng = np.random.default_rng(seed)
    H = 4 * W
    arrays = (
        rng.normal(0, 1, (R, W)),
        rng.normal(1, 0.1, W),
        rng.normal(0, 0.1, W),
        rng.normal(0, W**-0.5, (H, W)),
        rng.normal(0, 0.1, H),
        rng.normal(0, H**-0.5, (W, H)),
        rng.normal(0, 0.1, W),
    )
    return [torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype) for a in arrays]


def _rel_err(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


# bf16 ln_mlp is held on its branch, out - x: the residual dominates out and
# would hide a dropped bias. Sound runs differ by about 1e-3 of the branch.
BRANCH_TOL = 5e-3


@pytest.mark.parametrize(
    "R,W,dtype",
    [  # the towers at buckets 128 and 8, a ragged R, f32
        (6400, 768, torch.bfloat16), (9856, 512, torch.bfloat16), (400, 768, torch.bfloat16),
        (231, 512, torch.bfloat16), (400, 768, torch.float32), (77, 64, torch.float32),
    ]
    # bf16 at ragged R (a last 128-row tile that TMA fills with zeros and the
    # epilogue masks) and at W = 128, 384 and 1024: 128-column tiles, and
    # 256-column ones for GEMM 1 at R = 6465
    + [(R, W, torch.bfloat16) for R in (1, 65, 129, 231) for W in (128, 384, 1024)]
    + [(6465, 768, torch.bfloat16)],
)
def test_ln_mlp_kernel_matches_plain(cuda, R, W, dtype):
    args = _ln_mlp_args(R, W, dtype, cuda, seed=8)
    before = ln_mlp.launches
    got = ln_mlp(*args)
    torch.cuda.synchronize()
    assert ln_mlp.launches == before + 1
    want = ln_mlp_plain(*args)
    if dtype == torch.float32:
        # f32 sums in another order: the Pallas kernel test's tolerance
        torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)
    else:
        # the same bf16 rounding points; only f32 summation order differs
        x = args[0].float()
        assert _rel_err(got.float() - x, want.float() - x) <= BRANCH_TOL
        # and the check fails a kernel that drops b_out
        no_b_out = ln_mlp_plain(*args[:6], torch.zeros_like(args[6]))
        assert _rel_err(no_b_out.float() - x, want.float() - x) > BRANCH_TOL


# y and h: the same bf16 rounding of f32 values that differ only in
# summation order; sound runs differ by about 1e-4 (chip_smoke.py's tolerance)
STAGE_TOL = 1e-3


@pytest.mark.parametrize("R,W", [(6400, 768), (9856, 512), (231, 384), (65, 1024)])
def test_ln_mlp_stages_match_plain(cuda, R, W):
    x, lw, lb, wi, bi, wo, bo = _ln_mlp_args(R, W, torch.bfloat16, cuda, seed=R + W)
    before = [f.launches for f in (kln.ln_rows, kln.linear_gelu, kln.linear_residual)]
    y = kln.ln_rows(x, lw, lb)
    h = kln.linear_gelu(y, wi, bi)
    out = kln.linear_residual(h, wo, bo, x)
    torch.cuda.synchronize()
    assert [f.launches for f in (kln.ln_rows, kln.linear_gelu, kln.linear_residual)] == [n + 1 for n in before]
    assert _rel_err(y, kln.ln_rows_plain(x, lw, lb)) <= STAGE_TOL
    assert _rel_err(h, kln.linear_gelu_plain(y, wi, bi)) <= STAGE_TOL
    want = kln.linear_residual_plain(h, wo, bo, x)
    xf = x.float()
    assert _rel_err(out.float() - xf, want.float() - xf) <= BRANCH_TOL
    # ln_mlp is these three launches: the same bits
    assert torch.equal(out, ln_mlp(x, lw, lb, wi, bi, wo, bo))


def test_stage_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, lw, lb, wi, bi, wo, bo = _ln_mlp_args(64, 128, torch.float32, cuda, seed=21)
    with pytest.raises(ValueError, match="bfloat16"):
        kln.ln_rows(x, lw, lb)
    x, lw, lb, wi, bi, wo, bo = _ln_mlp_args(64, 128, torch.bfloat16, cuda, seed=22)
    with pytest.raises(ValueError, match="shape"):
        kln.linear_gelu(x, wo, bi)
    h = kln.linear_gelu(x, wi, bi)
    with pytest.raises(ValueError, match="contiguous"):
        kln.linear_residual(h, wo, bo, x.t().contiguous().t())


PREPROCESS_CASES = [  # (input_hw, n_px, B): the bench front end, other aspect ratios, an upscale, small B
    ((256, 256), 224, 16), ((256, 256), 224, 1), ((480, 640), 224, 8), ((300, 200), 224, 8),
    ((300, 200), 224, 1), ((224, 224), 224, 4), ((64, 64), 32, 5), ((48, 80), 32, 3),
    ((90, 131), 64, 3),  # W % 4 != 0: rows not 4-byte aligned, the kernel's byte loads
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw,n,B", PREPROCESS_CASES)
def test_preprocess_kernel_matches_plain(cuda, hw, n, B, dtype):
    imgs = torch.randint(0, 256, (B, *hw, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(9))
    bands = kpre.ResizeBands.build(hw, n, cuda)
    before = kpre.preprocess.launches
    got = kpre.preprocess(imgs.to(cuda), bands, dtype)
    torch.cuda.synchronize()
    assert kpre.preprocess.launches == before + 1
    want = kpre.preprocess_plain(imgs.to(cuda), bands, dtype)
    if dtype == torch.float32:
        # the banded sums skip exact zeros of the dense ones: f32 order only
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        assert _rel_err(got, want) <= 1e-2


def test_preprocess_check_fails_a_dropped_tap(cuda):
    """The plain version with one R_w tap column zeroed fails the f32 check."""
    imgs = torch.randint(0, 256, (4, 256, 256, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(10))
    bands = kpre.ResizeBands.build((256, 256), 224, cuda)
    got = kpre.preprocess(imgs.to(cuda), bands, torch.float32)
    rw = bands.rw.clone()
    rows = torch.arange(rw.shape[0], device=cuda)
    rw[rows, bands.rw_start.long() + bands.rw_taps.shape[1] // 2] = 0.0
    faulty = kpre.preprocess_plain(imgs.to(cuda), dataclasses.replace(bands, rw=rw), torch.float32)
    assert float((got - faulty).abs().max()) > 1e-4


def test_preprocess_kernel_takes_an_empty_batch(cuda):
    bands = kpre.ResizeBands.build((256, 256), 224, cuda)
    before = kpre.preprocess.launches
    out = kpre.preprocess(torch.zeros((0, 256, 256, 3), dtype=torch.uint8, device=cuda), bands)
    assert out.shape == (0, 224, 224, 3) and kpre.preprocess.launches == before


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, lw, lb, wi, bi, wo, bo = _ln_mlp_args(64, 96, torch.bfloat16, cuda, seed=10)
    with pytest.raises(ValueError, match="W % 128"):
        ln_mlp(x, lw, lb, wi, bi, wo, bo)
    x, lw, lb, wi, bi, wo, bo = _ln_mlp_args(64, 128, torch.bfloat16, cuda, seed=11)
    with pytest.raises(ValueError, match="contiguous"):
        ln_mlp(x.t().contiguous().t(), lw, lb, wi, bi, wo, bo)
    with pytest.raises(ValueError, match="float16"):
        ln_mlp(*(t.half() for t in (x, lw, lb, wi, bi, wo, bo)))
    bands = kpre.ResizeBands.build((256, 256), 224, cuda)
    with pytest.raises(ValueError, match="uint8"):
        kpre.preprocess(torch.zeros((1, 256, 256, 3), device=cuda), bands)


def _block_case(B, T, D, dtype, device, seed, text_tower):
    """A MixerBlock at its tower's init scales (LN parameters perturbed so
    the affine counts), in ``dtype`` on ``device``, and x [T, B, D]."""
    g = torch.Generator().manual_seed(seed)
    block = MixerBlock(D, T)
    init_mixer_block(block, text_tower=text_tower, n_layers=12, generator=g)
    with torch.no_grad():
        for ln in (block.layerNorm1, block.layerNorm2):
            ln.weight.add_(0.1 * torch.randn(D, generator=g))
            ln.bias.add_(0.1 * torch.randn(D, generator=g))
    x = torch.randn(T, B, D, generator=g)
    return block.to(device=device, dtype=dtype), x.to(device=device, dtype=dtype)


# chip_smoke.py's cases: both towers at bucket 128, vision at bucket 8, text
# at a B no batch tile divides, f32
BLOCK_CASES = [
    (128, 50, 768, torch.bfloat16, False), (128, 77, 512, torch.bfloat16, True),
    (8, 50, 768, torch.bfloat16, False), (12, 77, 512, torch.bfloat16, True), (8, 50, 768, torch.float32, False),
]


@pytest.mark.parametrize("B,T,D,dtype,text_tower", BLOCK_CASES)
def test_mixer_block_kernel_matches_plain(cuda, B, T, D, dtype, text_tower):
    block, x = _block_case(B, T, D, dtype, cuda, seed=B + T, text_tower=text_tower)
    before = fused_mixer_block_tbd.launches
    with torch.no_grad():
        got = fused_mixer_block_tbd(block, x)
        torch.cuda.synchronize()
        assert fused_mixer_block_tbd.launches == before + 1
        want = mixer_block_plain(block, x)
        if dtype == torch.float32:
            # f32 sums in another order: the tolerance chip_smoke.py gives ln_mlp
            torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)
            return
        xf = x.float()
        assert _rel_err(got.float() - xf, want.float() - xf) <= BRANCH_TOL
        # and the check fails a kernel that drops either residual branch's last bias
        for bias in ("token_mix_seq.lin2.bias", "channel_mix_seq.lin4.bias"):
            faulty = copy.deepcopy(block)
            faulty.get_parameter(bias).zero_()
            planted = mixer_block_plain(faulty, x)
            assert _rel_err(planted.float() - xf, want.float() - xf) > BRANCH_TOL, bias


@pytest.mark.parametrize("layout", ["TBD", "BTD view"])
@pytest.mark.parametrize("B", [1, 8, 12, 128])
@pytest.mark.parametrize("T,D,text_tower", [(50, 768, False), (77, 512, True)])
def test_token_mix_kernel_matches_plain(cuda, T, D, text_tower, B, layout):
    """The bf16 block's first launch alone: z on its branch z - x, y2 = LN_ch
    of the kernel's own z at the stage tolerance."""
    block, x = _block_case(B, T, D, torch.bfloat16, cuda, seed=B * T, text_tower=text_tower)
    if layout == "BTD view":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    p = kmb.block_params(block, torch.bfloat16)
    before = kmb.token_mix.launches
    with torch.no_grad():
        z, y2 = kmb.token_mix(x, *p[:8])
        torch.cuda.synchronize()
        assert kmb.token_mix.launches == before + 1
        assert z.stride() == y2.stride() == x.stride()
        want, _ = kmb.token_mix_plain(x, *p[:8])
        xf = x.float()
        assert _rel_err(z.float() - xf, want.float() - xf) <= BRANCH_TOL
        assert _rel_err(y2, kln.ln_rows_plain(z, p[6], p[7])) <= STAGE_TOL
        # and the branch check fails a kernel that drops b2
        no_b2, _ = kmb.token_mix_plain(x, *p[:5], torch.zeros_like(p[5]), *p[6:8])
        assert _rel_err(no_b2.float() - xf, want.float() - xf) > BRANCH_TOL


def test_mixer_block_kernel_reads_the_tower_layout(cuda):
    """The tower hands the kernel its [B, T, D] activations as a [T, B, D]
    view: the same arithmetic as on a contiguous [T, B, D] copy."""
    block, x = _block_case(16, 50, 768, torch.bfloat16, cuda, seed=12, text_tower=False)
    xb = x.transpose(0, 1).contiguous()  # [B, T, D]
    with torch.no_grad():
        got = fused_mixer_block_tbd(block, xb.transpose(0, 1))
        assert got.stride() == xb.transpose(0, 1).stride()
        torch.testing.assert_close(got, fused_mixer_block_tbd(block, x), atol=0, rtol=0)
        tower = torch.nn.Module()
        tower.mixBlocks = torch.nn.ModuleList([block, block])
        out = mixer_tower_fused(tower, xb)
    assert out.shape == xb.shape and out.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_through_the_kernels_matches_plain_autograd(cuda, dtype):
    """Gradients reach x and every f32 master parameter through both
    kernels, and equal autograd of the model's unfused chain (the block's
    own forward with fused_mlp=False; channel_mlp) on the same inputs."""
    tol = dict(atol=1e-4, rtol=1e-3) if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    block, x = _block_case(8, 50, 768, torch.float32, cuda, seed=13, text_tower=False)
    x = x.to(dtype).requires_grad_()
    inputs = [x, *block.parameters()]
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(14)).to(device=cuda, dtype=dtype)
    before = fused_mixer_block_tbd.launches
    got = torch.autograd.grad(mixer_block_fused(block, x), inputs, g)
    assert fused_mixer_block_tbd.launches == before + 1
    want = torch.autograd.grad(block(x.transpose(0, 1)).transpose(0, 1), inputs, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, **tol)  # test_pallas_kernels.py:121 in f32

    x, *params = [t.requires_grad_() for t in _ln_mlp_args(400, 768, torch.float32, cuda, seed=15)]
    x = x.detach().to(dtype).requires_grad_()
    g = torch.randn(400, 768, generator=torch.Generator().manual_seed(16)).to(device=cuda, dtype=dtype)
    before = ln_mlp.launches
    got = torch.autograd.grad(ln_mlp(x, *params), [x, *params], g)
    assert ln_mlp.launches == before + 1
    want = torch.autograd.grad(channel_mlp(x, *params), [x, *params], g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **tol)


def test_mixer_block_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    block, x = _block_case(4, 50, 768, torch.bfloat16, cuda, seed=17, text_tower=False)
    with pytest.raises(ValueError, match="float16"):
        fused_mixer_block_tbd(block.half(), x.half())
    with pytest.raises(ValueError, match="shared memory"):  # the text tower's tokens at the vision width
        wide, xw = _block_case(4, 77, 768, torch.bfloat16, cuda, seed=18, text_tower=False)
        fused_mixer_block_tbd(wide, xw)
    with pytest.raises(ValueError, match="bfloat16"):  # token_mix is the bf16 block's first launch
        kmb.token_mix(x.float(), *(t.float() for t in kmb.block_params(block, torch.bfloat16)[:8]))
    with pytest.raises(ValueError, match="T <= 80"):
        long, xl = _block_case(2, 96, 256, torch.float32, cuda, seed=19, text_tower=False)
        fused_mixer_block_tbd(long, xl)
    with pytest.raises(ValueError, match="D % 128"):
        narrow, xn = _block_case(2, 50, 96, torch.bfloat16, cuda, seed=20, text_tower=False)
        fused_mixer_block_tbd(narrow, xn)
    with pytest.raises(ValueError, match="strides"):
        fused_mixer_block_tbd(block.bfloat16(), x[:, ::2])


def test_device_prefetch_copies_each_batch_to_the_card(cuda):
    """The trainer's device prefetch: pinned in the producer (``pinned``),
    copied on a side stream, and safe to use on the consumer's stream at
    once, the same bytes as the host batch."""
    from clip_mixer_tpu_torch.data.pipeline import SyntheticSource, device_prefetch, pinned, prefetch

    src = SyntheticSource(batch_size=16, image_size=64, n_batches=5, context_length=77)
    host = list(src.iter_batches(0))
    got = list(device_prefetch(prefetch(pinned(src.iter_batches(0))), cuda))
    assert len(got) == len(host)
    for h, d in zip(host, got):
        for k in h:
            assert d[k].is_cuda and d[k].dtype == torch.as_tensor(h[k]).dtype
            # consumed on the current stream with no synchronisation of ours
            np.testing.assert_array_equal(d[k].clone().cpu().numpy(), h[k])


# ---- the int8 serving path (ops/quant.py: torch._int_mm, the planar front end)


@pytest.mark.parametrize("M,K,N", [(6400, 768, 3072), (6400, 3072, 768), (9856, 512, 2048), (392, 3072, 768), (24, 64, 8)])
@pytest.mark.parametrize("layout", ["out_in_view", "in_out"])
def test_int8_matmul_on_the_card_matches_the_cpu(cuda, M, K, N, layout):
    """The int32 sums are exact on both devices, and the quantisation and
    the f32 dequantisation are single IEEE operations: equal bits."""
    from clip_mixer_tpu_torch.ops.quant import int8_matmul, quantize_weight

    rng = np.random.default_rng(M + K)
    x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(np.float32))
    wq = quantize_weight(torch.from_numpy(rng.normal(0, K**-0.5, (K, N)).astype(np.float32)))
    q = wq["q"].t().contiguous().t() if layout == "out_in_view" else wq["q"]
    xq = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    acc = torch._int_mm(xq.to(cuda), q.to(cuda))
    torch.testing.assert_close(acc.cpu(), torch._int_mm(xq, q), rtol=0, atol=0)
    scale = torch.tensor(np.float32(np.abs(x.numpy()).max() / 127.0))
    for s in (scale, None):
        want = int8_matmul(x, {"q": q, "scale": wq["scale"]}, s, torch.float32)
        got = int8_matmul(x.to(cuda), {"q": q.to(cuda), "scale": wq["scale"].to(cuda)},
                          None if s is None else s.to(cuda), torch.float32)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def _quant_model(device, dtype="bfloat16"):
    from clip_mixer_tpu_torch import CLIP, CLIPConfig

    cfg = CLIPConfig(embed_dim=32, image_resolution=64, vision_layers=2, vision_width=128, vision_patch_size=16,
                     context_length=77, vocab_size=49408, text_width=128, text_heads=1, text_layers=2,
                     compute_dtype=dtype)
    return CLIP(cfg, device=device, generator=torch.Generator().manual_seed(3)).eval()


def test_int8_encoders_on_the_card_match_the_cpu(cuda):
    """bf16 on both devices, the same int8 weights and scales: per-row
    cosine >= 0.999 (bf16 sums in other orders), as the JAX comparison's
    bf16 bound."""
    from clip_mixer_tpu_torch.evals.quant_gate import synthetic_images
    from clip_mixer_tpu_torch.ops import quant as tq
    from clip_mixer_tpu_torch.ops.preprocess import normalize_images

    u8 = torch.from_numpy(synthetic_images(16, 64, seed=2))
    text = torch.from_numpy(np.random.default_rng(4).integers(1, 49407, (16, 77)).astype(np.int32))
    text[:, 20] = 49407
    cpu = _quant_model("cpu")
    imgs = normalize_images(u8, dtype=torch.bfloat16)
    scales = tq.calibrate_vision_tower(cpu, imgs)
    t_scales = tq.calibrate_text_tower(cpu, text)
    card = _quant_model(cuda)
    qv, qt = tq.quantize_vision_tower(card, scales), tq.quantize_text_tower(card, t_scales)
    qv_cpu, qt_cpu = tq.quantize_vision_tower(cpu, scales), tq.quantize_text_tower(cpu, t_scales)
    for name, buf in qv.named_buffers():
        torch.testing.assert_close(buf.cpu(), dict(qv_cpu.named_buffers())[name], rtol=0, atol=0)
    for got, want in ((tq.encode_image_q(qv, imgs.to(cuda)), tq.encode_image_q(qv_cpu, imgs)),
                      (tq.encode_text_q(qt, text.to(cuda)), tq.encode_text_q(qt_cpu, text))):
        cos = torch.nn.functional.cosine_similarity(got.float().cpu(), want.float(), dim=-1)
        assert float(cos.min()) >= 0.999, float(cos.min())


def test_planar_front_end_on_the_card_matches_the_cpu(cuda):
    """The bf16 resize sums in other orders: at most 1e-3 of the int8 patch
    elements differ, and those by 1."""
    from clip_mixer_tpu_torch import CLIPConfig
    from clip_mixer_tpu_torch.evals.quant_gate import synthetic_images
    from clip_mixer_tpu_torch.ops.quant import make_planar_front_end

    cfg = CLIPConfig()  # Mixer-B/32: 256 -> 224, 32-pixel patches
    u8 = torch.from_numpy(synthetic_images(8, 256, seed=1))
    front = make_planar_front_end(cfg, (256, 256), 0.02)
    got, want = front(u8.to(cuda)).cpu(), front(u8)
    assert got.dtype == torch.int8 and got.shape == (8, 49, 3072)
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3


def test_device_bank_on_the_card_matches_the_host(cuda):
    from clip_mixer_tpu_torch.serving import InferenceEngine

    engine = InferenceEngine(_quant_model(cuda, "float32"), batch_buckets=(8, 32))
    feats = np.random.default_rng(0).normal(size=(20000, 32)).astype(np.float32)
    ids = [str(i) for i in range(20000)]
    texts = [f"a photo of a {w}" for w in ("cat", "dog", "car", "tree", "boat")]
    engine.load_index(feats, ids, device=False)
    host = engine.retrieve(texts, top_k=5)
    engine.load_index(feats, ids)  # 20000 rows >= DEVICE_BANK_MIN_ROWS: on the card
    assert isinstance(engine._index[0], torch.Tensor) and engine._index[0].is_cuda
    dev = engine.retrieve(texts, top_k=5)
    assert [[r["id"] for r in row] for row in dev] == [[r["id"] for r in row] for row in host]


# ---- the transformer (ViT) towers ---------------------------------------------------


def _vit_model(device, dtype="float32", patch=16, res=64):
    from clip_mixer_tpu_torch import CLIP, CLIPConfig

    cfg = CLIPConfig(embed_dim=32, image_resolution=res, vision_layers=2, vision_width=128, vision_patch_size=patch,
                     context_length=77, vocab_size=49408, text_width=128, text_heads=2, text_layers=2,
                     tower="transformer", compute_dtype=dtype)
    return CLIP(cfg, device=device, generator=torch.Generator().manual_seed(5)).eval()


def _vit_inputs():
    from clip_mixer_tpu_torch.evals.quant_gate import synthetic_images
    from clip_mixer_tpu_torch.ops.preprocess import normalize_images

    images = normalize_images(torch.from_numpy(synthetic_images(8, 64, seed=2)), dtype=torch.float32)
    text = torch.from_numpy(np.random.default_rng(4).integers(1, 49407, (8, 77)).astype(np.int32))
    for i in range(8):
        text[i, 5 + 9 * i] = 49407
    return images, text


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_towers_on_the_card_match_the_cpu(cuda, dtype):
    """The same weights and inputs on both devices, TF32 off: per-row cosine
    >= 0.99999 in f32; >= 0.999 in bf16 (sums in other orders)."""
    images, text = _vit_inputs()
    cpu, card = _vit_model("cpu", dtype), _vit_model(cuda, dtype)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            pairs = ((card.encode_image(images.to(cuda)), cpu.encode_image(images)),
                     (card.encode_text(text.to(cuda)), cpu.encode_text(text)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    for got, want in pairs:
        cos = torch.nn.functional.cosine_similarity(got.float().cpu(), want.float(), dim=-1)
        assert float(cos.min()) >= (0.99999 if dtype == "float32" else 0.999), float(cos.min())


def test_vit_text_on_the_card_ignores_tokens_after_eot(cuda):
    _, text = _vit_inputs()
    changed = text.clone()
    changed[0, 20:] = 7  # the first caption's eot is at 5
    for dtype in ("float32", "bfloat16"):
        model = _vit_model(cuda, dtype)
        with torch.inference_mode():
            assert torch.equal(model.encode_text(text.to(cuda))[0], model.encode_text(changed.to(cuda))[0])


@pytest.mark.parametrize("patch", [16, 14], ids=["patch16", "patch14_k588"])
def test_vit_int8_encoders_on_the_card_match_the_cpu(cuda, patch):
    """bf16 on both devices, the same int8 weights and scales: per-row
    cosine >= 0.999. Patch 14 gives the patch embed K = 588, which the
    int8 product pads to a multiple of 8 on the card."""
    from clip_mixer_tpu_torch.ops import quant as tq

    images, text = _vit_inputs()
    res = 56 if patch == 14 else 64
    images = images[:, :res, :res].contiguous().to(torch.bfloat16)
    cpu, card = _vit_model("cpu", "bfloat16", patch, res), _vit_model(cuda, "bfloat16", patch, res)
    scales, t_scales = tq.calibrate_vit_vision_tower(cpu, images), tq.calibrate_vit_text_tower(cpu, text)
    qv, qt = tq.quantize_vit_vision_tower(card, scales), tq.quantize_vit_text_tower(card, t_scales)
    qv_cpu, qt_cpu = tq.quantize_vit_vision_tower(cpu, scales), tq.quantize_vit_text_tower(cpu, t_scales)
    for name, buf in qv.named_buffers():
        torch.testing.assert_close(buf.cpu(), dict(qv_cpu.named_buffers())[name], rtol=0, atol=0)
    for got, want in ((tq.encode_image_q(qv, images.to(cuda)), tq.encode_image_q(qv_cpu, images)),
                      (tq.encode_text_q(qt, text.to(cuda)), tq.encode_text_q(qt_cpu, text))):
        cos = torch.nn.functional.cosine_similarity(got.float().cpu(), want.float(), dim=-1)
        assert float(cos.min()) >= 0.999, float(cos.min())


# ---- the ResNet tower ----------------------------------------------------------------


def _rn_model(device, dtype, seed=6):
    """A small ResNet CLIP from a seed, every BN site's statistics and affine
    drawn from a numpy seed (the init's bn3 scales are 0)."""
    from clip_mixer_tpu_torch import CLIP, CLIPConfig

    cfg = CLIPConfig(embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=16,
                     vision_patch_size=None, context_length=77, vocab_size=49408, text_width=64, text_heads=1,
                     text_layers=1, tower="transformer", compute_dtype=dtype)
    model = CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for bn in model.visual.bn_sites().values():
            c = bn.num_features
            for t, draw in ((bn.weight, rng.uniform(0.5, 1.5, c)), (bn.bias, rng.normal(0, 0.1, c)),
                            (bn.running_mean, rng.normal(0, 0.2, c)), (bn.running_var, rng.uniform(0.5, 2.0, c))):
                t.copy_(torch.from_numpy(draw.astype(np.float32)))
    return model.to(device).eval()


def _rn_images(n=4, seed=8):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 1, (n, 64, 64, 3)).astype(np.float32))


def test_rn_f32_tower_on_the_card_matches_the_cpu(cuda):
    """f32 convolutions on the card run without TF32 (the port switches it
    off around them, whatever the global flag says): per-row cosine >=
    0.99999 against the CPU."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        images = _rn_images()
        with torch.inference_mode():
            want = _rn_model("cpu", "float32").encode_image(images)
            got = _rn_model(cuda, "float32").encode_image(images.to(cuda)).cpu()
        assert torch.backends.cudnn.allow_tf32  # restored
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert float(cos.min()) >= 0.99999, float(cos.min())


def test_rn_int8_conv_sums_on_the_card_equal_the_cpu(cuda):
    """The im2col into ``torch._int_mm``: the same int32 sums on both
    devices, stem (K = 27) and a 3x3 and a 1x1 site."""
    from clip_mixer_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(9)
    for k, cin, stride, padding in ((3, 3, 2, 1), (3, 64, 1, 1), (1, 256, 1, 0)):
        xq = torch.from_numpy(rng.integers(-127, 128, (4, 28, 28, cin)).astype(np.int8))
        q = tq.pad_k(torch.from_numpy(rng.integers(-127, 128, (64, k * k * cin)).astype(np.int8)))
        want = tq.conv_sums(xq, q, k, stride, padding)
        got = tq.conv_sums(xq.to(cuda), q.to(cuda), k, stride, padding)
        assert torch.equal(got.cpu(), want)


def test_rn_int8_tower_on_the_card_matches_the_cpu(cuda):
    """bf16, the same int8 weights and scales on both devices (the CPU's
    quantised tower moved to the card): per-row cosine >= 0.999."""
    from clip_mixer_tpu_torch.ops import quant as tq

    images = _rn_images().to(torch.bfloat16)
    cpu = _rn_model("cpu", "bfloat16")
    q_cpu = tq.quantize_resnet_tower(cpu, tq.calibrate_resnet_tower(cpu, images))
    q_card = copy.deepcopy(q_cpu).to(cuda)
    got, want = tq.encode_image_rn_q(q_card, images.to(cuda)), tq.encode_image_rn_q(q_cpu, images)
    cos = torch.nn.functional.cosine_similarity(got.float().cpu(), want.float(), dim=-1)
    assert float(cos.min()) >= 0.999, float(cos.min())


@pytest.mark.parametrize("wrapping", ["fp16_pt", "accelerate_dir"])
def test_load_of_a_reference_checkpoint_on_the_card(cuda, tmp_path, wrapping):
    """``api.load`` with no device: the model on the card, every tensor the
    file's fp16 value in f32, f32 features on the card against the CPU's
    load of the same file (cosine >= 0.99999), and ``compat.load`` in bf16."""
    from clip_mixer_tpu_torch import CLIP, PRESETS, api, compat

    src = CLIP(PRESETS["mixer-debug"], device="cpu", generator=torch.Generator().manual_seed(4)).state_dict()
    half = {k: v.half() for k, v in src.items()}
    if wrapping == "fp16_pt":
        path = str(tmp_path / "ref.pt")
        torch.save(half, path)
    else:
        path = str(tmp_path / "acc")
        (tmp_path / "acc").mkdir()
        torch.save({"state_dict": {f"module.{k}": v for k, v in half.items()}}, f"{path}/pytorch_model.bin")
    model, cfg, _ = api.load(path, compute_dtype="float32")
    assert model.device.type == "cuda" and cfg.vision_width == PRESETS["mixer-debug"].vision_width
    for k, v in model.state_dict().items():
        assert torch.equal(v.cpu(), half[k].float()), k
    cpu, _, _ = api.load(path, device="cpu", compute_dtype="float32")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        got, want = model.encode_image(images.to(cuda)).cpu(), cpu.encode_image(images)
    assert float(torch.nn.functional.cosine_similarity(got, want, dim=-1).min()) >= 0.99999
    cmodel, _ = compat.load(path)
    assert cmodel.dtype == torch.bfloat16 and cmodel.device.type == "cuda"


@pytest.mark.parametrize("route", ["fused_mlp", "fused_block"])
def test_zeroshot_head_on_a_kernel_route_matches_the_plain_route(cuda, route):
    """The zero-shot head (classifier and logits) with the channel mix
    through ``ln_mlp`` or both towers through ``mixer_tower_fused``, against
    the same weights' plain route on the card, f32: every class column at
    cosine >= 0.9999, logits within 1e-3 relative; the route's kernel
    launched, the other not."""
    from clip_mixer_tpu_torch.evals import zeroshot
    from clip_mixer_tpu_torch.evals.quant_gate import synthetic_images

    classes, templates = ["cat", "dog", "car", "tree"], ["a photo of a {}.", "a drawing of a {}.",
                                                         "a close-up of a {}.", "an image of the {}."]
    plain = _quant_model(cuda, "float32")
    routed = _quant_model(cuda, "float32")
    if route == "fused_mlp":
        for m in routed.modules():
            if hasattr(m, "fused_mlp"):
                m.fused_mlp = True
    else:
        kmb.route_towers(routed, True)
    images = synthetic_images(12, 64, seed=5)
    ln_mlp.launches = fused_mixer_block_tbd.launches = 0
    w = zeroshot.build_zeroshot_classifier(routed, classes, templates, batch_size=8)
    logits = zeroshot.make_image_classifier(routed, w)(images)
    assert (ln_mlp.launches > 0) == (route == "fused_mlp")
    assert (fused_mixer_block_tbd.launches > 0) == (route == "fused_block")
    want_w = zeroshot.build_zeroshot_classifier(plain, classes, templates, batch_size=8)
    want = zeroshot.make_image_classifier(plain, want_w)(images)
    assert float((w * want_w).sum(0).min()) >= 0.9999
    assert np.linalg.norm(logits - want) / np.linalg.norm(want) <= 1e-3


def test_custom_ops_match_their_plain_versions(cuda):
    """The ``clip_mixer::`` operators, called as operators, against the
    plain versions of their kernels; each adds one launch."""
    args = _ln_mlp_args(400, 768, torch.bfloat16, cuda, seed=14)
    before = ln_mlp.launches
    got = torch.ops.clip_mixer.ln_mlp(*args)
    assert ln_mlp.launches == before + 1
    assert _rel_err(got - args[0], ln_mlp_plain(*args) - args[0]) < BRANCH_TOL

    block = MixerBlock(256, 49)
    init_mixer_block(block, text_tower=False, n_layers=12, generator=torch.Generator().manual_seed(14))
    block = block.to(cuda)
    x = torch.randn(8, 49, 256, generator=torch.Generator().manual_seed(15)).to(cuda, torch.bfloat16)
    xt = x.transpose(0, 1)  # the tower's [T, B, D] view
    before = fused_mixer_block_tbd.launches
    got = torch.ops.clip_mixer.mixer_block(xt, list(kmb.block_params(block, torch.bfloat16)))
    assert fused_mixer_block_tbd.launches == before + 1 and got.stride() == xt.stride()
    assert _rel_err(got - xt, mixer_block_plain(block, xt) - xt) < BRANCH_TOL

    bands = kpre.ResizeBands.build((256, 256), 224, cuda)
    images = torch.randint(0, 256, (8, 256, 256, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(16))
    images = images.to(cuda)
    before = kpre.preprocess.launches
    got = torch.ops.clip_mixer.preprocess(images, *(getattr(bands, f.name) for f in dataclasses.fields(bands)),
                                          torch.float32)
    assert kpre.preprocess.launches == before + 1 and got.is_contiguous()
    torch.testing.assert_close(got, kpre.preprocess_plain(images, bands, torch.float32), atol=1e-4, rtol=0)


@pytest.mark.parametrize("route", ["fused_mlp", "fused_block"])
def test_frozen_program_matches_the_live_engine(cuda, tmp_path, route):
    """A frozen mixer-debug program in bf16 widths the kernels take, on the
    card: its features bit for bit the live engine's on the same route, its
    launches one a block."""
    from clip_mixer_tpu_torch import CLIP, PRESETS, aot
    from clip_mixer_tpu_torch.serving import InferenceEngine

    cfg = PRESETS["mixer-debug"].replace(vision_width=128, text_width=128, text_heads=2, compute_dtype="bfloat16",
                                         fused_mlp=route == "fused_mlp")
    model = CLIP(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    if route == "fused_block":
        kmb.route_towers(model, True)
    out = aot.export_servable(model, str(tmp_path / "srv"), batch_buckets=(8,))
    frozen = aot.load_servable(out)
    live = InferenceEngine(model, batch_buckets=(8,))
    texts = ["a photo of a cat", "two dogs", "a red car"]
    images = np.random.default_rng(0).integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    counter = ln_mlp if route == "fused_mlp" else fused_mixer_block_tbd
    before = counter.launches
    got_t, got_i = frozen.encode_text(texts), frozen.encode_image_arrays(images)
    assert counter.launches == before + cfg.text_layers + cfg.vision_layers
    np.testing.assert_array_equal(got_t, live.encode_text(texts))
    np.testing.assert_array_equal(got_i, live.encode_image_arrays(images))


@pytest.mark.parametrize("route", ["plain", "fused_mlp", "fused_block"])
def test_world_one_dp_step_is_the_single_device_step_bit_for_bit(cuda, tmp_path, route):
    """chip_smoke.py's 12a at a small width: in a world of one over NCCL the
    data-parallel step (augmentation and EMA on) gives the single-device
    step's losses and final state bit for bit, launching its route's
    kernel twice a block a step."""
    import torch.distributed as dist

    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.config import TrainConfig
    from clip_mixer_tpu_torch.parallel.dist import maybe_initialize_distributed
    from clip_mixer_tpu_torch.parallel.mesh import data_group, make_mesh
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    cfg = PRESETS["mixer-debug"].replace(vision_width=128, text_width=128, text_heads=2, compute_dtype="bfloat16",
                                         fused_mlp=route == "fused_mlp")
    tcfg = TrainConfig(augment=True, ema_decay=0.9, learning_rate=1e-3)
    rng = np.random.default_rng(0)
    batches = [{"images": torch.from_numpy(rng.integers(0, 256, (8, 40, 40, 3), dtype=np.uint8)).to(cuda),
                "texts": torch.from_numpy(rng.integers(1, 400, (8, cfg.context_length)).astype(np.int32)).to(cuda)}
               for _ in range(2)]
    assert maybe_initialize_distributed(cuda, coordinator=f"file://{tmp_path / 'store'}", num_processes=1,
                                        process_id=0, timeout_s=120)
    try:
        group = data_group(make_mesh(device=cuda))
        assert dist.get_backend(group) == "nccl"
        runs = {}
        for name, g in (("single", None), ("dp", group)):
            model = CLIP(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
            if route == "fused_block":
                kmb.route_towers(model, True)
            opt = make_optimizer(tcfg, total_steps=2)
            state, step = init_train_state(model, opt), make_train_step(cfg, tcfg, opt, group=g)
            counter = {"fused_mlp": ln_mlp, "fused_block": fused_mixer_block_tbd}.get(route)
            before = None if counter is None else counter.launches
            losses = []
            for b in batches:
                state, m = step(state, b)
                losses.append(m["loss"].detach().clone())
            if counter is not None:
                # a launch a block in each forward (the backward runs the unfused chain)
                assert counter.launches - before == 2 * (cfg.vision_layers + cfg.text_layers)
            runs[name] = (losses, {**state.model.state_dict(), **{f"ema.{k}": v for k, v in state.opt_state.ema.items()}})
    finally:
        dist.destroy_process_group()
    for a, b in zip(runs["dp"][0], runs["single"][0]):
        assert torch.equal(a, b)
    for k, v in runs["single"][1].items():
        assert torch.equal(runs["dp"][1][k], v), k


@pytest.mark.parametrize("route", ["plain", "fused_mlp", "fused_block"])
def test_world_one_fsdp_step_is_the_single_device_step_bit_for_bit(cuda, tmp_path, route):
    """chip_smoke.py's 13a at a small width: in a world of one over NCCL the
    FSDP step (augmentation and EMA on) gives the single-device step's
    (``grad_through_gather``) losses and final parameters, Adam moments and
    EMA bit for bit, launching its route's kernel once a block a step; the
    block parameters are FSDP shards."""
    import torch.distributed as dist

    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.config import TrainConfig
    from clip_mixer_tpu_torch.parallel.dist import maybe_initialize_distributed
    from clip_mixer_tpu_torch.parallel.fsdp import apply_fsdp, gather_full, make_fsdp_train_step
    from clip_mixer_tpu_torch.parallel.mesh import make_mesh
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    cfg = PRESETS["mixer-debug"].replace(vision_width=128, text_width=128, text_heads=2, compute_dtype="bfloat16",
                                         fused_mlp=route == "fused_mlp")
    tcfg = TrainConfig(augment=True, ema_decay=0.9, learning_rate=1e-3)
    rng = np.random.default_rng(0)
    batches = [{"images": torch.from_numpy(rng.integers(0, 256, (8, 40, 40, 3), dtype=np.uint8)).to(cuda),
                "texts": torch.from_numpy(rng.integers(1, 400, (8, cfg.context_length)).astype(np.int32)).to(cuda)}
               for _ in range(2)]
    assert maybe_initialize_distributed(cuda, coordinator=f"file://{tmp_path / 'store'}", num_processes=1,
                                        process_id=0, timeout_s=120)
    try:
        mesh = make_mesh(device=cuda)
        runs = {}
        for name in ("single", "fsdp"):
            model = CLIP(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
            if route == "fused_block":
                kmb.route_towers(model, True)
            opt = make_optimizer(tcfg, total_steps=2)
            if name == "fsdp":
                apply_fsdp(model, mesh)
                assert hasattr(model.visual.transformer.mixBlocks[0].channel_mix_seq.lin3.weight, "placements")
                step = make_fsdp_train_step(cfg, tcfg, opt, mesh)
            else:
                step = make_train_step(cfg, tcfg, opt, grad_through_gather=True)
            state = init_train_state(model, opt)
            counter = {"fused_mlp": ln_mlp, "fused_block": fused_mixer_block_tbd}.get(route)
            before = None if counter is None else counter.launches
            losses = []
            for b in batches:
                state, m = step(state, b)
                losses.append(m["loss"].detach().clone())
            if counter is not None:
                assert counter.launches - before == 2 * (cfg.vision_layers + cfg.text_layers)
            opt_state = state.opt_state
            runs[name] = (losses, {**gather_full(model), **{f"mu.{k}": v for k, v in opt_state.mu.items()},
                                   **{f"ema.{k}": v for k, v in gather_full(model, opt_state.ema).items()}})
    finally:
        dist.destroy_process_group()
    for a, b in zip(runs["fsdp"][0], runs["single"][0]):
        assert torch.equal(a, b)
    for k, v in runs["single"][1].items():
        assert torch.equal(runs["fsdp"][1][k], v), k


def test_sharded_checkpoint_round_trip(cuda, tmp_path):
    """A FSDP state on the card saved by every rank (a world of one:
    ``shard-0.pt`` and ``layout.json``) and restored into a fresh sharded
    state: the next step is bit for bit the uninterrupted one's; a whole
    (replicated) state refuses the sharded checkpoint."""
    import torch.distributed as dist

    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.config import TrainConfig
    from clip_mixer_tpu_torch.parallel.dist import maybe_initialize_distributed
    from clip_mixer_tpu_torch.parallel.fsdp import apply_fsdp, gather_full, make_fsdp_train_step
    from clip_mixer_tpu_torch.parallel.mesh import make_mesh
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state
    from clip_mixer_tpu_torch.train.checkpoint import Checkpointer
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    cfg = PRESETS["mixer-debug"].replace(vision_width=128, text_width=128, text_heads=2, compute_dtype="bfloat16")
    tcfg = TrainConfig(ema_decay=0.9, learning_rate=1e-3)
    rng = np.random.default_rng(1)
    batches = [{"images": torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)).to(cuda),
                "texts": torch.from_numpy(rng.integers(1, 400, (8, cfg.context_length)).astype(np.int32)).to(cuda)}
               for _ in range(2)]
    assert maybe_initialize_distributed(cuda, coordinator=f"file://{tmp_path / 'store'}", num_processes=1,
                                        process_id=0, timeout_s=120)
    try:
        mesh = make_mesh(device=cuda)

        def fresh(seed):
            model = apply_fsdp(CLIP(cfg, device=cuda, generator=torch.Generator().manual_seed(seed)), mesh)
            opt = make_optimizer(tcfg, total_steps=2)
            return init_train_state(model, opt), make_fsdp_train_step(cfg, tcfg, opt, mesh)

        state, step = fresh(0)
        state, _ = step(state, batches[0])
        ck = Checkpointer(str(tmp_path / "ck"), group=dist.group.WORLD)
        ck.save(state, epoch=0, step=1)
        assert sorted(os.listdir(tmp_path / "ck" / "1")) == ["layout.json", "meta.json", "shard-0.pt"]
        state, m_a = step(state, batches[1])
        restored, step_b = fresh(5)
        restored, epoch, batch_idx = ck.restore(restored)
        assert (epoch, batch_idx, restored.step) == (0, 1, 1)
        restored, m_b = step_b(restored, batches[1])
        assert torch.equal(m_a["loss"], m_b["loss"])
        a, b = gather_full(state.model), gather_full(restored.model)
        assert all(torch.equal(a[k], b[k]) for k in a)
        whole = CLIP(cfg, device=cuda)
        with pytest.raises(ValueError, match="layout it was saved in"):
            ck.restore(init_train_state(whole, make_optimizer(tcfg, total_steps=2)))
    finally:
        dist.destroy_process_group()
