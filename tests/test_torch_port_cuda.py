"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a CUDA
device. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
"""

import copy

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_preprocess_kernel_matches_plain(cuda, dtype):
    imgs = torch.randint(0, 256, (16, 256, 256, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(9))
    bands = kpre.ResizeBands.build((256, 256), 224, cuda)
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


def test_backward_through_the_kernels_matches_plain_autograd(cuda):
    """Gradients reach x and every parameter through both kernels (f32)."""
    block, x = _block_case(8, 50, 768, torch.float32, cuda, seed=13, text_tower=False)
    x.requires_grad_()
    inputs = [x, *block.parameters()]
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(14)).to(cuda)
    before = fused_mixer_block_tbd.launches
    got = torch.autograd.grad(mixer_block_fused(block, x), inputs, g)
    assert fused_mixer_block_tbd.launches == before + 1
    want = torch.autograd.grad(mixer_block_plain(block, x), inputs, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)  # test_pallas_kernels.py:121

    args = [t.requires_grad_() for t in _ln_mlp_args(400, 768, torch.float32, cuda, seed=15)]
    g = torch.randn(400, 768, generator=torch.Generator().manual_seed(16)).to(cuda)
    before = ln_mlp.launches
    got = torch.autograd.grad(ln_mlp(*args), args, g)
    assert ln_mlp.launches == before + 1
    want = torch.autograd.grad(ln_mlp_plain(*args), args, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


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
