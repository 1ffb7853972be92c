"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a CUDA
device. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
"""

import numpy as np
import pytest
import torch

from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre
from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp, ln_mlp_plain

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
    [  # 64-row blocks (R = 6400, 9856), 32-row blocks (400, 231), f32
        (6400, 768, torch.bfloat16), (9856, 512, torch.bfloat16), (400, 768, torch.bfloat16),
        (231, 512, torch.bfloat16), (400, 768, torch.float32), (77, 64, torch.float32),
    ],
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
