"""The host-side plan of the preprocess kernel (``csrc/preprocess.cu``) and its order of work.

The kernel runs only on the card; what surrounds it is Python that these
tests reach on the CPU: the bands of output rows a unit takes, the input
rows each unit stages, the shared-memory budget, and a numpy emulation of
the kernel's per-unit order held against ``preprocess_plain``. The kernel
itself is held against ``preprocess_plain`` on the card in
``test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre

SHAPES = [((256, 256), 224), ((480, 640), 224), ((300, 200), 224), ((224, 224), 224), ((64, 64), 32),
          ((90, 131), 64)]
SMS = 132  # an H100 SXM


def _plan(hw, n, batch):
    bands = kpre.ResizeBands.build(hw, n, "cpu")
    plan = kpre.plan_preprocess(bands.rh_start.numpy(), bands.rw_start.numpy(), bands.rh_taps.shape[1],
                                bands.rw_taps.shape[1], hw, n, batch, SMS)
    return bands, plan


@pytest.mark.parametrize("batches", [(128,), (8, 1)])  # the bench front end; small batches
@pytest.mark.parametrize("hw,n", SHAPES)
def test_plan_covers_every_row_and_tap_within_shared_memory(hw, n, batches):
    h, w = hw
    for batch in batches:
        bands, plan = _plan(hw, n, batch)
        kh = bands.rh_taps.shape[1]
        rh_start = bands.rh_start.numpy()
        # every output row in exactly one band
        covered = np.zeros(n, np.int64)
        for j in range(plan.n_bands):
            covered[j * plan.rows : min(n, (j + 1) * plan.rows)] += 1
        assert (covered == 1).all() and plan.n_bands == -(-n // plan.rows)
        # each band's staged input rows hold every tap of its rows, inside the image
        for j in range(plan.n_bands):
            lo, hi = plan.band_lo[j], plan.band_lo[j] + plan.band_rows[j]
            o = np.arange(j * plan.rows, min(n, (j + 1) * plan.rows))
            assert 0 <= lo and hi <= h
            assert (rh_start[o] >= lo).all() and (rh_start[o] + kh <= hi).all()
        rw_start = bands.rw_start.numpy()
        assert (rw_start >= 0).all() and (rw_start + bands.rw_taps.shape[1] <= w).all()
        # a stage holds the largest band at any 16-byte misalignment of its first byte
        assert plan.stage_bytes % 16 == 0 and plan.stage_bytes >= 15 + int(plan.band_rows.max()) * w * 3
        # the budget: the kernel's layout, under the opt-in limit; as many CTAs an SM as fit
        assert plan.smem_bytes == kpre.smem_bytes(w, n, kh, bands.rw_taps.shape[1], plan.group, plan.stage_bytes)
        assert plan.smem_bytes <= kpre.SMEM_MAX
        assert 1 <= plan.ctas_per_sm <= kpre.CTAS_PER_SM
        assert plan.ctas_per_sm * (plan.smem_bytes + 1024) <= kpre.SMEM_PER_SM
        assert 1 <= plan.group <= min(plan.rows, kpre.PASS_ROWS)
        assert 1 <= plan.grid <= min(batch * plan.n_bands, SMS * plan.ctas_per_sm)
        # a warp's pixels start within 32 words of a plane: its horizontal loads hit distinct banks
        pw = plan.warp_pixels
        assert 1 <= pw <= 32
        assert pw == 1 or (rw_start[pw - 1 :] - rw_start[: n - pw + 1]).max() <= 31


def test_plan_refuses_what_does_not_fit():
    # 8 taps of a 30000-pixel row are 720 KB: no band of one row fits
    bands = kpre.ResizeBands.build((64, 30000), 32, "cpu")
    with pytest.raises(ValueError, match="shared memory"):
        kpre.plan_preprocess(bands.rh_start.numpy(), bands.rw_start.numpy(), bands.rh_taps.shape[1],
                             bands.rw_taps.shape[1], (64, 30000), 32, 8, SMS)


def _emulate(imgs: np.ndarray, bands: kpre.ResizeBands, plan: kpre.PreprocessPlan) -> np.ndarray:
    """The kernel's per-unit order in numpy f32: per unit (image, band) the
    band's input rows staged, then per pass of ``group`` rows the vertical
    sums from the stage (taps in k order, rows offset by the band's first
    row) into channel planes, the horizontal sums (taps in k order, R_w
    transposed), normalised,
    and the pass's rows written where they lie in the output."""
    B, h, w, _ = imgs.shape
    n = bands.n_px
    rh, rh_s = bands.rh_taps.numpy(), bands.rh_start.numpy()
    rw_t, rw_s = bands.rw_taps.numpy().T, bands.rw_start.numpy()  # [KW, N], as the kernel holds it
    norm = bands.norm.numpy()
    out = np.full((B, n, n, 3), np.nan, np.float32)
    cols = rw_s[:, None] + np.arange(rw_t.shape[0])[None]  # [N, KW] input columns of each output pixel
    for u in range(B * plan.n_bands):
        b, j = divmod(u, plan.n_bands)
        lo = plan.band_lo[j]
        stage = imgs[b, lo : lo + plan.band_rows[j]].reshape(plan.band_rows[j], w * 3)
        o0, rows = j * plan.rows, min(plan.rows, n - j * plan.rows)
        for q in range(-(-rows // plan.group)):
            for g in range(min(plan.group, rows - q * plan.group)):
                o = o0 + q * plan.group + g
                t = np.zeros(w * 3, np.float32)
                for k in range(rh.shape[1]):
                    t = t + rh[o, k] * stage[rh_s[o] - lo + k].astype(np.float32)
                planes = t.reshape(w, 3).T  # [3, W]: the kernel's channel planes
                acc = np.zeros((n, 3), np.float32)
                for k in range(rw_t.shape[0]):
                    acc = acc + rw_t[k][:, None] * planes[:, cols[:, k]].T
                out[b, o] = (acc - norm[:3]) * norm[3:]
    return out


@pytest.mark.parametrize("hw,n,batch", [((256, 256), 224, 2), ((480, 640), 224, 1), ((300, 200), 224, 2),
                                        ((64, 64), 32, 3), ((90, 131), 64, 3)])
def test_kernel_order_emulation_matches_plain(hw, n, batch):
    imgs = np.random.default_rng(sum(hw) + batch).integers(0, 256, (batch, *hw, 3), dtype=np.uint8)
    bands, plan = _plan(hw, n, batch)
    got = _emulate(imgs, bands, plan)
    want = kpre.preprocess_plain(torch.from_numpy(imgs), bands, torch.float32).numpy()
    # f32 sums in the banded order against the dense einsums: order only
    np.testing.assert_allclose(got, want, atol=1e-5)
