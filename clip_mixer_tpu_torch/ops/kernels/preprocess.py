"""Fused image front end: uint8 resize + crop + normalise in one kernel.

Replaces ``clip_mixer_tpu/ops/pallas/preprocess_kernel.py::make_pallas_preprocess``.
The CUDA kernel is ``csrc/preprocess.cu`` (its header says what bounds it on
an H100 and how the design answers that): a banded, separable pass over the
same PIL-bicubic matrices the ``"torch"`` backend multiplies densely.
:func:`preprocess` launches it for CUDA tensors and raises on what it does
not take; it uses :func:`preprocess_plain` only for tensors on the CPU.

The kernel's work units are bands of output rows of one image, each with the
contiguous input rows its taps reach staged whole in shared memory;
:func:`plan_preprocess` cuts the bands, sizes the passes and the shared
memory (:func:`smem_bytes` mirrors the kernel's ``Layout``) and picks the
grid and the pixels a warp takes, on the host, once per (shape, batch, card).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from clip_mixer_tpu_torch.ops.kernels import _build
from clip_mixer_tpu_torch.ops.preprocess import _cached_matrices, norm_constants, resize

_P = ctypes.c_void_p
_I = ctypes.c_int
# img, R_h taps and starts, KH, R_w taps and starts, KW, norm, bands, out; B, H,
# W, N, R, G, n_bands, stage bytes, pixels a warp, shared memory, grid; the stream
_ARGTYPES = [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P] + [_I] * 11 + [_P]

THREADS = 256  # csrc/preprocess.cu
SMEM_MAX = 232448  # 227 KB, the most one block may opt into on an H100
SMEM_PER_SM = 233472  # an SM's 228 KB of shared memory; each block also takes 1 KB
ROWS = (32, 16, 8, 4, 2, 1)  # output rows a unit may take
PASS_ROWS = 4  # output rows a pass, at most (MAX_PASS of csrc/preprocess.cu)
CTAS_PER_SM = 3  # the most the kernel's register bound (__launch_bounds__) allows


def band(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pack the non-zero band of each row of ``m`` [N, L]: (taps [N, K] f32,
    start [N] int32) with ``m[r, start[r]:start[r] + K] == taps[r]`` and every
    non-zero of row r inside it. K is the widest band; narrower rows carry
    exact zeros, and starts are pulled left so no band runs past L."""
    nz = m != 0
    first = nz.argmax(axis=1)
    last = m.shape[1] - 1 - nz[:, ::-1].argmax(axis=1)
    k = int((last - first + 1).max())
    start = np.minimum(first, m.shape[1] - k)
    taps = np.stack([m[r, s : s + k] for r, s in enumerate(start)]).astype(np.float32)
    return taps, start.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ResizeBands:
    """The resize constants of one (input_hw, n_px) on one device: the dense
    matrices (for the plain version), their packed bands (for the kernel),
    and ``norm`` = (255 * mean, 1 / (255 * std)) as one f32 [6] tensor."""

    rh: torch.Tensor
    rw: torch.Tensor
    rh_taps: torch.Tensor
    rh_start: torch.Tensor
    rw_taps: torch.Tensor
    rw_start: torch.Tensor
    norm: torch.Tensor

    @classmethod
    def build(cls, input_hw: Tuple[int, int], n_px: int, device) -> "ResizeBands":
        rh, rw = _cached_matrices(input_hw[0], input_hw[1], n_px)
        rh_taps, rh_start = band(rh)
        rw_taps, rw_start = band(rw)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(t(rh), t(rw), t(rh_taps), t(rh_start), t(rw_taps), t(rw_start), torch.cat(norm_constants(device)))

    @property
    def input_hw(self) -> Tuple[int, int]:
        return self.rh.shape[1], self.rw.shape[1]

    @property
    def n_px(self) -> int:
        return self.rh.shape[0]


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(input_w: int, n_px: int, kh: int, kw: int, group: int, stage_bytes: int) -> int:
    """The kernel's shared memory (``Layout`` of ``csrc/preprocess.cu``):
    two input stages; two f32 row buffers [group, 3 channel planes, W
    rounded up to 4]; the R_h and R_w taps and starts; norm; two
    mbarriers. Each region 16-byte aligned."""
    rowf = 3 * (-(-input_w // 4) * 4)
    n = 2 * stage_bytes + _a16(2 * group * rowf * 4)
    n += _a16(n_px * kh * 4) + _a16(n_px * 4) + _a16(n_px * kw * 4) + _a16(n_px * 4)
    return n + 32 + 16


@dataclasses.dataclass(frozen=True)
class PreprocessPlan:
    """How the kernel cuts one call. A unit is a band of ``rows`` output
    rows of one image (the last band may be shorter); band j stages input
    rows ``band_lo[j]`` to ``band_lo[j] + band_rows[j]`` whole, every tap of
    its rows; a pass computes ``group`` output rows, and in its horizontal
    sums a warp takes ``warp_pixels`` consecutive output pixels. ``grid``
    persistent CTAs of ``THREADS`` threads, ``ctas_per_sm`` an SM, walk the
    units."""

    rows: int
    group: int
    band_lo: np.ndarray
    band_rows: np.ndarray
    stage_bytes: int
    warp_pixels: int
    smem_bytes: int
    ctas_per_sm: int
    grid: int

    @property
    def n_bands(self) -> int:
        return len(self.band_lo)


def warp_pixels(rw_start: np.ndarray) -> int:
    """The most consecutive output pixels whose R_w starts all lie within 32
    words: a warp of that many reads 32 distinct banks of a channel plane
    for each tap."""
    s = np.asarray(rw_start)
    for pw in range(min(32, len(s)), 1, -1):
        if int((s[pw - 1 :] - s[: len(s) - pw + 1]).max()) <= 31:
            return pw
    return 1


def plan_preprocess(rh_start: np.ndarray, rw_start: np.ndarray, kh: int, kw: int, input_hw: Tuple[int, int],
                    n_px: int, batch: int, sms: int) -> PreprocessPlan:
    """The plan for ``batch`` images of ``input_hw`` -> ``n_px`` on a card of
    ``sms`` SMs. Among the band heights in
    ``ROWS`` whose shared memory fits, it takes the one with the least
    (waves of units) x (band height + KH), the rows a CTA stages; the pass
    height is ``PASS_ROWS`` or less where that does not fit. Raises when even
    one row a unit does not fit."""
    h, w = input_hw
    rowb = w * 3
    best = None
    for rows in ROWS:
        starts = [np.asarray(rh_start[o : o + rows]) for o in range(0, n_px, rows)]
        lo = np.array([s.min() for s in starts], np.int32)
        hi = np.array([s.max() + kh for s in starts], np.int32)
        stage = _a16(15 + int((hi - lo).max()) * rowb)
        for group in (g for g in (PASS_ROWS, 2, 1) if g <= min(rows, PASS_ROWS)):
            smem = smem_bytes(w, n_px, kh, kw, group, stage)
            if smem <= SMEM_MAX:
                break
        else:
            continue
        per_sm = min(CTAS_PER_SM, SMEM_PER_SM // (smem + 1024))
        units = max(batch, 1) * len(lo)
        grid = min(units, sms * per_sm)
        cost = -(-units // grid) * (rows + kh)
        if best is None or cost < best[0]:
            best = (cost, PreprocessPlan(rows, group, lo, hi - lo, stage, warp_pixels(rw_start), smem, per_sm, grid))
    if best is None:
        raise ValueError(f"preprocess: input {h}x{w} -> {n_px} does not fit the kernel's shared memory "
                         f"({SMEM_MAX} bytes) even at one output row a unit")
    return best[1]


def preprocess_plain(images: torch.Tensor, bands: ResizeBands, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dense R_h, then R_w per
    channel, then normalise, in f32."""
    x = resize(images, bands.rh, bands.rw)
    return ((x - bands.norm[:3]) * bands.norm[3:]).to(dtype)


@functools.lru_cache(maxsize=None)
def _cached_plan(input_hw: Tuple[int, int], n_px: int, batch: int, device_index: int):
    """(plan, its band table [2, n_bands] int32 on the card), once per
    (shape, batch, card): a plan depends on nothing else."""
    rh, rw = _cached_matrices(input_hw[0], input_hw[1], n_px)
    rh_taps, rh_start = band(rh)
    rw_taps, rw_start = band(rw)
    dev = torch.device("cuda", device_index)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = plan_preprocess(rh_start, rw_start, rh_taps.shape[1], rw_taps.shape[1], input_hw, n_px, batch, sms)
    return plan, torch.from_numpy(np.concatenate([plan.band_lo, plan.band_rows])).to(dev)


def _plan(bands: ResizeBands, batch: int):
    """The kernel's plan and band table for ``batch`` images on the bands' card."""
    dev = bands.rh_taps.device
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _cached_plan(bands.input_hw, bands.n_px, batch, index)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("preprocess")
    for fn in (lib.preprocess_u8_bf16, lib.preprocess_u8_f32):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def preprocess(images: torch.Tensor, bands: ResizeBands, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised [B, n_px, n_px, 3] ``dtype``."""
    if images.device.type == "cpu":
        return preprocess_plain(images, bands, dtype)
    if images.device.type != "cuda":
        raise ValueError(f"preprocess runs on CUDA or CPU tensors, got {images.device}")
    h, w = bands.input_hw
    n = bands.n_px
    if images.dtype != torch.uint8 or images.dim() != 4 or tuple(images.shape[1:]) != (h, w, 3):
        raise ValueError(f"preprocess takes uint8 [B, {h}, {w}, 3], got {images.dtype} {tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("preprocess: images must be contiguous")
    if bands.rh_taps.device != images.device:
        raise ValueError(f"preprocess: constants on {bands.rh_taps.device}, images on {images.device}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"preprocess stores bfloat16 or float32, got {dtype}")
    B = images.shape[0]
    out = torch.empty((B, n, n, 3), dtype=dtype, device=images.device)
    if B == 0:
        return out
    plan, table = _plan(bands, B)
    lib = _lib()
    fn = lib.preprocess_u8_bf16 if dtype == torch.bfloat16 else lib.preprocess_u8_f32
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            images.data_ptr(), bands.rh_taps.data_ptr(), bands.rh_start.data_ptr(), bands.rh_taps.shape[1],
            bands.rw_taps.data_ptr(), bands.rw_start.data_ptr(), bands.rw_taps.shape[1], bands.norm.data_ptr(),
            table.data_ptr(), out.data_ptr(), B, h, w, n, plan.rows, plan.group, plan.n_bands, plan.stage_bytes,
            plan.warp_pixels, plan.smem_bytes, plan.grid, stream,
        )
    _build.check(rc, "preprocess")
    preprocess.launches += 1
    return out


preprocess.launches = 0


def make_kernel_preprocess(input_hw: Tuple[int, int], n_px: int = 224, dtype: torch.dtype = torch.bfloat16):
    """A function uint8 [B, H, W, 3] -> [B, n_px, n_px, 3] ``dtype`` through
    :func:`preprocess`, with the constants built once per device."""
    per_device = {}

    def fn(images: torch.Tensor) -> torch.Tensor:
        bands = per_device.get(images.device)
        if bands is None:
            bands = per_device[images.device] = ResizeBands.build(tuple(input_hw), n_px, images.device)
        return preprocess(images, bands, dtype)

    return fn
