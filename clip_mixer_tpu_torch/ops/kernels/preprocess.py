"""Fused image front end: uint8 resize + crop + normalise in one kernel.

Replaces ``clip_mixer_tpu/ops/pallas/preprocess_kernel.py::make_pallas_preprocess``.
The CUDA kernel is ``csrc/preprocess.cu`` (its header says what bounds it on
an H100 and how the design answers that): a banded, separable pass over the
same PIL-bicubic matrices the ``"torch"`` backend multiplies densely.
:func:`preprocess` launches it for CUDA tensors and raises on what it does
not take; it uses :func:`preprocess_plain` only for tensors on the CPU.
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
_ARGTYPES = [_P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P]


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


def preprocess_plain(images: torch.Tensor, bands: ResizeBands, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dense R_h, then R_w per
    channel, then normalise, in f32."""
    x = resize(images, bands.rh, bands.rw)
    return ((x - bands.norm[:3]) * bands.norm[3:]).to(dtype)


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
    if w * 3 * 4 > 48 * 1024:
        raise ValueError(f"preprocess: input width {w} too wide for one shared-memory row")
    B = images.shape[0]
    out = torch.empty((B, n, n, 3), dtype=dtype, device=images.device)
    if B == 0:
        return out
    lib = _lib()
    fn = lib.preprocess_u8_bf16 if dtype == torch.bfloat16 else lib.preprocess_u8_f32
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            images.data_ptr(), bands.rh_taps.data_ptr(), bands.rh_start.data_ptr(), bands.rh_taps.shape[1],
            bands.rw_taps.data_ptr(), bands.rw_start.data_ptr(), bands.rw_taps.shape[1], bands.norm.data_ptr(),
            out.data_ptr(), B, h, w, n, stream,
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
