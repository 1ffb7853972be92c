"""The port's default-device rule.

Entry points run on the card unless the caller names another device. With
no device given and no CUDA device present they raise: they never drop to
the CPU without being asked.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port on the CPU"
        )
    return torch.device("cuda")


def compute_dtype(name: Optional[str]) -> torch.dtype:
    """``CLIPConfig.compute_dtype`` name -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


def no_tf32() -> None:
    """f32 matmuls and convolutions in full f32 on the card: PyTorch's
    default lets cuDNN's convolutions run in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card(device: torch.device):
    """(name, power limit) of ``device``: the card's, as ``nvidia-smi
    --query-gpu=name,power.limit`` reads them; (the device, None) off a card."""
    if device.type != "cuda":
        return str(device), None
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        power = out.strip().splitlines()[device.index or 0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        power = None
    return name, power
