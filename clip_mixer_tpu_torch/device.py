"""The port's default-device rule.

Entry points run on the card unless the caller names another device. With
no device given and no CUDA device present they raise: they never drop to
the CPU without being asked.
"""

from __future__ import annotations

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
