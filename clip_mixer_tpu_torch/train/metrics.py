"""Metrics writer: an in-memory history, a JSONL sink, and TensorBoard when present.

Counterpart of ``clip_mixer_tpu/train/metrics.py``, with its scalar names
(Loss, Learning rate, Gradient norm, Logit scale, Throughput (imgs/s), ...).
``{log_dir}/metrics.jsonl`` gets every scalar as ``{"step", "name",
"value"}``, appended at :meth:`MetricsWriter.flush`, so the step path never
touches the disk; with ``log_dir=None`` the writer keeps the history only
(the eval command line's default). TensorBoard events are written too when
``torch.utils.tensorboard`` imports; where it does not (the card's host has
no ``tensorboard``), the JSONL file is the record.

Run directories are local: a ``gs://`` log dir is refused (ROADMAP.md,
Queue 3), where ``os.makedirs`` would silently create ``./gs:/``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


def require_local(path: str, what: str) -> None:
    """Raise ValueError for a remote (``scheme://``) path."""
    if "://" in str(path):
        raise ValueError(
            f"{what} must be a local directory, got {path!r}: the port does not write "
            "remote run dirs yet (ROADMAP.md, Queue 3: no gs:// run dirs)"
        )


class MetricsWriter:
    def __init__(self, log_dir: Optional[str] = None):
        self.history: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
        self._jsonl_path = None
        self._jsonl_buf: List[str] = []
        self._tb = None
        if log_dir is None:
            return
        require_local(log_dir, "log_dir")
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, name: str, value: float, step: int) -> None:
        self.history[name].append((int(step), float(value)))
        if self._jsonl_path is not None:
            self._jsonl_buf.append(json.dumps({"step": int(step), "name": name, "value": float(value)}))
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)

    def add_figure(self, name: str, figure, step: int) -> None:
        """Records ``"{name}:figure"`` in the history; the figure itself
        goes to TensorBoard only."""
        self.history[f"{name}:figure"].append((int(step), 1.0))
        if self._tb is not None:
            self._tb.add_figure(name, figure, step)

    def flush(self) -> None:
        if self._jsonl_buf:
            with open(self._jsonl_path, "a") as f:
                f.write("\n".join(self._jsonl_buf) + "\n")
            self._jsonl_buf = []
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        if self._tb is not None:
            self._tb.close()
