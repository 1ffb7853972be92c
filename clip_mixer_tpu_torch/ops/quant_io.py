"""Persistent int8 calibration artifacts: calibrate once, serve anywhere.

Counterpart of ``clip_mixer_tpu/ops/quant_io.py``, copied so that the port
imports nothing of the JAX package. The data-dependent part of enabling the
W8A8 serving path (``ops/quant.py``) is calibration, the activation scales
measured on sample inputs; weight quantisation is deterministic given the
weights and scales. An artifact is those scale trees (a few KB) with the
architecture fingerprint they were measured under, so a serving process
enables int8 with no calibration data on hand::

    engine.enable_int8(calibration="scales.npz")

The format is the JAX package's, so an ``.npz`` written by either package
loads in the other: one ``.npz`` whose scale trees are flattened to arrays
keyed ``image/NNNN`` / ``text/NNNN``, their tree paths recorded in a JSON
``__meta__`` entry beside the config fingerprint and the format version.
Paths are local; a remote (``gs://``) path raises.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from clip_mixer_tpu_torch.config import CLIPConfig

FORMAT_VERSION = 1

# Config fields that do not change the quantisation sites or numerics of the
# serving forward — a mismatch here is fine. Everything else (dims, depths,
# tower family, vocab) is a hard error: scales are per-site measurements.
_TRAIN_ONLY_FIELDS = frozenset(
    {
        "remat",
        "remat_policy",
        "fused_mlp",
        "model_axis",
        "pipeline_axis",
        "pipeline_stages",
        "pipeline_microbatches",
        # Loss-init scalars: irrelevant to inference numerics (the trained
        # values live in the params), and absent from artifacts saved before
        # these config fields existed — hard-matching them would reject every
        # previously shipped calibration/bank/release on upgrade.
        "logit_scale_init",
        "logit_bias_init",
    }
)
# Soft-checked: scales measured under one compute dtype remain valid under
# another (they are f32 quantile statistics), but the numerics drift is
# worth a warning.
_SOFT_FIELDS = frozenset({"compute_dtype"})

_Path = Tuple[Tuple[str, Any], ...]


def require_local_file(path: str, what: str) -> None:
    """Raise ValueError for a remote (``scheme://``) path."""
    if "://" in str(path):
        raise ValueError(
            f"{what} must be a local file, got {path!r}: the port reads and writes no "
            "remote paths yet (ROADMAP.md, Queue 3: no gs:// run dirs)"
        )


def _flatten(tree: Any, prefix: _Path = ()) -> Iterator[Tuple[_Path, np.ndarray]]:
    if isinstance(tree, dict):
        bad = [k for k in tree if not isinstance(k, str)]
        if bad:
            # str(k) would silently change the key on the load side
            raise TypeError(f"scale-tree dict keys must be str, got {bad!r}")
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (("d", k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (("i", i),))
    else:
        yield prefix, np.asarray(tree)


def _unflatten(items: List[Tuple[_Path, np.ndarray]]) -> Any:
    if not items:
        return None
    if len(items) == 1 and items[0][0] == ():
        return items[0][1]

    # Build with (kind, key) dict keys, then convert "i" levels to lists.
    root: Dict = {}
    for path, arr in items:
        node = root
        for step in path[:-1]:
            node = node.setdefault(step, {})
        node[path[-1]] = arr

    def convert(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        kinds = {k[0] for k in node}
        if len(kinds) != 1:
            raise ValueError(f"corrupt artifact: mixed dict/list level {sorted(node)}")
        if kinds == {"i"}:
            idx = sorted(node, key=lambda k: k[1])
            if [k[1] for k in idx] != list(range(len(idx))):
                raise ValueError(f"corrupt artifact: non-contiguous list indices {idx}")
            return [convert(node[k]) for k in idx]
        return {k[1]: convert(v) for k, v in node.items()}

    return convert(root)


def _cfg_dict(cfg: CLIPConfig) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    # tuple fields (resnet vision_layers) -> lists so the JSON round-trip
    # compares equal.
    return json.loads(json.dumps(d))


def check_cfg(saved: Dict[str, Any], cfg: CLIPConfig) -> None:
    """Raise if `cfg`'s architecture differs from the fingerprint the scales
    were calibrated under; warn on soft (numerics-only) differences."""
    current = _cfg_dict(cfg)
    hard, soft = [], []
    for k in sorted(set(saved) | set(current)):
        if k in _TRAIN_ONLY_FIELDS:
            continue
        if saved.get(k) != current.get(k):
            (soft if k in _SOFT_FIELDS else hard).append(
                f"{k}: artifact={saved.get(k)!r} vs model={current.get(k)!r}"
            )
    if hard:
        raise ValueError(
            "int8 calibration artifact was made for a different architecture: "
            + "; ".join(hard)
        )
    for msg in soft:
        warnings.warn(f"int8 calibration dtype mismatch ({msg}); scales remain valid", stacklevel=3)


def save_calibration(
    path: str,
    cfg: CLIPConfig,
    image_scales: Optional[Dict] = None,
    text_scales: Optional[Dict] = None,
) -> None:
    """Write an int8 calibration artifact (either or both towers; numpy
    leaves)."""
    require_local_file(path, "calibration artifact")
    if image_scales is None and text_scales is None:
        raise ValueError("nothing to save: both image_scales and text_scales are None")
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {"version": FORMAT_VERSION, "cfg": _cfg_dict(cfg), "paths": {}}
    for section, tree in (("image", image_scales), ("text", text_scales)):
        if tree is None:
            continue
        paths = []
        for i, (p, arr) in enumerate(_flatten(tree)):
            arrays[f"{section}/{i:04d}"] = arr
            paths.append([list(step) for step in p])
        meta["paths"][section] = paths
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:  # a file object: np.savez adds no suffix
        np.savez(f, **arrays)


def load_calibration(path: str) -> Dict[str, Any]:
    """Read an artifact -> {"cfg": dict, "image_scales": tree|None,
    "text_scales": tree|None}. Validate against a model with check_cfg()."""
    require_local_file(path, "calibration artifact")
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported calibration artifact version {meta.get('version')!r} "
                f"(this build reads version {FORMAT_VERSION})"
            )
        out: Dict[str, Any] = {"cfg": meta["cfg"], "image_scales": None, "text_scales": None}
        for section in ("image", "text"):
            if section not in meta["paths"]:
                continue
            items = [
                (tuple((kind, key) for kind, key in meta["paths"][section][i]), z[f"{section}/{i:04d}"])
                for i in range(len(meta["paths"][section]))
            ]
            out[f"{section}_scales"] = _unflatten(items)
    return out
