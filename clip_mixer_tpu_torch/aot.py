"""Frozen serving programs through ``torch.export``.

Counterpart of ``clip_mixer_tpu/aot.py``. Each serving entry point (the
image and the text encoder, one per batch bucket, float or calibrated int8)
is recorded with :func:`torch.export.export` from the one serving
composition, ``serving.encoder_fns``, and saved beside the checkpoint. A
server then runs the recorded programs, not the model code, with the
tracing paid at export time.

Layout written by :func:`export_servable` (a superset of the
``save_pretrained`` directory, so ``api.load`` still takes it):

    out_dir/
      config.json + model.pt          # save_pretrained payload
      servable/manifest.json          # buckets, int8, device type, route
      servable/{image,text}_{B}.pt2   # torch.export programs
      servable/calibration.npz        # int8 scales (ops/quant_io.py), if int8

A program takes the parameters and buffers of the module it was recorded
from as its first input, ``{name: tensor}``, as the JAX programs take
``params`` at call time: no ``.pt2`` holds weights, and
:func:`load_servable` takes them from the checkpoint (int8 weights
re-derived from ``calibration.npz``). The kernels are the ``clip_mixer::``
operators of ``ops/kernels/``, one node each in a program.

Deviations from the JAX package: a program is recorded on the exporting
process's device type, and ``platforms=`` may name only that (a ``.pt2``
has no lowering for a platform the host lacks); ``mesh=`` is refused
(ROADMAP.md item 16); the manifest writes ``torch_version`` where JAX
writes ``jax_version``, and ``route``, the tower route the programs were
recorded on (``fused_mlp``, ``fused_block`` or ``plain``), which loading
rebuilds on the engine's model.
"""

from __future__ import annotations

import json
import operator
import os
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

# the operators a program may hold; registered before any program loads
from clip_mixer_tpu_torch.ops.kernels import ln_mlp as _ln_mlp  # noqa: F401
from clip_mixer_tpu_torch.ops.kernels import mixer_block as _mixer_block
from clip_mixer_tpu_torch.ops.kernels import preprocess as _preprocess  # noqa: F401

# version 1: the original layout; version 2 adds input_hw (device-side
# resize), written only when input_hw is set, so that a loader that knows
# only version 1 refuses such an export instead of feeding it model-sized
# images
_MANIFEST_VERSION = 1
_SUPPORTED_MANIFEST_VERSIONS = (1, 2)
ROUTES = ("plain", "fused_mlp", "fused_block")


def _sdir(out_dir: str) -> Path:
    return Path(out_dir) / "servable"


def _checked_artifact(int8_calibration: str, cfg) -> dict:
    """Load and validate a calibration artifact for a frozen int8 export."""
    from clip_mixer_tpu_torch.ops import quant_io

    art = quant_io.load_calibration(int8_calibration)
    quant_io.check_cfg(art["cfg"], cfg)
    if art["image_scales"] is None or art["text_scales"] is None:
        raise ValueError(
            "servable int8 export needs a calibration artifact with BOTH towers "
            "(scripts/torch_calibrate_int8.py writes one)"
        )
    return art


def _quantized_towers(model, art: dict):
    """(image quant module, text quant module) re-derived from an artifact
    (deterministic given the weights and the scales)."""
    from clip_mixer_tpu_torch.ops.quant import image_quant_fns, text_quant_fns

    cfg = model.cfg
    return image_quant_fns(cfg)[1](model, art["image_scales"]), text_quant_fns(cfg)[1](model, art["text_scales"])


def serving_route(model) -> str:
    """The route a CLIP's Mixer towers run: ``fused_block`` when
    ``route_towers`` bound them, else ``fused_mlp`` or ``plain`` by its
    config."""
    towers = (getattr(model.visual, "transformer", None), model.transformer)
    if any(t is not None and "forward" in vars(t) for t in towers):
        return "fused_block"
    return "fused_mlp" if model.cfg.fused_mlp else "plain"


def program_state(module) -> Dict[str, torch.Tensor]:
    """A program's first input: the module's parameters and buffers
    (non-persistent ones too), by name."""
    state = dict(module.named_parameters())
    state.update(module.named_buffers())
    return {k: v.detach() for k, v in state.items()}


class _Bound(torch.nn.Module):
    """``fn(module, batch)`` as a module's forward, for ``functional_call``."""

    def __init__(self, fn, module):
        super().__init__()
        self.fn, self.m = fn, module

    def forward(self, batch):
        return self.fn(self.m, batch)


class _Program(torch.nn.Module):
    """What is exported: ``forward(state, batch)`` runs ``fn(module,
    batch)`` with ``module``'s tensors replaced by ``state``. The module is
    held unregistered, so the program records no weights of its own."""

    def __init__(self, fn, module):
        super().__init__()
        self.__dict__["bound"] = _Bound(fn, module)

    def forward(self, state: Dict[str, torch.Tensor], batch: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.bound, {f"m.{k}": v for k, v in state.items()}, (batch,))


def _record(fn, module, batch: torch.Tensor, path: Path) -> None:
    with torch.no_grad():
        ep = torch.export.export(_Program(fn, module), (program_state(module), batch))
    ep.example_inputs = None  # they hold the weights, which torch.export.save would write
    tmp_dir = path.parent / f".tmp{os.getpid()}"
    tmp_dir.mkdir(exist_ok=True)
    torch.export.save(ep, str(tmp_dir / path.name))
    os.replace(tmp_dir / path.name, path)
    tmp_dir.rmdir()


def export_servable(
    model,
    out_dir: str,
    *,
    batch_buckets: Sequence[int] = (1, 8, 32, 128),
    int8_calibration: Optional[str] = None,
    platforms: Optional[Sequence[str]] = None,
    mesh=None,
    input_hw=None,
) -> str:
    """Write a self-contained frozen-serving directory (see the module
    doc) for ``model``, a port ``CLIP`` on the device the programs are
    for: its ``save_pretrained`` checkpoint plus the recorded programs.

    int8_calibration: a ``quant_io`` artifact holding BOTH towers' scales;
    the programs are then the calibrated W8A8 encoders. platforms: None or
    the model's device type only. mesh: refused (ROADMAP.md item 16)."""
    from clip_mixer_tpu_torch.api import save_pretrained

    check_target(model, platforms, mesh)
    if int8_calibration is not None:
        # before the checkpoint write, so a bad artifact leaves no half-written export
        _checked_artifact(int8_calibration, model.cfg)
    save_pretrained(model, model.cfg, out_dir)
    return freeze_programs(model, out_dir, batch_buckets=batch_buckets, int8_calibration=int8_calibration,
                           platforms=platforms, mesh=mesh, input_hw=input_hw)


def check_target(model, platforms=None, mesh=None) -> None:
    """Raise ValueError unless ``platforms`` is None or the model's device
    type alone, and ``mesh`` is None: what the export functions take."""
    if mesh is not None:
        raise ValueError("mesh= (programs recorded over several devices) is not ported to "
                         "clip_mixer_tpu_torch yet: ROADMAP.md, Queue 1 item 16")
    here = torch.device(model.device).type
    if platforms is not None and set(platforms) != {here}:
        raise ValueError(
            f"platforms={list(platforms)!r}: a torch.export program is recorded on the exporting "
            f"process's device ({here!r}) and runs only there; export on a host of each device type"
        )


def freeze_programs(
    model,
    out_dir: str,
    *,
    batch_buckets: Sequence[int] = (1, 8, 32, 128),
    int8_calibration: Optional[str] = None,
    platforms: Optional[Sequence[str]] = None,
    mesh=None,
    input_hw=None,
) -> str:
    """Record just the ``servable/`` payload into an existing
    ``save_pretrained`` directory of ``model``'s weights (the trainer's
    completion export, for one). The weights only shape the programs:
    :func:`load_servable` feeds them the checkpoint's."""
    from clip_mixer_tpu_torch.serving import encoder_fns

    check_target(model, platforms, mesh)
    cfg, dev = model.cfg, torch.device(model.device)
    buckets = sorted(set(int(b) for b in batch_buckets))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"batch_buckets must be positive ints, got {batch_buckets!r}")
    sdir = _sdir(out_dir)
    sdir.mkdir(parents=True, exist_ok=True)

    int8 = int8_calibration is not None
    # the ONE serving composition: frozen-vs-live bit equality rests on both
    # paths building from it
    image_fn, text_fn = encoder_fns(cfg, int8=int8, input_hw=input_hw)
    was_training = model.training
    model.eval()
    try:
        if int8:
            art = _checked_artifact(int8_calibration, cfg)
            img_mod, txt_mod = _quantized_towers(model, art)
            (sdir / "calibration.npz").write_bytes(Path(int8_calibration).read_bytes())
        else:
            img_mod = txt_mod = model
        R, ctx = cfg.image_resolution, cfg.context_length
        ih, iw = tuple(input_hw) if input_hw is not None else (R, R)
        for b in buckets:
            _record(image_fn, img_mod, torch.zeros((b, ih, iw, 3), dtype=torch.uint8, device=dev),
                    sdir / f"image_{b}.pt2")
            _record(text_fn, txt_mod, torch.zeros((b, ctx), dtype=torch.int32, device=dev),
                    sdir / f"text_{b}.pt2")
    finally:
        model.train(was_training)

    manifest = {
        "version": _MANIFEST_VERSION if input_hw is None else 2,
        "buckets": buckets,
        "int8": int8,
        "platforms": [dev.type],
        "mesh": None,
        "input_hw": None if input_hw is None else [ih, iw],
        "torch_version": torch.__version__,
        "route": serving_route(model),
    }
    (sdir / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return out_dir


def read_manifest(path: str) -> dict:
    """``servable/manifest.json`` of ``path``, its version checked."""
    mpath = _sdir(path) / "manifest.json"
    if not mpath.exists():
        raise FileNotFoundError(f"{path} has no servable/manifest.json — not an export_servable dir")
    manifest = json.loads(mpath.read_text())
    if manifest.get("version") not in _SUPPORTED_MANIFEST_VERSIONS:
        raise ValueError(f"unsupported servable manifest version {manifest.get('version')!r}")
    return manifest


def apply_route(model, route: str) -> None:
    """Rebuild a manifest's ``route`` on a freshly loaded model."""
    if route not in ROUTES:
        raise ValueError(f"unknown serving route {route!r} (known: {ROUTES})")
    if route == "fused_mlp" and not model.cfg.fused_mlp:
        raise ValueError("the programs were recorded with fused_mlp=True but the checkpoint's config has it off")
    _mixer_block.route_towers(model, route == "fused_block")


def _program(path: Path) -> torch.fx.GraphModule:
    """A saved program, ready to call. Its ``_assert_tensor_metadata``
    nodes go: export records one before each dtype cast (~180 a tower),
    each a check of a tensor the program itself derived from inputs that
    were checked, run on the host at every call."""
    gm = torch.export.load(str(path)).module()
    for node in list(gm.graph.nodes):
        if node.op == "call_function" and node.target is torch.ops.aten._assert_tensor_metadata.default:
            gm.graph.erase_node(node)
    gm.recompile()
    return gm


def load_servable(path: str, *, check_platform: bool = True, device=None):
    """Load a frozen-serving directory into an ``InferenceEngine`` that
    runs the recorded programs (no model code is traced). Raises if
    ``path`` has no ``servable/`` payload: use ``api.load`` then.

    check_platform: refuse a device type the programs were not recorded
    for, here rather than as a per-request error; False defers to call
    time. device: as every entry point (the card unless another is named)."""
    from clip_mixer_tpu_torch.api import load
    from clip_mixer_tpu_torch.device import resolve_device
    from clip_mixer_tpu_torch.ops import quant_io
    from clip_mixer_tpu_torch.serving import InferenceEngine

    manifest = read_manifest(path)
    dev = resolve_device(device)
    if check_platform and manifest["platforms"] and dev.type not in manifest["platforms"]:
        raise ValueError(
            f"servable programs were recorded for {manifest['platforms']} but this process serves on "
            f"{dev.type!r}: re-export there, or pass check_platform=False to defer to call time"
        )
    if manifest.get("mesh"):
        raise ValueError("servable programs recorded over a device mesh are not ported to "
                         "clip_mixer_tpu_torch yet: ROADMAP.md, Queue 1 item 16")

    model, cfg, _ = load(str(path), device=dev)
    apply_route(model, manifest.get("route", "plain"))
    input_hw = manifest.get("input_hw")
    engine = InferenceEngine(model, batch_buckets=tuple(manifest["buckets"]),
                             input_hw=None if input_hw is None else tuple(input_hw))
    sdir = _sdir(path)
    if manifest["int8"]:
        art = quant_io.load_calibration(str(sdir / "calibration.npz"))
        quant_io.check_cfg(art["cfg"], cfg)
        img_mod, txt_mod = _quantized_towers(model, art)
    else:
        img_mod = txt_mod = model

    def table(modality):
        return {b: _program(sdir / f"{modality}_{b}.pt2") for b in manifest["buckets"]}

    def dispatch(progs):
        # a program's call runs its forward pre-hooks, where torch.export
        # checks every input against the recorded spec, ~200 tensors, which
        # costs ms of host time a call. A program is called through them when
        # its batch's shape, dtype or device, or its state (the same dict
        # holding the same tensors, kept here), is new to it, and straight to
        # its forward when all are what the last checked call had
        seen = {}

        def fn(state, batch):
            b = int(batch.shape[0])
            if b not in progs:
                raise ValueError(f"no exported program for batch {b} (buckets {sorted(progs)})")
            key = (tuple(batch.shape), batch.dtype, batch.device)
            tensors = tuple(state.values())
            prev = seen.get(b)
            if (prev is not None and prev[0] == key and prev[1] is state and len(prev[2]) == len(tensors)
                    and all(map(operator.is_, prev[2], tensors))):
                return progs[b].forward(state, batch)
            out = progs[b](state, batch)
            seen[b] = (key, state, tensors)
            return out

        return fn

    engine._image_path = (dispatch(table("image")), program_state(img_mod))
    engine._text_path = (dispatch(table("text")), program_state(txt_mod))
    kind = "int8" if manifest["int8"] else "float"
    engine.path_kinds = {"image": kind, "text": kind}
    engine.frozen = True
    return engine
