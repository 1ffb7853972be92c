"""The port's hub entry points (``clip_mixer_tpu_torch.hub``) against the
repo's root ``hubconf.py``, which stays the JAX package's: the same
sanitised names, the triple from ``api.load`` and, with ``compat=True``,
the reference pair."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from clip_mixer_tpu_torch import CLIP, hub


def _hubconf():
    path = os.path.join(os.path.dirname(__file__), "..", "hubconf.py")
    spec = importlib.util.spec_from_file_location("hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entries(mod):
    return {k for k, v in vars(mod).items() if callable(v) and getattr(v, "__name__", "") == "entrypoint"}


def test_entry_names_are_the_root_hubconfs():
    root = _hubconf()
    assert _entries(hub) == _entries(root) and len(_entries(hub)) == 21
    assert set(hub._SANITIZED.items()) == set(root._SANITIZED.items())
    for name in ["ViT_B_32", "RN50", "ViT_L_14_336px", "mixer_b32", "mixer_debug"]:
        assert callable(getattr(hub, name)), name
    assert hub.dependencies == ["torch", "numpy"]
    np.testing.assert_array_equal(hub.tokenize(["hub"], context_length=16),
                                  root.tokenize(["hub"], context_length=16))


def test_entrypoint_native_and_compat():
    model, cfg, preprocess = hub.mixer_debug(device="cpu")
    assert isinstance(model, CLIP) and cfg.tower == "mixer" and callable(preprocess)

    cmodel, tpre = hub.mixer_debug(compat=True, device="cpu")
    toks = hub.tokenize(["hub"], context_length=cmodel.context_length)
    feats = cmodel.encode_text(torch.from_numpy(toks).long())
    assert feats.shape == (1, cfg.embed_dim) and callable(tpre)
    with torch.inference_mode():
        want = model.encode_text(torch.from_numpy(toks))
    assert torch.equal(feats, want)  # the same seed-0 draw, f32 on the CPU both ways


def test_entrypoints_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hub.mixer_debug()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hub.mixer_debug(compat=True)
