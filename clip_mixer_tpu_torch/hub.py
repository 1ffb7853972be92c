"""Hub entry points of the port: the counterpart of the repo's root
``hubconf.py``, which stays the JAX package's (``torch.hub.load(<repo>,
...)`` serves the JAX package). Import the port's from here::

    from clip_mixer_tpu_torch import hub
    model, cfg, preprocess = hub.ViT_B_32(device="cuda")
    model, preprocess = hub.mixer_b32(compat=True)      # the reference pair

One entry point per registry model and preset, its punctuation turned into
underscores (the reference's hubconf.py:8,40-42); each returns
``clip_mixer_tpu_torch.api.load``'s ``(model, cfg, preprocess)`` or, with
``compat=True``, ``clip_mixer_tpu_torch.compat.load``'s ``(model,
preprocess)``.
"""

from clip_mixer_tpu_torch.api import _MODELS, load
from clip_mixer_tpu_torch.config import PRESETS
from clip_mixer_tpu_torch.text.tokenize import tokenize  # noqa: F401  (an entry point)

dependencies = ["torch", "numpy"]


def _create_entrypoint(model_name):
    def entrypoint(compat=False, **kwargs):
        if compat:
            from clip_mixer_tpu_torch import compat as _compat

            return _compat.load(model_name, **kwargs)
        return load(model_name, **kwargs)

    entrypoint.__doc__ = (
        f"Load the {model_name} model (model, cfg, preprocess); "
        "compat=True returns the reference-style (model, preprocess)."
    )
    return entrypoint


_SANITIZED = {
    name.replace("/", "_").replace("-", "_").replace("@", "_"): name
    for name in list(_MODELS.keys()) + list(PRESETS.keys())
}

for _entry, _name in _SANITIZED.items():
    globals()[_entry] = _create_entrypoint(_name)
