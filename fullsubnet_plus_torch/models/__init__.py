"""Model registry: the reference TOMLs' dotted paths and the short names.

Counterpart of fullsubnet_plus_tpu/models/__init__.py:13-59. The baseline
FullSubNet is ROADMAP.md Queue 1 item 7; its names raise until then.
"""

from __future__ import annotations

from fullsubnet_plus_torch.device import not_ported
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlus, FullSubNetPlusConfig


class ModelDef:
    """A model family's config dataclass and module class."""

    def __init__(self, name, config_cls, module_cls, n_inputs):
        self.name = name
        self.config_cls = config_cls
        self.module_cls = module_cls
        self.n_inputs = n_inputs  # spectrogram views consumed (1 or 3)

    def make_config(self, args: dict):
        """The config dataclass from a reference-style TOML args table
        (unknown keys such as weight_init are ignored)."""
        fields = self.config_cls.__dataclass_fields__
        kwargs = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in args.items() if k in fields}
        return self.config_cls(**kwargs)


FULLSUBNET_PLUS = ModelDef("fullsubnet_plus", FullSubNetPlusConfig, FullSubNetPlus, n_inputs=3)

MODEL_REGISTRY = {
    "fullsubnet_plus": FULLSUBNET_PLUS,
    "fullsubnet_plus.model.fullsubnet_plus.FullSubNet_Plus": FULLSUBNET_PLUS,
}
_NOT_PORTED = ("fullsubnet", "fullsubnet.model.fullsubnet.Model")


def get_model(name: str) -> ModelDef:
    if name in _NOT_PORTED:
        raise not_ported(f"model {name!r}", "Queue 1 item 7")
    if name not in MODEL_REGISTRY:
        raise KeyError(f"Unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]
