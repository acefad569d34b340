"""Model registry: the reference TOMLs' dotted paths and the short names.

Counterpart of fullsubnet_plus_tpu/models/__init__.py:13-59: FullSubNet+
(three spectrogram views) and the FullSubNet baseline (the magnitude alone).
"""

from __future__ import annotations

from fullsubnet_plus_torch.models.fullsubnet import FullSubNet, FullSubNetConfig
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
FULLSUBNET = ModelDef("fullsubnet", FullSubNetConfig, FullSubNet, n_inputs=1)

# the reference's dotted paths (config/train.toml:74, inference.toml:27-28)
# and the short names
MODEL_REGISTRY = {
    "fullsubnet_plus": FULLSUBNET_PLUS,
    "fullsubnet": FULLSUBNET,
    "fullsubnet_plus.model.fullsubnet_plus.FullSubNet_Plus": FULLSUBNET_PLUS,
    "fullsubnet.model.fullsubnet.Model": FULLSUBNET,
}


def get_model(name: str) -> ModelDef:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"Unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]
