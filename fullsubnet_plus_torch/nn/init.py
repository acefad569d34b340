"""Parameter initializers drawn from an explicit `torch.Generator`: torch's
defaults and the reference's optional `weight_init` scheme.

Counterpart of fullsubnet_plus_tpu/nn/init.py:20-89 (reference
base_model.py:332-397). `kaiming_uniform` and `uniform_fan_in` are torch's
default Linear / Conv1d / LSTM / GRU draws (the layers of nn/layers.py and
nn/lstm.py draw the same bounds); `orthogonal` is a QR of a normal draw with
the signs of R's diagonal, as jax.nn.initializers.orthogonal;
`reference_weight_init` re-draws a module's parameters with the reference's
scheme: xavier-normal for Linear weights, standard-normal for conv weights
and every bias, orthogonal for recurrent matrices, GroupNorm and PReLU left
as they are. The shipped configs set weight_init=false, so this is the
config surface only. The draws cannot match JAX's key for key; they share
its structure and properties (tests/test_torch_zoo.py).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def kaiming_uniform(shape, fan_in: int, generator: torch.Generator,
                    a: float = math.sqrt(5.0)) -> torch.Tensor:
    """torch.nn.init.kaiming_uniform_ with the leaky_relu gain (torch's
    default for Linear and Conv1d weights): U(-b, b), b = gain sqrt(3 / fan_in)."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    bound = gain * math.sqrt(3.0 / fan_in)
    return torch.rand(shape, generator=generator) * (2 * bound) - bound


def uniform_fan_in(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)); zeros for fan_in 0."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return torch.rand(shape, generator=generator) * (2 * bound) - bound


def orthogonal(shape, generator: torch.Generator) -> torch.Tensor:
    """A [rows, cols] matrix whose rows (rows <= cols) or columns are
    orthonormal."""
    rows, cols = shape
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return (q.t() if rows < cols else q).to(torch.float32).contiguous()


def reference_weight_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw `model`'s parameters in place with the reference's scheme,
    in `named_parameters` order. Recurrent matrices (`weight_ih_l*`,
    `weight_hh_l*`) are orthogonal in torch's [gates, in] layout, so the
    JAX layout's wide [H, 4H] `w_hh` has orthonormal rows as there."""
    from fullsubnet_plus_torch.nn.layers import Conv1d, GroupNormParams, Linear, PReLU

    kinds = {}
    for module_name, module in model.named_modules():
        for name, _ in module.named_parameters(recurse=False):
            kinds[f"{module_name}.{name}" if module_name else name] = (module, name)
    with torch.no_grad():
        for key, p in model.named_parameters():
            module, name = kinds[key]
            if isinstance(module, (GroupNormParams, PReLU)):
                continue
            if name.startswith(("weight_ih", "weight_hh")):
                value = orthogonal(tuple(p.shape), generator)
            elif isinstance(module, Linear) and name == "weight":
                fan_out, fan_in = p.shape
                value = math.sqrt(2.0 / (fan_in + fan_out)) * torch.randn(
                    p.shape, generator=generator)
            elif isinstance(module, (Linear, Conv1d)) or name.startswith("bias"):
                value = torch.randn(p.shape, generator=generator)
            else:
                raise ValueError(f"reference_weight_init: no rule for {key}")
            p.copy_(value)
    return model
