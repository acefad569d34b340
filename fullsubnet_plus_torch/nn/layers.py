"""Parameter-holding layers with torch's default initialization, drawn from
an explicit `torch.Generator`.

Counterpart of fullsubnet_plus_tpu/nn/init.py:20-50: Linear and Conv1d
weights and biases are U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (kaiming-uniform
with a = sqrt(5), torch's default), PReLU starts at 0.25 and GroupNorm at
weight 1, bias 0; BatchNorm2d (fullsubnet_plus_tpu/nn/tcn.py:195-201) at
weight 1, bias 0, running mean 0 and variance 1. The forwards are plain
tensor code; the convolutions take the forms of `conv1d` and `conv2d` in
nn/tcn.py and never reach cuDNN.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fullsubnet_plus_torch.nn.init import kaiming_uniform, uniform_fan_in


def uniform_(tensor: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        values = torch.rand(tensor.shape, generator=generator, dtype=torch.float32)
        tensor.copy_(values * (2 * bound) - bound)


class Linear(nn.Module):
    """y = x @ weight.T + bias over the last axis; weight [out, in]."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.weight.t()) + self.bias


class Conv1d(nn.Module):
    """Holds a torch-layout conv weight [out, in/groups, k] and, unless
    `bias` is False, a bias [out] (None otherwise)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.weight.shape[2]
        bound = 1.0 / math.sqrt(fan_in)
        uniform_(self.weight, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, bound, generator)


class Conv2d(nn.Module):
    """Holds a 2-D conv weight and bias [out]: [out, in, kf, kt] for a conv,
    torch's ConvTranspose2d layout [in, out, kf, kt] for a transposed one.
    Either way the fan-in is weight.shape[1] * kf * kt, as torch draws it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple,
                 transposed: bool = False):
        super().__init__()
        shape = (in_channels, out_channels) if transposed else (out_channels, in_channels)
        self.weight = nn.Parameter(torch.empty(*shape, *kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _, fan, kf, kt = self.weight.shape
        fan_in = fan * kf * kt
        with torch.no_grad():
            self.weight.copy_(kaiming_uniform(self.weight.shape, fan_in, generator))
            self.bias.copy_(uniform_fan_in(self.bias.shape, fan_in, generator))


class PReLU(nn.Module):
    """nn.PReLU with one shared slope: where(x >= 0, x, a * x)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)


class GroupNormParams(nn.Module):
    """The affine parameters of nn.GroupNorm(1, C); see nn/tcn.group_norm1."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


class BatchNorm2dParams(nn.Module):
    """The affine parameters and running statistics of nn.BatchNorm2d(C);
    see nn/tcn.batch_norm2d, which never updates the statistics."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)


def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize every layer of `model` from `generator`, in module
    registration order."""
    for module in model.modules():
        if module is not model and hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
