"""Temporal convolutional network: the full-band extractor, and the 2-D
causal encoder / decoder conv blocks.

Counterpart of fullsubnet_plus_tpu/nn/tcn.py:23-158, 275-296 (reference
TCNBlock, causal_conv.py:67-117): 1x1 conv -> PReLU -> GroupNorm(1) ->
depthwise dilated conv -> PReLU -> GroupNorm(1) -> 1x1 conv, plus the
residual skip. The stack is 8 blocks with dilations (1, 2, 5, 9) x 2 and
hidden width 512, hard-coded as in the reference (the sub-band variant's
widths are `tcn_stack`'s options). `CausalConvBlock` and
`CausalTransConvBlock` are JAX tcn.py:173-268 (reference causal_conv.py:
5-64): a (3, 2) conv, or transposed conv, at stride (2, 1) on [B, C, F, T],
chomped to stay causal in T, then BatchNorm2d and an activation. No shipped
config uses them.

Float32 on the card: `conv1d` keeps the JAX package's two forms, a matmul
for the 1x1 conv and shifted multiply-adds for the depthwise conv, and
`conv2d` / `conv_transpose2d` gather or scatter their taps around one
matmul, so no convolution goes through cuDNN (whose float32 default is
TF32), and a float32 matmul runs in full float32 under PyTorch's default
precision.
"""

from __future__ import annotations

import torch
from torch import nn

from fullsubnet_plus_torch.dsp.norms import time_mask
from fullsubnet_plus_torch.nn.layers import (
    BatchNorm2dParams,
    Conv1d,
    Conv2d,
    GroupNormParams,
    PReLU,
)

TCN_DILATIONS = (1, 2, 5, 9, 1, 2, 5, 9)
TCN_HIDDEN = 512


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, *,
           dilation: int = 1, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """torch.nn.functional.conv1d for the two forms the model uses.
    x [B, C, T], weight [O, I/g, K]: depthwise (groups == C == O) or 1x1."""
    out_c, in_per_group, k = weight.shape
    in_c = x.shape[1]
    if groups == in_c == out_c and in_per_group == 1:
        xp = nn.functional.pad(x, (padding, padding)) if padding else x
        t_out = xp.shape[-1] - dilation * (k - 1)
        out = weight[None, :, 0, 0, None] * xp[:, :, :t_out]
        for tap in range(1, k):
            start = tap * dilation
            out = out + weight[None, :, 0, tap, None] * xp[:, :, start:start + t_out]
    elif k == 1 and groups == 1 and dilation == 1 and padding == 0:
        out = torch.matmul(weight[:, :, 0], x)  # [O, C] @ [B, C, T]
    else:
        raise ValueError(
            f"conv1d supports depthwise and 1x1 forms only, got weight "
            f"{tuple(weight.shape)}, groups={groups}, for {in_c} input channels")
    if bias is not None:
        out = out + bias[None, :, None]
    return out


def group_norm1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-8, valid: torch.Tensor | None = None) -> torch.Tensor:
    """nn.GroupNorm(1, C) over (C, T) per sample, x [B, C, T]. With `valid`
    the statistics cover the first valid[b] frames and the rest is zeroed."""
    if valid is None:
        mu = x.mean(dim=(1, 2), keepdim=True)
        var = ((x - mu) ** 2).mean(dim=(1, 2), keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * weight[None, :, None] + bias[None, :, None]
    mask = time_mask(x.shape[-1], valid, x.dtype)[:, None, :]
    count = (x.shape[1] * valid.to(x.dtype))[:, None, None]
    mu = (x * mask).sum(dim=(1, 2), keepdim=True) / count
    var = (((x - mu) * mask) ** 2).sum(dim=(1, 2), keepdim=True) / count
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight[None, :, None] + bias[None, :, None]) * mask


class TCNBlock(nn.Module):
    """Non-causal TCN block, x [B, C, T] -> [B, C, T]."""

    def __init__(self, channels: int, hidden: int = TCN_HIDDEN, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.padding = dilation * (kernel_size - 1) // 2
        self.conv1x1 = Conv1d(channels, hidden, 1)
        self.prelu1 = PReLU()
        self.norm1 = GroupNormParams(hidden)
        self.depthwise_conv = Conv1d(hidden, hidden, kernel_size, groups=hidden)
        self.prelu2 = PReLU()
        self.norm2 = GroupNormParams(hidden)
        self.sconv = Conv1d(hidden, channels, 1)

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
        y = conv1d(x, self.conv1x1.weight, self.conv1x1.bias)
        y = group_norm1(self.prelu1(y), self.norm1.weight, self.norm1.bias, valid=valid)
        y = conv1d(y, self.depthwise_conv.weight, self.depthwise_conv.bias,
                   dilation=self.dilation, padding=self.padding,
                   groups=self.depthwise_conv.weight.shape[0])
        y = group_norm1(self.prelu2(y), self.norm2.weight, self.norm2.bias, valid=valid)
        out = x + conv1d(y, self.sconv.weight, self.sconv.bias)
        if valid is not None:
            # keep "zero beyond valid": the sconv bias and the skip would
            # otherwise put back values the next conv smears inward
            out = out * time_mask(out.shape[-1], valid, out.dtype)[:, None, :]
        return out


def tcn_stack(channels: int, hidden: int = TCN_HIDDEN,
              last_hidden: int | None = None) -> nn.ModuleList:
    """The 8 blocks; the stack's ReLU is applied by its caller. The shipped
    stack has hidden width 512 throughout; SequenceModel's "TCN-subband"
    (reference sequence_model.py:59-70, JAX nn/tcn.py:274-289) has
    `hidden` for blocks 1-7 and `last_hidden` (384) for block 8."""
    hiddens = [hidden] * len(TCN_DILATIONS)
    if last_hidden is not None:
        hiddens[-1] = last_hidden
    return nn.ModuleList(TCNBlock(channels, h, dilation=d)
                         for h, d in zip(hiddens, TCN_DILATIONS))


# -- 2-D causal conv blocks ----------------------------------------------------

ACTIVATIONS = {"ELU": nn.functional.elu, "ReLU": nn.functional.relu, "Tanh": torch.tanh,
               "LeakyReLU": nn.functional.leaky_relu}  # LeakyReLU's slope 0.01


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, *,
           stride=(1, 1), padding=((0, 0), (0, 0))) -> torch.Tensor:
    """torch.nn.functional.conv2d as a gather of the kf * kt taps and one
    matmul. x [B, I, F, T], weight [O, I, kf, kt], padding ((F before,
    after), (T before, after)) -> [B, O, F', T']."""
    out_c, in_c, kf, kt = weight.shape
    (f0, f1), (t0, t1) = padding
    sf, st = stride
    xp = nn.functional.pad(x, (t0, t1, f0, f1)) if f0 or f1 or t0 or t1 else x
    f_out = (xp.shape[2] - kf) // sf + 1
    t_out = (xp.shape[3] - kt) // st + 1
    taps = [xp[:, :, i:i + sf * (f_out - 1) + 1:sf, j:j + st * (t_out - 1) + 1:st]
            for i in range(kf) for j in range(kt)]
    cols = torch.stack(taps, dim=2).reshape(x.shape[0], in_c * kf * kt, f_out * t_out)
    out = torch.matmul(weight.reshape(out_c, in_c * kf * kt), cols)
    out = out.reshape(x.shape[0], out_c, f_out, t_out)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                     *, stride=(1, 1), output_padding=(0, 0)) -> torch.Tensor:
    """torch.nn.functional.conv_transpose2d without padding, as one matmul of
    x by the [I, O kf kt] weight and a scatter-add of the taps into the
    strided output. x [B, I, F, T], weight [I, O, kf, kt] -> [B, O,
    (F - 1) sf + kf + output_padding[0], (T - 1) st + kt + output_padding[1]];
    the padded rows and columns hold the bias alone."""
    in_c, out_c, kf, kt = weight.shape
    b, _, f, t = x.shape
    sf, st = stride
    cols = torch.matmul(weight.reshape(in_c, out_c * kf * kt).t(), x.reshape(b, in_c, f * t))
    cols = cols.reshape(b, out_c, kf, kt, f, t)
    out = x.new_zeros(b, out_c, (f - 1) * sf + kf + output_padding[0],
                      (t - 1) * st + kt + output_padding[1])
    for i in range(kf):
        for j in range(kt):
            out[:, :, i:i + sf * (f - 1) + 1:sf, j:j + st * (t - 1) + 1:st] += cols[:, :, i, j]
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


def batch_norm2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 running_mean: torch.Tensor, running_var: torch.Tensor, *,
                 training: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """nn.BatchNorm2d on x [B, C, F, T]: with `training` the batch's mean
    and biased variance, else the running statistics, which it never
    updates (the JAX package is functional)."""
    if training:
        mu = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mu) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    else:
        mu = running_mean[None, :, None, None]
        var = running_var[None, :, None, None]
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * weight[None, :, None, None] + bias[None, :, None, None]


class CausalConvBlock(nn.Module):
    """Conv2d (3, 2) at stride (2, 1), T padded by one each side and the
    look-ahead sample chomped, BatchNorm2d, then the activation: [B, I, F, T]
    -> [B, O, (F - 3) // 2 + 1, T]."""

    def __init__(self, in_channels: int, out_channels: int, activation: str = "ELU"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"CausalConvBlock: unknown activation {activation!r}, "
                             f"expected one of {sorted(ACTIVATIONS)}")
        self.activation = activation
        self.conv = Conv2d(in_channels, out_channels, (3, 2))
        self.norm = BatchNorm2dParams(out_channels)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        y = conv2d(x, self.conv.weight, self.conv.bias, stride=(2, 1),
                   padding=((0, 0), (1, 1)))[:, :, :, :-1]
        n = self.norm
        y = batch_norm2d(y, n.weight, n.bias, n.running_mean, n.running_var, training=training)
        return ACTIVATIONS[self.activation](y)


class CausalTransConvBlock(nn.Module):
    """ConvTranspose2d (3, 2) at stride (2, 1) with `output_padding`, the
    last time sample chomped, BatchNorm2d, then ReLU (`is_last`) or ELU:
    [B, I, F, T] -> [B, O, 2 F + 1 + output_padding[0], T + output_padding[1]]."""

    def __init__(self, in_channels: int, out_channels: int, is_last: bool = False,
                 output_padding=(0, 0)):
        super().__init__()
        self.is_last = is_last
        self.output_padding = tuple(output_padding)
        self.conv = Conv2d(in_channels, out_channels, (3, 2), transposed=True)
        self.norm = BatchNorm2dParams(out_channels)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        y = conv_transpose2d(x, self.conv.weight, self.conv.bias, stride=(2, 1),
                             output_padding=self.output_padding)[:, :, :, :-1]
        n = self.norm
        y = batch_norm2d(y, n.weight, n.bias, n.running_mean, n.running_var, training=training)
        return nn.functional.relu(y) if self.is_last else nn.functional.elu(y)
