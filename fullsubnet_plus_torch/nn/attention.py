"""Channel attention: TSSE (the paper's MulCA, the shipped variant) and the
SE, ECA, CBAM, TSSE-weight, DeepTSSE and TSSE_ATT alternatives.

Counterpart of fullsubnet_plus_tpu/nn/attention.py:34-359 (reference
attention_model.py:6-390). Inputs are [B, C, T], the C frequency bins
acting as channels; each attention pools over time into a per-channel
descriptor and gates x with a sigmoid per channel:
  * TSSE: three depthwise valid convs over time (kernel sizes 3, 5, 10),
    each averaged and ReLU'd, fused by Linear(3 -> 1), then an SE
    bottleneck C -> C/2 -> C;
  * SE: the bottleneck on the time mean; CBAM: the shared fc1 on the mean
    and the max, the two ReLUs summed before fc2; ECA: a bias-free conv over
    the channel axis of the time mean, its kernel size from the weight's
    shape and padding (k - 1) // 2;
  * TSSEWeight: TSSE returning its gate [B, C, 1] too; DeepTSSE: two
    depthwise convs with ReLUs a scale, pooled after them; TSSE_ATT: each
    scale a depthwise conv, then a self-attention over time that scores with
    a sigmoid (not a softmax) scaled by sqrt(d_k), d_k = C a module
    constant, written as explicit products, then a mean and a ReLU.
TSSE, SE, ECA and CBAM take `valid` ([B] frame counts) for a padded batch:
their time pooling covers each row's valid frames (CBAM's max over -inf
outside them); DeepTSSE and TSSE_ATT refuse it, as JAX does
(nn/attention.py:351-353). Attribute names follow the reference state_dict.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fullsubnet_plus_torch.dsp.norms import time_mask
from fullsubnet_plus_torch.nn.layers import Conv1d, Linear
from fullsubnet_plus_torch.nn.tcn import conv1d

def _gate(module: nn.Module, squeeze: torch.Tensor) -> torch.Tensor:
    """The SE bottleneck: sigmoid(fc2(relu(fc1(squeeze)))), [B, C]."""
    return torch.sigmoid(module.fc2(torch.relu(module.fc1(squeeze))))


def _masked_mean_t(x: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """[B, C, T] -> [B, C], the mean over each row's first valid[b] frames
    (the padded region must be zero)."""
    if valid is None:
        return x.mean(dim=2)
    return x.sum(dim=2) / valid.to(x.dtype)[:, None]


def _refuse_valid(name: str, valid) -> None:
    if valid is not None:
        raise ValueError(f"masked pooling is not wired for {name} "
                         "(it has no valid_frames form, as in the JAX package)")


def _add_bottleneck(module: nn.Module, num_channels: int, reduction_ratio: int = 2) -> None:
    """fc1 C -> C/2 and fc2 C/2 -> C, the SE bottleneck every attention but
    ECA ends in, registered last as in the reference."""
    module.fc1 = Linear(num_channels, num_channels // reduction_ratio)
    module.fc2 = Linear(num_channels // reduction_ratio, num_channels)


class TSSE(nn.Module):
    """x [B, C, T] -> gated x. Keys follow the reference: smallConv1d.0,
    middleConv1d.0, largeConv1d.0, feature_concate_fc, fc1, fc2."""

    def __init__(self, num_channels: int, kersize=(3, 5, 10), reduction_ratio: int = 2):
        super().__init__()
        self.kersize = tuple(kersize)
        c = num_channels
        self.smallConv1d = nn.ModuleList([Conv1d(c, c, kersize[0], groups=c)])
        self.middleConv1d = nn.ModuleList([Conv1d(c, c, kersize[1], groups=c)])
        self.largeConv1d = nn.ModuleList([Conv1d(c, c, kersize[2], groups=c)])
        self.feature_concate_fc = Linear(3, 1)
        _add_bottleneck(self, c, reduction_ratio)

    def gate(self, x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
        """[B, C] sigmoid gate. `valid` ([B] frame counts): each branch
        averages over exactly the valid - k + 1 frames its conv yields on
        the exact-length input. The padded region of x must be zero (the
        masked norm before it is)."""
        channels = x.shape[1]

        def branch(conv: Conv1d, k: int) -> torch.Tensor:
            y = conv1d(x, conv.weight, conv.bias, groups=channels)
            if valid is None:
                return torch.relu(y.mean(dim=-1))
            n_out = torch.clamp(valid - k + 1, min=1).to(y.dtype)
            mask = time_mask(y.shape[-1], valid - k + 1, y.dtype)
            return torch.relu((y * mask[:, None, :]).sum(dim=-1) / n_out[:, None])

        feats = torch.stack([
            branch(self.smallConv1d[0], self.kersize[0]),
            branch(self.middleConv1d[0], self.kersize[1]),
            branch(self.largeConv1d[0], self.kersize[2]),
        ], dim=-1)  # [B, C, 3]
        return _gate(self, self.feature_concate_fc(feats)[..., 0])

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
        return x * self.gate(x, valid)[:, :, None]


class TSSEWeight(TSSE):
    """ChannelTimeSenseSEWeightLayer (attention_model.py:101-156): TSSE's
    parameters; x -> (gated x, gate [B, C, 1])."""

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None):
        _refuse_valid("TSSEWeight", valid)
        gate = self.gate(x)[:, :, None]
        return x * gate, gate


class SE(nn.Module):
    """Squeeze-and-excitation on the time mean (attention_model.py:6-40)."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2):
        super().__init__()
        _add_bottleneck(self, num_channels, reduction_ratio)

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
        return x * _gate(self, _masked_mean_t(x, valid))[:, :, None]


class CBAM(SE):
    """CBAM's channel attention (attention_model.py:296-332): the shared fc1
    on the time mean and the time max, the two ReLUs summed before fc2."""

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
        avg_pool = _masked_mean_t(x, valid)
        if valid is None:
            max_pool = x.amax(dim=2)
        else:
            mask = time_mask(x.shape[-1], valid, torch.bool)[:, None, :]
            max_pool = torch.where(mask, x, torch.full_like(x, -torch.inf)).amax(dim=2)
        hidden = torch.relu(self.fc1(avg_pool)) + torch.relu(self.fc1(max_pool))
        return x * torch.sigmoid(self.fc2(hidden))[:, :, None]


class ECA(nn.Module):
    """ECA (attention_model.py:344-361): conv1d(1, 1, k, bias=False) over the
    channel axis of the time mean. Key: conv.weight [1, 1, k]."""

    def __init__(self, num_channels: int, k_size: int = 3):
        super().__init__()
        self.conv = Conv1d(1, 1, k_size, bias=False)

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
        k_size = self.conv.weight.shape[-1]
        squeeze = _masked_mean_t(x, valid)[:, None, :]  # [B, 1, C]
        y = conv1d(squeeze, self.conv.weight, padding=(k_size - 1) // 2)
        return x * torch.sigmoid(y[:, 0, :])[:, :, None]


class DeepTSSE(nn.Module):
    """ChannelDeepTimeSenseSELayer (attention_model.py:159-223): a scale is
    conv -> ReLU -> conv -> ReLU (keys smallConv1d.0 and .2), pooled over
    time after the ReLUs."""

    def __init__(self, num_channels: int, kersize=(3, 5, 10), reduction_ratio: int = 2):
        super().__init__()
        c = num_channels

        def scale(k):
            return nn.Sequential(Conv1d(c, c, k, groups=c), nn.ReLU(),
                                 Conv1d(c, c, k, groups=c), nn.ReLU())

        self.smallConv1d = scale(kersize[0])
        self.middleConv1d = scale(kersize[1])
        self.largeConv1d = scale(kersize[2])
        self.feature_concate_fc = Linear(3, 1)
        _add_bottleneck(self, c, reduction_ratio)

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
        _refuse_valid("DeepTSSE", valid)
        channels = x.shape[1]

        def branch(seq: nn.Sequential) -> torch.Tensor:
            y = torch.relu(conv1d(x, seq[0].weight, seq[0].bias, groups=channels))
            y = torch.relu(conv1d(y, seq[2].weight, seq[2].bias, groups=channels))
            return y.mean(dim=-1)

        feats = torch.stack([branch(self.smallConv1d), branch(self.middleConv1d),
                             branch(self.largeConv1d)], dim=-1)
        return x * _gate(self, self.feature_concate_fc(feats)[..., 0])[:, :, None]


class SelfAttention(nn.Module):
    """SelfAttentionlayer (attention_model.py:226-256) over [B, T, F]:
    sigmoid(q k^T / sqrt(d_k)) v, then the out Linear; d_k = amp_dim."""

    def __init__(self, amp_dim: int = 257, att_dim: int = 257):
        super().__init__()
        self.d_k = amp_dim  # a constant, not a parameter
        self.q_linear = Linear(amp_dim, att_dim)
        self.k_linear = Linear(amp_dim, att_dim)
        self.v_linear = Linear(amp_dim, att_dim)
        self.out = Linear(att_dim, amp_dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        q, k, v = self.q_linear(q), self.k_linear(k), self.v_linear(v)
        scores = torch.sigmoid(torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(self.d_k))
        return self.out(torch.matmul(scores, v))


class ConvAttentionBlock(nn.Module):
    """Conv_Attention_Block (attention_model.py:364-390): [B, C, T] -> a
    depthwise valid conv, self-attention over time, mean, ReLU -> [B, C, 1]."""

    def __init__(self, num_channels: int, kersize: int):
        super().__init__()
        self.conv1d = Conv1d(num_channels, num_channels, kersize, groups=num_channels)
        self.attention = SelfAttention(num_channels, num_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv1d(x, self.conv1d.weight, self.conv1d.bias, groups=x.shape[1]).transpose(1, 2)
        y = self.attention(y, y, y)  # [B, T', C]
        return torch.relu(y.mean(dim=1)[:, :, None])


class TSSE_ATT(nn.Module):
    """ChannelTimeSenseAttentionSELayer (attention_model.py:259-293): TSSE
    with each scale a ConvAttentionBlock (keys smallConv1d.conv1d,
    smallConv1d.attention.q_linear, ...)."""

    def __init__(self, num_channels: int, kersize=(3, 5, 10), reduction_ratio: int = 2):
        super().__init__()
        self.smallConv1d = ConvAttentionBlock(num_channels, kersize[0])
        self.middleConv1d = ConvAttentionBlock(num_channels, kersize[1])
        self.largeConv1d = ConvAttentionBlock(num_channels, kersize[2])
        self.feature_concate_fc = Linear(3, 1)
        _add_bottleneck(self, num_channels, reduction_ratio)

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
        _refuse_valid("TSSE_ATT", valid)
        feats = torch.cat([self.smallConv1d(x), self.middleConv1d(x), self.largeConv1d(x)],
                          dim=2)  # [B, C, 3]
        return x * _gate(self, self.feature_concate_fc(feats)[..., 0])[:, :, None]


def channel_attention(model: str, num_channels: int, kersize=(3, 5, 10)) -> nn.Module:
    """The attention named by the config (fullsubnet_plus.py:52-70)."""
    if model == "TSSE":
        return TSSE(num_channels, kersize=kersize)
    if model == "SE":
        return SE(num_channels)
    if model == "ECA":
        return ECA(num_channels)
    if model == "CBAM":
        return CBAM(num_channels)
    if model == "DeepTSSE":
        return DeepTSSE(num_channels, kersize=kersize)
    if model == "TSSE_ATT":
        return TSSE_ATT(num_channels, kersize=kersize)
    raise NotImplementedError(f"Not implemented channel attention model {model}")
