"""Channel attention: TSSE (the paper's MulCA), the shipped variant.

Counterpart of fullsubnet_plus_tpu/nn/attention.py:34-88 and the dispatch at
:324-359 (reference ChannelTimeSenseSELayer, attention_model.py:43-98):
three depthwise valid convs over time with kernel sizes (3, 5, 10), each
averaged over time and ReLU'd, fused by Linear(3 -> 1), then an SE
bottleneck C -> C/2 -> C and a sigmoid gate per channel. The other
attentions (SE, ECA, CBAM, DeepTSSE, TSSE_ATT) are ROADMAP.md Queue 1
item 11.
"""

from __future__ import annotations

import torch
from torch import nn

from fullsubnet_plus_torch.device import not_ported
from fullsubnet_plus_torch.dsp.norms import time_mask
from fullsubnet_plus_torch.nn.layers import Conv1d, Linear
from fullsubnet_plus_torch.nn.tcn import conv1d


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
        self.fc1 = Linear(c, c // reduction_ratio)
        self.fc2 = Linear(c // reduction_ratio, c)

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
        """`valid` ([B] frame counts): each branch averages over exactly the
        valid - k + 1 frames its conv yields on the exact-length input. The
        padded region of x must be zero (the masked norm before it is)."""
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
        squeeze = self.feature_concate_fc(feats)[..., 0]
        gate = torch.sigmoid(self.fc2(torch.relu(self.fc1(squeeze))))
        return x * gate[:, :, None]


def channel_attention(model: str, num_channels: int, kersize=(3, 5, 10)) -> nn.Module:
    """The attention named by the config (fullsubnet_plus.py:52-70)."""
    if model == "TSSE":
        return TSSE(num_channels, kersize=kersize)
    raise not_ported(f"channel_attention_model={model!r}", "Queue 1 item 11")
