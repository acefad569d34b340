"""The sub-band model's 2-layer unidirectional LSTM, in torch's layout.

Counterpart of fullsubnet_plus_tpu/nn/lstm.py:31-90. The parameters carry
torch.nn.LSTM's names and layouts (`weight_ih_l{k}` [4H, D], gate order
i, f, g, o), so a reference state_dict loads with strict=True; the JAX tree
stores the same matrices transposed. The forward is not here: the 2-layer
sweep with the output Linear fused runs through ops/lstm2.py, whose
`lstm2_fc_reference` is the plain scan and whose `lstm2_fc` launches the
CUDA kernel on the card.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fullsubnet_plus_torch.nn.layers import Linear, uniform_
from fullsubnet_plus_torch.ops.lstm2 import LSTM2Weights


class LSTM2(nn.Module):
    """Parameters of torch.nn.LSTM(input_size, hidden_size, num_layers=2)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        gates = 4 * hidden_size
        for layer, d_in in enumerate((input_size, hidden_size)):
            self.register_parameter(f"weight_ih_l{layer}", nn.Parameter(torch.empty(gates, d_in)))
            self.register_parameter(f"weight_hh_l{layer}",
                                    nn.Parameter(torch.empty(gates, hidden_size)))
            self.register_parameter(f"bias_ih_l{layer}", nn.Parameter(torch.empty(gates)))
            self.register_parameter(f"bias_hh_l{layer}", nn.Parameter(torch.empty(gates)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch.nn.LSTM's default: every tensor U(-1/sqrt(H), 1/sqrt(H))."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters(recurse=False):
            uniform_(p, bound, generator)

    def packed(self, fc: Linear) -> LSTM2Weights:
        """The kernel's operands: weights transposed to [K, 4H] row-major in
        the parameters' dtype, layer 2's input and recurrent matrices stacked
        into [W2; U2] ([2H, 4H]), b_ih + b_hh summed in the parameters' dtype
        (as the TPU kernel's wrapper does) and then widened to float32, and
        the output Linear as W_fc [H, O] and b_fc [O] in float32."""
        def t(w):
            return w.detach().t().contiguous()

        return LSTM2Weights(
            w1=t(self.weight_ih_l0),
            u1=t(self.weight_hh_l0),
            b1=(self.bias_ih_l0 + self.bias_hh_l0).detach().float(),
            w2=torch.cat([t(self.weight_ih_l1), t(self.weight_hh_l1)], dim=0),
            b2=(self.bias_ih_l1 + self.bias_hh_l1).detach().float(),
            fc_w=t(fc.weight).float(),
            fc_b=fc.bias.detach().float(),
        )
