"""Recurrent models in torch's layout: the sub-band model's 2-layer
unidirectional LSTM, whose forward runs through the kernels, and every
other LSTM / GRU form of the reference SequenceModel, which runs plain.

Counterpart of fullsubnet_plus_tpu/nn/lstm.py:31-166. The parameters carry
torch.nn.LSTM's and torch.nn.GRU's names and layouts (`weight_ih_l{k}`
[gates * H, D], `_reverse` for a bidirectional model's backward direction;
gate order i, f, g, o for the LSTM and r, z, n for the GRU), so a reference
state_dict loads with strict=True; the JAX tree stores the same matrices
transposed.

`RNN` is the plain form, as the JAX package runs these models: the input
product hoisted to one matmul over the whole sequence, then a loop over T
(the GRU's candidate is tanh(x W_in + b_in + r * (h W_hn + b_hn))); a
bidirectional layer runs the second direction on the time-reversed input
and concatenates both for the next layer. `LSTM2` is the 2-layer
unidirectional LSTM whose forward is not here: the sweep with the output
Linear fused runs through ops/lstm2.py, whose `lstm2_fc_reference` is the
plain scan and whose `lstm2_fc` launches the CUDA kernel on the card; the
int8-recurrent serving form through ops/lstm2_int8.py, with operands from
`prepare_int8`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fullsubnet_plus_torch.nn.layers import Linear, uniform_
from fullsubnet_plus_torch.ops.lstm2 import LSTM2Weights, pack_weights
from fullsubnet_plus_torch.ops.lstm2_int8 import (
    LSTM2Int8Weights,
    pack_int8_mma,
    prepare_quantized_lstm,
)

GATES = {"LSTM": 4, "GRU": 3}


def lstm_layer(x: torch.Tensor, w_ih, w_hh, b_ih, b_hh) -> torch.Tensor:
    """One LSTM layer from zero state, x [B, T, D] -> [B, T, H]."""
    xw = torch.matmul(x, w_ih.t()) + (b_ih + b_hh)
    h = x.new_zeros(x.shape[0], w_hh.shape[1])
    c = torch.zeros_like(h)
    u = w_hh.t()
    out = []
    for t in range(x.shape[1]):
        i, f, g, o = (xw[:, t] + torch.matmul(h, u)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1)


def gru_layer(x: torch.Tensor, w_ih, w_hh, b_ih, b_hh) -> torch.Tensor:
    """One GRU layer from zero state, x [B, T, D] -> [B, T, H]."""
    xw = torch.matmul(x, w_ih.t()) + b_ih
    h = x.new_zeros(x.shape[0], w_hh.shape[1])
    u = w_hh.t()
    out = []
    for t in range(x.shape[1]):
        xr, xz, xn = xw[:, t].chunk(3, dim=-1)
        hr, hz, hn = (torch.matmul(h, u) + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        out.append(h)
    return torch.stack(out, dim=1)


class RNN(nn.Module):
    """Parameters of torch.nn.LSTM or torch.nn.GRU (`kind`) with
    batch_first; forward x [B, T, D] -> [B, T, H] (2H bidirectional)."""

    def __init__(self, kind: str, input_size: int, hidden_size: int, num_layers: int,
                 bidirectional: bool = False):
        super().__init__()
        if kind not in GATES:
            raise NotImplementedError(f"Not implemented {kind}")
        self.kind = kind
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.directions = ("", "_reverse") if bidirectional else ("",)
        gates = GATES[kind] * hidden_size
        for layer in range(num_layers):
            d_in = input_size if layer == 0 else hidden_size * len(self.directions)
            for sfx in self.directions:  # torch's registration order
                for name, shape in (("weight_ih", (gates, d_in)),
                                    ("weight_hh", (gates, hidden_size)),
                                    ("bias_ih", (gates,)), ("bias_hh", (gates,))):
                    self.register_parameter(f"{name}_l{layer}{sfx}",
                                            nn.Parameter(torch.empty(shape)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch's default: every tensor U(-1/sqrt(H), 1/sqrt(H))."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters(recurse=False):
            uniform_(p, bound, generator)

    def layer(self, layer: int, sfx: str = "") -> tuple:
        """(weight_ih, weight_hh, bias_ih, bias_hh) of one layer and direction."""
        return tuple(getattr(self, f"{name}_l{layer}{sfx}")
                     for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        run = lstm_layer if self.kind == "LSTM" else gru_layer
        for layer in range(self.num_layers):
            outs = [run(x, *self.layer(layer))]
            if len(self.directions) == 2:
                outs.append(run(x.flip(1), *self.layer(layer, "_reverse")).flip(1))
            x = torch.cat(outs, dim=-1) if len(outs) == 2 else outs[0]
        return x


class LSTM2(RNN):
    """Parameters of torch.nn.LSTM(input_size, hidden_size, num_layers=2),
    for the kernels' routes."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__("LSTM", input_size, hidden_size, 2)

    def tensors(self, fc: Linear) -> tuple:
        """torch.nn.LSTM's eight tensors, layer by layer, then the output
        Linear's weight and bias: the arguments of `pack_weights` and of the
        differentiable `lstm2_fc_train`."""
        return (*self.layer(0), *self.layer(1), fc.weight, fc.bias)

    def packed(self, fc: Linear) -> LSTM2Weights:
        """The forward kernel's operands (`pack_weights`), detached: the
        route without a gradient."""
        return pack_weights(*(p.detach() for p in self.tensors(fc)))

    def prepare_int8(self, fc: Linear) -> LSTM2Int8Weights:
        """The int8-recurrent kernel's operands, built once (the counterpart
        of the JAX Enhancer's `_attach_int8_prepared`): every weight is first
        cast to bfloat16, as the JAX Enhancer casts its parameters before it
        quantizes, then U1 and [W2; U2] are quantized per column
        (`prepare_quantized_lstm`) and packed for the kernel into
        fragment order (`pack_int8_mma`), here and not per call. Raises if a
        prepared shape does not match the float weights it came from."""
        def bf16(p):
            return p.detach().to(torch.bfloat16)

        def t(p):
            return bf16(p).t().contiguous()

        u1 = t(self.weight_hh_l0)
        w2 = torch.cat([t(self.weight_ih_l1), t(self.weight_hh_l1)], dim=0)
        q = prepare_quantized_lstm(u1.float().cpu().numpy(), w2.float().cpu().numpy())
        gates = 4 * self.hidden_size
        expect = {"u1q": tuple(u1.shape), "w2q": tuple(w2.shape), "s1": (gates,),
                  "s2": (gates,)}
        for name, shape in expect.items():
            if q[name].shape != shape:
                raise ValueError(f"prepare_int8: {name} is {q[name].shape}, the float "
                                 f"weights give {shape}")
        device = self.weight_hh_l0.device
        plain = dict(
            w1=t(self.weight_ih_l0),
            u1q=torch.from_numpy(q["u1q"]).to(device),
            s1=torch.from_numpy(q["s1"]).to(device),
            b1=(bf16(self.bias_ih_l0) + bf16(self.bias_hh_l0)).float(),
            w2q=torch.from_numpy(q["w2q"]).to(device),
            s2=torch.from_numpy(q["s2"]).to(device),
            b2=(bf16(self.bias_ih_l1) + bf16(self.bias_hh_l1)).float(),
            fc_w=t(fc.weight).float(),
        )
        return LSTM2Int8Weights(**plain, fc_b=bf16(fc.bias).float(), mma=pack_int8_mma(**plain))
