"""SequenceModel: the TCN and 2-layer LSTM sequence models.

Counterpart of fullsubnet_plus_tpu/nn/sequence.py:48-188 (reference
SequenceModel, sequence_model.py:5-123) for the two forms the shipped models
use: the 8-block TCN (FullSubNet+'s full-band models; it ignores hidden_size
and num_layers, as the reference does) and the unidirectional 2-layer LSTM
(both models' sub-band model, FullSubNet's full-band one), whose output
Linear is fused into the sweep of ops/lstm2.py (or, on the quantized route,
of ops/lstm2_int8.py, with weights prepared once by `prepare_int8`; or,
where a gradient is asked, of ops/lstm2_train.py with its own backward).
GRU, bidirectional and TCN-subband models are ROADMAP.md Queue 1 item 11.
"""

from __future__ import annotations

import torch
from torch import nn

from fullsubnet_plus_torch.device import not_ported
from fullsubnet_plus_torch.nn.layers import Linear
from fullsubnet_plus_torch.nn.lstm import LSTM2
from fullsubnet_plus_torch.nn.tcn import tcn_stack
from fullsubnet_plus_torch.ops.lstm2 import lstm2_fc
from fullsubnet_plus_torch.ops.lstm2_int8 import lstm2_int8_fc
from fullsubnet_plus_torch.ops.lstm2_train import lstm2_fc_train

ACTIVATIONS = {
    "Tanh": torch.tanh,
    "ReLU": torch.relu,
    "ReLU6": lambda x: torch.clamp(x, 0.0, 6.0),
}


class SequenceModel(nn.Module):
    """x [B, F, T] -> [B, output_size, T]."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int,
                 num_layers: int = 2, bidirectional: bool = False,
                 sequence_model: str = "LSTM", output_activate_function=None):
        super().__init__()
        if output_activate_function and output_activate_function not in ACTIVATIONS:
            raise NotImplementedError(
                f"output activation {output_activate_function!r}")
        self.kind = sequence_model
        self.activation = output_activate_function or None
        if sequence_model == "TCN":
            self.sequence_model = tcn_stack(input_size)
            fc_in = input_size
        elif sequence_model == "LSTM" and num_layers == 2 and not bidirectional:
            self.sequence_model = LSTM2(input_size, hidden_size)
            fc_in = hidden_size
        else:
            raise not_ported(
                f"sequence_model={sequence_model!r} with num_layers={num_layers}, "
                f"bidirectional={bidirectional}", "Queue 1 item 11")
        self.fc_output_layer = Linear(fc_in, output_size)
        self.int8_weights = None  # set by prepare_int8 for the quantized route

    def prepare_int8(self) -> None:
        """Quantize the LSTM's recurrent weights once, for the quantized
        route (serving only). Call after the module's final move and cast;
        a later weight change needs another call."""
        if self.kind != "LSTM":
            raise ValueError(f"prepare_int8: a {self.kind} sequence model has no LSTM")
        self.int8_weights = self.sequence_model.prepare_int8(self.fc_output_layer)

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None,
                quantized: bool = False) -> torch.Tensor:
        """`valid` ([B] frame counts) masks the TCN's GroupNorm statistics;
        the LSTM is causal and needs no mask. `quantized` runs the LSTM
        through the int8-recurrent kernel (forward only). Otherwise the LSTM
        takes the forward-only sweep when no gradient is asked and the
        differentiable one (residual-saving forward, reverse-sweep backward)
        when one is, as the JAX package's custom VJP does."""
        if self.kind == "TCN":
            for block in self.sequence_model:
                x = block(x, valid=valid)
            o = self.fc_output_layer(torch.relu(x).transpose(1, 2))  # [B, T, O]
        elif quantized:
            if self.int8_weights is None:
                raise RuntimeError("the quantized route needs prepare_int8() first")
            o = lstm2_int8_fc(x, self.int8_weights)
        else:
            tensors = self.sequence_model.tensors(self.fc_output_layer)
            if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *tensors)):
                o = lstm2_fc_train(x, *tensors)
            else:
                o = lstm2_fc(x, self.sequence_model.packed(self.fc_output_layer))
        if self.activation:
            o = ACTIVATIONS[self.activation](o)
        return o.transpose(1, 2)
