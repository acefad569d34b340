"""SequenceModel: the reference's configurable TCN / LSTM / GRU backbone and
output Linear, and the complex-valued ComplexSequenceModel.

Counterpart of fullsubnet_plus_tpu/nn/sequence.py:48-241 (reference
SequenceModel and Complex_SequenceModel, sequence_model.py:5-243), with
JAX's routing (nn/sequence.py:127-184): the unidirectional 2-layer LSTM
(both models' sub-band model, FullSubNet's full-band one) runs through the
kernels, its output Linear fused into the sweep of ops/lstm2.py (or, on the
quantized route, of ops/lstm2_int8.py, with weights prepared once by
`prepare_int8`; or, where a gradient is asked, of ops/lstm2_train.py with
its own backward). Every other form runs plain, as JAX runs it outside any
Pallas kernel: the 8-block TCN (FullSubNet+'s full-band models; it ignores
hidden_size and num_layers, as the reference does) and its "TCN-subband"
variant (hidden_size for blocks 1-7, 384 for block 8), and every LSTM or
GRU of another depth or direction (nn/lstm.py `RNN`). `quantized` on a
plain form runs it in float, as JAX's does. `shard_fold` splits the
kernels' fold rows over several cards, forward and backward: the
counterpart of `fold_axes` (JAX nn/sequence.py:118-175), with the mesh axes
resolved to cards by the caller (parallel/mesh.py Mesh.fold_devices).
"""

from __future__ import annotations

import torch
from torch import nn

from fullsubnet_plus_torch.nn.layers import Linear
from fullsubnet_plus_torch.nn.lstm import LSTM2, RNN
from fullsubnet_plus_torch.nn.tcn import tcn_stack
from fullsubnet_plus_torch.ops.lstm2 import lstm2_fc, lstm2_fc_split, to_device
from fullsubnet_plus_torch.ops.lstm2_int8 import lstm2_int8_fc, lstm2_int8_fc_split
from fullsubnet_plus_torch.ops.lstm2_train import lstm2_fc_train, lstm2_fc_train_split

ACTIVATIONS = {
    "Tanh": torch.tanh,
    "ReLU": torch.relu,
    "ReLU6": lambda x: torch.clamp(x, 0.0, 6.0),
}
SUBBAND_TCN_LAST_HIDDEN = 384  # block 8 of "TCN-subband" (sequence_model.py:59-70)


def _check_activation(name) -> None:
    if name and name not in ACTIVATIONS:
        raise NotImplementedError(f"output activation {name!r}")


class SequenceModel(nn.Module):
    """x [B, F, T] -> [B, output_size, T]."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int,
                 num_layers: int = 2, bidirectional: bool = False,
                 sequence_model: str = "LSTM", output_activate_function=None):
        super().__init__()
        _check_activation(output_activate_function)
        self.kind = sequence_model
        self.activation = output_activate_function or None
        if sequence_model == "TCN":
            self.sequence_model = tcn_stack(input_size)
            fc_in = input_size
        elif sequence_model == "TCN-subband":
            self.sequence_model = tcn_stack(input_size, hidden_size, SUBBAND_TCN_LAST_HIDDEN)
            fc_in = input_size
        elif sequence_model == "LSTM" and num_layers == 2 and not bidirectional:
            self.sequence_model = LSTM2(input_size, hidden_size)
            fc_in = hidden_size
        elif sequence_model in ("LSTM", "GRU"):
            self.sequence_model = RNN(sequence_model, input_size, hidden_size, num_layers,
                                      bidirectional)
            fc_in = hidden_size * (2 if bidirectional else 1)
        else:
            raise NotImplementedError(f"Not implemented {sequence_model}")
        self.fused = isinstance(self.sequence_model, LSTM2)  # the kernels' routes
        self.fc_output_layer = Linear(fc_in, output_size)
        self.int8_weights = None  # set by prepare_int8 for the quantized route
        self.fold_devices: tuple = ()  # set by shard_fold
        self.int8_fold_weights: list = []  # the int8 weights on each of fold_devices
        self._fold_packed: tuple = ((), [])  # (weights' versions, K1 operands a fold card)

    def prepare_int8(self) -> None:
        """Quantize the LSTM's recurrent weights once, for the quantized
        route (serving only), and give each card of `shard_fold` its own
        copy. Call after the module's final move and cast and after
        `shard_fold`; a later weight change needs another call."""
        if not self.fused:
            raise ValueError(f"prepare_int8: a {self.kind} sequence model has no 2-layer LSTM")
        self.int8_weights = self.sequence_model.prepare_int8(self.fc_output_layer)
        self.int8_fold_weights = [to_device(self.int8_weights, d) for d in self.fold_devices]

    def shard_fold(self, devices) -> None:
        """Split the LSTM's fold rows over `devices` (the first is the
        module's own card): each card sweeps its own rows, the outputs
        gathered on the first; where a gradient is asked each card also
        runs its rows' backward, and the weight gradients are summed into
        the module's parameters. One device, or none, undoes the split.
        Call before `prepare_int8`."""
        if not self.fused:
            raise ValueError(f"shard_fold: a {self.kind} sequence model has no 2-layer LSTM "
                             "fold")
        devices = tuple(torch.device(d) for d in devices)
        own = self.fc_output_layer.weight.device
        if devices and devices[0] != own:
            raise ValueError(f"shard_fold: the first card {devices[0]} is not the module's {own}")
        self.fold_devices = devices if len(devices) > 1 else ()
        self.int8_weights = None
        self.int8_fold_weights = []
        self._fold_packed = ((), [])

    def fold_packed(self) -> list:
        """K1's operands on each card of `shard_fold`: packed and copied
        once, and again only after the weights change (a cast, a move or
        an in-place update, each of which changes a tensor's storage or
        version)."""
        tensors = self.sequence_model.tensors(self.fc_output_layer)
        key = (self.fold_devices, *((t.data_ptr(), t._version, t.dtype) for t in tensors))
        if self._fold_packed[0] != key:
            packed = self.sequence_model.packed(self.fc_output_layer)
            self._fold_packed = (key, [to_device(packed, d) for d in self.fold_devices])
        return self._fold_packed[1]

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None,
                quantized: bool = False) -> torch.Tensor:
        """`valid` ([B] frame counts) masks the TCN's GroupNorm statistics;
        the recurrent models are causal and need no mask. `quantized` runs
        the 2-layer LSTM through the int8-recurrent kernel (forward only).
        Otherwise it takes the forward-only sweep when no gradient is asked
        and the differentiable one (residual-saving forward, reverse-sweep
        backward) when one is, as the JAX package's custom VJP does. The
        differentiable route reads the parameters themselves, never the
        detached operands `fold_packed` caches for the forward."""
        if self.kind in ("TCN", "TCN-subband"):
            for block in self.sequence_model:
                x = block(x, valid=valid)
            o = self.fc_output_layer(torch.relu(x).transpose(1, 2))  # [B, T, O]
        elif not self.fused:
            o = self.fc_output_layer(self.sequence_model(x.transpose(1, 2)))
        elif quantized:
            if self.int8_weights is None:
                raise RuntimeError("the quantized route needs prepare_int8() first")
            if self.fold_devices:
                o = lstm2_int8_fc_split(x, self.int8_fold_weights, self.fold_devices)
            else:
                o = lstm2_int8_fc(x, self.int8_weights)
        else:
            tensors = self.sequence_model.tensors(self.fc_output_layer)
            if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *tensors)):
                if self.fold_devices:
                    o = lstm2_fc_train_split(x, tensors, self.fold_devices)
                else:
                    o = lstm2_fc_train(x, *tensors)
            elif self.fold_devices:
                o = lstm2_fc_split(x, self.fold_packed(), self.fold_devices)
            else:
                o = lstm2_fc(x, self.sequence_model.packed(self.fc_output_layer))
        if self.activation:
            o = ACTIVATIONS[self.activation](o)
        return o.transpose(1, 2)


class ComplexSequenceModel(nn.Module):
    """Two real recurrent models of the real and imaginary parts with cross
    terms (reference Complex_SequenceModel, sequence_model.py:126-243; no
    shipped config uses it): real = real_net(re) - imag_net(im), imag =
    real_net(im) + imag_net(re), each through its own Linear. x [B, 2F, T]
    (real and imaginary stacked on the channel axis) -> [B, 2 O, T]. Plain
    recurrences: the kernels fuse the Linear, which comes after the cross
    terms here."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int,
                 num_layers: int = 2, bidirectional: bool = False,
                 sequence_model: str = "LSTM", output_activate_function=None):
        super().__init__()
        if bidirectional:
            raise ValueError("a bidirectional complex sequence model is not supported "
                             "(JAX nn/sequence.py:197)")
        if sequence_model not in ("LSTM", "GRU"):
            raise NotImplementedError(f"Not implemented {sequence_model}")
        _check_activation(output_activate_function)
        self.activation = output_activate_function or None
        self.real_sequence_model = RNN(sequence_model, input_size, hidden_size, num_layers)
        self.imag_sequence_model = RNN(sequence_model, input_size, hidden_size, num_layers)
        self.real_fc_output_layer = Linear(hidden_size, output_size)
        self.imag_fc_output_layer = Linear(hidden_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        real, imag = (v.transpose(1, 2) for v in x.chunk(2, dim=1))
        r2r, r2i = self.real_sequence_model(real), self.imag_sequence_model(real)
        i2r, i2i = self.real_sequence_model(imag), self.imag_sequence_model(imag)
        real_out = self.real_fc_output_layer(r2r - i2i)
        imag_out = self.imag_fc_output_layer(i2r + r2i)
        if self.activation:
            act = ACTIVATIONS[self.activation]
            real_out, imag_out = act(real_out), act(imag_out)
        return torch.cat([real_out.transpose(1, 2), imag_out.transpose(1, 2)], dim=1)
