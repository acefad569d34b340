"""FullSubNet, the baseline: a magnitude-only full-band + sub-band model, as
an nn.Module.

Counterpart of fullsubnet_plus_tpu/models/fullsubnet.py:21-139 (reference
fullsubnet/model/fullsubnet.py:12-118): the noisy magnitude [B, 1, F, T],
right-padded by `look_ahead` frames, is normalized and run through the
full-band 2-layer LSTM(512) with its Linear(F) and ReLU over all bins; the
magnitude is unfolded into sub-bands (15 neighbours a side) and the
full-band output taken per bin (0 neighbours), the two concatenated (32
features), normalized again, folded to [B*F, 32, T] and run through the
sub-band 2-layer LSTM(384) with its Linear(2), giving the compressed cIRM
[B, 2, F, T] with the look-ahead frames sliced off. Both LSTMs run through
the fused forward kernel of ops/lstm2.py on the card (the full-band one at
D 257, H 512, O 257), or through the int8-recurrent kernel of
ops/lstm2_int8.py with `quantized_lstm`. With `sequence_model="GRU"` both
models are 2-layer GRUs and run plain (nn/lstm.py).

Attribute names follow the reference state_dict, so a reference-layout
state_dict (or the JAX tree through io/convert.py) loads with strict=True.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from fullsubnet_plus_torch.dsp.norms import model_norm, time_mask
from fullsubnet_plus_torch.dsp.unfold import drop_band, freq_unfold
from fullsubnet_plus_torch.nn.layers import reset_parameters
from fullsubnet_plus_torch.nn.sequence import SequenceModel


@dataclasses.dataclass(frozen=True)
class FullSubNetConfig:
    """Static hyperparameters (reference fullsubnet config/train.toml
    defaults)."""

    num_freqs: int = 257
    look_ahead: int = 2
    sequence_model: str = "LSTM"
    fb_num_neighbors: int = 0
    sb_num_neighbors: int = 15
    fb_output_activate_function: str | bool = "ReLU"
    sb_output_activate_function: str | bool = False
    fb_model_hidden_size: int = 512
    sb_model_hidden_size: int = 384
    norm_type: str = "offline_laplace_norm"
    num_groups_in_drop_band: int = 2
    # serving only: both LSTMs' recurrent products in int8
    # (ops/lstm2_int8.py), set by Enhancer(compute_dtype="int8")
    quantized_lstm: bool = False

    @property
    def sb_input_size(self) -> int:
        return (self.sb_num_neighbors * 2 + 1) + (self.fb_num_neighbors * 2 + 1)


class FullSubNet(nn.Module):
    def __init__(self, config: FullSubNetConfig = FullSubNetConfig()):
        super().__init__()
        if config.sequence_model not in ("GRU", "LSTM"):
            raise ValueError(f"sequence_model={config.sequence_model!r}: FullSubNet's models "
                             "are GRU or LSTM")
        self.config = config
        self.norm = model_norm(config.norm_type)
        self.fb_model = SequenceModel(
            config.num_freqs, config.num_freqs, config.fb_model_hidden_size,
            sequence_model=config.sequence_model,
            output_activate_function=config.fb_output_activate_function)
        self.sb_model = SequenceModel(
            config.sb_input_size, 2, config.sb_model_hidden_size,
            sequence_model=config.sequence_model,
            output_activate_function=config.sb_output_activate_function)

    def init_weights(self, generator: torch.Generator) -> "FullSubNet":
        """torch-default initialization of every layer, drawn from `generator`."""
        reset_parameters(self, generator)
        return self

    def load_jax_params(self, params) -> "FullSubNet":
        """Load the JAX package's parameter tree (nested numpy) of this
        model's variant (the key table of its config), strict."""
        from fullsubnet_plus_torch.io.convert import (
            key_table,
            layout_of_config,
            state_dict_from_table,
        )

        table = key_table(**layout_of_config(self.config))
        self.load_state_dict(state_dict_from_table(params, table), strict=True)
        return self

    def prepare_int8(self) -> "FullSubNet":
        """Quantize both LSTMs once for `quantized_lstm` (after the model's
        final move and cast), as the JAX Enhancer's `_attach_int8_prepared`
        walks both; GRUs run in float."""
        for model in (self.fb_model, self.sb_model):
            if model.fused:
                model.prepare_int8()
        return self

    def forward(self, noisy_mag: torch.Tensor, valid_frames: torch.Tensor | None = None,
                training: bool = False) -> torch.Tensor:
        """[B, 1, F, T] -> compressed cIRM [B, 2, F, T], or [B, 2, F //
        groups, T] with `training` (`drop_band` on the sub-band input).

        `valid_frames` ([B] int, serving only): per-utterance valid frame
        counts of a bucket-padded batch; the LSTMs are causal, so only the
        two norms' statistics need the mask."""
        if training and valid_frames is not None:
            raise ValueError("valid_frames is a serving-path feature")
        cfg = self.config
        la = cfg.look_ahead
        noisy_mag = nn.functional.pad(noisy_mag, (0, la))
        batch, channels, num_freqs, frames = noisy_mag.shape
        if channels != 1:
            raise ValueError("FullSubNet takes a single-channel magnitude")

        valid = None
        if valid_frames is not None:
            # the entry mask zeroes everything past the data frames; the
            # statistics count the look-ahead zeros, as the exact-length
            # run's do (fullsubnet.py:88-100 of the JAX package)
            data_valid = torch.clamp(valid_frames, max=frames)
            valid = torch.clamp(valid_frames + la, max=frames)
            noisy_mag = noisy_mag * time_mask(frames, data_valid, noisy_mag.dtype)[:, None, None, :]

        quantized = cfg.quantized_lstm and not training
        fb_input = self.norm(noisy_mag, valid=valid).reshape(batch, num_freqs, frames)
        fb_output = self.fb_model(fb_input, quantized=quantized).reshape(
            batch, 1, num_freqs, frames)

        fb_w = cfg.fb_num_neighbors * 2 + 1
        sb_w = cfg.sb_num_neighbors * 2 + 1
        fb_unf = freq_unfold(fb_output, cfg.fb_num_neighbors).reshape(
            batch, num_freqs, fb_w, frames)
        mag_unf = freq_unfold(noisy_mag, cfg.sb_num_neighbors).reshape(
            batch, num_freqs, sb_w, frames)
        sb_input = self.norm(torch.cat([mag_unf, fb_unf], dim=2), valid=valid)
        if training:
            sb_input = drop_band(sb_input.permute(0, 2, 1, 3),
                                 cfg.num_groups_in_drop_band).permute(0, 2, 1, 3)
        freqs_out = sb_input.shape[1]
        sb_mask = self.sb_model(sb_input.reshape(batch * freqs_out, cfg.sb_input_size, frames),
                                quantized=quantized)
        sb_mask = sb_mask.reshape(batch, freqs_out, 2, frames).permute(0, 2, 1, 3)
        return sb_mask[:, :, :, la:]
