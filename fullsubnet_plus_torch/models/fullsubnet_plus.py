"""FullSubNet+ as an nn.Module.

Counterpart of fullsubnet_plus_tpu/models/fullsubnet_plus.py:54-311
(reference fullsubnet_plus/model/fullsubnet_plus.py:16-209): three
spectrogram views (magnitude, real, imag), each normalized, gated by TSSE
channel attention and passed through an 8-block TCN over all bins; the
attended magnitude and the three full-band outputs are unfolded into
sub-bands (15 neighbours a side, 34 features), normalized again, folded to
[B*F, 34, T] and run through the 2-layer LSTM(384) with its Linear(2),
giving the compressed cIRM [B, 2, F, T]. Inputs are right-padded by
`look_ahead` frames and the output sliced by as many.

Attribute names follow the reference state_dict, so a reference-layout
state_dict (or the JAX tree through io/convert.py) loads with strict=True.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from fullsubnet_plus_torch.device import not_ported
from fullsubnet_plus_torch.dsp.norms import get_norm, time_mask
from fullsubnet_plus_torch.dsp.unfold import drop_band, freq_unfold
from fullsubnet_plus_torch.nn.attention import channel_attention
from fullsubnet_plus_torch.nn.layers import reset_parameters
from fullsubnet_plus_torch.nn.sequence import SequenceModel


@dataclasses.dataclass(frozen=True)
class FullSubNetPlusConfig:
    """Static hyperparameters (reference config/train.toml:73-91 defaults)."""

    num_freqs: int = 257
    look_ahead: int = 2
    sequence_model: str = "LSTM"  # the sub-band model; full-band models are TCN
    fb_num_neighbors: int = 0
    sb_num_neighbors: int = 15
    fb_output_activate_function: str | bool = "ReLU"
    sb_output_activate_function: str | bool = False
    fb_model_hidden_size: int = 512
    sb_model_hidden_size: int = 384
    channel_attention_model: str = "TSSE"
    norm_type: str = "offline_laplace_norm"
    num_groups_in_drop_band: int = 2
    output_size: int = 2
    subband_num: int = 1
    kersize: tuple = (3, 5, 10)
    # the mesh axes the folded (B*F) sub-band batch is split over, e.g.
    # ("data", "freq") (JAX models/fullsubnet_plus.py:73-78); the Enhancer
    # and the eval step resolve them to cards (parallel/mesh.py
    # Mesh.fold_devices) and hand those to `shard_fold`
    fold_sharding: tuple | None = None
    # serving only: the sub-band LSTM's recurrent products in int8
    # (ops/lstm2_int8.py), set by Enhancer(compute_dtype="int8"); never
    # used in training and not the checkpoint-parity path
    quantized_lstm: bool = False

    @property
    def num_channels(self) -> int:
        if self.subband_num == 1:
            return self.num_freqs
        return self.num_freqs // self.subband_num + 1

    @property
    def sb_input_size(self) -> int:
        return (self.sb_num_neighbors * 2 + 1) + 3 * (self.fb_num_neighbors * 2 + 1)


class FullSubNetPlus(nn.Module):
    def __init__(self, config: FullSubNetPlusConfig = FullSubNetPlusConfig()):
        super().__init__()
        if config.subband_num > 1 and config.channel_attention_model != "ECA":
            # the reference's own forward crashes on the real/imag branches
            # here (fullsubnet_plus.py:157-164); only ECA runs
            raise ValueError(
                f"subband_num={config.subband_num} with channel_attention_model="
                f"{config.channel_attention_model!r} cannot run: the reference "
                "architecture itself crashes on the real/imag branches "
                "(fullsubnet_plus.py:157-164); only 'ECA' works with subband_num > 1")
        if config.subband_num > 1:
            raise not_ported("subband_num > 1", "Queue 1 item 11")
        self.config = config
        self.norm = get_norm(config.norm_type)

        def attention():
            return channel_attention(config.channel_attention_model, config.num_channels,
                                     kersize=config.kersize)

        def full_band():  # hard-coded TCN, as in the reference
            return SequenceModel(config.num_freqs, config.num_freqs,
                                 config.fb_model_hidden_size, sequence_model="TCN",
                                 output_activate_function=config.fb_output_activate_function)

        self.channel_attention = attention()
        self.channel_attention_real = attention()
        self.channel_attention_imag = attention()
        self.fb_model = full_band()
        self.fb_model_real = full_band()
        self.fb_model_imag = full_band()
        self.sb_model = SequenceModel(
            config.sb_input_size, config.output_size, config.sb_model_hidden_size,
            sequence_model=config.sequence_model,
            output_activate_function=config.sb_output_activate_function)

    def init_weights(self, generator: torch.Generator) -> "FullSubNetPlus":
        """torch-default initialization of every layer, drawn from `generator`."""
        reset_parameters(self, generator)
        return self

    def load_jax_params(self, params) -> "FullSubNetPlus":
        """Load the JAX package's parameter tree (nested numpy), strict."""
        from fullsubnet_plus_torch.io.convert import state_dict_from_jax

        self.load_state_dict(state_dict_from_jax(params), strict=True)
        return self

    def prepare_int8(self) -> "FullSubNetPlus":
        """Quantize the sub-band LSTM once for `quantized_lstm` (after the
        model's final move and cast, and after `shard_fold`)."""
        self.sb_model.prepare_int8()
        return self

    def shard_fold(self, devices) -> "FullSubNetPlus":
        """Split the sub-band fold's rows over `devices` in the forward
        without a gradient (the first is the model's own card): the
        counterpart of the fold sharded over `config.fold_sharding`."""
        self.sb_model.shard_fold(devices)
        return self

    def forward(self, noisy_mag: torch.Tensor, noisy_real: torch.Tensor,
                noisy_imag: torch.Tensor, valid_frames: torch.Tensor | None = None,
                training: bool = False, row_offset: int = 0,
                global_batch: int | None = None) -> torch.Tensor:
        """[B, 1, F, T] x 3 -> compressed cIRM [B, 2, F, T], or
        [B, 2, F // groups, T] with `training`, which applies `drop_band` to
        the sub-band model's input (the reference gates it on batch size > 1,
        fullsubnet_plus.py:192-196; here it is explicit).

        `valid_frames` ([B] int): per-utterance valid STFT frame counts of a
        bucket-padded batch; every statistic over time (norms, attention
        pooling, TCN GroupNorms) then sees exactly the exact-length run's
        frames. It is a serving-path feature and excludes `training`.

        `row_offset` and `global_batch`: under data parallelism the batch is
        the rows from `row_offset` of a global batch of `global_batch` rows,
        and `drop_band` couples each row's kept bins to its global index."""
        if training and valid_frames is not None:
            raise ValueError("valid_frames is a serving-path feature")
        cfg = self.config
        la = cfg.look_ahead
        views = [nn.functional.pad(v, (0, la)) for v in (noisy_mag, noisy_real, noisy_imag)]
        batch, channels, num_freqs, frames = views[0].shape
        if channels != 1:
            raise ValueError("FullSubNet+ takes single-channel spectrogram views")

        valid = None
        if valid_frames is not None:
            # two counts: the entry mask zeroes everything past the data
            # frames; the statistics include the look-ahead zeros, as the
            # exact-length run's do (fullsubnet_plus.py:190-204 of the JAX
            # package)
            data_valid = torch.clamp(valid_frames, max=frames)
            valid = torch.clamp(valid_frames + la, max=frames)
            entry = time_mask(frames, data_valid, views[0].dtype)[:, None, None, :]
            views = [v * entry for v in views]

        def branch(attention, full_band, x):
            fb_in = self.norm(x, valid=valid).reshape(batch, num_freqs, frames)
            fb_in = attention(fb_in, valid=valid)
            fb_out = full_band(fb_in, valid=valid)
            return fb_in, fb_out.reshape(batch, 1, num_freqs, frames)

        fb_input, fb_output = branch(self.channel_attention, self.fb_model, views[0])
        _, fbr_output = branch(self.channel_attention_real, self.fb_model_real, views[1])
        _, fbi_output = branch(self.channel_attention_imag, self.fb_model_imag, views[2])

        fb_w = cfg.fb_num_neighbors * 2 + 1
        sb_w = cfg.sb_num_neighbors * 2 + 1

        def unfold_fb(y):
            return freq_unfold(y, cfg.fb_num_neighbors).reshape(batch, num_freqs, fb_w, frames)

        mag_unf = freq_unfold(fb_input.reshape(batch, 1, num_freqs, frames),
                              cfg.sb_num_neighbors).reshape(batch, num_freqs, sb_w, frames)
        sb_input = torch.cat(
            [mag_unf, unfold_fb(fb_output), unfold_fb(fbr_output), unfold_fb(fbi_output)],
            dim=2)
        sb_input = self.norm(sb_input, valid=valid)  # [B, F, 34, T]
        if training:
            sb_input = drop_band(sb_input.permute(0, 2, 1, 3), cfg.num_groups_in_drop_band,
                                 row_offset, global_batch).permute(0, 2, 1, 3)
        freqs_out = sb_input.shape[1]
        sb_mask = self.sb_model(sb_input.reshape(batch * freqs_out, cfg.sb_input_size, frames),
                                quantized=cfg.quantized_lstm and not training)
        sb_mask = sb_mask.reshape(batch, freqs_out, cfg.output_size, frames).permute(0, 2, 1, 3)
        return sb_mask[:, :, :, la:]
