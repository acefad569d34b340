"""Multi-channel DSP of the reference's framework surface (no shipped model
uses it): the multi-channel STFT, the beamforming products and the
directional features.

Counterpart of fullsubnet_plus_tpu/dsp/multichannel.py:23-125 (reference
audio_zen/acoustics/feature.py:68-91, :415-631 and beamforming.py:5-39), on
complex tensors: `mc_stft`, `apply_crf_filter`,
`get_power_spectral_density_matrix`, `apply_beamforming_vector`,
`channel_wise_layer_norm`, `DirectionalFeatureConfig`, `compute_ipd` and
`directional_features` (the log power spectrum of one channel, layer-normed
over frequency, and the cos / sin inter-channel phase differences of the
microphone pairs).
"""

from __future__ import annotations

import dataclasses

import torch

from fullsubnet_plus_torch.dsp.stft import stft


def mc_stft(y_s: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """[B, M, L] multi-channel waveforms -> [B, M, F, T] complex STFTs."""
    if y_s.ndim != 3:
        raise ValueError(f"mc_stft expects [B, M, L], got {tuple(y_s.shape)}")
    batch, channels, samples = y_s.shape
    spec = stft(y_s.reshape(batch * channels, samples), n_fft, hop_length, win_length)
    return spec.reshape(batch, channels, spec.shape[-2], spec.shape[-1])


def apply_crf_filter(crm_filter: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """The complex ratio filter: [B, F, T, D] (conjugated) x [B, C, F, D, T]
    -> [B, C, F, T]."""
    return torch.einsum("bftd,bcfdt->bcft", crm_filter.conj(), mix)


def get_power_spectral_density_matrix(spec: torch.Tensor) -> torch.Tensor:
    """[..., C, T] -> [..., T, C, C] cross-channel outer products."""
    return torch.einsum("...ct,...et->...tce", spec, spec.conj())


def apply_beamforming_vector(bf_vector: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """[B, F, T, C] (conjugated) x [B, F, C, T] -> [B, F, T]."""
    return torch.einsum("bftc,bfct->bft", bf_vector.conj(), mix)


def channel_wise_layer_norm(x: torch.Tensor, weight=None, bias=None,
                            eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the channel axis of [B, N, K] (feature.py:415-435),
    the biased variance."""
    mu = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, correction=0)
    out = (x - mu) / torch.sqrt(var + eps)
    if weight is not None:
        out = out * weight[None, :, None] + bias[None, :, None]
    return out


@dataclasses.dataclass(frozen=True)
class DirectionalFeatureConfig:
    n_fft: int = 512
    win_length: int = 512
    hop_length: int = 256
    input_features: tuple = ("LPS", "IPD")
    mic_pairs: tuple = ((0, 4), (1, 5), (2, 6), (3, 7))
    lps_channel: int = 4
    use_cos_ipd: bool = True
    use_sin_ipd: bool = False
    eps: float = 1e-8

    @property
    def num_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def directional_feature_dim(self) -> int:
        dim = self.num_freqs if "LPS" in self.input_features else 0
        if "IPD" in self.input_features:
            pairs = self.num_freqs * len(self.mic_pairs)
            dim += pairs * (2 if self.use_sin_ipd else 1)
        return dim


def compute_ipd(phase: torch.Tensor, mic_pairs) -> tuple:
    """phase [B, M, F, K] -> (cos IPD, sin IPD), each [B, P, F, K]."""
    left = [p[0] for p in mic_pairs]
    right = [p[1] for p in mic_pairs]
    diff = phase[:, left] - phase[:, right]
    return torch.cos(diff), torch.sin(diff)


def directional_features(y: torch.Tensor, config: DirectionalFeatureConfig):
    """[B, M, L] mixture -> (features [B, D, K], magnitude, real, imag of
    every channel [B, M, F, K]) (DirectionalFeatureComputer.forward,
    feature.py:489-560): the configured channel's log power spectrum,
    layer-normed without affine, then the cos (and with `use_sin_ipd` the
    sin) IPD of each microphone pair, flattened over frequency."""
    batch = y.shape[0]
    spec = mc_stft(y, config.n_fft, config.hop_length, config.win_length)
    magnitude, phase = spec.abs(), spec.angle()
    frames = spec.shape[-1]
    feats = []
    if "LPS" in config.input_features:
        lps = torch.log(magnitude[:, config.lps_channel] ** 2 + config.eps)  # [B, F, K]
        feats.append(channel_wise_layer_norm(lps))
    if "IPD" in config.input_features:
        cos_ipd, sin_ipd = compute_ipd(phase, config.mic_pairs)
        feats.append(cos_ipd.reshape(batch, -1, frames))
        if config.use_sin_ipd:
            feats.append(sin_ipd.reshape(batch, -1, frames))
    features = (torch.cat(feats, dim=1) if feats
                else magnitude.new_zeros(batch, 0, frames))
    return features, magnitude, spec.real, spec.imag
