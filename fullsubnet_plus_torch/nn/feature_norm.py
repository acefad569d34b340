"""Magnitude-spectral normalization of the reference's module surface
(audio_zen/model/module/feature_norm.py:5-82), used by no shipped model.

Counterpart of fullsubnet_plus_tpu/nn/feature_norm.py:13-60:
`cumulative_norm`, the streaming zero-norm with eps 1e-10 inside the sqrt,
and `cumulative_mag_spectral_norm`, the parameter-free
CumulativeMagSpectralNorm (offline or cumulative mu, from the frame mean or
the middle frequency bin). Inputs are [B, C, F, T].
"""

from __future__ import annotations

import torch


def _check_4d(x: torch.Tensor, name: str) -> None:
    if x.ndim != 4:
        raise ValueError(f"{name} takes [B, C, F, T], got {tuple(x.shape)}")


def cumulative_norm(x: torch.Tensor) -> torch.Tensor:
    """(x - cumulative mean) / cumulative std per frame (feature_norm.py:5-36)."""
    _check_4d(x, "cumulative_norm")
    batch, channels, freqs, frames = x.shape
    flat = x.reshape(batch * channels, freqs, frames)
    cumulative_sum = torch.cumsum(flat.sum(dim=1), dim=-1)
    cumulative_pow_sum = torch.cumsum((flat * flat).sum(dim=1), dim=-1)
    entry_count = torch.arange(freqs, freqs * frames + 1, freqs, dtype=x.dtype,
                               device=x.device)[None, :]
    cum_mean = cumulative_sum / entry_count
    cum_var = (cumulative_pow_sum - 2 * cum_mean * cumulative_sum) / entry_count + cum_mean ** 2
    cum_std = torch.sqrt(cum_var + 1e-10)
    normed = (flat - cum_mean[:, None, :]) / cum_std[:, None, :]
    return normed.reshape(batch, channels, freqs, frames)


def cumulative_mag_spectral_norm(x: torch.Tensor, *, cumulative: bool = False,
                                 use_mid_freq_mu: bool = False,
                                 eps: float = 1e-6) -> torch.Tensor:
    """x / mu (feature_norm.py:39-82): mu from each frame's mean over
    frequency (or the bin F // 2 - 1 with `use_mid_freq_mu`), averaged over
    all frames, or with `cumulative` over the frames up to each one."""
    _check_4d(x, "cumulative_mag_spectral_norm")
    batch, channels, freqs, frames = x.shape
    flat = x.reshape(batch * channels, freqs, frames)
    step = flat[:, freqs // 2 - 1, :] if use_mid_freq_mu else flat.mean(dim=1)
    if cumulative:
        count = torch.arange(1, frames + 1, dtype=x.dtype, device=x.device)[None, :]
        mu = (torch.cumsum(step, dim=-1) / count)[:, None, :]
    else:
        mu = step.mean(dim=-1)[:, None, None]
    return (flat / (mu + eps)).reshape(batch, channels, freqs, frames)
