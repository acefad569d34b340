"""Ideal ratio masks: the (real) IRM and the complex cIRM, their
compression, decompression and application.

Counterpart of fullsubnet_plus_tpu/dsp/mask.py:14-66 (reference
audio_zen/acoustics/mask.py:10-69).
"""

from __future__ import annotations

import torch

from fullsubnet_plus_torch.constants import EPSILON


def build_ideal_ratio_mask(noisy_mag: torch.Tensor, clean_mag: torch.Tensor) -> torch.Tensor:
    """Compressed IRM = compress(|clean| / (|noisy| + eps)). [B, F, T] -> [B, F, T, 1]."""
    return compress_cirm((clean_mag / (noisy_mag + EPSILON))[..., None], k=10.0, c=0.1)


def build_complex_ideal_ratio_mask(noisy_real: torch.Tensor, noisy_imag: torch.Tensor,
                                   clean_real: torch.Tensor,
                                   clean_imag: torch.Tensor) -> torch.Tensor:
    """Compressed cIRM = compress(clean / noisy) in C. [B, F, T] -> [B, F, T, 2]."""
    denominator = noisy_real ** 2 + noisy_imag ** 2 + EPSILON
    mask_real = (noisy_real * clean_real + noisy_imag * clean_imag) / denominator
    mask_imag = (noisy_real * clean_imag - noisy_imag * clean_real) / denominator
    return compress_cirm(torch.stack((mask_real, mask_imag), dim=-1), k=10.0, c=0.1)


def compress_cirm(mask: torch.Tensor, k: float = 10.0, c: float = 0.1) -> torch.Tensor:
    """(-inf, inf) -> (-k, k); values <= -100 are clamped to -100 first, as
    in the reference (audio_zen/acoustics/mask.py:47-57)."""
    mask = torch.where(mask <= -100.0, torch.full_like(mask, -100.0), mask)
    e = torch.exp(-c * mask)
    return k * (1.0 - e) / (1.0 + e)


def decompress_cirm(mask: torch.Tensor, k: float = 10.0, limit: float = 9.9) -> torch.Tensor:
    """Inverse of the compressed cIRM map, clamped to +-limit first."""
    mask = torch.clamp(mask, -limit, limit)
    return -k * torch.log((k - mask) / (k + mask))


def complex_mul(noisy_r, noisy_i, mask_r, mask_i):
    """(noisy_r + i noisy_i) * (mask_r + i mask_i) -> (real, imag)."""
    return noisy_r * mask_r - noisy_i * mask_i, noisy_r * mask_i + noisy_i * mask_r
