"""Complex ideal ratio mask decompression and application.

Counterpart of fullsubnet_plus_tpu/dsp/mask.py:50-66 (reference
audio_zen/acoustics/mask.py:60-69).
"""

from __future__ import annotations

import torch


def decompress_cirm(mask: torch.Tensor, k: float = 10.0, limit: float = 9.9) -> torch.Tensor:
    """Inverse of the compressed cIRM map, clamped to +-limit first."""
    mask = torch.clamp(mask, -limit, limit)
    return -k * torch.log((k - mask) / (k + mask))


def complex_mul(noisy_r, noisy_i, mask_r, mask_i):
    """(noisy_r + i noisy_i) * (mask_r + i mask_i) -> (real, imag)."""
    return noisy_r * mask_r - noisy_i * mask_i, noisy_r * mask_i + noisy_i * mask_r
