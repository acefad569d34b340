"""Sub-band frequency unfold (reflect padding).

Counterpart of fullsubnet_plus_tpu/dsp/unfold.py:22-66 with its default
pad mode: reflect-pad the frequency axis by `num_neighbors`, then slide a
(2n+1)-wide window over it, as a gather with a precomputed index table.
`drop_band` is training-only and waits for ROADMAP.md Queue 1 item 6.
"""

from __future__ import annotations

import numpy as np
import torch


def _reflect_indices(num_freqs: int, num_neighbors: int) -> np.ndarray:
    """[F, 2n+1] indices into the unpadded frequency axis (torch F.pad
    reflect semantics: no edge repeat)."""
    idx = np.abs(np.arange(-num_neighbors, num_freqs + num_neighbors))
    over = idx > num_freqs - 1
    idx[over] = 2 * (num_freqs - 1) - idx[over]
    window = 2 * num_neighbors + 1
    return np.stack([idx[f:f + window] for f in range(num_freqs)])


def freq_unfold(x: torch.Tensor, num_neighbors: int) -> torch.Tensor:
    """[B, C, F, T] -> [B, F, C, 2n+1, T] overlapping frequency sub-bands."""
    if x.ndim != 4:
        raise ValueError(f"freq_unfold expects [B, C, F, T], got {tuple(x.shape)}")
    batch, channels, num_freqs, frames = x.shape
    if num_neighbors < 1:
        return x.permute(0, 2, 1, 3).reshape(batch, num_freqs, channels, 1, frames)
    idx = torch.from_numpy(_reflect_indices(num_freqs, num_neighbors)).to(x.device)
    gathered = x[:, :, idx, :]  # [B, C, F, W, T]
    return gathered.permute(0, 2, 1, 3, 4)
