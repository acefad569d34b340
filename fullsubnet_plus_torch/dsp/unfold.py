"""Sub-band frequency unfold and the training-time band dropout.

Counterpart of fullsubnet_plus_tpu/dsp/unfold.py:22-101: pad the frequency
axis by `num_neighbors` (reflect by default; replicate, circular or
constant zeros as the reference inferencer's `pad_mode`), then slide a
(2n+1)-wide window over it, as a gather with a precomputed index table;
`drop_band` keeps every num_groups-th frequency, rotating with the sample.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PAD_MODES = ("reflect", "replicate", "circular", "constant")


@functools.lru_cache(maxsize=64)
def _unfold_indices(num_freqs: int, num_neighbors: int, pad_mode: str = "reflect") -> np.ndarray:
    """[F, 2n+1] indices into the unpadded frequency axis with torch F.pad's
    edge semantics for `pad_mode` (reflect: no edge repeat). "constant" maps
    out-of-range taps to index `num_freqs`, where the caller appends a row
    of zeros."""
    idx = np.arange(-num_neighbors, num_freqs + num_neighbors)
    if pad_mode == "reflect":
        idx = np.abs(idx)
        over = idx > num_freqs - 1
        idx[over] = 2 * (num_freqs - 1) - idx[over]
    elif pad_mode == "replicate":
        idx = np.clip(idx, 0, num_freqs - 1)
    elif pad_mode == "circular":
        idx = idx % num_freqs
    elif pad_mode == "constant":
        idx = np.where((idx < 0) | (idx > num_freqs - 1), num_freqs, idx)
    else:
        raise ValueError(f"unknown pad_mode {pad_mode!r}; one of {PAD_MODES}")
    window = 2 * num_neighbors + 1
    return np.stack([idx[f:f + window] for f in range(num_freqs)])


def freq_unfold(x: torch.Tensor, num_neighbors: int, pad_mode: str = "reflect") -> torch.Tensor:
    """[B, C, F, T] -> [B, F, C, 2n+1, T] overlapping frequency sub-bands."""
    if x.ndim != 4:
        raise ValueError(f"freq_unfold expects [B, C, F, T], got {tuple(x.shape)}")
    batch, channels, num_freqs, frames = x.shape
    if num_neighbors < 1:
        return x.permute(0, 2, 1, 3).reshape(batch, num_freqs, channels, 1, frames)
    idx = torch.from_numpy(_unfold_indices(num_freqs, num_neighbors, pad_mode)).to(x.device)
    if pad_mode == "constant":  # the zero row the out-of-range taps read
        x = torch.nn.functional.pad(x, (0, 0, 0, 1))
    gathered = x[:, :, idx, :]  # [B, C, F, W, T]
    return gathered.permute(0, 2, 1, 3, 4)


@functools.lru_cache(maxsize=64)
def _drop_band_indices(batch_size: int, num_freqs: int, num_groups: int, row_offset: int = 0):
    """(batch_idx [B], freq_idx [B, F // G]) in the reference's order: the
    output samples of group g are the inputs whose global index s (the
    local index plus `row_offset`) has s % G == g, in order, each keeping
    frequencies g, g + G, g + 2G, ... (reference feature.py:276-285). With
    an offset these are exactly the rows of the global batch's drop_band
    that belong to this slice of it, in the same relative order."""
    kept = num_freqs - (num_freqs % num_groups)
    batch_idx, freq_idx = [], []
    for g in range(num_groups):
        freqs = np.arange(g, kept, num_groups)
        for s in range(batch_size):
            if (row_offset + s) % num_groups == g:
                batch_idx.append(s)
                freq_idx.append(freqs)
    return np.asarray(batch_idx), np.stack(freq_idx, axis=0)


def drop_band(x: torch.Tensor, num_groups: int = 2, row_offset: int = 0,
              global_batch: int | None = None) -> torch.Tensor:
    """[B, C, F, T] -> [B, C, F // num_groups, T]: the training-only
    frequency subsample, coupling batch and frequency indices as the
    reference does.

    Under data parallelism x is one rank's (or one card's) rows of a global
    batch of `global_batch` rows, starting at global row `row_offset`: the
    coupling follows the global index, so the rows equal the global
    batch's drop_band restricted to them (a local index would keep the
    wrong bins wherever the offset is not a multiple of num_groups). The
    batch-size check is on the global batch."""
    batch_size, _, num_freqs, _ = x.shape
    total = batch_size if global_batch is None else global_batch
    if total <= num_groups:
        raise ValueError(f"Batch size ({total}) must exceed num_groups ({num_groups}).")
    if not 0 <= row_offset <= total - batch_size:
        raise ValueError(f"rows {row_offset}..{row_offset + batch_size - 1} are not in a "
                         f"batch of {total}")
    if num_groups <= 1:
        return x
    batch_idx, freq_idx = _drop_band_indices(batch_size, num_freqs, num_groups,
                                             row_offset % num_groups)
    batch_idx = torch.from_numpy(batch_idx).to(x.device)[:, None]
    freq_idx = torch.from_numpy(freq_idx).to(x.device)
    # advanced indices split by a slice move to the front: [B, F // G, C, T]
    return x[batch_idx, :, freq_idx, :].permute(0, 2, 1, 3)
