"""Spectral normalization: the shipped offline Laplace norm.

Counterpart of fullsubnet_plus_tpu/dsp/norms.py:20-58 and `get_norm` (:232).
Inputs are [B, C, F, T] or [B, F, T]; statistics run over every non-batch
axis. The rest of the norm zoo is ROADMAP.md Queue 1 item 11.
"""

from __future__ import annotations

import torch

from fullsubnet_plus_torch.device import not_ported


def time_mask(num_frames: int, valid: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, num_frames] 1/0 mask of each row's first valid[b] frames."""
    frames = torch.arange(num_frames, device=valid.device)
    return (frames[None, :] < valid[:, None]).to(dtype)


def _broadcast_mask(x: torch.Tensor, valid):
    if valid is None:
        return None
    return time_mask(x.shape[-1], valid, x.dtype).reshape(
        x.shape[0], *([1] * (x.ndim - 2)), x.shape[-1]
    )


def offline_laplace_norm(x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """x / (utterance mean + 1e-5). With `valid` ([B] frame counts) the mean
    covers only the first valid[b] frames and the rest of x is zeroed."""
    axes = tuple(range(1, x.ndim))
    mask = _broadcast_mask(x, valid)
    if mask is None:
        return x / (x.mean(dim=axes, keepdim=True) + 1e-5)
    n_inner = 1
    for d in x.shape[1:-1]:
        n_inner *= d
    count = (n_inner * valid.to(x.dtype)).reshape(x.shape[0], *([1] * (x.ndim - 1)))
    mu = (x * mask).sum(dim=axes, keepdim=True) / count
    return x * mask / (mu + 1e-5)


def get_norm(norm_type: str):
    if norm_type != "offline_laplace_norm":
        raise not_ported(f"norm_type={norm_type!r}", "Queue 1 item 11")
    return offline_laplace_norm
