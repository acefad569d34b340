"""Loss functions, selected by name from the config.

Counterpart of fullsubnet_plus_tpu/train/loss.py (reference
audio_zen/loss.py:1-32).
"""

from __future__ import annotations

import torch

from fullsubnet_plus_torch.constants import EPSILON


def mse_loss(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(target - prediction))


def l1_loss(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(target - prediction))


def si_snr_loss(target: torch.Tensor, estimate: torch.Tensor) -> torch.Tensor:
    """Negative scale-invariant SNR on time-domain signals [B, T]
    (zero-mean projection form)."""
    target = target - torch.mean(target, dim=-1, keepdim=True)
    estimate = estimate - torch.mean(estimate, dim=-1, keepdim=True)
    s_target = (torch.sum(estimate * target, dim=-1, keepdim=True) * target
                / (torch.sum(torch.square(target), dim=-1, keepdim=True) + EPSILON))
    e_noise = estimate - s_target
    ratio = torch.sum(torch.square(s_target), dim=-1) / (
        torch.sum(torch.square(e_noise), dim=-1) + EPSILON)
    return -torch.mean(10.0 * torch.log10(ratio + EPSILON))


LOSS_REGISTRY = {
    "mse_loss": mse_loss,
    "l1_loss": l1_loss,
    "si_snr_loss": si_snr_loss,
}


def get_loss(name: str):
    if name not in LOSS_REGISTRY:
        raise KeyError(f"Unknown loss {name!r}; known: {sorted(LOSS_REGISTRY)}")
    return LOSS_REGISTRY[name]
