"""Spectral normalization: the norm zoo of the reference BaseModel.

Counterpart of fullsubnet_plus_tpu/dsp/norms.py:20-253 (reference
base_model.py:90-330). Inputs are [B, C, F, T] or [B, F, T]; the offline
norms take their statistics over every non-batch axis, the cumulative ones
per frame over the (C, F) axes through `_flatten_bc`, running over time with
float32 `cumsum`s. The forgetting norms (`forgetting_norm`, `hybrid_norm`,
`sband_forgetting_norm`) are recurrences over frames, run as a loop over T
with the reference's idx-0 quirk alp = min(-1, alpha); like the JAX ones
they take [B, F, T] only, so neither model can use them (both feed their
norm [B, 1, F, T]).
"""

from __future__ import annotations

import torch

from fullsubnet_plus_torch.constants import EPSILON

# the norms that take [B, F, T] only: the models, which norm [B, 1, F, T],
# refuse them (the JAX ones assert 3-D input)
THREE_D_ONLY = ("forgetting_norm", "hybrid_norm", "sband_forgetting_norm")


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


def _valid_count(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The number of entries a row's masked statistics cover, broadcast to x."""
    n_inner = 1
    for d in x.shape[1:-1]:
        n_inner *= d
    return (n_inner * valid.to(x.dtype)).reshape(x.shape[0], *([1] * (x.ndim - 1)))


def offline_laplace_norm(x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """x / (utterance mean + 1e-5). With `valid` ([B] frame counts) the mean
    covers only the first valid[b] frames and the rest of x is zeroed."""
    axes = tuple(range(1, x.ndim))
    mask = _broadcast_mask(x, valid)
    if mask is None:
        return x / (x.mean(dim=axes, keepdim=True) + 1e-5)
    mu = (x * mask).sum(dim=axes, keepdim=True) / _valid_count(x, valid)
    return x * mask / (mu + 1e-5)


def offline_gaussian_norm(x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """(x - mean) / (std + 1e-5), std with Bessel's correction (torch.std).
    `valid` as in `offline_laplace_norm`; the padded region is zeroed."""
    axes = tuple(range(1, x.ndim))
    mask = _broadcast_mask(x, valid)
    if mask is None:
        mu = x.mean(dim=axes, keepdim=True)
        return (x - mu) / (x.std(dim=axes, keepdim=True, correction=1) + 1e-5)
    count = _valid_count(x, valid)
    mu = (x * mask).sum(dim=axes, keepdim=True) / count
    var = (((x - mu) * mask) ** 2).sum(dim=axes, keepdim=True) / (count - 1.0)
    return (x - mu) * mask / (torch.sqrt(var) + 1e-5)


def _flatten_bc(x: torch.Tensor):
    """[B, C, F, T] -> ([B*C, F, T], unflatten); [B, F, T] passes through."""
    if x.ndim == 4:
        b, c, f, t = x.shape
        return x.reshape(b * c, f, t), lambda y: y.reshape(b, c, f, t)
    return x, lambda y: y


def _entry_count(num_freqs: int, num_frames: int, like: torch.Tensor) -> torch.Tensor:
    """[1, T]: F, 2F, ..., T*F, the entries up to each frame."""
    return torch.arange(num_freqs, num_freqs * num_frames + 1, num_freqs,
                        dtype=like.dtype, device=like.device)[None, :]


def cumulative_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """x / the mean of every entry up to its frame (base_model.py:227-258)."""
    flat, unflatten = _flatten_bc(x)
    _, num_freqs, num_frames = flat.shape
    cumulative_mean = torch.cumsum(flat.sum(dim=1), dim=-1) / _entry_count(
        num_freqs, num_frames, flat)
    return unflatten(flat / (cumulative_mean[:, None, :] + EPSILON))


def cumulative_layer_norm(x: torch.Tensor) -> torch.Tensor:
    """(x - cumulative mean) / cumulative std, the variance as E[x^2] -
    mean^2 from the running sums, as the reference (base_model.py:277-316)."""
    flat, unflatten = _flatten_bc(x)
    _, num_freqs, num_frames = flat.shape
    cumulative_sum = torch.cumsum(flat.sum(dim=1), dim=-1)
    cumulative_pow_sum = torch.cumsum((flat * flat).sum(dim=1), dim=-1)
    entry_count = _entry_count(num_freqs, num_frames, flat)
    cumulative_mean = cumulative_sum / entry_count
    cumulative_var = ((cumulative_pow_sum - 2.0 * cumulative_mean * cumulative_sum)
                      / entry_count + cumulative_mean ** 2)
    cumulative_std = torch.sqrt(cumulative_var + EPSILON)
    return unflatten((flat - cumulative_mean[:, None, :]) / cumulative_std[:, None, :])


def _check_3d(x: torch.Tensor, name: str) -> None:
    if x.ndim != 3:
        raise ValueError(f"{name} takes [B, F, T], got {tuple(x.shape)}")


def _alphas(num_frames: int, sample_length: int, like: torch.Tensor,
            hold: bool = True) -> torch.Tensor:
    """[T]: min((idx - 1) / (idx + 1), alpha), alpha = (L - 1) / (L + 1);
    frame 0 gives -1, the reference loop's quirk. With `hold`, exactly
    alpha from frame L on, as the JAX norms select it."""
    alpha = (sample_length - 1) / (sample_length + 1)
    idx = torch.arange(num_frames, dtype=like.dtype, device=like.device)
    alp = torch.clamp((idx - 1.0) / (idx + 1.0), max=alpha)
    return torch.where(idx < sample_length, alp, torch.full_like(alp, alpha)) if hold else alp


def _forgetting_mean(alp: torch.Tensor, drive: torch.Tensor) -> torch.Tensor:
    """mu_t = alp_t mu_(t-1) + (1 - alp_t) drive_t from mu_(-1) = 0, a loop
    over frames. alp [T], drive [B, T] -> [B, T]."""
    mu = drive.new_zeros(drive.shape[0])
    out = []
    for t in range(drive.shape[1]):
        mu = alp[t] * mu + (1.0 - alp[t]) * drive[:, t]
        out.append(mu)
    return torch.stack(out, dim=1)


def forgetting_norm(x: torch.Tensor, sample_length_in_training: int = 192) -> torch.Tensor:
    """x / exponentially forgotten frame mean (base_model.py:128-162);
    past `sample_length_in_training` frames alpha stays fixed."""
    _check_3d(x, "forgetting_norm")
    mu = _forgetting_mean(_alphas(x.shape[-1], sample_length_in_training, x), x.mean(dim=1))
    return x / (mu[:, None, :] + 1e-10)


def hybrid_norm(x: torch.Tensor, sample_length_in_training: int = 192) -> torch.Tensor:
    """The forgetting mean for the first `sample_length_in_training` frames,
    the cumulative mean after (base_model.py:165-208)."""
    _check_3d(x, "hybrid_norm")
    _, num_freqs, num_frames = x.shape
    cum_mean = torch.cumsum(x.sum(dim=1), dim=-1) / _entry_count(num_freqs, num_frames, x)
    initial_mu = _forgetting_mean(
        _alphas(num_frames, sample_length_in_training, x, hold=False), x.mean(dim=1))
    in_prefix = torch.arange(num_frames, device=x.device) < sample_length_in_training
    mu = torch.where(in_prefix[None, :], initial_mu, cum_mean)
    return x / (mu[:, None, :] + 1e-10)


def sband_forgetting_norm(x: torch.Tensor, train_sample_length: int = 192) -> torch.Tensor:
    """A forgetting norm whose steady state tracks the middle frequency bin
    alone (base_model.py:91-125)."""
    _check_3d(x, "sband_forgetting_norm")
    _, n_freqs, num_frames = x.shape
    in_prefix = torch.arange(num_frames, device=x.device) < train_sample_length
    drive = torch.where(in_prefix[None, :], x.mean(dim=1), x[:, n_freqs // 2 - 1, :])
    mu = _forgetting_mean(_alphas(num_frames, train_sample_length, x), drive)
    return x / (mu[:, None, :] + 1e-10)


_NORMS = {
    "sband_forgetting_norm": sband_forgetting_norm,
    "offline_laplace_norm": offline_laplace_norm,
    "cumulative_laplace_norm": cumulative_laplace_norm,
    "offline_gaussian_norm": offline_gaussian_norm,
    "cumulative_layer_norm": cumulative_layer_norm,
    "forgetting_norm": forgetting_norm,
    "hybrid_norm": hybrid_norm,
}


def get_norm(norm_type: str):
    """The norm named by the config (base_model.py:318-330), as a function
    (x, valid=None). The offline norms take masked statistics; the causal
    ones are unaffected by trailing padding, so with `valid` they zero the
    padded region and keep their statistics."""
    if norm_type not in _NORMS:
        raise NotImplementedError(
            f"Unknown norm type {norm_type!r}; choose from {sorted(_NORMS)}")
    fn = _NORMS[norm_type]
    if norm_type in ("offline_laplace_norm", "offline_gaussian_norm"):
        return fn

    def causal_norm(x, valid=None):
        y = fn(x)
        mask = _broadcast_mask(x, valid)
        return y if mask is None else y * mask

    return causal_norm


def model_norm(norm_type: str):
    """`get_norm` for a model, which norms [B, 1, F, T]: the forgetting
    norms take [B, F, T] only and are refused here (the JAX models reach
    their assert)."""
    if norm_type in THREE_D_ONLY:
        raise ValueError(f"norm_type={norm_type!r} takes [B, F, T] only; the models norm "
                         "[B, 1, F, T]")
    return get_norm(norm_type)
