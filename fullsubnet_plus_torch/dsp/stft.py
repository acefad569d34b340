"""STFT / iSTFT with the reference's `torch.stft` / `torch.istft` semantics.

Counterpart of fullsubnet_plus_tpu/dsp/stft.py:35-260: center=True with
reflect padding, periodic Hann window, onesided, unnormalized; least-squares
iSTFT (overlap-add over the squared-window envelope, center-trimmed, cut to
`length`), from real and imaginary parts or, with `use_mag_phase`, from
magnitude and phase (`mag_phase` splits a complex spectrum so). The forward
transform is `torch.stft` itself. The inverse runs its own overlap-add
because `istft(valid_frames=...)` normalizes each utterance by its own
window envelope, which `torch.istft` cannot do.
"""

from __future__ import annotations

import torch

from fullsubnet_plus_torch.dsp.norms import time_mask


def hann_window(win_length: int, n_fft: int | None = None, device=None) -> torch.Tensor:
    """Periodic Hann window (float32), center-padded to `n_fft` when
    win_length < n_fft (torch.stft semantics)."""
    window = torch.hann_window(win_length, periodic=True, dtype=torch.float32,
                               device=device)
    n_fft = win_length if n_fft is None else n_fft
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = torch.nn.functional.pad(window, (pad, n_fft - win_length - pad))
    return window


def stft(y: torch.Tensor, n_fft: int = 512, hop_length: int = 256,
         win_length: int = 512) -> torch.Tensor:
    """[B, L] waveform -> [B, F, T] complex64 spectrum."""
    if y.ndim != 2:
        raise ValueError(f"stft expects [B, L], got {tuple(y.shape)}")
    return torch.stft(
        y.float(), n_fft, hop_length, win_length,
        window=hann_window(win_length, device=y.device), center=True,
        pad_mode="reflect", normalized=False, onesided=True, return_complex=True,
    )


def stft_split(y: torch.Tensor, n_fft: int = 512, hop_length: int = 256,
               win_length: int = 512):
    """[B, L] waveform -> (mag, real, imag), each [B, F, T] float32."""
    spec = stft(y, n_fft, hop_length, win_length)
    real, imag = spec.real.contiguous(), spec.imag.contiguous()
    return torch.sqrt(real * real + imag * imag), real, imag


def overlap_add(frames_time: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """[B, T, n_fft] frames -> [B, T*hop + n_fft - hop] overlap-added signal.

    Each frame is split into n_fft // hop hop-sized slabs and slab i is
    added at row offset i (n_fft must be a multiple of hop)."""
    if n_fft % hop_length:
        raise ValueError("overlap_add needs hop_length to divide n_fft")
    batch, frames, _ = frames_time.shape
    rows_per_frame = n_fft // hop_length
    slabs = frames_time.reshape(batch, frames, rows_per_frame, hop_length)
    out = frames_time.new_zeros(batch, frames + rows_per_frame - 1, hop_length)
    for i in range(rows_per_frame):
        out[:, i:i + frames] += slabs[:, :, i]
    return out.reshape(batch, -1)


def mag_phase(spec: torch.Tensor):
    """Complex [.., F, T] -> (magnitude, phase)."""
    return spec.abs(), spec.angle()


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int = 512,
          hop_length: int = 256, win_length: int = 512, length: int | None = None,
          valid_frames: torch.Tensor | None = None, use_mag_phase: bool = False) -> torch.Tensor:
    """[B, F, T] real and imaginary parts (with `use_mag_phase`: magnitude
    and phase) -> [B, length] waveform.

    `valid_frames` ([B] int): per-utterance frame counts for bucket-padded
    batches; the window envelope then counts only each utterance's own
    frames, as its exact-length iSTFT would."""
    if use_mag_phase:
        real, imag = real * torch.cos(imag), real * torch.sin(imag)
    batch, _, frames = real.shape
    window = hann_window(win_length, n_fft, device=real.device)
    spec = torch.complex(real.float(), imag.float()).transpose(1, 2)  # [B, T, F]
    frames_time = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    signal = overlap_add(frames_time, n_fft, hop_length)
    if valid_frames is None:
        mask = real.new_ones(batch, frames, dtype=torch.float32)
    else:
        mask = time_mask(frames, valid_frames, torch.float32)
    env = overlap_add(mask[:, :, None] * (window * window), n_fft, hop_length)
    signal = signal / torch.where(env > 1e-11, env, torch.ones_like(env))
    signal = signal[:, n_fft // 2:]
    length = (frames - 1) * hop_length if length is None else length
    if length <= signal.shape[1]:
        return signal[:, :length]
    return torch.nn.functional.pad(signal, (0, length - signal.shape[1]))
