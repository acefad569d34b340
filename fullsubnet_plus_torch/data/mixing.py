"""Dynamic mixing: clean + noise (+ RIR) at a random SNR.

Counterpart of fullsubnet_plus_tpu/data/mixing.py (reference
fullsubnet_plus/dataset/dataset_train.py:106-207): every random draw comes
from an explicit np.random.Generator seeded per (seed, host, epoch, index),
so training data is deterministic and resumable. All draws happen in Python,
never in the native library, so the native path (data/native.py) and the
numpy path consume the same random stream and agree to float rounding.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import fftconvolve

from fullsubnet_plus_torch.data import native
from fullsubnet_plus_torch.data.wav import load_wav
from fullsubnet_plus_torch.dsp.audio import is_clipped, norm_amplitude, subsample, tailor_db_fs

# the native direct-form convolution is O(n * taps): faster than an FFT only
# for short room responses
NATIVE_RIR_MAX_TAPS = 512


def select_noise(noise_list, target_length: int, rng: np.random.Generator, sr: int = 16000,
                 silence_length: float = 0.2) -> np.ndarray:
    """Random noise files joined by silences, cut to a random window of
    `target_length` (dataset_train.py:106-127)."""
    noise_y = np.zeros(0, dtype=np.float32)
    silence = np.zeros(int(sr * silence_length), dtype=np.float32)
    remaining = target_length
    while remaining > 0:
        new = load_wav(noise_list[rng.integers(len(noise_list))], sr=sr)
        noise_y = np.append(noise_y, new)
        remaining -= len(new)
        if remaining > 0:
            silence_len = min(remaining, len(silence))
            noise_y = np.append(noise_y, silence[:silence_len])
            remaining -= silence_len
    if len(noise_y) > target_length:
        start = rng.integers(len(noise_y) - target_length)
        noise_y = noise_y[start : start + target_length]
    return noise_y


def snr_mix(clean_y: np.ndarray, noise_y: np.ndarray, snr: float, target_db_fs: float,
            target_db_fs_floating_value: float, rng: np.random.Generator,
            rir: np.ndarray | None = None, eps: float = 1e-6, use_native: bool = True):
    """Mix at `snr` dB with loudness retargeting and de-clipping
    (dataset_train.py:129-182) -> (noisy_y, clean_y)."""
    if rir is not None and rir.ndim > 1:
        rir = rir[rng.integers(rir.shape[0]), :]
    # a floating value of 0 is a fixed target level (the reference's
    # np.random.randint would raise on low >= high, dataset_train.py:166)
    if target_db_fs_floating_value > 0:
        noisy_target_db_fs = int(rng.integers(target_db_fs - target_db_fs_floating_value,
                                              target_db_fs + target_db_fs_floating_value))
    else:
        noisy_target_db_fs = int(target_db_fs)

    if rir is not None:
        convolved = None
        if use_native and len(rir) <= NATIVE_RIR_MAX_TAPS:
            convolved = native.rir_convolve(clean_y, rir)
        clean_y = convolved if convolved is not None else fftconvolve(clean_y, rir)[: len(clean_y)]

    if use_native:
        mixed = native.snr_mix_native(clean_y, noise_y, snr, target_db_fs, noisy_target_db_fs,
                                      eps)
        if mixed is not None:
            return mixed

    clean_y, _ = norm_amplitude(clean_y)
    clean_y, _, _ = tailor_db_fs(clean_y, target_db_fs)
    clean_rms = (clean_y**2).mean() ** 0.5

    noise_y, _ = norm_amplitude(noise_y)
    noise_y, _, _ = tailor_db_fs(noise_y, target_db_fs)
    noise_rms = (noise_y**2).mean() ** 0.5

    snr_scalar = clean_rms / (10 ** (snr / 20)) / (noise_rms + eps)
    noisy_y = clean_y + noise_y * snr_scalar

    noisy_y, _, noisy_scalar = tailor_db_fs(noisy_y, noisy_target_db_fs)
    clean_y = clean_y * noisy_scalar

    if is_clipped(noisy_y):
        noisy_scalar = np.max(np.abs(noisy_y)) / (0.99 - eps)
        noisy_y = noisy_y / noisy_scalar
        clean_y = clean_y / noisy_scalar
    return noisy_y, clean_y


def synthesize_pair(clean_file, noise_list, rir_list, rng: np.random.Generator, *,
                    sr: int = 16000, sub_sample_length: float = 3.072, snr_list,
                    reverb_proportion: float = 0.75, silence_length: float = 0.2,
                    target_db_fs: float = -25, target_db_fs_floating_value: float = 10):
    """One training example, (noisy float32 [L], clean float32 [L])
    (dataset_train.py:184-207)."""
    clean_y = subsample(load_wav(clean_file, sr=sr), int(sub_sample_length * sr), rng=rng)
    noise_y = select_noise(noise_list, len(clean_y), rng, sr=sr, silence_length=silence_length)
    snr = snr_list[rng.integers(len(snr_list))]
    use_reverb = bool(rng.random() < reverb_proportion) and len(rir_list) > 0
    rir = load_wav(rir_list[rng.integers(len(rir_list))], sr=sr) if use_reverb else None
    noisy_y, clean_y = snr_mix(clean_y, noise_y, snr, target_db_fs, target_db_fs_floating_value,
                               rng, rir=rir)
    return noisy_y.astype(np.float32), clean_y.astype(np.float32)


def parse_snr_range(snr_range) -> list:
    """[low, high] -> the integer grid low..high (reference
    BaseDataset._parse_snr_range, base_dataset.py:13-25)."""
    if len(snr_range) != 2 or snr_range[0] > snr_range[1]:
        raise ValueError(f"the SNR range must be [low, high] with low <= high, got {snr_range}")
    low, high = snr_range
    return list(range(int(low), int(high) + 1))
