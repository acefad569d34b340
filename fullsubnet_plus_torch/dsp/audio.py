"""Host-side waveform utilities for the data pipeline (numpy).

A copy of fullsubnet_plus_tpu/dsp/audio.py, which the port does not import.
They run in the input pipeline on the host, so they are numpy with an
explicit np.random.Generator (the reference draws from global random
state), which makes each (seed, host, epoch, index) stream deterministic.

Reference: audio_zen/acoustics/feature.py:98-251 and the dynamic-mixing
math in fullsubnet_plus/dataset/dataset_train.py:106-182.
"""

from __future__ import annotations

import numpy as np


def norm_amplitude(y: np.ndarray, scalar: float | None = None, eps: float = 1e-6):
    """Peak-normalize; returns (y, scalar). feature.py:98-102."""
    if not scalar:
        scalar = np.max(np.abs(y)) + eps
    return y / scalar, scalar


def tailor_db_fs(y: np.ndarray, target_db_fs: float = -25, eps: float = 1e-6):
    """RMS loudness targeting; returns (y, rms, scalar). feature.py:105-109."""
    rms = np.sqrt(np.mean(y**2))
    scalar = 10 ** (target_db_fs / 20) / (rms + eps)
    return y * scalar, rms, scalar


def is_clipped(y: np.ndarray, clipping_threshold: float = 0.999) -> bool:
    """feature.py:112-113."""
    return bool(np.any(np.abs(y) > clipping_threshold))


def subsample(
    data: np.ndarray,
    sub_sample_length: int,
    rng: np.random.Generator | None = None,
    start_position: int = -1,
    return_start_position: bool = False,
):
    """Random fixed-length crop (or zero-pad) of 1-D data. feature.py:151-179."""
    assert np.ndim(data) == 1, f"Only 1-D data supported, got ndim={np.ndim(data)}"
    length = len(data)
    if length > sub_sample_length:
        if start_position < 0:
            rng = rng or np.random.default_rng()
            start_position = int(rng.integers(length - sub_sample_length))
        data = data[start_position : start_position + sub_sample_length]
    elif length < sub_sample_length:
        data = np.append(data, np.zeros(sub_sample_length - length, dtype=np.float32))
    assert len(data) == sub_sample_length
    if return_start_position:
        return data, start_position
    return data


def aligned_subsample(
    data_a: np.ndarray,
    data_b: np.ndarray,
    sub_sample_length: int,
    rng: np.random.Generator | None = None,
):
    """Crop the same random window from two aligned signals. feature.py:123-148."""
    assert data_a.shape[-1] == data_b.shape[-1], "Inconsistent dataset size."
    length = data_a.shape[-1]
    if length > sub_sample_length:
        rng = rng or np.random.default_rng()
        start = int(rng.integers(length - sub_sample_length + 1))
        end = start + sub_sample_length
        return data_a[..., start:end], data_b[..., start:end]
    if length < sub_sample_length:
        pad = sub_sample_length - length
        pad_width = [(0, 0)] * (data_a.ndim - 1) + [(0, pad)]
        return (
            np.pad(data_a, pad_width, mode="constant"),
            np.pad(data_b, pad_width, mode="constant"),
        )
    return data_a, data_b


def overlap_cat(chunk_list, axis: int = -1) -> np.ndarray:
    """Concatenate chunks with 50% overlap-average. feature.py:182-203."""
    overlap_output = []
    for i, chunk in enumerate(chunk_list):
        half = chunk.shape[axis] // 2
        first_half, last_half = np.split(chunk, [half], axis=axis)
        if i == 0:
            overlap_output += [first_half, last_half]
        else:
            overlap_output[-1] = (overlap_output[-1] + first_half) / 2
            overlap_output.append(last_half)
    return np.concatenate(overlap_output, axis=axis)


def activity_detector(
    audio: np.ndarray,
    fs: int = 16000,
    activity_threshold: float = 0.13,
    target_level: float = -25,
    eps: float = 1e-6,
) -> float:
    """Fraction of 50 ms windows above an energy threshold. feature.py:206-251."""
    audio, _, _ = tailor_db_fs(audio, target_level)
    window_samples = int(fs * 50 / 1000)
    sample_start = 0
    cnt = 0
    prev_energy_prob = 0.0
    active_frames = 0
    a, b = -1.0, 0.2
    alpha_rel, alpha_att = 0.05, 0.8
    while sample_start < len(audio):
        audio_win = audio[sample_start : sample_start + window_samples]
        frame_rms = 20 * np.log10(np.sum(audio_win**2) + eps)
        frame_energy_prob = 1.0 / (1 + np.exp(-(a + b * frame_rms)))
        if frame_energy_prob > prev_energy_prob:
            smoothed = frame_energy_prob * alpha_att + prev_energy_prob * (1 - alpha_att)
        else:
            smoothed = frame_energy_prob * alpha_rel + prev_energy_prob * (1 - alpha_rel)
        if smoothed > activity_threshold:
            active_frames += 1
        prev_energy_prob = frame_energy_prob
        sample_start += window_samples
        cnt += 1
    return active_frames / cnt
