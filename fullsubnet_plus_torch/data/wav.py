"""WAV read/write without librosa or soundfile (a copy of
fullsubnet_plus_tpu/data/wav.py, which the port does not import).

Supports PCM16/24/32 and float32/64 WAVs via scipy.io.wavfile, normalized to
float32 in [-1, 1] like librosa.load(sr=None) / soundfile. Resampling uses a
polyphase filter (scipy.signal.resample_poly), which is the same algorithm
librosa's "soxr"-free fallback uses.

Replaces the reference's `load_wav` (feature.py:116-120) and the
inferencer's soundfile write (base_inferencer.py:160).
"""

from __future__ import annotations

import os
from fractions import Fraction

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def read_wav(path: str, sr: int | None = None, mono: bool = True) -> np.ndarray:
    """Load a WAV as float32 [-1, 1]; resample to `sr` if given."""
    file_sr, data = wavfile.read(os.path.abspath(os.path.expanduser(path)))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if mono and data.ndim > 1:
        data = data.mean(axis=1)
    if sr is not None and file_sr != sr:
        data = resample(data, file_sr, sr)
    return np.ascontiguousarray(data, dtype=np.float32)


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis."""
    if orig_sr == target_sr:
        return y
    frac = Fraction(target_sr, orig_sr)
    return resample_poly(y, frac.numerator, frac.denominator, axis=-1).astype(
        np.float32
    )


def write_wav(path: str, y: np.ndarray, sr: int, subtype: str = "PCM_16") -> None:
    """Write float waveform; PCM_16 quantization matches soundfile's default."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    y = np.asarray(y)
    if subtype == "PCM_16":
        data = np.clip(np.round(y * 32768.0), -32768, 32767).astype(np.int16)
    elif subtype == "FLOAT":
        data = y.astype(np.float32)
    else:
        raise ValueError(f"Unsupported subtype {subtype}")
    wavfile.write(path, sr, data)


def load_wav(file, sr: int = 16000):
    """Reference-compatible loader: (path, waveform) pairs pass through
    (feature.py:116-120 preload support)."""
    if isinstance(file, (tuple, list)) and len(file) == 2:
        return file[-1]
    return read_wav(file, sr=sr)
