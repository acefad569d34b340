"""ctypes bindings for the host-side mixing helpers (native/mixkit.cc).

Counterpart of fullsubnet_plus_tpu/data/native.py. At first use the library
is compiled with g++ into fullsubnet_plus_torch/_build/ (git-ignored), named
after a digest of the source, and loaded; where g++ or the source is
missing every entry point returns None and the callers (data/mixing.py)
take their numpy path. Which path is in use is logged once. This is the
input pipeline's host work; nothing of it runs on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from fullsubnet_plus_torch.utils import logger

SOURCE = Path(__file__).resolve().parents[2] / "native" / "mixkit.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_lock = threading.Lock()
_loaded: dict = {}  # "lib": the CDLL, or None when the numpy path is in use


def build() -> Path | None:
    """Compile native/mixkit.cc once per source version; the library's path,
    or None when the source or g++ is missing or the build fails."""
    if not SOURCE.exists():
        return None
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    lib_path = BUILD_DIR / f"libmixkit_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mixkit_pcm16_to_float.argtypes = [ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
                                          ctypes.c_int32, f32p]
    lib.mixkit_pcm16_to_float.restype = ctypes.c_int64
    lib.mixkit_snr_mix.argtypes = [f32p, f32p, f32p, ctypes.c_int64, ctypes.c_float,
                                   ctypes.c_float, ctypes.c_float, ctypes.c_float]
    lib.mixkit_snr_mix.restype = ctypes.c_float
    lib.mixkit_rir_convolve.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64, f32p]
    lib.mixkit_rir_convolve.restype = None
    return lib


def _load() -> ctypes.CDLL | None:
    with _lock:
        if "lib" not in _loaded:
            path = build()
            try:
                _loaded["lib"] = _bind(ctypes.CDLL(str(path))) if path else None
            except OSError:
                _loaded["lib"] = None
            logger.log(f"[mixkit] native mixing from {path}" if _loaded["lib"] else
                       "[mixkit] no native library (g++ or native/mixkit.cc missing): "
                       "mixing in numpy")
        return _loaded["lib"]


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def pcm16_to_float(samples: np.ndarray, num_channels: int = 1) -> np.ndarray:
    """Interleaved int16 samples -> mono float32 in [-1, 1): each sample over
    32768, the channels of a frame averaged; natively, or in numpy without
    the library."""
    lib = _load()
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    frames = len(samples) // num_channels
    if lib is None:
        data = samples[:frames * num_channels].astype(np.float32) / 32768.0
        return data.reshape(frames, num_channels).mean(axis=1) if num_channels > 1 else data
    out = np.empty(frames, np.float32)
    lib.mixkit_pcm16_to_float(samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), frames,
                              num_channels, _fptr(out))
    return out


def snr_mix_native(clean: np.ndarray, noise: np.ndarray, snr_db: float, target_db_fs: float,
                   noisy_target_db_fs: float, eps: float = 1e-6):
    """(noisy, clean rescaled) mixed natively, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    if len(noise) != len(clean):
        raise ValueError(f"clean has {len(clean)} samples, noise {len(noise)}")
    clean = np.array(clean, np.float32)  # copies: the library works in place
    noise = np.array(noise, np.float32)
    noisy = np.empty_like(clean)
    lib.mixkit_snr_mix(_fptr(clean), _fptr(noise), _fptr(noisy), len(clean), float(snr_db),
                       float(target_db_fs), float(noisy_target_db_fs), float(eps))
    return noisy, clean


def rir_convolve(clean: np.ndarray, rir: np.ndarray) -> np.ndarray | None:
    """clean convolved with rir, cut to len(clean); None without the library."""
    lib = _load()
    if lib is None:
        return None
    clean = np.ascontiguousarray(clean, np.float32)
    rir = np.ascontiguousarray(rir, np.float32)
    out = np.empty_like(clean)
    lib.mixkit_rir_convolve(_fptr(clean), len(clean), _fptr(rir), len(rir), _fptr(out))
    return out
