"""Misc helpers (reference audio_zen/utils.py:13-218).

Counterpart of fullsubnet_plus_tpu/utils/misc.py:12-70. Its
`enable_compilation_cache` (:73) is left out: it configures XLA's
persistent compilation cache, and the port compiles nothing but its CUDA
kernels, which ops/nvcc.py builds once per source version and keeps under
fullsubnet_plus_torch/_build/. `check_nan` and `print_tensor_info` take
numpy arrays and torch tensors (on any device).
"""

from __future__ import annotations

import importlib
import os
import time

import numpy as np


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, possibly on the card
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def initialize_module(path: str, args: dict | None = None, initialize: bool = True):
    """Dynamic dotted-path loader (audio_zen/utils.py:63-99): the class or
    function at `path`, called with `args` when `initialize`."""
    module_path, _, name = path.rpartition(".")
    target = getattr(importlib.import_module(module_path), name)
    return target(**(args or {})) if initialize else target


def prepare_empty_dir(dirs, resume: bool = False) -> None:
    """audio_zen/utils.py:26-38: each directory must exist when resuming;
    otherwise it is made."""
    for dir_path in dirs:
        if resume:
            if not os.path.exists(dir_path):
                raise AssertionError(f"Resuming expects existing directory {dir_path}")
        else:
            os.makedirs(dir_path, exist_ok=True)


def check_nan(arr, name: str = "array") -> bool:
    """audio_zen/utils.py:41-43: whether `arr` holds a NaN (printed)."""
    has_nan = bool(np.isnan(_numpy(arr)).any())
    if has_nan:
        print(f"Warning: {name} contains NaN")
    return has_nan


class ExecutionTime:
    """Wall-clock timer (audio_zen/utils.py:46-60)."""

    def __init__(self):
        self.start_time = time.time()

    def duration(self) -> int:
        return int(time.time() - self.start_time)


def print_tensor_info(tensor, flag: str = "Tensor") -> None:
    """audio_zen/utils.py:102-110."""
    arr = _numpy(tensor)
    print(f"{flag}\tmax: {arr.max():.6f}, min: {arr.min():.6f}, "
          f"mean: {arr.mean():.6f}, shape: {arr.shape}, dtype: {arr.dtype}")


def expand_path(path: str) -> str:
    """audio_zen/utils.py:212-214."""
    return os.path.abspath(os.path.expanduser(path))


def basename(path: str):
    """audio_zen/utils.py:216-218: (stem, extension)."""
    stem, ext = os.path.splitext(os.path.basename(path))
    return stem, ext
