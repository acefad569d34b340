"""Profiling and RTF accounting.

Counterpart of fullsubnet_plus_tpu/utils/profiling.py:16-52. The
reference's only tracing is wall-clock RTF prints
(fullsubnet_plus/inferencer/inferencer.py:149-163). `device_trace` records
a torch.profiler trace of the host and, where there is one, the card
(CUDA kernels through CUPTI), and writes it as a Chrome trace
(`chrome://tracing`, Perfetto); `RtfMeter` counts audio-seconds against
wall seconds.
"""

from __future__ import annotations

import contextlib
import os
import time

TRACE_FILE = "trace.json"  # the Chrome trace `device_trace` writes into its directory


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """torch.profiler trace of the block, written to log_dir/TRACE_FILE;
    a no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class RtfMeter:
    """Accumulates (wall seconds, audio seconds) and reports RTF and
    audio-s/s throughput: the reference's per-utterance RTF, batched."""

    def __init__(self, sr: int = 16000):
        self.sr = sr
        self.wall = 0.0
        self.audio = 0.0

    @contextlib.contextmanager
    def measure(self, num_samples: int):
        t0 = time.perf_counter()
        yield
        self.wall += time.perf_counter() - t0
        self.audio += num_samples / self.sr

    @property
    def rtf(self) -> float:
        return self.wall / self.audio if self.audio else float("nan")

    @property
    def throughput(self) -> float:
        return self.audio / self.wall if self.wall else float("nan")
