"""Inference dataset: a recursive scan of directories for `.wav` files.

Counterpart of `InferenceDataset` in fullsubnet_plus_tpu/data/datasets.py:
187-207 (reference dataset_inference.py:10-39). The training datasets are
ROADMAP.md Queue 1 item 11.
"""

from __future__ import annotations

import os

from fullsubnet_plus_torch.data.wav import read_wav


class InferenceDataset:
    """Sorted `.wav` paths under every directory of `dataset_dir_list`;
    item i is (waveform float32 at `sr`, file stem)."""

    def __init__(self, dataset_dir_list, sr=16000):
        self.sr = sr
        self.files = []
        for d in dataset_dir_list:
            d = os.path.abspath(os.path.expanduser(d))
            for root, _, files in os.walk(d):
                self.files.extend(os.path.join(root, f) for f in files if f.endswith(".wav"))
        self.files.sort()

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        path = self.files[index]
        return read_wav(path, sr=self.sr), os.path.splitext(os.path.basename(path))[0]
