"""Datasets: dynamic-mixing training, DNS validation pairs, inference scan.

Counterpart of fullsubnet_plus_tpu/data/datasets.py (reference
fullsubnet_plus/dataset/dataset_{train,validation,inference}.py). No torch
DataLoader: data/loader.py drives these with worker threads, and items are
numpy arrays on the host.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from fullsubnet_plus_torch.data.mixing import parse_snr_range, synthesize_pair
from fullsubnet_plus_torch.data.wav import load_wav, read_wav


def _read_list(path: str):
    with open(os.path.abspath(os.path.expanduser(path))) as f:
        return [line.rstrip("\n") for line in f]


def _offset_and_limit(lst, offset, limit):
    """base_dataset.py:8-12; a false limit keeps the rest."""
    lst = lst[offset:]
    return lst[:limit] if limit else lst


class TrainDataset:
    """Dynamic mixing per item (dataset_train.py:12-207). Item `index` of
    epoch `epoch` draws from its own stream, SeedSequence([seed, host_id,
    epoch, index]), so any item is reproducible alone. The clean list is
    sharded by host (`host_id::num_hosts`)."""

    def __init__(self, clean_dataset, noise_dataset, rir_dataset, *, clean_dataset_limit=None,
                 clean_dataset_offset=0, noise_dataset_limit=None, noise_dataset_offset=0,
                 rir_dataset_limit=None, rir_dataset_offset=0, snr_range=(-5, 20),
                 reverb_proportion=0.75, silence_length=0.2, target_dB_FS=-25,
                 target_dB_FS_floating_value=10, sub_sample_length=3.072, sr=16000,
                 pre_load_clean_dataset=False, pre_load_noise=False, pre_load_rir=False,
                 num_workers=4, seed=0, host_id=0, num_hosts=1):
        if not 0 <= reverb_proportion <= 1:
            raise ValueError(f"reverb_proportion {reverb_proportion} is not in [0, 1]")
        self.sr = sr
        clean_list = _offset_and_limit(_read_list(clean_dataset), clean_dataset_offset,
                                       clean_dataset_limit)
        self.clean_list = clean_list[host_id::num_hosts]
        self.noise_list = _offset_and_limit(_read_list(noise_dataset), noise_dataset_offset,
                                            noise_dataset_limit)
        self.rir_list = (_offset_and_limit(_read_list(rir_dataset), rir_dataset_offset,
                                           rir_dataset_limit) if rir_dataset else [])

        def preload(paths):
            with ThreadPoolExecutor(max_workers=num_workers) as ex:
                return list(zip(paths, ex.map(lambda p: load_wav(p, sr=sr), paths)))

        if pre_load_clean_dataset:
            self.clean_list = preload(self.clean_list)
        if pre_load_noise:
            self.noise_list = preload(self.noise_list)
        if pre_load_rir and self.rir_list:
            self.rir_list = preload(self.rir_list)

        self.snr_list = parse_snr_range(tuple(snr_range))
        self.reverb_proportion = reverb_proportion
        self.silence_length = silence_length
        self.target_db_fs = target_dB_FS
        self.target_db_fs_floating_value = target_dB_FS_floating_value
        self.sub_sample_length = sub_sample_length
        self.seed = seed
        self.host_id = host_id
        self.epoch = 0

    def __len__(self):
        return len(self.clean_list)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __getitem__(self, index: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host_id, self.epoch, int(index)]))
        return synthesize_pair(
            self.clean_list[index], self.noise_list, self.rir_list, rng, sr=self.sr,
            sub_sample_length=self.sub_sample_length, snr_list=self.snr_list,
            reverb_proportion=self.reverb_proportion, silence_length=self.silence_length,
            target_db_fs=self.target_db_fs,
            target_db_fs_floating_value=self.target_db_fs_floating_value)


class ValidationDataset:
    """The DNS test-set layout (dataset_validation.py:42-92): each
    `noisy/<...>fileid_N.wav` pairs with `clean/clean_fileid_N.wav`, and the
    speech type comes from the directory's name. Item i is (noisy, clean,
    name, speech type)."""

    def __init__(self, dataset_dir_list, sr=16000):
        self.sr = sr
        self.items = []  # (noisy_path, clean_path, name, speech_type)
        for dataset_dir in dataset_dir_list:
            dataset_dir = os.path.abspath(os.path.expanduser(dataset_dir))
            speech_type = self._speech_type(dataset_dir)
            noisy_dir = os.path.join(dataset_dir, "noisy")
            clean_dir = os.path.join(dataset_dir, "clean")
            if not os.path.isdir(noisy_dir):
                continue
            for fname in sorted(os.listdir(noisy_dir)):
                if not fname.endswith(".wav"):
                    continue
                stem = fname.removesuffix(".wav")
                clean_path = os.path.join(clean_dir, f"clean_fileid_{stem.split('fileid_')[-1]}.wav")
                if os.path.exists(clean_path):
                    self.items.append((os.path.join(noisy_dir, fname), clean_path, stem,
                                       speech_type))

    @staticmethod
    def _speech_type(dataset_dir):
        base = dataset_dir.rstrip("/").lower()
        for key, speech_type in (("with_reverb", "With_reverb"), ("no_reverb", "No_reverb"),
                                 ("non_english", "Non_english"), ("emotion", "Emotion"),
                                 ("singing", "Singing")):
            if key in base:
                return speech_type
        return "No_reverb"

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        noisy_path, clean_path, name, speech_type = self.items[index]
        return read_wav(noisy_path, sr=self.sr), read_wav(clean_path, sr=self.sr), name, speech_type


class InferenceDataset:
    """Sorted `.wav` paths under every directory of `dataset_dir_list`;
    item i is (waveform float32 at `sr`, file stem) (dataset_inference.py:
    10-39)."""

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
