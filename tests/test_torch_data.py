"""The port's input pipeline (data/mixing.py, data/datasets.py, data/loader.py,
data/native.py, dsp/audio.py) against the JAX package's, on a tiny seeded
corpus in the DNS layout.

Items and batches are compared bit for bit: the port draws the same random
numbers in the same order and does the same float arithmetic. Each side's
mixing runs either on the numpy path or on ONE shared native library (the
port's build of native/mixkit.cc, handed to the JAX module too), so the
comparison does not hang on two builds' compiler flags. The port's native
path against its numpy path: within 1e-6 (float32 sums in another order).
"""

import threading
import time

import numpy as np
import pytest
from scipy.signal import fftconvolve

from fullsubnet_plus_torch.data import datasets, loader, mixing, native, wav
from fullsubnet_plus_torch.dsp import audio
from fullsubnet_plus_tpu.data import datasets as jdatasets
from fullsubnet_plus_tpu.data import loader as jloader
from fullsubnet_plus_tpu.data import mixing as jmixing
from fullsubnet_plus_tpu.data import native as jnative
from fullsubnet_plus_tpu.dsp import audio as jaudio

SR = 16000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """6 clean utterances of 0.6-1.1 s, 3 noise files of 0.4 s (shorter than
    an item, so select_noise joins several), RIRs of 200 taps (the native
    convolution) and 900 taps (fftconvolve), and the list files."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(7)
    files = {"clean": [], "noise": [], "rir": []}
    for i in range(6):
        n = int((0.6 + 0.1 * i) * SR)
        t = np.arange(n) / SR
        y = 0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t) + 0.01 * rng.standard_normal(n)
        files["clean"].append(str(root / f"clean_{i}.wav"))
        wav.write_wav(files["clean"][-1], y, SR)
    for i in range(3):
        files["noise"].append(str(root / f"noise_{i}.wav"))
        wav.write_wav(files["noise"][-1], 0.1 * rng.standard_normal(int(0.4 * SR)), SR)
    for i, taps in enumerate((200, 900)):
        rir = rng.standard_normal(taps) * np.exp(-np.arange(taps) / 60.0)
        rir[0] = 1.0
        files["rir"].append(str(root / f"rir_{i}.wav"))
        wav.write_wav(files["rir"][-1], rir.astype(np.float32), SR, subtype="FLOAT")
    lists = {}
    for kind, paths in files.items():
        lists[kind] = str(root / f"{kind}.txt")
        (root / f"{kind}.txt").write_text("\n".join(paths) + "\n")
    return lists


@pytest.fixture(params=["numpy", "native"])
def mixing_path(request, monkeypatch):
    """Both packages on the numpy path, or both on the port's library."""
    if request.param == "numpy":
        monkeypatch.setitem(native._loaded, "lib", None)
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    else:
        lib = native._load()
        if lib is None:
            pytest.skip("no C++ compiler: the native library cannot be built")
        monkeypatch.setattr(jnative, "_lib", lib)
    return request.param


def _train_kwargs(lists, reverb):
    return dict(clean_dataset=lists["clean"], noise_dataset=lists["noise"],
                rir_dataset=lists["rir"], snr_range=(-5, 20), reverb_proportion=reverb,
                sub_sample_length=0.5, seed=3)


@pytest.mark.parametrize("reverb", [0.0, 1.0])
def test_train_dataset_items_equal_jax(corpus, mixing_path, reverb):
    ours = datasets.TrainDataset(**_train_kwargs(corpus, reverb))
    ref = jdatasets.TrainDataset(**_train_kwargs(corpus, reverb))
    assert len(ours) == len(ref) == 6
    for epoch in (0, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for index in range(len(ours)):
            for a, b in zip(ours[index], ref[index]):
                assert a.dtype == b.dtype == np.float32 and a.shape == (SR // 2,)
                np.testing.assert_array_equal(a, b)
    ours.set_epoch(0)
    assert not np.array_equal(ours[0][0], ours[1][0])  # per-index streams differ


def test_train_dataset_host_shard_and_preload_equal_jax(corpus, mixing_path):
    kw = dict(_train_kwargs(corpus, 0.5), host_id=1, num_hosts=2, pre_load_clean_dataset=True,
              pre_load_noise=True, pre_load_rir=True, clean_dataset_offset=1,
              noise_dataset_limit=2)
    ours, ref = datasets.TrainDataset(**kw), jdatasets.TrainDataset(**kw)
    assert len(ours) == len(ref) == 2  # items 1-5, host 1 of 2: 2 and 4
    for index in range(2):
        for a, b in zip(ours[index], ref[index]):
            np.testing.assert_array_equal(a, b)


def test_batch_loader_batches_equal_jax(corpus, mixing_path):
    kw = _train_kwargs(corpus, 0.5)
    ours = loader.BatchLoader(datasets.TrainDataset(**kw), 4, num_workers=3, seed=5)
    ref = jloader.BatchLoader(jdatasets.TrainDataset(**kw), 4, num_workers=3, seed=5)
    assert len(ours) == len(ref) == 1
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 1
        for a, b in zip(got[0], want[0]):
            assert a.shape == (4, SR // 2)
            np.testing.assert_array_equal(a, b)
    keep = loader.BatchLoader(datasets.TrainDataset(**kw), 4, drop_last=False, shuffle=False)
    assert len(keep) == 2 and [b[0].shape[0] for b in keep.epoch(0)] == [4, 2]


def test_batch_loader_propagates_worker_exception():
    class Boom:
        def __len__(self):
            return 8

        def __getitem__(self, idx):
            raise ValueError("synthetic worker failure")

    with pytest.raises(ValueError, match="synthetic worker failure"):
        list(loader.BatchLoader(Boom(), batch_size=2, num_workers=2).epoch(0))


def test_batch_loader_early_exit_releases_producer(corpus):
    ds = datasets.TrainDataset(**_train_kwargs(corpus, 0.0))
    before = threading.active_count()
    gen = loader.BatchLoader(ds, 2, num_workers=2, prefetch=1).epoch(0)
    next(gen)  # the producer now blocks refilling the queue of one
    gen.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_validation_dataset_items_and_types_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    dirs = []
    for split in ("with_reverb", "no_reverb", "dns_2_emotion", "dns_2_singing",
                  "dns_2_non_english", "custom"):
        d = tmp_path / split
        for i in range(2):
            n = int((0.3 + 0.1 * i) * SR)
            wav.write_wav(str(d / "clean" / f"clean_fileid_{i}.wav"), 0.1 * rng.standard_normal(n), SR)
            wav.write_wav(str(d / "noisy" / f"x_snr{i}_fileid_{i}.wav"),
                          0.1 * rng.standard_normal(n), SR)
        wav.write_wav(str(d / "noisy" / "x_fileid_9.wav"), np.zeros(100), SR)  # no clean pair
        (d / "noisy" / "notes.txt").write_text("not a wav")
        dirs.append(str(d))
    dirs.append(str(tmp_path / "missing"))
    ours, ref = datasets.ValidationDataset(dirs), jdatasets.ValidationDataset(dirs)
    assert len(ours) == len(ref) == 12
    assert [it[2:] for it in ours.items] == [it[2:] for it in ref.items]
    assert {it[3] for it in ours.items} == {"With_reverb", "No_reverb", "Emotion", "Singing",
                                           "Non_english"}
    for i in range(len(ours)):
        got, want = ours[i], ref[i]
        assert got[2:] == want[2:]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_native_mix_matches_numpy_path(rng):
    """snr_mix through the library against its numpy path on the same draws,
    with a short RIR (the native convolution against fftconvolve)."""
    if not native.available():
        pytest.skip("no C++ compiler: the native library cannot be built")
    clean = (0.3 * rng.standard_normal(8000)).astype(np.float32)
    noise = (0.1 * rng.standard_normal(8000)).astype(np.float32)
    rir = (rng.standard_normal(300) * np.exp(-np.arange(300) / 40)).astype(np.float32)
    for snr, rir_or_none, seed in ((5.0, None, 0), (-5.0, rir, 1), (20.0, rir, 2)):
        got = mixing.snr_mix(clean, noise, snr, -25, 10, np.random.default_rng(seed),
                             rir=rir_or_none)
        want = mixing.snr_mix(clean, noise, snr, -25, 10, np.random.default_rng(seed),
                              rir=rir_or_none, use_native=False)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(native.rir_convolve(clean, rir),
                               fftconvolve(clean, rir)[: len(clean)], rtol=0, atol=1e-6)


@pytest.mark.parametrize("channels", [1, 2])
def test_pcm16_to_float_matches_jax(rng, mixing_path, channels):
    """PCM16 decoding, mono and stereo, on both paths: the port's and JAX's
    bit-equal on the same path, each within 1e-7 / 1e-6 of sample / 32768
    averaged over the channels (tests/test_native.py's bounds)."""
    samples = rng.integers(-32768, 32767, 1000 * channels).astype(np.int16)
    got = native.pcm16_to_float(samples, num_channels=channels)
    np.testing.assert_array_equal(got, jnative.pcm16_to_float(samples, num_channels=channels))
    want = (samples.astype(np.float32) / 32768.0).reshape(-1, channels).mean(axis=1)
    assert got.dtype == np.float32 and got.shape == (1000,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 if channels == 1 else 1e-6)


def test_native_build_missing_falls_back_to_numpy(monkeypatch, capsys):
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "build", lambda: None)
    assert not native.available()
    assert native.snr_mix_native(np.ones(4, np.float32), np.ones(4, np.float32), 0, -25, -25) is None
    assert "mixing in numpy" in capsys.readouterr().out
    noisy, clean = mixing.snr_mix(np.linspace(-1, 1, 64).astype(np.float32),
                                  np.cos(np.arange(64)).astype(np.float32), 5.0, -25, 10,
                                  np.random.default_rng(1))
    assert noisy.shape == clean.shape == (64,) and np.isfinite(noisy).all()


def test_mixing_helpers_equal_jax(corpus, rng):
    noise_list = open(corpus["noise"]).read().split()
    for target in (100, 6400, 20000):
        np.testing.assert_array_equal(
            mixing.select_noise(noise_list, target, np.random.default_rng(target)),
            jmixing.select_noise(noise_list, target, np.random.default_rng(target)))
    clean = (0.5 * rng.standard_normal(4000)).astype(np.float32)
    noise = (0.2 * rng.standard_normal(4000)).astype(np.float32)
    rirs = np.stack([np.r_[1.0, np.zeros(20)], np.r_[0.5, 0.3, np.zeros(19)]]).astype(np.float32)
    for kw in ({}, {"rir": rirs[0]}, {"rir": rirs}):  # a 2-D RIR bank draws a row
        got = mixing.snr_mix(clean, noise, 3.0, -25, 10, np.random.default_rng(4),
                             use_native=False, **kw)
        want = jmixing.snr_mix(clean, noise, 3.0, -25, 10, np.random.default_rng(4),
                               use_native=False, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # a loud mix is de-clipped below 0.99
    loud, _ = mixing.snr_mix(clean, noise, 40.0, 0, 0, rng, use_native=False)
    assert np.max(np.abs(loud)) <= 0.99
    assert mixing.parse_snr_range([-5, 20]) == jmixing.parse_snr_range([-5, 20])
    with pytest.raises(ValueError):
        mixing.parse_snr_range([3, 1])


@pytest.mark.parametrize("name", ["norm_amplitude", "tailor_db_fs", "is_clipped", "subsample",
                                  "aligned_subsample", "overlap_cat", "activity_detector"])
def test_dsp_audio_equal_jax(name, rng):
    y = (0.4 * rng.standard_normal(5000)).astype(np.float32)
    z = (0.2 * rng.standard_normal(5000)).astype(np.float32)
    def gen(seed):  # a fresh generator for each side
        return lambda: np.random.default_rng(seed)

    cases = {
        "norm_amplitude": [(y,), (y, 2.0)],
        "tailor_db_fs": [(y,), (y, -15)],
        "is_clipped": [(y,), (y * 0.1,)],
        "subsample": [(y, 1000, gen(1)), (y, 8000), (y, 1000, None, 17, True)],
        "aligned_subsample": [(y, z, 1000, gen(2)), (y, z, 6000), (y, z, 5000)],
        "overlap_cat": [([y[:400].reshape(2, 200), y[400:800].reshape(2, 200),
                          y[800:1200].reshape(2, 200)],)],
        "activity_detector": [(np.concatenate([np.zeros(4000, np.float32), y]),)],
    }[name]
    for args in cases:
        got = getattr(audio, name)(*(a() if callable(a) else a for a in args))
        want = getattr(jaudio, name)(*(a() if callable(a) else a for a in args))
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
