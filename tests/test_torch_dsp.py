"""The port's DSP (fullsubnet_plus_torch/dsp) against the JAX package's, on
the CPU: the same numpy inputs go through both, JAX at HIGHEST matmul
precision, the port in float32. Tolerances are float32 round-off for the
operation's size; the STFT ones cover an FFT (port) against a DFT matmul
(JAX)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_plus_tpu.dsp import mask as jmask
from fullsubnet_plus_tpu.dsp import norms as jnorms
from fullsubnet_plus_tpu.dsp.stft import istft as j_istft, stft_split as j_stft_split
from fullsubnet_plus_tpu.dsp import unfold as junfold
from fullsubnet_plus_torch.dsp import mask as tmask
from fullsubnet_plus_torch.dsp import norms as tnorms
from fullsubnet_plus_torch.dsp import stft as tstft
from fullsubnet_plus_torch.dsp import unfold as tunfold


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("n_fft,hop,length", [(64, 32, 1000), (512, 256, 8000)])
def test_stft_split_matches_jax(rng, n_fft, hop, length):
    y = (0.3 * rng.standard_normal((2, length))).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = [np.asarray(a) for a in j_stft_split(jnp.asarray(y), n_fft, hop, n_fft)]
    out = [_np(a) for a in tstft.stft_split(torch.from_numpy(y), n_fft, hop, n_fft)]
    for r, o in zip(ref, out):
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r, atol=2e-4 * np.abs(r).max(), rtol=0)


@pytest.mark.parametrize("valid", [None, [20, 32]])
def test_istft_matches_jax(rng, valid):
    """Plain and per-utterance-envelope iSTFT (valid_frames)."""
    n_fft, hop, frames = 64, 32, 32
    real = rng.standard_normal((2, n_fft // 2 + 1, frames)).astype(np.float32)
    imag = rng.standard_normal((2, n_fft // 2 + 1, frames)).astype(np.float32)
    vf = None if valid is None else np.asarray(valid, np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(j_istft(
            (jnp.asarray(real), jnp.asarray(imag)), n_fft, hop, n_fft, length=1000,
            valid_frames=None if vf is None else jnp.asarray(vf)))
    out = _np(tstft.istft(
        torch.from_numpy(real), torch.from_numpy(imag), n_fft, hop, n_fft, length=1000,
        valid_frames=None if vf is None else torch.from_numpy(vf).long()))
    assert out.shape == ref.shape == (2, 1000)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)


def test_stft_istft_round_trip(rng):
    y = (0.3 * rng.standard_normal((3, 2000))).astype(np.float32)
    _, real, imag = tstft.stft_split(torch.from_numpy(y), 64, 32, 64)
    back = _np(tstft.istft(real, imag, 64, 32, 64, length=2000))
    np.testing.assert_allclose(back, y, atol=1e-5)


@pytest.mark.parametrize("ndim,valid", [(3, None), (3, [5, 11]), (4, None), (4, [9, 3])])
def test_offline_laplace_norm_matches_jax(rng, ndim, valid):
    shape = (2, 7, 11) if ndim == 3 else (2, 3, 7, 11)
    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    v = None if valid is None else np.asarray(valid, np.int32)
    ref = np.asarray(jnorms.offline_laplace_norm(
        jnp.asarray(x), valid=None if v is None else jnp.asarray(v)))
    out = _np(tnorms.offline_laplace_norm(
        torch.from_numpy(x), valid=None if v is None else torch.from_numpy(v).long()))
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-5)


def test_time_mask_matches_jax():
    v = np.asarray([0, 3, 9], np.int32)
    ref = np.asarray(jnorms.time_mask(7, jnp.asarray(v)))
    np.testing.assert_array_equal(_np(tnorms.time_mask(7, torch.from_numpy(v))), ref)


@pytest.mark.parametrize("num_neighbors", [0, 1, 4, 15])
def test_freq_unfold_matches_jax(rng, num_neighbors):
    x = rng.standard_normal((2, 3, 33, 5)).astype(np.float32)
    ref = np.asarray(junfold.freq_unfold(jnp.asarray(x), num_neighbors))
    out = _np(tunfold.freq_unfold(torch.from_numpy(x), num_neighbors))
    np.testing.assert_array_equal(out, ref)  # a gather: exact


def test_decompress_cirm_and_complex_mul_match_jax(rng):
    m = (12 * rng.standard_normal((2, 9, 13, 2))).astype(np.float32)  # past the clamp
    ref = np.asarray(jmask.decompress_cirm(jnp.asarray(m)))
    out = _np(tmask.decompress_cirm(torch.from_numpy(m)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    a, b, c, d = (rng.standard_normal((4, 6)).astype(np.float32) for _ in range(4))
    ref_mul = jmask.complex_mul(*(jnp.asarray(v) for v in (a, b, c, d)))
    out_mul = tmask.complex_mul(*(torch.from_numpy(v) for v in (a, b, c, d)))
    for r, o in zip(ref_mul, out_mul):
        np.testing.assert_allclose(_np(o), np.asarray(r), atol=1e-6, rtol=1e-6)
