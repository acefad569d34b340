"""Every inference mode of the port's Enhancer against the JAX package's, on
the CPU at a tiny config (n_fft 64, hidden 16). The shipped models drive
the full-band modes (FullSubNet+ through `mag_complex_full_band_crm_mask`,
FullSubNet through `full_band_crm_mask`, both through `overlapped_chunk`);
modes that serve model families no shipped config has are driven by stub
models of the right signature, the same arithmetic on both sides, as the
JAX package's own tests drive them (tests/test_enhance_modes.py). Also the
DSP they add: the unfold's pad modes and the iSTFT from magnitude and phase.

Floors: waveforms >= 60 dB against JAX (float32; JAX at HIGHEST matmul
precision); a length-masked batch against exact-length runs >= 80 dB;
`overlapped_chunk` against the reference's per-chunk loop as the JAX
package holds its own (relative L2 2e-2, 2e-3 over the full chunks).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fullsubnet_plus_tpu.dsp import unfold as junfold
from fullsubnet_plus_tpu.dsp.norms import time_mask as jtime_mask
from fullsubnet_plus_tpu.enhance import Enhancer as JEnhancer
from fullsubnet_plus_tpu.models import FULLSUBNET as J_BASE
from fullsubnet_plus_tpu.models import FULLSUBNET_PLUS as J_PLUS
from fullsubnet_plus_tpu.models import ModelDef as JModelDef
from fullsubnet_plus_tpu.models.fullsubnet import FullSubNetConfig as JBaseConfig
from fullsubnet_plus_tpu.models.fullsubnet_plus import FullSubNetPlusConfig as JPlusConfig
from fullsubnet_plus_torch.dsp import stft, unfold
from fullsubnet_plus_torch.dsp.norms import time_mask
from fullsubnet_plus_torch.enhance import Enhancer
from fullsubnet_plus_torch.io.convert import state_dict_from_jax
from fullsubnet_plus_torch.models import FULLSUBNET, FULLSUBNET_PLUS, ModelDef
from fullsubnet_plus_torch.models.fullsubnet import FullSubNetConfig
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlusConfig

jstft = importlib.import_module("fullsubnet_plus_tpu.dsp.stft")  # the package exports stft()

TINY = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)
ACOUSTICS = dict(n_fft=64, hop_length=32, win_length=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _snr(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return 10 * np.log10((ref ** 2).sum() / max(((ref - out) ** 2).sum(), 1e-300))


def _noisy(shape, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def plus_params():
    return jax.tree_util.tree_map(np.asarray, J_PLUS.init(jax.random.PRNGKey(0),
                                                          JPlusConfig(**TINY)))


@pytest.fixture(scope="module")
def base_params():
    return jax.tree_util.tree_map(np.asarray, J_BASE.init(jax.random.PRNGKey(1),
                                                          JBaseConfig(**TINY)))


def _pair(family, params, **kw):
    """(JAX Enhancer, port Enhancer) of a shipped family on the same weights."""
    if family == "plus":
        jdef, jcfg, tdef, tcfg = J_PLUS, JPlusConfig(**TINY), FULLSUBNET_PLUS, \
            FullSubNetPlusConfig(**TINY)
    else:
        jdef, jcfg, tdef, tcfg = J_BASE, JBaseConfig(**TINY), FULLSUBNET, FullSubNetConfig(**TINY)
    return (JEnhancer(jdef, jcfg, params, **ACOUSTICS, **kw),
            Enhancer(tdef, tcfg, state_dict_from_jax(params), device="cpu", **ACOUSTICS, **kw))


# ---------------------------------------------------------------------------
# stub models: one arithmetic, written once for each framework
# ---------------------------------------------------------------------------

def _stub_mag(m, xp):  # [B, 1, F, T] magnitude -> enhanced magnitude
    return m * xp["sigmoid"](m - 0.1)


def _stub_scaled(m, xp):  # -> [B, 2, F, T]; the mode uses channel 0
    return xp["cat"]([xp["sigmoid"](4.0 * m), xp["tanh"](m)], 1)


def _stub_complex(x, xp):  # [B, 2, F, T] real / imag -> compressed cIRM
    return 2.0 * xp["tanh"](x * 3.0) + 0.4


def _stub_time(w, xp):  # [B, L] -> [B, L]
    return 0.5 * w + 0.1 * xp["tanh"](3.0 * w)


def _stub_sub_band(folded, xp, valid_frames=None):
    """[B*F, W, T] -> [B*F, 2, T]: a gain from a global-over-time mean, a
    statistic that bucket padding dilutes unless `valid_frames` masks it."""
    n, w, t = folded.shape
    if valid_frames is None:
        mean = xp["sum12"](folded) / (w * t)
    else:
        mask = xp["time_mask"](t, valid_frames, folded.dtype)[:, None, :]
        mean = xp["sum12"](folded * mask) / (w * valid_frames[:, None, None])
    g = xp["tanh"](folded[:, w // 2:w // 2 + 1, :] / (mean + 1e-3))
    return xp["cat"]([0.4995837 * g, 0.1 * g * g], 1)


JNP = {"sigmoid": jax.nn.sigmoid, "tanh": jnp.tanh, "time_mask": jtime_mask,
       "cat": lambda xs, axis: jnp.concatenate(xs, axis=axis),
       "sum12": lambda x: x.sum(axis=(1, 2), keepdims=True)}
TORCH = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "time_mask": time_mask,
         "cat": lambda xs, dim: torch.cat(xs, dim=dim),
         "sum12": lambda x: x.sum(dim=(1, 2), keepdim=True)}


def _jax_stub(fn, n_inputs=1):
    def apply_fn(params, x, config, training=False, valid_frames=None):
        if valid_frames is None:
            return fn(x, JNP)
        return fn(x, JNP, valid_frames=valid_frames)

    return JModelDef("stub", type(None), lambda *a, **k: {}, apply_fn, n_inputs)


def _torch_stub(fn, n_inputs=1):
    class Stub(nn.Module):
        def __init__(self, config=None):
            super().__init__()

        def forward(self, x, valid_frames=None):
            if valid_frames is None:
                return fn(x, TORCH)
            return fn(x, TORCH, valid_frames=valid_frames)

    return ModelDef("stub", type(None), Stub, n_inputs)


def _stub_pair(fn, mode, **kw):
    return (JEnhancer(_jax_stub(fn), None, {}, inference_type=mode, **ACOUSTICS, **kw),
            Enhancer(_torch_stub(fn), None, {}, inference_type=mode, device="cpu",
                     **ACOUSTICS, **kw))


STUB_MODES = {"mag": _stub_mag, "scaled_mask": _stub_scaled,
              "complex_full_band_crm_mask": _stub_complex, "time_domain": _stub_time,
              "sub_band_crm_mask": _stub_sub_band}


# ---------------------------------------------------------------------------
# each mode against JAX
# ---------------------------------------------------------------------------

def test_every_mode_is_known():
    assert set(Enhancer.MODES) == {m for m in dir(JEnhancer) if not m.startswith("_")
                                   and m not in ("enhance", "enhance_batch",
                                                 "LENGTH_AWARE_MODES")}
    assert Enhancer.LENGTH_AWARE_MODES == JEnhancer.LENGTH_AWARE_MODES


@pytest.mark.parametrize("mode", list(STUB_MODES))
def test_stub_mode_matches_jax(mode):
    noisy = _noisy((2, 4000), 0)
    kw = {"n_neighbor": 4} if mode == "sub_band_crm_mask" else {}
    j, t = _stub_pair(STUB_MODES[mode], mode, **kw)
    with jax.default_matmul_precision("highest"):
        ref = j.enhance_batch(noisy)
    out = t.enhance_batch(noisy)
    assert out.shape == noisy.shape and out.dtype == np.float32 and np.isfinite(out).all()
    assert _snr(ref, out) >= 60.0, _snr(ref, out)


@pytest.mark.parametrize("pad_mode", unfold.PAD_MODES)
def test_sub_band_pad_mode_matches_jax(pad_mode):
    """[inferencer.args] pad_mode reaches the unfold; each mode matches JAX,
    and the edge handling really differs between them."""
    noisy = _noisy((1, 3000), 1)
    j, t = _stub_pair(_stub_sub_band, "sub_band_crm_mask", n_neighbor=4,
                      inference_args={"pad_mode": pad_mode})
    with jax.default_matmul_precision("highest"):
        ref = j.enhance_batch(noisy)
    out = t.enhance_batch(noisy)
    assert _snr(ref, out) >= 60.0, _snr(ref, out)
    if pad_mode != "reflect":
        _, plain = _stub_pair(_stub_sub_band, "sub_band_crm_mask", n_neighbor=4)
        assert not np.allclose(plain.enhance_batch(noisy), out)


@pytest.mark.parametrize("family,mode", [("plus", "mag_complex_full_band_crm_mask"),
                                         ("base", "full_band_crm_mask")])
@pytest.mark.parametrize("lengths", [None, [2500, 4000]])
def test_full_band_modes_match_jax(request, family, mode, lengths):
    params = request.getfixturevalue(f"{family}_params")
    noisy = _noisy((2, 4000), 2)
    if lengths is not None:
        noisy[0, lengths[0]:] = 0.0
    j, t = _pair(family, params, inference_type=mode)
    with jax.default_matmul_precision("highest"):
        ref = j.enhance_batch(noisy, lengths=lengths)
    out = t.enhance_batch(noisy, lengths=lengths)
    assert _snr(ref, out) >= 60.0, _snr(ref, out)


@pytest.mark.parametrize("family", ["plus", "base"])
def test_overlapped_chunk_matches_jax(request, family):
    """The fixed-shape batched streaming mode against JAX's, chunk_length
    1 s from [inferencer.args], on an utterance of 5 full chunks and a tail."""
    params = request.getfixturevalue(f"{family}_params")
    y = _noisy((1, 36800), 7)
    j, t = _pair(family, params, inference_type="overlapped_chunk", sr=16000,
                 inference_args={"chunk_length": 1})
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(j.overlapped_chunk(y, chunk_batch=4))
    out = t.overlapped_chunk(y, chunk_batch=4).numpy()
    assert out.shape == ref.shape == y.shape
    assert _snr(ref, out) >= 60.0, _snr(ref, out)
    np.testing.assert_array_equal(t.enhance_batch(y), t.overlapped_chunk(y).numpy())


def _reference_ola_loop(e, y, chunk_seconds):
    """The reference's overlapped_chunk loop (inferencer.py:191-250,
    single-channel): per-chunk exact-length calls of the base mode, Hann
    OLA in numpy; the oracle of the fixed-shape batched form."""
    chunk_length = e.sr * chunk_seconds
    hop = chunk_length // 2
    window = np.hanning(chunk_length + 1)[:chunk_length].astype(np.float32)
    prev, segments = None, []
    for idx in range(int(len(y) / hop) + 1):
        start = idx * hop
        pad = np.zeros(256, np.float32) if idx == 0 else y[start - 256:start]
        chunk = np.concatenate([pad, y[start:start + chunk_length]])
        if len(chunk) <= 256:
            break
        enhanced = e.enhance_batch(chunk[None])[0][256:]
        if idx == 0:
            cur = enhanced[:hop]
            prev = enhanced[hop:] * window[hop:][:max(0, len(enhanced) - hop)]
        else:
            enhanced = enhanced * window[:len(enhanced)]
            tmp = enhanced[:hop]
            n = min(len(tmp), len(prev))
            cur = tmp[:n] + prev[:n]
            prev = enhanced[hop:]
        segments.append(cur)
    return np.concatenate(segments)[:len(y)]


@pytest.mark.parametrize("family", ["plus", "base"])
def test_overlapped_chunk_matches_the_reference_loop(request, family):
    params = request.getfixturevalue(f"{family}_params")
    _, base = _pair(family, params, sr=16000, inference_type=(
        "mag_complex_full_band_crm_mask" if family == "plus" else "full_band_crm_mask"))
    _, t = _pair(family, params, inference_type="overlapped_chunk", sr=16000)
    y = _noisy(36800, 8)
    ref = _reference_ola_loop(base, y, 1)
    out = t.overlapped_chunk(y[None], chunk_seconds=1, chunk_batch=4).numpy()[0]
    assert out.shape == ref.shape
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 2e-2
    head = 16000 * 2
    assert np.linalg.norm(out[:head] - ref[:head]) / np.linalg.norm(ref[:head]) < 2e-3


# ---------------------------------------------------------------------------
# length masking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_short", [2500, 3984])
def test_length_masked_full_band_matches_exact(base_params, n_short):
    """FullSubNet's full_band_crm_mask on a padded batch with true lengths:
    each row matches its exact-length run (an utterance ending within
    n_fft // 2 of the bucket edge too)."""
    _, e = _pair("base", base_params, inference_type="full_band_crm_mask")
    short, longer = _noisy(n_short, 3), _noisy(4000, 4)
    padded = np.zeros((2, 4000), np.float32)
    padded[0, :n_short], padded[1] = short, longer
    masked = e.enhance_batch(padded, lengths=[n_short, 4000])
    exact = e.enhance_batch(short[None])[0]
    assert _snr(exact, masked[0, :n_short]) > 80.0
    assert _snr(e.enhance_batch(longer[None])[0], masked[1]) > 80.0
    if n_short == 2500:  # without lengths the norms' statistics see the padding
        assert _snr(exact, e.enhance_batch(padded)[0, :n_short]) < 60.0


def test_length_masked_sub_band_matches_exact():
    """sub_band_crm_mask repeats each utterance's frame count over its fold
    rows as `valid_frames`: the stub's mean then ignores the padding."""
    _, e = _stub_pair(_stub_sub_band, "sub_band_crm_mask", n_neighbor=4)
    short = _noisy(2500, 5)
    padded = np.zeros((2, 4000), np.float32)
    padded[0, :2500], padded[1] = short, _noisy(4000, 6)
    exact = e.enhance_batch(short[None])[0]
    agree = _snr(exact, e.enhance_batch(padded, lengths=[2500, 4000])[0, :2500])
    assert agree > 80.0, agree
    assert _snr(exact, e.enhance_batch(padded)[0, :2500]) < agree - 10.0


@pytest.mark.parametrize("mode", ["complex_full_band_crm_mask", "mag", "scaled_mask",
                                  "time_domain"])
def test_lengths_rejected_for_modes_that_cannot_honor_them(mode):
    _, e = _stub_pair(STUB_MODES[mode], mode)
    with pytest.raises(ValueError, match="cannot honor"):
        e.enhance_batch(np.zeros((1, 4000), np.float32), lengths=[2500])


# ---------------------------------------------------------------------------
# the DSP the modes add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_mode", unfold.PAD_MODES)
@pytest.mark.parametrize("neighbors", [0, 3])
def test_freq_unfold_pad_modes_match_jax(pad_mode, neighbors):
    x = np.random.default_rng(9).standard_normal((2, 3, 11, 5)).astype(np.float32)
    ref = np.asarray(junfold.freq_unfold(jnp.asarray(x), neighbors, pad_mode))
    out = unfold.freq_unfold(torch.from_numpy(x), neighbors, pad_mode).numpy()
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError, match="pad_mode"):
        unfold.freq_unfold(torch.from_numpy(x), 2, "mirror")


def test_mag_phase_and_istft_from_mag_phase_match_jax():
    y = _noisy((2, 2000), 10)
    spec = torch.stft(torch.from_numpy(y), 64, 32, 64, window=torch.hann_window(64),
                      center=True, return_complex=True)
    mag, phase = stft.mag_phase(spec)
    jmag, jphase = jstft.mag_phase(jnp.asarray(spec.numpy()))
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(phase.numpy(), np.asarray(jphase), rtol=1e-6, atol=1e-6)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jstft.istft((jmag, jphase), 64, 32, 64, length=2000,
                                     use_mag_phase=True))
    out = stft.istft(mag, phase, 64, 32, 64, length=2000, use_mag_phase=True).numpy()
    assert _snr(ref, out) >= 60.0 and _snr(y, out) >= 60.0
