"""Short-Time Objective Intelligibility (STOI), numpy implementation.

A copy of fullsubnet_plus_tpu/eval/stoi.py, which the port does not import:
Taal et al., "An Algorithm for Intelligibility Prediction of Time-Frequency
Weighted Noisy Speech" (IEEE TASLP 2011), the algorithm behind the `pystoi`
package the reference calls (audio_zen/metrics.py:88-89): 10 kHz resample,
silent-frame removal, STFT, 1/3-octave band grouping, 384 ms short-time
segments, clipped normalized correlation.
"""

from __future__ import annotations

import functools

import numpy as np

from fullsubnet_plus_torch.data.wav import resample

FS = 10000          # internal sample rate
N_FRAME = 256       # frame length (25.6 ms), 50% overlap
NFFT = 512
NUM_BANDS = 15      # 1/3-octave bands
MIN_FREQ = 150.0    # center frequency of the first band
N = 30              # frames per short-time segment (384 ms)
BETA = -15.0        # lower SDR bound (dB)
DYN_RANGE = 40.0    # silent-frame energy range (dB)


@functools.lru_cache(maxsize=1)
def _third_octave_matrix():
    """[NUM_BANDS, NFFT//2+1] band-grouping matrix (paper eq. band edges)."""
    f = np.linspace(0, FS, NFFT + 1)[: NFFT // 2 + 1]
    k = np.arange(NUM_BANDS)
    cf = 2.0 ** (k / 3.0) * MIN_FREQ
    freq_low = cf * 2 ** (-1.0 / 6.0)
    freq_high = cf * 2 ** (1.0 / 6.0)
    obm = np.zeros((NUM_BANDS, len(f)))
    for i in range(NUM_BANDS):
        fl_ii = np.argmin((f - freq_low[i]) ** 2)
        fh_ii = np.argmin((f - freq_high[i]) ** 2)
        obm[i, fl_ii:fh_ii] = 1.0
    return obm


def _frames(x: np.ndarray) -> np.ndarray:
    """[L] -> [num_frames, N_FRAME] with 50% overlap, hann-windowed."""
    hop = N_FRAME // 2
    num = (len(x) - N_FRAME) // hop + 1
    if num <= 0:
        return np.zeros((0, N_FRAME))
    idx = np.arange(N_FRAME)[None, :] + hop * np.arange(num)[:, None]
    w = np.hanning(N_FRAME + 2)[1:-1]
    return x[idx] * w[None, :]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    """Drop frames whose clean energy is > DYN_RANGE dB below the max
    (pystoi-compatible: OLA-reconstruct the kept frames)."""
    hop = N_FRAME // 2
    xf = _frames(x)
    yf = _frames(y)
    if len(xf) == 0:
        return x, y
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-14)
    mask = energies > np.max(energies) - DYN_RANGE
    xf, yf = xf[mask], yf[mask]
    n_kept = len(xf)
    out_len = (n_kept - 1) * hop + N_FRAME if n_kept else 0
    x_out = np.zeros(out_len)
    y_out = np.zeros(out_len)
    for i in range(n_kept):
        x_out[i * hop : i * hop + N_FRAME] += xf[i]
        y_out[i * hop : i * hop + N_FRAME] += yf[i]
    return x_out, y_out


def _band_envelopes(x: np.ndarray) -> np.ndarray:
    """[L] -> [NUM_BANDS, num_frames] 1/3-octave magnitude envelopes."""
    frames = _frames(x)
    spec = np.abs(np.fft.rfft(frames, NFFT, axis=1)) ** 2  # [T, F]
    obm = _third_octave_matrix()
    return np.sqrt(obm @ spec.T)  # [bands, T]


def stoi(clean: np.ndarray, enhanced: np.ndarray, sr: int = 16000) -> float:
    """d in [~0, 1]; higher is more intelligible."""
    assert clean.shape == enhanced.shape, "signals must be aligned"
    if sr != FS:
        clean = resample(clean.astype(np.float64), sr, FS)
        enhanced = resample(enhanced.astype(np.float64), sr, FS)
    clean, enhanced = _remove_silent_frames(clean, enhanced)

    X = _band_envelopes(clean)   # [J, M]
    Y = _band_envelopes(enhanced)
    M = X.shape[1]
    if M < N:
        # too short after silence removal; fall back to whole-signal corr
        seg_starts = [0] if M > 1 else []
        seg_len = M
    else:
        seg_starts = range(M - N + 1)
        seg_len = N

    c = 10 ** (-BETA / 20.0)
    d_sum, count = 0.0, 0
    for m in seg_starts:
        Xs = X[:, m : m + seg_len]  # [J, N]
        Ys = Y[:, m : m + seg_len]
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
            np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-14
        )
        Ys_scaled = Ys * alpha
        Ys_clipped = np.minimum(Ys_scaled, Xs * (1 + c))
        xn = Xs - Xs.mean(axis=1, keepdims=True)
        yn = Ys_clipped - Ys_clipped.mean(axis=1, keepdims=True)
        corr = np.sum(xn * yn, axis=1) / (
            np.linalg.norm(xn, axis=1) * np.linalg.norm(yn, axis=1) + 1e-14
        )
        d_sum += np.sum(corr)
        count += len(corr)
    return float(d_sum / count) if count else 0.0
