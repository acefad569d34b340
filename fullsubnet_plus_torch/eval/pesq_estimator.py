"""PESQ-style perceptual quality estimators (numpy): wide-band (16 kHz,
P.862.2 structure) and narrow-band (8 kHz, P.862/P.862.1 structure).

A copy of fullsubnet_plus_tpu/eval/pesq_estimator.py, which the port does
not import; tests/test_torch_eval.py holds the two equal. The reference
computes WB-PESQ and NB-PESQ only through the `pesq`/`pypesq` wheels
(audio_zen/metrics.py:92-111); where they are not installed these
estimators rank checkpoints in the validation gate instead. They follow the
P.862 pipeline's structure:

  level alignment → input filter (100 Hz high-pass in wideband mode; an
  IRS-receive-like 300–3400 Hz band-pass in narrow-band mode) → envelope
  time alignment → 32 ms Hann frames → Bark-band pitch power densities →
  partial frequency compensation (of the reference) → short-term gain
  compensation (of the degraded) → Zwicker loudness → masked symmetric +
  asymmetric disturbances → L6/L2 two-stage time aggregation → sigmoid
  MOS-LQO mapping (P.862.2 coefficients for WB, P.862.1 for NB).

They are NOT ITU-conformant (registered as `WB_PESQ_EST` / `NB_PESQ_EST`,
never substituted for `WB_PESQ` / `NB_PESQ`): the Bark bands use the
Traunmüller scale, the hearing threshold Terhardt's approximation at 79 dB
SPL active speech, time alignment one global envelope cross-correlation,
and the two disturbance weights are self-calibrated per mode (see
`_CALIBRATION_NOTE`). Both are monotone in distortion, level-invariant,
delay-robust and bounded.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ACTIVE_SPEECH_SPL = 79.0  # dB SPL assumed for level-aligned speech (P.862)

_CALIBRATION_NOTE = """
The aggregation constants below were fit once on synthetic anchors: a
speech-shaped, 4 Hz-amplitude-modulated pink-noise "utterance" with
silences, degraded by additive white noise at SNR ∈ {0, 10, 20, 30, 40} dB.

Wideband targets MOS-LQO ≈ {1.3, 2.0, 2.8, 3.6, 4.2} (the widely reported
WB-PESQ vs SNR shape for noisy speech). The power-law p=0.7 on both
disturbances fits that curve to 0.07 MOS RMSE ({1.34, 1.93, 2.81, 3.47,
4.16}); the identical-signal score is pinned at 4.64 by construction (zero
disturbance → raw 4.5 → P.862.2 sigmoid 4.64).

Narrow-band targets MOS-LQO ≈ {1.35, 1.8, 2.65, 3.65, 4.3} — the raw-PESQ
vs SNR shape ({≈1.5, 2.2, 2.9, 3.6, 4.2}) pushed through the P.862.1
raw→LQO sigmoid. Fit by scripts/calibrate_pesq_estimator.py with the
symmetric/asymmetric ratio CONSTRAINED to WB's (an unconstrained 2-param
fit collapses to d_weight≈0, i.e. an estimator blind to omission-type
distortions — exactly what over-suppressing enhancement produces); the
constrained fit reaches {1.14, 1.69, 2.85, 3.62, 4.25}, 0.14 MOS RMSE.
Identical-signal score is 4.55 by construction (raw 4.5 → P.862.1
sigmoid 4.55).
"""

D_POWER = 0.7


# ---------------------------------------------------------------------------
# Mode tables (WB 16 kHz / NB 8 kHz)
# ---------------------------------------------------------------------------

def _bark(f):
    return 26.81 * f / (1960.0 + f) - 0.53


def _bark_inv(z):
    return 1960.0 * (z + 0.53) / (26.28 - z)


def _terhardt_threshold_spl(f_hz):
    """Absolute hearing threshold in dB SPL (Terhardt 1979 approximation)."""
    f = np.maximum(f_hz, 20.0) / 1000.0
    return (
        3.64 * f ** -0.8
        - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
        + 1e-3 * f ** 4
    )


def _make_bands(n_fft, fs, n_bands):
    """Returns (bin->band index map [n_bins], band centers Hz, band widths
    in bark). Bands are equal-width in bark from 50 Hz to Nyquist."""
    z_lo, z_hi = _bark(50.0), _bark(fs / 2)
    edges_z = np.linspace(z_lo, z_hi, n_bands + 1)
    edges_hz = _bark_inv(edges_z)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / fs)
    band_of_bin = np.clip(np.searchsorted(edges_hz, freqs, side="right") - 1, -1, n_bands - 1)
    band_of_bin[freqs < edges_hz[0]] = -1  # below 50 Hz: discarded
    centers = 0.5 * (edges_hz[:-1] + edges_hz[1:])
    widths_bark = np.diff(edges_z)
    return band_of_bin, centers, widths_bark


@dataclass(frozen=True)
class _Mode:
    fs: int
    frame: int          # 32 ms
    shift: int          # 16 ms
    n_bands: int
    d_weight: float     # symmetric-disturbance weight (see _CALIBRATION_NOTE)
    a_weight: float     # asymmetric-disturbance weight
    sigmoid: tuple      # (slope, offset) of the raw→MOS-LQO mapping
    filter_band: tuple  # (low_hz | None, high_hz | None) input filter

    def __post_init__(self):
        band_of_bin, centers, widths = _make_bands(self.frame, self.fs, self.n_bands)
        object.__setattr__(self, "band_of_bin", band_of_bin)
        object.__setattr__(self, "width_bark", widths)
        object.__setattr__(
            self, "abs_thresh",
            10.0 ** (_terhardt_threshold_spl(centers) / 10.0),  # intensity
        )


WB = _Mode(
    fs=16000, frame=512, shift=256, n_bands=49,
    d_weight=0.5155, a_weight=0.2011,
    sigmoid=(1.3669, 3.8224),       # P.862.2 WB raw→LQO mapping
    filter_band=(100.0, None),      # P.862.2 wideband input high-pass role
)
NB = _Mode(
    fs=8000, frame=256, shift=128, n_bands=42,
    d_weight=0.5563, a_weight=0.2170,  # scripts/calibrate_pesq_estimator.py
    sigmoid=(1.4945, 4.6607),       # P.862.1 raw→LQO mapping
    filter_band=(300.0, 3400.0),    # IRS-receive-like telephone band role
)


# ---------------------------------------------------------------------------
# Front end
# ---------------------------------------------------------------------------

def _input_filter(x, mode: _Mode):
    """Butterworth realization of the mode's input filter role (our own
    design — the ITU IIR coefficients are not reproduced here)."""
    from scipy.signal import butter, sosfilt

    lo, hi = mode.filter_band
    if hi is None:
        sos = butter(2, lo, btype="highpass", fs=mode.fs, output="sos")
    else:
        sos = butter(2, [lo, hi], btype="bandpass", fs=mode.fs, output="sos")
    return sosfilt(sos, x)


def _speech_band_power(x, fs):
    """Mean power in the 350-3250 Hz speech band (level-alignment band)."""
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    mask = (freqs >= 350.0) & (freqs <= 3250.0)
    # Parseval: mean power of the band-limited signal
    return (np.abs(spec[mask]) ** 2).sum() * 2.0 / (len(x) ** 2) + 1e-20


def _level_align(x, fs, target=1e7 / 32768.0**2):
    """Scale so the 350-3250 Hz band has fixed power (P.862 fix_power_level;
    the target keeps the traditional 10^7 figure in int16-sample units)."""
    return x * np.sqrt(target / _speech_band_power(x, fs))


def _envelope_delay(ref, deg, hop=64):
    """Global delay estimate via cross-correlation of log energy envelopes."""
    n = min(len(ref), len(deg)) // hop * hop
    e = lambda x: np.log1p(
        (x[:n].reshape(-1, hop).astype(np.float64) ** 2).sum(axis=1)
    )
    er, ed = e(ref), e(deg)
    er = er - er.mean()
    ed = ed - ed.mean()
    corr = np.correlate(ed, er, mode="full")
    lag = int(np.argmax(corr)) - (len(er) - 1)
    return lag * hop  # samples by which deg lags ref


def _frames(x, mode: _Mode):
    n = max((len(x) - mode.frame) // mode.shift + 1, 1)
    idx = np.arange(mode.frame)[None, :] + mode.shift * np.arange(n)[:, None]
    pad = np.zeros(max(0, idx.max() + 1 - len(x)), x.dtype)
    xp = np.concatenate([x, pad])
    return xp[idx] * np.hanning(mode.frame)[None, :]


def _pitch_power_density(x, mode: _Mode):
    """[n_frames, n_bands] band intensities, scaled so active speech sits at
    ACTIVE_SPEECH_SPL dB SPL total."""
    frames = _frames(x, mode)
    psd = np.abs(np.fft.rfft(frames, axis=1)) ** 2 / (mode.frame * 0.375) ** 2
    bands = np.zeros((len(frames), mode.n_bands))
    valid = mode.band_of_bin >= 0
    np.add.at(bands.T, mode.band_of_bin[valid], psd[:, valid].T)
    total = bands.sum(axis=1)
    active = total > total.max() * 1e-4
    mean_active = total[active].mean() if active.any() else total.mean() + 1e-20
    k = 10.0 ** (ACTIVE_SPEECH_SPL / 10.0) / (mean_active + 1e-20)
    return bands * k


def _zwicker_loudness(p, mode: _Mode):
    """Bark-band intensity -> specific loudness (Zwicker power law 0.23)."""
    thr = mode.abs_thresh[None, :]
    s = (thr / 0.5) ** 0.23 * ((0.5 + 0.5 * p / thr) ** 0.23 - 1.0)
    return np.where(p > thr, s, 0.0)


# ---------------------------------------------------------------------------
# Main estimator
# ---------------------------------------------------------------------------

def _disturbances(clean: np.ndarray, degraded: np.ndarray,
                  sr: int, mode: _Mode) -> tuple:
    """(symmetric, asymmetric) aggregate disturbances — the two numbers the
    final score is an affine+sigmoid function of."""
    from fullsubnet_plus_torch.data.wav import resample

    ref = np.asarray(clean, np.float64)
    deg = np.asarray(degraded, np.float64)
    if sr != mode.fs:
        ref = resample(ref.astype(np.float32), sr, mode.fs).astype(np.float64)
        deg = resample(deg.astype(np.float32), sr, mode.fs).astype(np.float64)

    ref = _level_align(_input_filter(ref, mode), mode.fs)
    deg = _level_align(_input_filter(deg, mode), mode.fs)

    # Global time alignment
    lag = _envelope_delay(ref, deg)
    if lag > 0:
        deg = deg[lag:]
    elif lag < 0:
        ref = ref[-lag:]
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    if n < mode.frame:
        return np.inf, np.inf  # too short to score: worst case

    p_ref = _pitch_power_density(ref, mode)
    p_deg = _pitch_power_density(deg, mode)

    total_ref = p_ref.sum(axis=1)
    speech_active = total_ref > 10.0 ** ((ACTIVE_SPEECH_SPL - 30.0) / 10.0)
    if not speech_active.any():
        speech_active = total_ref >= np.median(total_ref)

    # Partial frequency compensation: correct the REFERENCE by the
    # band-wise deg/ref ratio averaged over active frames, clipped ±20 dB.
    num = p_deg[speech_active].mean(axis=0) + 1e3
    den = p_ref[speech_active].mean(axis=0) + 1e3
    band_ratio = np.clip(num / den, 0.01, 100.0)
    p_ref = p_ref * band_ratio[None, :]

    # Short-term gain compensation: correct the DEGRADED frame-by-frame by
    # the smoothed total-power ratio, clipped [3e-4, 5].
    raw_gain = (p_ref.sum(axis=1) + 5e4) / (p_deg.sum(axis=1) + 5e4)
    gain = np.empty_like(raw_gain)
    g = 1.0
    for i, r in enumerate(raw_gain):  # first-order smoother, 0.8 memory
        g = 0.8 * g + 0.2 * r
        gain[i] = g
    p_deg = p_deg * np.clip(gain, 3e-4, 5.0)[:, None]

    l_ref = _zwicker_loudness(p_ref, mode)
    l_deg = _zwicker_loudness(p_deg, mode)

    # Masked symmetric disturbance
    d = l_deg - l_ref
    m = 0.25 * np.minimum(l_deg, l_ref)
    d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    # Asymmetry factor: additive (noise) disturbances weigh more than
    # omissions; below 3 it is zeroed, above 12 clipped (P.862 shape).
    asym = ((p_deg + 50.0) / (p_ref + 50.0)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))

    w = mode.width_bark[None, :]
    d_frame = np.sqrt(((np.abs(d) * w) ** 2).sum(axis=1) / w.sum())
    a_frame = (np.abs(d) * asym * w).sum(axis=1) / w.sum()

    # Emphasize frames with audible reference energy (h weighting)
    h = ((total_ref + 1e5) / 1e7) ** 0.04
    h = np.clip(h, 1e-2, 10.0)
    d_frame = d_frame / h
    a_frame = a_frame / h

    def _two_stage(values, p_inner):
        """Lp over 20-frame 'syllables' (hop 10), then L2 over syllables.
        A final tail-anchored window guarantees the last frames are always
        aggregated (otherwise distortion in the trailing ~150 ms of an
        utterance would be invisible)."""
        if len(values) < 20:
            chunks = values[None, :]
        else:
            starts = list(np.arange(0, len(values) - 19, 10))
            if starts[-1] != len(values) - 20:
                starts.append(len(values) - 20)
            chunks = np.stack([values[s : s + 20] for s in starts])
        inner = (np.mean(chunks ** p_inner, axis=1)) ** (1.0 / p_inner)
        return float(np.sqrt(np.mean(inner**2)))

    return _two_stage(d_frame, 6.0), _two_stage(a_frame, 1.0)


def _score(clean, degraded, sr, mode: _Mode) -> float:
    d_total, a_total = _disturbances(clean, degraded, sr, mode)
    if not np.isfinite(d_total):
        return 1.0
    raw = 4.5 - mode.d_weight * d_total**D_POWER - mode.a_weight * a_total**D_POWER
    raw = float(np.clip(raw, -0.5, 4.5))
    slope, offset = mode.sigmoid
    return float(0.999 + 4.0 / (1.0 + np.exp(-slope * raw + offset)))


def wb_pesq_estimator(clean: np.ndarray, degraded: np.ndarray,
                      sr: int = 16000) -> float:
    """Wideband MOS-LQO in [~1.0, 4.64]. See module docstring for scope."""
    return _score(clean, degraded, sr, WB)


def nb_pesq_estimator(clean: np.ndarray, degraded: np.ndarray,
                      sr: int = 16000) -> float:
    """Narrow-band MOS-LQO in [~1.0, 4.55]: the 8 kHz P.862/P.862.1-shaped
    sibling of `wb_pesq_estimator` (IRS-like band-pass input, 42 bark
    bands, P.862.1 raw→LQO mapping). Fallback for the reference's NB_PESQ
    (audio_zen/metrics.py:103-111) when no PESQ wheel is installed."""
    return _score(clean, degraded, sr, NB)
