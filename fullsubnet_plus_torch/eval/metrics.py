"""Metric registry and the validation score (reference audio_zen/metrics.py:
56-134, base_trainer.py:296-302).

Counterpart of fullsubnet_plus_tpu/eval/metrics.py, in numpy on the host:
validation scores enhanced waveforms copied back from the card. SI-SDR,
STOI and the two PESQ estimators are implemented here; WB/NB-PESQ use the
`pesq` / `pypesq` wheels, SDR `mir_eval` and MOSNET `speechmetrics`, and
each raises a RuntimeError naming its package when that is not installed
(`metric_available` says which can run).
"""

from __future__ import annotations

import importlib.util

import numpy as np

from fullsubnet_plus_torch.data.wav import resample
from fullsubnet_plus_torch.eval.pesq_estimator import nb_pesq_estimator, wb_pesq_estimator
from fullsubnet_plus_torch.eval.stoi import stoi as _stoi


def si_sdr(reference: np.ndarray, estimation: np.ndarray, sr: int = 16000) -> float:
    """Scale-Invariant Signal-to-Distortion Ratio (metrics.py:61-85)."""
    reference = np.asarray(reference, np.float64)
    estimation = np.asarray(estimation, np.float64)
    optimal_scaling = np.sum(reference * estimation) / (np.sum(reference**2) + 1e-14)
    projection = optimal_scaling * reference
    noise = estimation - projection
    ratio = np.sum(projection**2) / (np.sum(noise**2) + 1e-14)
    return float(10 * np.log10(ratio + 1e-14))


def stoi(clean: np.ndarray, enhanced: np.ndarray, sr: int = 16000) -> float:
    return _stoi(clean, enhanced, sr=sr)


def wb_pesq_est(clean: np.ndarray, enhanced: np.ndarray, sr: int = 16000) -> float:
    """The WB-PESQ-style estimator of eval/pesq_estimator.py (not ITU-conformant)."""
    return wb_pesq_estimator(clean, enhanced, sr=sr)


def nb_pesq_est(clean: np.ndarray, enhanced: np.ndarray, sr: int = 16000) -> float:
    """The NB-PESQ-style estimator of eval/pesq_estimator.py (not ITU-conformant)."""
    return nb_pesq_estimator(clean, enhanced, sr=sr)


def _require(module: str, metric: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise RuntimeError(f"{metric} needs the `{module}` package, which is not installed") from e


def wb_pesq(clean: np.ndarray, enhanced: np.ndarray, sr: int = 16000) -> float:
    """Wide-band PESQ (ITU-T P.862.2) through the `pesq` wheel (metrics.py:92-100)."""
    return float(_require("pesq", "WB_PESQ").pesq(sr, clean, enhanced, "wb"))


def nb_pesq(clean: np.ndarray, enhanced: np.ndarray, sr: int = 16000) -> float:
    """Narrow-band PESQ at 8 kHz through `pypesq`, else `pesq` (metrics.py:103-111)."""
    clean8 = resample(np.asarray(clean, np.float32), sr, 8000)
    enhanced8 = resample(np.asarray(enhanced, np.float32), sr, 8000)
    if importlib.util.find_spec("pypesq") is not None:
        return float(_require("pypesq", "NB_PESQ").pesq(clean8, enhanced8, 8000))
    return float(_require("pesq", "NB_PESQ").pesq(8000, clean8, enhanced8, "nb"))


def sdr(reference: np.ndarray, estimation: np.ndarray, sr: int = 16000) -> float:
    """BSS-eval SDR through `mir_eval` (metrics.py:56-58)."""
    separation = _require("mir_eval.separation", "SDR")
    value, _, _, _ = separation.bss_eval_sources(reference[None, :], estimation[None, :])
    return float(value[0])


def mosnet(reference: np.ndarray, estimation: np.ndarray, sr: int = 16000) -> float:
    """MOSNet through `speechmetrics` (metrics.py:113-125); loads its model per call."""
    model = _require("speechmetrics", "MOSNET").load("mosnet", window=None)
    return float(np.mean(model(estimation, rate=sr)["mosnet"]))


REGISTERED_METRICS = {
    "SI_SDR": si_sdr,
    "STOI": stoi,
    "WB_PESQ": wb_pesq,
    "WB_PESQ_EST": wb_pesq_est,
    "NB_PESQ": nb_pesq,
    "NB_PESQ_EST": nb_pesq_est,
    "SDR": sdr,
    "MOSNET": mosnet,
}

# the packages each wheel-backed metric can run on
_PACKAGES = {"WB_PESQ": ("pesq",), "NB_PESQ": ("pypesq", "pesq"), "SDR": ("mir_eval",),
             "MOSNET": ("speechmetrics",)}


def metric_available(name: str) -> bool:
    """True if the metric's implementation can run here."""
    if name in ("SI_SDR", "STOI", "WB_PESQ_EST", "NB_PESQ_EST"):
        return True
    return any(importlib.util.find_spec(p) is not None for p in _PACKAGES.get(name, ()))


def compute_metric(name: str, clean: np.ndarray, enhanced: np.ndarray, sr: int = 16000) -> float:
    if name not in REGISTERED_METRICS:
        raise KeyError(f"Unknown metric {name!r}; known: {sorted(REGISTERED_METRICS)}")
    return REGISTERED_METRICS[name](clean, enhanced, sr=sr)


def transform_pesq_range(pesq_score: float) -> float:
    """[-0.5, 4.5] -> [0, 1] (reference acoustics/utils.py:4-8)."""
    return (pesq_score + 0.5) / 5.0


def validation_score(metric_means: dict) -> float:
    """The best-model gate: the mean of STOI and range-normalized WB-PESQ
    (base_trainer.py:296-302); WB_PESQ_EST in the same formula when the
    wheel's WB_PESQ is absent, then STOI alone, then SI_SDR / 20."""
    for pesq in ("WB_PESQ", "WB_PESQ_EST"):
        if pesq in metric_means and "STOI" in metric_means:
            return (metric_means["STOI"] + transform_pesq_range(metric_means[pesq])) / 2
    if "STOI" in metric_means:
        return metric_means["STOI"]
    if "SI_SDR" in metric_means:
        return metric_means["SI_SDR"] / 20.0
    raise ValueError(f"No score-eligible metrics in {sorted(metric_means)}")
