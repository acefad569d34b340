"""The port's validation metrics (eval/metrics.py, eval/stoi.py,
eval/pesq_estimator.py) against the JAX package's on seeded pairs: equal
within 1e-9 (both are numpy on the host in float64; the port's copies keep
the arithmetic)."""

import importlib.util

import numpy as np
import pytest

from fullsubnet_plus_torch.eval import metrics
from fullsubnet_plus_tpu.eval import metrics as jmetrics

SR = 16000


def _pairs():
    """(clean, enhanced) pairs: a voiced tone under noise at several SNRs and
    lengths, an enhanced copy delayed and rescaled, and an identical pair."""
    rng = np.random.default_rng(11)
    out = []
    for seconds, snr_db in ((1.0, 0.0), (2.3, 10.0), (3.0, 25.0)):
        n = int(seconds * SR)
        t = np.arange(n) / SR
        clean = (0.3 * np.sin(2 * np.pi * 150 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
                 + 0.02 * rng.standard_normal(n)).astype(np.float32)
        noise = rng.standard_normal(n).astype(np.float32)
        noise *= np.sqrt(np.mean(clean**2) / np.mean(noise**2) / 10 ** (snr_db / 10))
        out.append((clean, clean + noise))
    clean = out[1][0]
    out.append((clean, 0.5 * np.roll(clean, 40)))
    out.append((clean, clean.copy()))
    return out


PAIRS = _pairs()


@pytest.mark.parametrize("name", ["SI_SDR", "STOI", "WB_PESQ_EST", "NB_PESQ_EST"])
def test_metrics_equal_jax(name):
    for clean, enhanced in PAIRS:
        got = metrics.compute_metric(name, clean, enhanced, sr=SR)
        want = jmetrics.compute_metric(name, clean, enhanced, sr=SR)
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_metrics_rank_distortion():
    """Each metric scores the cleaner pairs higher (a sanity check of the
    inputs above, not a calibration)."""
    for name in ("SI_SDR", "STOI", "WB_PESQ_EST", "NB_PESQ_EST"):
        scores = [metrics.compute_metric(name, c, e) for c, e in PAIRS[:3]]
        assert scores == sorted(scores), (name, scores)


@pytest.mark.parametrize("means", [
    {"STOI": 0.8, "WB_PESQ": 2.5, "WB_PESQ_EST": 3.9},
    {"STOI": 0.7, "WB_PESQ_EST": 3.1, "SI_SDR": 9.0},
    {"STOI": 0.55, "SI_SDR": 4.0},
    {"SI_SDR": 12.5},
    {"NB_PESQ_EST": 2.0},
])
def test_validation_score_equal_jax(means):
    try:
        want = jmetrics.validation_score(means)
    except ValueError:
        with pytest.raises(ValueError):
            metrics.validation_score(means)
        return
    assert metrics.validation_score(means) == want


def test_registry_equal_jax():
    assert set(metrics.REGISTERED_METRICS) == set(jmetrics.REGISTERED_METRICS)
    for name in metrics.REGISTERED_METRICS:
        assert metrics.metric_available(name) == jmetrics.metric_available(name), name
    assert not metrics.metric_available("NOPE")
    with pytest.raises(KeyError, match="Unknown metric"):
        metrics.compute_metric("NOPE", *PAIRS[0])
    for x in (-0.5, 1.0, 4.5):
        assert metrics.transform_pesq_range(x) == jmetrics.transform_pesq_range(x)


@pytest.mark.parametrize("name,package", [("WB_PESQ", "pesq"), ("SDR", "mir_eval"),
                                          ("MOSNET", "speechmetrics")])
def test_wheel_metrics_raise_without_their_package(name, package):
    if importlib.util.find_spec(package) is not None:
        pytest.skip(f"{package} is installed")
    assert not metrics.metric_available(name)
    with pytest.raises(RuntimeError, match=package):
        metrics.compute_metric(name, *PAIRS[0])
