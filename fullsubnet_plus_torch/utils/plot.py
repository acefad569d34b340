"""Metric analysis and plotting (reference utils/plot.py / tools/analyse.py).

Counterpart of fullsubnet_plus_tpu/utils/plot.py:14-60: compares two runs'
per-file metric outputs (the ranked txt files cli/calculate_metrics.py
writes) and draws histograms of the deltas. matplotlib is imported only by
`draw_hist`, which raises ImportError where it is not installed; nothing
else needs it.
"""

from __future__ import annotations

import os

import numpy as np


def load_metric_file(path: str) -> dict:
    """Parse a `{metric}.txt` written by cli/calculate_metrics.py: first
    line `mean: X`, then `value\\tpath` lines. Returns {basename: value}."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("mean:"):
                continue
            value, fpath = line.split("\t")
            out[os.path.basename(fpath)] = float(value)
    return out


def compare_two_runs(path_a: str, path_b: str) -> dict:
    """Per-file deltas between runs (utils/plot.py compare_two_data)."""
    a, b = load_metric_file(path_a), load_metric_file(path_b)
    deltas = {k: b[k] - a[k] for k in sorted(set(a) & set(b))}
    values = np.asarray(list(deltas.values())) if deltas else np.zeros(0)
    return {
        "per_file": deltas,
        "mean_delta": float(values.mean()) if len(values) else 0.0,
        "improved": int((values > 0).sum()),
        "regressed": int((values < 0).sum()),
    }


def draw_hist(values, title: str = "", out_path: str | None = None, bins: int = 50):
    """Histogram of metric values or deltas (utils/plot.py draw_hist):
    writes a PNG to out_path and returns it, or returns the figure."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("draw_hist needs matplotlib, which is not installed; "
                          "compare_two_runs and load_metric_file do not") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    ax.hist(np.asarray(list(values)), bins=bins)
    ax.set_title(title)
    ax.set_xlabel("value")
    ax.set_ylabel("count")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return out_path
    return fig
