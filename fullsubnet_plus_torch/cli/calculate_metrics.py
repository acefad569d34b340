"""Offline metric CLI (reference tools/calculate_metrics.py:61-227).

    python -m fullsubnet_plus_torch.cli.calculate_metrics \
        -R clean_dir -E enhanced_dir -M SI_SDR,STOI [-S DNS_1] [-D out_dir] \
        [--offset K] [--limit N] [--workers W] [--sr 16000]

Counterpart of fullsubnet_plus_tpu/cli/calculate_metrics.py with the same
flags: pairs reference and estimate files (DNS-1 and DNS-2 by the
"fileid_N" in their names, others in sorted order), computes each metric
(eval/metrics.py) in a thread pool on the host, prints the means and, with
-D, writes each metric's ranked per-file results as `{metric}.txt`. A
metric whose package is not installed is reported as SKIPPED.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from fullsubnet_plus_torch.data.wav import read_wav
from fullsubnet_plus_torch.eval.metrics import compute_metric, metric_available


def _list_wavs(path: str) -> list:
    if path.endswith((".scp", ".txt")):
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]
    out = []
    for root, _, files in os.walk(path):
        out += [os.path.join(root, f) for f in sorted(files) if f.endswith(".wav")]
    return sorted(out)


def _fileid(path: str) -> str:
    stem = os.path.splitext(os.path.basename(path))[0]
    return stem.split("fileid_")[-1] if "fileid_" in stem else stem


def pair_files(reference_dir: str, estimated_dir: str, specific_dataset: str | None) -> list:
    """(reference, estimate) paths (calculate_metrics.py:61-113): DNS-1 and
    DNS-2 pair "clean_fileid_N" with "..._fileid_N" and drop references
    without an estimate; otherwise both lists in sorted order, of equal
    length."""
    ref, est = _list_wavs(reference_dir), _list_wavs(estimated_dir)
    if specific_dataset in ("DNS_1", "DNS_2"):
        est_by_id = {_fileid(p): p for p in est}
        return [(r, est_by_id[_fileid(r)]) for r in ref if _fileid(r) in est_by_id]
    if len(ref) != len(est):
        raise AssertionError(f"reference ({len(ref)}) and estimated ({len(est)}) counts differ")
    return list(zip(ref, est))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Compute speech metrics")
    parser.add_argument("-R", "--reference_dir", required=True)
    parser.add_argument("-E", "--estimated_dir", required=True)
    parser.add_argument("-M", "--metrics", default="SI_SDR,STOI")
    parser.add_argument("-S", "--specific_dataset", default=None,
                        choices=[None, "DNS_1", "DNS_2"])
    parser.add_argument("-D", "--dst_dir", default=None, help="write ranked per-file txt here")
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--limit", type=int, default=None,
                        help="cap the number of file pairs scored")
    parser.add_argument("--offset", type=int, default=0, help="skip this many file pairs first")
    args = parser.parse_args(argv)

    pairs = pair_files(args.reference_dir, args.estimated_dir, args.specific_dataset)
    pairs = pairs[args.offset:]  # calculate_metrics.py:217-218's windowing
    if args.limit is not None:
        pairs = pairs[:args.limit]
    if not pairs:
        raise AssertionError("no file pairs found")
    metrics = [m.strip() for m in args.metrics.split(",") if m.strip()]
    loaded = [(read_wav(r, sr=args.sr), read_wav(e, sr=args.sr), r) for r, e in pairs]

    means = {}
    for metric in metrics:
        if not metric_available(metric):
            print(f"{metric}: SKIPPED (implementation not available in this image)")
            continue
        with ThreadPoolExecutor(max_workers=args.workers) as ex:
            vals = list(ex.map(lambda t: compute_metric(metric, t[0], t[1][:len(t[0])],
                                                        sr=args.sr), loaded))
        means[metric] = mean = float(np.mean(vals))
        print(f"{metric}: {mean:.4f}  (n={len(vals)})")
        if args.dst_dir:
            os.makedirs(args.dst_dir, exist_ok=True)
            with open(os.path.join(args.dst_dir, f"{metric}.txt"), "w") as f:
                f.write(f"mean: {mean:.6f}\n")
                for v, path in sorted(zip(vals, (t[2] for t in loaded))):
                    f.write(f"{v:.6f}\t{path}\n")
    return means


if __name__ == "__main__":
    main()
