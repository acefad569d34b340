"""Data preparation tools (reference tools/gen_lst.py, resample_dir.py,
collect_lst.py).

    python -m fullsubnet_plus_torch.cli.prepare_data gen-lst DIR OUT.txt
    python -m fullsubnet_plus_torch.cli.prepare_data resample-dir SRC DST --sr 16000 \
        [--workers W]
    python -m fullsubnet_plus_torch.cli.prepare_data collect-lst DIR OUT.txt \
        [--activity-threshold 0.6] [--min-seconds 3] [--check-clipping] [--workers W]

Counterpart of fullsubnet_plus_tpu/cli/prepare_data.py with the same
subcommands and flags, on the host: a recursive wav list, a resampled copy
of a tree (data/wav.py), and a list filtered by duration, clipping and
voice activity (dsp/audio.py).
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

from fullsubnet_plus_torch.data.wav import read_wav, write_wav
from fullsubnet_plus_torch.dsp.audio import activity_detector, is_clipped


def _walk_wavs(directory: str) -> list:
    out = []
    for root, _, files in os.walk(os.path.abspath(os.path.expanduser(directory))):
        out += [os.path.join(root, f) for f in sorted(files) if f.lower().endswith(".wav")]
    return sorted(out)


def _write_list(path: str, files: list) -> None:
    with open(path, "w") as f:
        f.write("\n".join(files) + ("\n" if files else ""))


def gen_lst(args) -> None:
    """Recursive wav glob -> txt list (tools/gen_lst.py:5-11)."""
    files = _walk_wavs(args.directory)
    _write_list(args.output, files)
    print(f"wrote {len(files)} paths to {args.output}")


def resample_dir(args) -> None:
    """Parallel resample of a tree to --sr, its layout kept
    (tools/resample_dir.py:7-25, without sox)."""
    files = _walk_wavs(args.src)
    src_root = os.path.abspath(os.path.expanduser(args.src))
    dst_root = os.path.abspath(os.path.expanduser(args.dst))

    def work(path):
        out = os.path.join(dst_root, os.path.relpath(path, src_root))
        write_wav(out, read_wav(path, sr=args.sr), args.sr)

    with ThreadPoolExecutor(max_workers=args.workers) as ex:
        list(ex.map(work, files))
    print(f"resampled {len(files)} files to {args.sr} Hz under {dst_root}")


def collect_lst(args) -> None:
    """The wavs that pass the duration, clipping and voice-activity gates
    (tools/collect_lst.py)."""
    files = _walk_wavs(args.directory)

    def keep(path):
        y = read_wav(path, sr=args.sr)
        if len(y) < args.min_seconds * args.sr:
            return False
        if args.check_clipping and is_clipped(y):
            return False
        return not (args.activity_threshold > 0
                    and activity_detector(y, fs=args.sr) < args.activity_threshold)

    with ThreadPoolExecutor(max_workers=args.workers) as ex:
        kept = [path for path, ok in zip(files, ex.map(keep, files)) if ok]
    _write_list(args.output, kept)
    print(f"kept {len(kept)}/{len(files)} files -> {args.output}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Data preparation")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("gen-lst")
    p.add_argument("directory")
    p.add_argument("output")
    p.set_defaults(fn=gen_lst)

    p = sub.add_parser("resample-dir")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--workers", type=int, default=8)
    p.set_defaults(fn=resample_dir)

    p = sub.add_parser("collect-lst")
    p.add_argument("directory")
    p.add_argument("output")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--activity-threshold", type=float, default=0.6)
    p.add_argument("--min-seconds", type=float, default=3.0)
    p.add_argument("--check-clipping", action="store_true")
    p.add_argument("--workers", type=int, default=8)
    p.set_defaults(fn=collect_lst)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
