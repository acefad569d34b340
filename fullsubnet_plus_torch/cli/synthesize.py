"""Offline noisy-speech synthesizer (reference tools/noisyspeech_synthesizer.py).

    python -m fullsubnet_plus_torch.cli.synthesize \
        --clean-list clean.txt --noise-list noise.txt [--rir-list rir.txt] \
        --output-dir out/ --num-files 100 [--snr-range -5 20] [--seconds 10] \
        [--reverb-proportion 0] [--sr 16000] [--seed 0]

Counterpart of fullsubnet_plus_tpu/cli/synthesize.py with the same flags:
pre-mixes a fixed noisy / clean corpus to disk with the training loader's
mixing (data/mixing.py `synthesize_pair`), pair i drawn from the seed
sequence (seed, i), as `noisy/noisy_fileid_{i}.wav` and
`clean/clean_fileid_{i}.wav` (the DNS layout calculate_metrics pairs).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from fullsubnet_plus_torch.data.mixing import parse_snr_range, synthesize_pair
from fullsubnet_plus_torch.data.wav import write_wav


def _read_list(path: str) -> list:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Offline DNS-style mixer")
    parser.add_argument("--clean-list", required=True)
    parser.add_argument("--noise-list", required=True)
    parser.add_argument("--rir-list", default=None)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--num-files", type=int, default=100)
    parser.add_argument("--snr-range", type=float, nargs=2, default=(-5, 20))
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--reverb-proportion", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    clean_list, noise_list = _read_list(args.clean_list), _read_list(args.noise_list)
    rir_list = _read_list(args.rir_list) if args.rir_list else []
    snr_list = parse_snr_range(tuple(args.snr_range))
    noisy_dir = os.path.join(args.output_dir, "noisy")
    clean_dir = os.path.join(args.output_dir, "clean")
    os.makedirs(noisy_dir, exist_ok=True)
    os.makedirs(clean_dir, exist_ok=True)

    for idx in range(args.num_files):
        rng = np.random.default_rng(np.random.SeedSequence([args.seed, idx]))
        noisy, clean = synthesize_pair(clean_list[idx % len(clean_list)], noise_list, rir_list,
                                       rng, sr=args.sr, sub_sample_length=args.seconds,
                                       snr_list=snr_list,
                                       reverb_proportion=args.reverb_proportion)
        write_wav(os.path.join(noisy_dir, f"noisy_fileid_{idx}.wav"), noisy, args.sr)
        write_wav(os.path.join(clean_dir, f"clean_fileid_{idx}.wav"), clean, args.sr)
    print(f"wrote {args.num_files} pairs under {args.output_dir}")


if __name__ == "__main__":
    main()
