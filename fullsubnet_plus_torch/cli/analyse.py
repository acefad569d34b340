"""Metric analysis CLI (reference tools/analyse.py + utils/plot.py).

    python -m fullsubnet_plus_torch.cli.analyse compare A/SI_SDR.txt B/SI_SDR.txt \
        [--hist out.png] [--top N]
    python -m fullsubnet_plus_torch.cli.analyse hist A/SI_SDR.txt --out hist.png

Counterpart of fullsubnet_plus_tpu/cli/analyse.py with the same
subcommands, flags and printout. The histograms need matplotlib
(utils/plot.py `draw_hist`); the comparison does not.
"""

from __future__ import annotations

import argparse

from fullsubnet_plus_torch.utils.plot import compare_two_runs, draw_hist, load_metric_file


def main(argv=None):
    parser = argparse.ArgumentParser(description="Per-file metric analysis")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("compare", help="diff two runs' per-file metrics")
    p.add_argument("run_a")
    p.add_argument("run_b")
    p.add_argument("--hist", default=None, help="write delta histogram PNG")
    p.add_argument("--top", type=int, default=10)

    h = sub.add_parser("hist", help="histogram one run's metric values")
    h.add_argument("run")
    h.add_argument("--out", required=True)

    args = parser.parse_args(argv)
    if args.cmd == "compare":
        result = compare_two_runs(args.run_a, args.run_b)
        print(f"mean delta: {result['mean_delta']:+.4f}  "
              f"improved: {result['improved']}  regressed: {result['regressed']}")
        ranked = sorted(result["per_file"].items(), key=lambda kv: kv[1])
        print("worst regressions:")
        for name, delta in ranked[:args.top]:
            print(f"  {delta:+.4f}  {name}")
        print("best improvements:")
        for name, delta in ranked[-args.top:][::-1]:
            print(f"  {delta:+.4f}  {name}")
        if args.hist:
            draw_hist(result["per_file"].values(), "metric deltas (B - A)", args.hist)
            print(f"wrote {args.hist}")
    else:
        draw_hist(load_metric_file(args.run).values(), args.run, args.out)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
