"""Where a step of the port's bf16 reverse sweep goes
(`sweep_mma_kernel`, fullsubnet_plus_torch/csrc/lstm2_bwd_sweep.cuh).

    python3 scripts/profile_torch_bwd_sweep.py        (from the repo's root)

Needs an NVIDIA GPU and nvcc. Copies the package into a temporary directory
once per variant: as it is, without the three products, without the
weight loads (the products run on register values) and without the two
cell backwards. It builds the variants' K4 libraries in parallel, then, one
variant after another, times K4 (`lstm2_bwd_sweep`) in bf16 at T 195 with
CUDA events (median of 3) at N 192 (12 CTAs of 16 rows), 2112 (one full
wave on 132 SMs) and 2304 (the training fold: two waves), and prints
microseconds per step. The variants compute wrong gradients; they only
time. Imports nothing of JAX.
"""

import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
HEADER = "csrc/lstm2_bwd_sweep.cuh"
D, H, O, T = 34, 384, 2, 195
FOLDS = (192, 2112, 2304)
# variant: (text in the header, its replacement) for each place it changes
VARIANTS = {
    "as committed": [],
    "without the three products": [
        ("mma_tiles<4>(acc, a_addr, a.w2p", "if (0) mma_tiles<4>(acc, a_addr, a.w2p"),
        ("mma_tiles<4>(acc, a_addr, a.u1p", "if (0) mma_tiles<4>(acc, a_addr, a.u1p"),
        ("mma_tiles<1>(acc, a_addr, a.w1p", "if (0) mma_tiles<1>(acc, a_addr, a.w1p"),
    ],
    "without the weight loads": [
        ("b[i] = __ldg(B + ((size_t)i * kpairs + kp) * 32);",
         "b[i] = make_uint4(kp * 0x10001u, i * 0x10001u + 0x3c003c00u, kp, i);"),
    ],
    "without the two cell backwards": [
        ("cell_bwd<T, R>(dh, dc2, db[1], a.g2 + row0 * G, a.c2 + row0 * H,\n"
         "                   t > 0 ? a.c2 + prev0 * H : nullptr, a.dg2 + dg0, dgs, rows_here, H, j, ld);",
         "if (t < -1) cell_bwd<T, R>(dh, dc2, db[1], a.g2 + row0 * G, a.c2 + row0 * H,\n"
         "                   t > 0 ? a.c2 + prev0 * H : nullptr, a.dg2 + dg0, dgs, rows_here, H, j, ld);"),
        ("cell_bwd<T, R>(dh, dc1, db[0], a.g1 + row0 * G, a.c1 + row0 * H,\n"
         "                   t > 0 ? a.c1 + prev0 * H : nullptr, a.dg1 + dg0, dgs, rows_here, H, j, ld);",
         "if (t < -1) cell_bwd<T, R>(dh, dc1, db[0], a.g1 + row0 * G, a.c1 + row0 * H,\n"
         "                   t > 0 ? a.c1 + prev0 * H : nullptr, a.dg1 + dg0, dgs, rows_here, H, j, ld);"),
    ],
}


def make_variant(root: Path, edits) -> Path:
    """A copy of the package under root with the header edited; each
    edited text must appear exactly once in the header's bf16 part."""
    package = root / "fullsubnet_plus_torch"
    shutil.copytree(REPO / "fullsubnet_plus_torch", package,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    header = package / HEADER
    text = header.read_text()
    bf16 = text.index("// bf16: the three products on the tensor cores")
    for old, new in edits:
        if text.count(old, bf16) != 1:
            raise SystemExit(f"the header no longer has exactly one {old[:60]!r}")
        text = text[:bf16] + text[bf16:].replace(old, new)
    header.write_text(text)
    return root


def time_here() -> None:
    """Run inside a variant's copy: K4's bf16 sweep time at each fold."""
    import torch

    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    def ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    cells = []
    for n in FOLDS:
        g = torch.Generator().manual_seed(n)
        lstm, fc = LSTM2(D, H), Linear(H, O)
        lstm.reset_parameters(g)
        fc.reset_parameters(g)
        lstm, fc = lstm.to("cuda", torch.bfloat16), fc.to("cuda", torch.bfloat16)
        x = torch.rand(n, D, T, generator=g).mul_(2.0).to("cuda", torch.bfloat16)
        dy = torch.randn(n, T, O, generator=g).to("cuda", torch.bfloat16)
        w = lstm.packed(fc)
        _, res = lt.lstm2_train_fwd(x, w)
        k4 = ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res))
        cells.append(f"N {n}: {k4:.2f} ms, {k4 / T * 1e3:.1f} us a step")
        del x, dy, w, res
        torch.cuda.empty_cache()
    print(" | ".join(cells), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    with tempfile.TemporaryDirectory(prefix="sweep_variants_") as tmp:
        roots = {name: make_variant(Path(tmp) / str(i), edits)
                 for i, (name, edits) in enumerate(VARIANTS.items())}

        def run(root, *args):
            env = {**os.environ, "PYTHONPATH": str(root)}
            return subprocess.Popen([sys.executable, *args], cwd=root, env=env)

        builds = [run(root, "-c", "from fullsubnet_plus_torch.ops import nvcc; "
                                  "nvcc.build('lstm2_bwd')") for root in roots.values()]
        if [b.wait() for b in builds] != [0] * len(builds):
            raise SystemExit("a variant did not build")
        for name, root in roots.items():
            print(f"{name}: ", end="", flush=True)
            if run(root, str(Path(__file__).resolve()), "--time").wait() != 0:
                raise SystemExit(f"{name} failed")


if __name__ == "__main__":
    if sys.argv[1:] == ["--time"]:
        time_here()
    else:
        main()
