"""Where a step of the forward sweep's cluster form goes
(`fwd::sweep_cluster_kernel<T, kSave>`, fullsubnet_plus_torch/csrc/lstm2_fwd_sweep.cuh)
at FullSubNet's full-band shape (D 257, H 512, O 257), in float32 and bf16.

    python3 scripts/profile_torch_fwd_sweep.py [float32] [bfloat16]   (from the repo's root)

Needs an NVIDIA GPU and nvcc. Copies the package into a temporary directory
once per variant and edits the copy: as it is; without the products (each
warp still waits for its owners' blocks, so the exchange stays whole);
without their weight loads (the products run on register values); without
the exchange (no block copies, no mbarrier waits, no cluster barrier
halves in the loop); without the block copies alone (the cluster barrier
kept); without the two cells; the exchange alone (the products and the
cells out: what the recurrence's synchronisation, the x loads and the
block writes cost a step, the step floor of this design); and two
schedules of the same arithmetic: each chunk's weights loaded two chunks
ahead instead of one, and the chunk loop unrolled once instead of twice.
It builds the variants' K1 libraries in parallel, prints the registers and
spills of their cluster functions, then, one variant after another, times
K1 (`lstm2_fc`, which takes the cluster form there) at T 195 with CUDA
events (median of 3) at N 8 (a batch of 8: one cluster) and N 18
(training: two clusters), and prints microseconds per step. The variants
that take work out compute wrong outputs; they only time. Imports nothing
of JAX. With no dtype it runs both.
"""

import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SWEEP = "csrc/lstm2_fwd_sweep.cuh"
T = 195
FB, FOLDS = (257, 512, 257), (8, 18)
DTYPES = ("float32", "bfloat16")

PRODUCTS = """    AFrag<T> a;
    a.load(a_of(v));
#pragma unroll
    for (int g = 0; g < 4; ++g) a.mma(acc[g], b[g]);
    if (kFc && v < fc_chunks) a.mma(facc, f);
"""
PRODUCTS_OUT = [(SWEEP, PRODUCTS, "")]  # wait(v) stays: the exchange is whole
LOADS_OUT = [
    (SWEEP, "b[g] = __ldg(B + k + g * ns);", "b[g] = make_uint4(0x3c003c00u, g, 0u, 1u);"),
    (SWEEP, "nb[g] = __ldg(B + kn + g * ns);",
     "nb[g] = make_uint4(0x3c003c00u + (uint32_t)kn, g, 0u, 1u);"),
    (SWEEP, "nf = __ldg(F + (size_t)vn * 32);", "nf = make_uint4(0x3c003c00u, (uint32_t)vn, 0u, 1u);"),
]
COPIES_OUT = [  # no block sent, none awaited, no bytes armed
    (SWEEP, "    for (int k = 1; k < C; ++k) {", "    for (int k = 1; k < 1; ++k) {"),
    (SWEEP, "              mbar_wait(bar(0, p, o), (uint32_t)(t >> 1) & 1u);", "              (void)0;"),
    (SWEEP, "              mbar_wait(bar(1, pq, o), (uint32_t)((t - 1) >> 1) & 1u);",
     "              (void)0;"),
    (SWEEP, "      if (q / S != c) mbar_wait(bar(1, pl, q / S), (uint32_t)((steps - 1) >> 1) & 1u);\n",
     ""),
    (SWEEP, "    arm(0, 0);  // h1_0\n    arm(0, 1);  // h1_1\n", ""),
    (SWEEP, "    arm(1, 0);  // h2_0 (h2_1's at the end of step 0)\n", ""),
    (SWEEP, "      arm(0, p);   // h1_{t+2}\n      arm(1, pq);  // h2_{t+1}\n", ""),
]
EXCHANGE_OUT = COPIES_OUT + [  # the pre-loop arrive and the closing wait stay paired
    (SWEEP, "    cluster_wait();       // every peer has read the blocks of step t - 2 these copies "
            "overwrite\n", ""),
    (SWEEP, "    cluster_arrive();  // this CTA has read h1_{t-1} and h2_{t-1}\n", ""),
]
CELLS_OUT = [
    (SWEEP, "    cell(0, p, c1, row0,", "    if (t < -1) cell(0, p, c1, row0,"),
    (SWEEP, "    cell(1, p, c2, row0,", "    if (t < -1) cell(1, p, c2, row0,"),
]
TWO_AHEAD = [  # chunk v + 2's weights load while chunk v's products run
    (SWEEP, "  uint4 b[4], f = make_uint4(0u, 0u, 0u, 0u);\n",
     "  uint4 b[4], b1[4], f = make_uint4(0u, 0u, 0u, 0u), f1 = f;\n"),
    (SWEEP, "    if (kFc && fc_chunks > 0) f = __ldg(F);\n  }\n",
     "    if (kFc && fc_chunks > 0) f = __ldg(F);\n"
     "    const size_t k1 = (size_t)kc_of(min(1, n - 1)) * 32;\n"
     "    for (int g = 0; g < 4; ++g) b1[g] = __ldg(B + k1 + g * ns);\n"
     "    if (kFc && 1 < fc_chunks) f1 = __ldg(F + 32);\n  }\n"),
    (SWEEP, "    const int vn = min(v + 1, n - 1);\n", "    const int vn = min(v + 2, n - 1);\n"),
    (SWEEP, "    uint4 nb[4], nf = f;\n", "    uint4 nb[4], nf = f1;\n"),
    (SWEEP, "    for (int g = 0; g < 4; ++g) b[g] = nb[g];\n    f = nf;\n",
     "    for (int g = 0; g < 4; ++g) {\n      b[g] = b1[g];\n      b1[g] = nb[g];\n    }\n"
     "    f = f1;\n    f1 = nf;\n"),
]
UNROLL_1 = [(SWEEP, "#pragma unroll 2\n  for (int v = 0; v < n; ++v) {",
             "#pragma unroll 1\n  for (int v = 0; v < n; ++v) {")]
VARIANTS = {
    "as committed": [],
    "without the products": PRODUCTS_OUT,
    "without their weight loads": LOADS_OUT,
    "without the exchange and its barriers": EXCHANGE_OUT,
    "without the block copies": COPIES_OUT,
    "without the two cells": CELLS_OUT,
    "the exchange alone": PRODUCTS_OUT + CELLS_OUT,
    "weights two chunks ahead": TWO_AHEAD,
    "chunk loop unrolled once": UNROLL_1,
}


def make_variant(root: Path, edits) -> Path:
    """A copy of the package under root with its sources edited; each edited
    text must appear exactly once in its file."""
    package = root / "fullsubnet_plus_torch"
    shutil.copytree(REPO / "fullsubnet_plus_torch", package,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name, old, new in edits:
        path = package / name
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name} no longer has exactly one {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return root


def registers_and_spills(root: Path) -> str:
    """The registers and spill stores of the cluster functions in the ptxas
    report (`-Xptxas -v`) that the variant's build kept."""
    report = next((root / "fullsubnet_plus_torch" / "_build").glob("lstm2_fwd_*.ptxas.txt"))
    out, function = [], None
    for line in report.read_text().splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1]
        elif function and "sweep_cluster_kernel" in function:
            dtype = "bf16" if "bfloat16" in function else "float32"
            if m := re.search(r"(\d+) bytes spill stores", line):
                out.append(f"{dtype} {m[1]} B spill stores")
            elif m := re.search(r"Used (\d+) registers", line):
                out.append(f"{dtype} {m[1]} registers")
    return ", ".join(out)


def time_here(dtype_name: str) -> None:
    """Run inside a variant's copy: K1's time at each fold."""
    import torch

    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2
    from fullsubnet_plus_torch.ops import lstm2

    dtype = getattr(torch, dtype_name)

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

    d, h, o = FB
    cells = []
    for n in FOLDS:
        g = torch.Generator().manual_seed(n)
        lstm, fc = LSTM2(d, h), Linear(h, o)
        lstm.reset_parameters(g)
        fc.reset_parameters(g)
        lstm, fc = lstm.to("cuda", dtype), fc.to("cuda", dtype)
        x = torch.rand(n, d, T, generator=g).mul_(2.0).to("cuda", dtype)
        w = lstm.packed(fc)
        if lstm2.fwd_sweep_cluster(n, d, h, o, dtype) != lstm2.FWD_CLUSTER:
            raise SystemExit(f"N {n} does not take the cluster form")
        k1 = ms(lambda: lstm2.lstm2_fc(x, w))
        cells.append(f"N {n}: {k1:.2f} ms, {k1 / T * 1e3:.1f} us a step")
    print(" | ".join(cells), flush=True)


def main(dtypes) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    with tempfile.TemporaryDirectory(prefix="fwd_variants_") as tmp:
        roots = {name: make_variant(Path(tmp) / str(i), edits)
                 for i, (name, edits) in enumerate(VARIANTS.items())}

        def run(root, *args):
            env = {**os.environ, "PYTHONPATH": str(root)}
            return subprocess.Popen([sys.executable, *args], cwd=root, env=env)

        builds = [run(root, "-c", "from fullsubnet_plus_torch.ops import nvcc; "
                                  "nvcc.build('lstm2_fwd')") for root in roots.values()]
        if [b.wait() for b in builds] != [0] * len(builds):
            raise SystemExit("a variant did not build")
        for name, root in roots.items():
            print(f"{name}: ptxas {registers_and_spills(root)}")
        for dtype in dtypes:
            for name, root in roots.items():
                print(f"{dtype} {name}: ", end="", flush=True)
                if run(root, str(Path(__file__).resolve()), "--time", dtype).wait() != 0:
                    raise SystemExit(f"{dtype} {name} failed")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_here(sys.argv[2])
    else:
        chosen = tuple(sys.argv[1:]) or DTYPES
        if not set(chosen) <= set(DTYPES):
            raise SystemExit(f"dtypes: {DTYPES}")
        main(chosen)
