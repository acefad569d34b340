"""Where a step of the forward sweep goes
(fullsubnet_plus_torch/csrc/lstm2_fwd_sweep.cuh): the cluster form
(`fwd::sweep_cluster_kernel<T, kSave>`) at FullSubNet's full-band shape
(D 257, H 512, O 257) in float32 and bf16, or with `--sb` the bf16 forms of
the sub-band shape (D 34, H 384, O 2): the tile form (`sweep_mma_kernel`)
at R 16 and R 32 and the pair form (`sweep_pair_kernel`, a cluster of two
CTAs a 32-row tile).

    python3 scripts/profile_torch_fwd_sweep.py [float32] [bfloat16]   (from the repo's root)
    python3 scripts/profile_torch_fwd_sweep.py --sb [tile16] [tile32] [pair]

Needs an NVIDIA GPU and nvcc. Copies the package into a temporary directory
once per variant and edits the copy. The cluster form's variants: as it
is; without the products (each warp still waits for its owners' blocks, so
the exchange stays whole); without their weight loads (the products run on
register values); without the exchange (no block copies, no mbarrier waits,
no cluster barrier halves in the loop); without the block copies alone
(the cluster barrier kept); without the two cells; the exchange alone (the
products and the cells out: what the recurrence's synchronisation, the x
loads and the block writes cost a step, the step floor of this design); and
two schedules of the same arithmetic: each chunk's weights loaded two
chunks ahead instead of one, and the chunk loop unrolled once instead of
twice. It builds the variants' K1 libraries in parallel, prints the
registers and spills of their cluster functions, then, one variant after
another, times K1 (`lstm2_fc`, which takes the cluster form there) at T 195
with CUDA events (median of 3) at N 8 (a batch of 8: one cluster) and N 18
(training: two clusters), and prints microseconds per step.

With `--sb` the variants edit the code the tile and pair forms share
(`mma_pass`, `cell_mma`): as it is; without the products (the A fragments
and the mma.sync out; each weight fragment still loaded and used, its
bits' sign added to a gate sum as a zero); without their weight loads (the
products run on register values); without the cells (no activation and no
c: each h word the sum of its four gate sums, stored where the cell
stores it, the pair form's copy into the peer too; no residual); K2
without its residual stores. It builds the variants' K1 and
K2 libraries in parallel, prints the bf16 tile and pair functions'
registers and spills, then times K1 (`lstm2_fc`) and K2
(`lstm2_train_fwd`) at T 195 in each chosen form at 12 CTAs (N 192 at R 16
and in the pair form, 6 clusters; N 384 at R 32), one full wave of the
card's SMs (N 16 rows an SM at R 16 and in the pair form, 32 at R 32) and
N 2304 (the training fold: R 16 in two waves, R 32 in one of 72 CTAs, the
pair form in waves, items of FWD_WAVE_STEPS steps) and prints
microseconds per step.

The variants that take work out compute wrong outputs; they only time.
Imports nothing of JAX. With no dtype (no form) it runs all.
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

# The sub-band forms' variants (`--sb`): edits of `mma_pass` and `cell_mma`,
# which the tile and pair forms share; an edit marked every=True replaces
# each of its occurrences (the kernels' first weight loads)
SB_PRODUCTS_OUT = [(SWEEP, """      AFrag<T> a;
      a.load(a_addr + mt * m_stride + kc * CHUNK_BYTES);
#pragma unroll
      for (int i = 0; i < 4; ++i) a.mma(acc[mt][i], b[i]);
""", """#pragma unroll
      for (int i = 0; i < 4; ++i)  // keeps each weight load: adds a zero of its bits' sign
        acc[mt][i][0] += __uint_as_float((b[i].x ^ b[i].y ^ b[i].z ^ b[i].w) & 0x80000000u);
""")]
SB_LOADS_OUT = [
    (SWEEP, "nb[i] = __ldg(nxt + i * nst);", "nb[i] = make_uint4(0x3c003c00u + (uint32_t)kc, i, 0u, 1u);"),
    (SWEEP, "b[i] = __ldg(w1w + i * ns1);", "b[i] = make_uint4(0x3c003c00u, i, 0u, 1u);", True),
]
SB_RESIDUALS_OUT = [(SWEEP, "      if (kSave && row < rows_here) {", "      if (kSave && row < -1) {")]
SB_CELLS_OUT = [(SWEEP, """        act[0][p] = sigm(acc[mt][0][e]);
        act[1][p] = sigm(acc[mt][1][e]);
        act[2][p] = tanhf(acc[mt][2][e]);
        act[3][p] = sigm(acc[mt][3][e]);
        float& cw = cs[(4 * mt + e) * 32 + lane];
        c[p] = act[1][p] * cw + act[0][p] * act[2][p];
        cw = c[p];
        h[p] = act[3][p] * tanhf(c[p]);
""", """        h[p] = acc[mt][0][e] + acc[mt][1][e] + acc[mt][2][e] + acc[mt][3][e];
        c[p] = act[0][p] = act[1][p] = act[2][p] = act[3][p] = h[p];
""")] + SB_RESIDUALS_OUT
SB_VARIANTS = {
    "as committed": [],
    "without the products": SB_PRODUCTS_OUT,
    "without their weight loads": SB_LOADS_OUT,
    "without the cells": SB_CELLS_OUT,
    "K2 without its residual stores": SB_RESIDUALS_OUT,
}
SB, SB_FORMS = (34, 384, 2), ("tile16", "tile32", "pair")


def make_variant(root: Path, edits) -> Path:
    """A copy of the package under root with its sources edited; each edited
    text must appear exactly once in its file (an edit (name, old, new,
    True): at least once, each occurrence replaced)."""
    package = root / "fullsubnet_plus_torch"
    shutil.copytree(REPO / "fullsubnet_plus_torch", package,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name, old, new, *every in edits:
        path = package / name
        text = path.read_text()
        if text.count(old) != 1 and not (every and text.count(old) >= 1):
            raise SystemExit(f"{name} no longer has exactly one {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return root


def registers_and_spills(root: Path, stem: str = "lstm2_fwd",
                         kernels=("sweep_cluster_kernel",), bf16_only: bool = False) -> str:
    """The registers and spill stores of the `kernels` functions in the
    ptxas report (`-Xptxas -v`) that the variant's build of `stem` kept."""
    report = next((root / "fullsubnet_plus_torch" / "_build").glob(f"{stem}_*.ptxas.txt"))
    out, function = [], None
    for line in report.read_text().splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1]
        elif function and any(k in function for k in kernels):
            dtype = "bf16" if "bfloat16" in function else "float32"
            if bf16_only and dtype != "bf16":
                continue
            kind = next(k for k in kernels if k in function)
            name = f"{dtype} {kind}" if len(kernels) > 1 else dtype
            if kind != "sweep_cluster_kernel":  # <T, MT, kSave, threads> or <T, kSave, threads>
                args = re.findall(r"L[ib](\d+)E", function)
                mt = int(args[0]) if kind == "sweep_mma_kernel" else 2
                name += f" R{16 * mt} {args[-1]} threads"
            if m := re.search(r"(\d+) bytes spill stores", line):
                out.append(f"{name} {m[1]} B spill stores")
            elif m := re.search(r"Used (\d+) registers", line):
                out.append(f"{name} {m[1]} registers")
    return ", ".join(out)


def time_here(dtype_name: str) -> None:
    """Run inside a variant's copy: K1's time at each fold."""
    import torch

    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2
    from fullsubnet_plus_torch.ops import lstm2

    dtype = getattr(torch, dtype_name)

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


def sb_folds(form: str, sms: int):
    """(label, N) of the three folds a sub-band form is timed at: 12 CTAs,
    one full wave of the card's SMs, the training fold."""
    rows = {"tile16": 16, "tile32": 32, "pair": 16}[form]  # rows an SM
    return (("12 CTAs", 12 * rows), ("a full wave", sms * rows), ("N 2304", 2304))


def time_sb_here(forms) -> None:
    """Run inside a variant's copy: K1's and K2's time in each bf16 form at
    each of its folds, T 195."""
    import torch

    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2
    from fullsubnet_plus_torch.ops import lstm2
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    dtype, (d, h, o) = torch.bfloat16, SB
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator().manual_seed(7)
    lstm, fc = LSTM2(d, h), Linear(h, o)
    lstm.reset_parameters(g)
    fc.reset_parameters(g)
    w = lstm.to("cuda", dtype).packed(fc.to("cuda", dtype))
    rule = lstm2.fwd_mma_rows_per_cta
    for form in forms:
        cells = []
        for label, n in sb_folds(form, sms):
            if form == "pair":
                tiles = -(-n // lstm2.FWD_PAIR_ROWS)
                lstm2.FWD_SWEEP_FORM = (lstm2.FWD_PAIR if tiles <= sms // lstm2.FWD_PAIR_CTAS
                                        else lstm2.FWD_PAIR_WAVE)
            else:
                rows = int(form[4:])
                lstm2.FWD_SWEEP_FORM = 0
                lstm2.fwd_mma_rows_per_cta = lambda *_, rows=rows: rows
            x = torch.rand(n, d, T, generator=g).mul_(2.0).to("cuda", dtype)
            k1 = ms(lambda: lstm2.lstm2_fc(x, w))
            k2 = ms(lambda: lt.lstm2_train_fwd(x, w))
            name = lstm2.fwd_form_name(lstm2.FWD_SWEEP_FORM)
            cells.append(f"{label} (N {n}, {name}): K1 {k1 / T * 1e3:.1f} us, "
                         f"K2 {k2 / T * 1e3:.1f} us a step")
            lstm2.FWD_SWEEP_FORM, lstm2.fwd_mma_rows_per_cta = None, rule
            del x
        print(f"  {form}: " + " | ".join(cells), flush=True)


def ms(fn, reps=3):
    """Median of `reps` timed calls of fn after one warm-up (CUDA events)."""
    import torch

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


def main_sb(forms) -> None:
    """The bf16 sub-band forms' variants: built in parallel, then timed one
    after another."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    with tempfile.TemporaryDirectory(prefix="fwd_sb_variants_") as tmp:
        roots = {name: make_variant(Path(tmp) / str(i), edits)
                 for i, (name, edits) in enumerate(SB_VARIANTS.items())}
        env = {name: {**os.environ, "PYTHONPATH": str(root)} for name, root in roots.items()}
        builds = [subprocess.Popen([sys.executable, "-c",
                                    f"from fullsubnet_plus_torch.ops import nvcc; "
                                    f"nvcc.build({stem!r})"], cwd=root, env=env[name])
                  for name, root in roots.items() for stem in ("lstm2_fwd", "lstm2_train_fwd")]
        if [b.wait() for b in builds] != [0] * len(builds):
            raise SystemExit("a variant did not build")
        for name, root in roots.items():
            for stem in ("lstm2_fwd", "lstm2_train_fwd"):
                print(f"{name}: {stem} ptxas " + registers_and_spills(
                    root, stem, ("sweep_mma_kernel", "sweep_pair_kernel"), bf16_only=True))
        for name, root in roots.items():
            print(f"bf16 {name}:", flush=True)
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--time-sb",
                                   *forms], cwd=root, env=env[name])
            if proc.returncode != 0:
                raise SystemExit(f"{name} failed")


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
    elif sys.argv[1:2] == ["--time-sb"]:
        time_sb_here(sys.argv[2:])
    elif sys.argv[1:2] == ["--sb"]:
        chosen = tuple(sys.argv[2:]) or SB_FORMS
        if not set(chosen) <= set(SB_FORMS):
            raise SystemExit(f"forms: {SB_FORMS}")
        main_sb(chosen)
    else:
        chosen = tuple(sys.argv[1:]) or DTYPES
        if not set(chosen) <= set(DTYPES):
            raise SystemExit(f"dtypes: {DTYPES}")
        main(chosen)
