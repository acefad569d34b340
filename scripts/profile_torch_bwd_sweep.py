"""Where a step of the port's reverse sweep goes (its wave form: the
launches of `sweep_mma_kernel` a CTA an SM, each CTA an item of a row tile
and WAVE_STEPS steps; with `--tile` its tile form, `sweep_mma_kernel` a CTA
a row tile for all the steps; with `--fb` its cluster form
`sweep_cluster_kernel<T>`; fullsubnet_plus_torch/csrc/lstm2_bwd_sweep.cuh),
in float32 and bf16.

    python3 scripts/profile_torch_bwd_sweep.py [float32] [bfloat16]   (from the repo's root)
    python3 scripts/profile_torch_bwd_sweep.py --tile [float32] [bfloat16]
    python3 scripts/profile_torch_bwd_sweep.py --fb [float32] [bfloat16]

Needs an NVIDIA GPU and nvcc. Copies the package into a temporary directory
once per variant and edits the copy. The wave form's variants (the form
forced in each): as it is, the tile form as it is (the same tree,
SWEEP_FORM 0), without the three products, without the weight loads (the
products run on register values), without the two cell backwards, and in
float32 without the TF32 splits (both halves the raw word), and in bf16
as it is with items of 8 steps (WAVE_STEPS 8).
With `--tile`, the tile form's variants (forced likewise): as it is, without the three products,
without the weight loads (the products run on register values), without
the two cell backwards, and in float32 also without the TF32 splits (both
halves are the raw word: the three products stay), with one TF32 product
instead of three (the small halves then go unused) and with the k-chunk
loop unrolled 1 or 4 times instead of 2; and, in both, with each k-chunk's
weight words loaded while the previous chunk's products run. It builds the
variants' K4 libraries in parallel, prints the registers and spills of
their 384-thread sweep functions, then, one variant after another, times
K4 (`lstm2_bwd_sweep`) at T 195 with CUDA events (median of 3) at N 192
(12 CTAs of 16 rows: what the second wave at N 2304 costs, where each
CTA's chain of steps sets the pace), 2112 (one full wave on 132 SMs) and
2304 (the training fold: two waves), and prints microseconds per step. The residuals come from the plain forward. The
variants that take work out compute wrong gradients; they only time.
With `--fb`, at FullSubNet's full-band shape (D 257, H 512, O 257) at N
18, where the sweep takes its cluster form (`sweep_cluster_kernel`: two
clusters of 16 CTAs, each CTA 32 hidden units), the variants of that
kernel's step: as it is, without its three products (each warp still
waiting for the peers' blocks), without their weight
loads, without the exchange of the dgates (the copies of a CTA's block
to its peers with their mbarrier waits, and the two cluster barrier
halves a step), without the copies alone (the cluster barrier kept),
without the two cell backwards, without
dy W_fc^T, and with the exchange alone left (the products, the cells and
dy W_fc^T out: what the recurrence's synchronisation costs a step), with
the cluster functions' registers and spills.
Imports nothing of JAX.
With no dtype it runs both.
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
SWEEP = "csrc/lstm2_bwd_sweep.cuh"
COMMON = "csrc/lstm2_common.cuh"
T = 195
# (D, H, O), the folds timed, the sweep functions whose registers are shown:
# the shipped sub-band shape (the tile form's 384-thread functions), and
# with --fb FullSubNet's full-band one at the fold of configs/train.toml's
# batch (N 18: the cluster form's functions)
SHAPES = {"shipped": ((34, 384, 2), (192, 2112, 2304), ("sweep_mma_kernel", "Li384E")),
          "fb": ((257, 512, 257), (18,), ("sweep_cluster_kernel",))}
DTYPES = ("float32", "bfloat16")
CELLS_OUT = [
    (SWEEP, "    cell_bwd<T, R>(dh, dc2, db[1]", "    if (t < -1) cell_bwd<T, R>(dh, dc2, db[1]"),
    (SWEEP, "    cell_bwd<T, R>(dh, dc1, db[0]", "    if (t < -1) cell_bwd<T, R>(dh, dc1, db[0]"),
]
# variant: (the dtypes it is timed in, [(file, text, its replacement), ...])
TILE_VARIANTS = {
    "as committed": (DTYPES, []),
    "without the three products": (DTYPES, [
        (SWEEP, "mma_tiles<T, 4>(acc, a_addr, a.w2p", "if (0) mma_tiles<T, 4>(acc, a_addr, a.w2p"),
        (SWEEP, "mma_tiles<T, 4>(acc, a_addr, a.u1p", "if (0) mma_tiles<T, 4>(acc, a_addr, a.u1p"),
        (SWEEP, "mma_tiles<T, 1>(acc, a_addr, a.w1p", "if (0) mma_tiles<T, 1>(acc, a_addr, a.w1p"),
    ]),
    "without the weight loads": (DTYPES, [
        (SWEEP, "b[i] = __ldg(B + ((size_t)i * stride * chunks + kc) * 32);",
         "b[i] = make_uint4(kc * 0x10001u, i * 0x10001u + 0x3c003c00u, kc, i);"),
    ]),
    "without the TF32 splits": (("float32",), [
        (COMMON, "big = (a + 0x1000u) & 0xffffe000u;", "big = a;"),
        (COMMON, "small = __float_as_uint(__uint_as_float(a) - __uint_as_float(big)) + 0x1000u;",
         "small = a;"),
    ]),
    "one TF32 product instead of three": (("float32",), [
        (COMMON, "mma_3xtf32(p, big[0], small[0], bb[0], bb[1], bs[0], bs[1]);",
         "mma_tf32(p, big[0], bb[0], bb[1]);"),
        (COMMON, "mma_3xtf32(p, big[1], small[1], bb[2], bb[3], bs[2], bs[3]);",
         "mma_tf32(p, big[1], bb[2], bb[3]);"),
    ]),
    "the k-chunk loop not unrolled": (("float32",), [
        (SWEEP, "#pragma unroll 2\n  for (int kc = kc0;", "#pragma unroll 1\n  for (int kc = kc0;"),
    ]),
    "the k-chunk loop unrolled 4 times": (("float32",), [
        (SWEEP, "#pragma unroll 2\n  for (int kc = kc0;", "#pragma unroll 4\n  for (int kc = kc0;"),
    ]),
    "the weights loaded a k-chunk ahead": (DTYPES, [
        (SWEEP, """#pragma unroll 2
  for (int kc = kc0; kc < kc1; ++kc) {
    uint4 b[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) b[i] = __ldg(B + ((size_t)i * stride * chunks + kc) * 32);
    AFrag<T> a;
    a.load(a_addr + kc * CHUNK_BYTES);
#pragma unroll
    for (int i = 0; i < NT; ++i) a.mma(acc[i], b[i]);
  }""", """uint4 b[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) b[i] = __ldg(B + ((size_t)i * stride * chunks + kc0) * 32);
#pragma unroll 2
  for (int kc = kc0; kc < kc1; ++kc) {
    const int next = kc + 1 < kc1 ? kc + 1 : kc;
    uint4 nb[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) nb[i] = __ldg(B + ((size_t)i * stride * chunks + next) * 32);
    AFrag<T> a;
    a.load(a_addr + kc * CHUNK_BYTES);
#pragma unroll
    for (int i = 0; i < NT; ++i) a.mma(acc[i], b[i]);
#pragma unroll
    for (int i = 0; i < NT; ++i) b[i] = nb[i];
  }"""),
    ]),
    "without the two cell backwards": (DTYPES, CELLS_OUT),
}
BF16 = ("bfloat16",)
# the wave form's variants; "the tile form" times the tile form on the same tree
VARIANTS = {
    "as committed": (DTYPES, []),
    "the tile form": (DTYPES, []),
    "without the three products": TILE_VARIANTS["without the three products"],
    "without the weight loads": TILE_VARIANTS["without the weight loads"],
    "without the two cell backwards": (DTYPES, CELLS_OUT),
    "without the TF32 splits": (("float32",), TILE_VARIANTS["without the TF32 splits"][1]),
    "items of 8 steps": (BF16, [("ops/lstm2_train.py", "\nWAVE_STEPS = 4\n",
                                 "\nWAVE_STEPS = 8\n")]),
}
# FullSubNet's full-band LSTM (--fb): the cluster form's step
WAIT_BLOCKS = "for (int o = 0; o < C; ++o) if (o != c) mbar_wait(bars + 8 * o, ex.parity);\n"
FB_PRODUCTS_OUT = [  # each warp still waits for every peer's block, which keeps the copies whole
    (SWEEP, "      owned_mma<T, NT, U>(acc, a_base, a.w2p",
     "      " + WAIT_BLOCKS + "      if (0) owned_mma<T, NT, U>(acc, a_base, a.w2p"),
    (SWEEP, "      owned_mma<T, NT, U>(acc, a_base, a.u1p",
     "      " + WAIT_BLOCKS + "      if (0) owned_mma<T, NT, U>(acc, a_base, a.u1p"),
    (SWEEP, "dx_parts<T, NT, U>(ndx, a_base", "if (0) dx_parts<T, NT, U>(ndx, a_base"),
]
FB_COPIES_OUT = [  # no block sent, none awaited, no bytes armed
    (SWEEP, "    for (int p = 1; p < C; ++p) {", "    for (int p = 1; p < 1; ++p) {"),
    (SWEEP, "      mbar_wait(ex.bars + 8 * o, ex.parity);\n", ""),
    (SWEEP, "    ex.arm();          // layer 1's exchange\n", ""),
    (SWEEP, "    ex.arm();          // the next step's layer 2 exchange\n", ""),
]
FB_EXCHANGE_OUT = FB_COPIES_OUT + [  # the pre-loop arrive and the closing wait stay paired
    (SWEEP, "    cluster_wait();  // every peer has read the dgates these copies overwrite\n", ""),
    (SWEEP, "    cluster_arrive();  // this CTA has read dgates2\n", ""),
    (SWEEP, "    cluster_arrive();  // this CTA has read dgates1\n", ""),
]
FB_CELLS_OUT = [
    (SWEEP, "    cell_bwd_one<T>(dyw[r * U + lane] + dh2c, dc2,",
     "    if (t < -1) cell_bwd_one<T>(dyw[r * U + lane] + dh2c, dc2,"),
    (SWEEP, "    cell_bwd_one<T>(dh1, dc1,", "    if (t < -1) cell_bwd_one<T>(dh1, dc1,"),
]
FB_DYW_OUT = [
    (SWEEP, "for (int o4 = 0; o4 < fc_ld / 4; ++o4) {", "for (int o4 = 0; o4 < 0; ++o4) {"),
]
FB_VARIANTS = {
    "as committed": (DTYPES, []),
    "without the three products": (DTYPES, FB_PRODUCTS_OUT),
    "without the weight loads": (DTYPES, [
        (SWEEP, "b[i] = __ldg(&B[((size_t)i * stride * chunks + kc) * 32]);",
         "b[i] = make_uint4(kc * 0x10001u, i * 0x10001u + 0x3c003c00u, kc, i);"),
    ]),
    "without the exchange and its barriers": (DTYPES, FB_EXCHANGE_OUT),
    "without the block copies": (DTYPES, FB_COPIES_OUT),
    "without the two cell backwards": (DTYPES, FB_CELLS_OUT),
    "without dy W_fc^T": (DTYPES, FB_DYW_OUT),
    "the exchange alone": (DTYPES, FB_PRODUCTS_OUT + FB_CELLS_OUT + FB_DYW_OUT),
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


def registers_and_spills(root: Path, functions: tuple) -> str:
    """The registers and spill stores of the sweep functions whose names
    hold each of `functions` in the ptxas report (`-Xptxas -v`) that the
    variant's build kept."""
    report = next((root / "fullsubnet_plus_torch" / "_build").glob("lstm2_bwd_*.ptxas.txt"))
    out, function = [], None
    for line in report.read_text().splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1]
        elif function and all(part in function for part in functions):
            dtype = "float32" if "kernelIf" in function else "bf16"
            if m := re.search(r"(\d+) bytes spill stores", line):
                out.append(f"{dtype} {m[1]} B spill stores")
            elif m := re.search(r"Used (\d+) registers", line):
                out.append(f"{dtype} {m[1]} registers")
    return ", ".join(out)


def time_here(dtype_name: str, shape: str, form: str) -> None:
    """Run inside a variant's copy: K4's sweep time at each fold, in `form`
    ("wave", "tile" or "rule")."""
    import torch

    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    dtype = getattr(torch, dtype_name)
    lt.SWEEP_FORM = {"wave": lt.SWEEP_WAVE, "tile": 0}.get(form)

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

    (D, H, O), folds, _ = SHAPES[shape]
    cells = []
    for n in folds:
        g = torch.Generator().manual_seed(n)
        lstm, fc = LSTM2(D, H), Linear(H, O)
        lstm.reset_parameters(g)
        fc.reset_parameters(g)
        lstm, fc = lstm.to("cuda", dtype), fc.to("cuda", dtype)
        x = torch.rand(n, D, T, generator=g).mul_(2.0).to("cuda", dtype)
        dy = torch.randn(n, T, O, generator=g).to("cuda", dtype)
        w = lstm.packed(fc)
        _, res = lt.lstm2_train_fwd_reference(x, w)
        k4 = ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res))
        cells.append(f"N {n}: {k4:.3f} ms, {k4 / T * 1e3:.1f} us a step")
        del x, dy, w, res
        torch.cuda.empty_cache()
    print(" | ".join(cells), flush=True)


def main(dtypes, shape, tile: bool) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    table = FB_VARIANTS if shape == "fb" else TILE_VARIANTS if tile else VARIANTS
    variants = {name: edits for name, (where, edits) in table.items()
                if any(dt in where for dt in dtypes)}
    with tempfile.TemporaryDirectory(prefix="sweep_variants_") as tmp:
        roots = {name: make_variant(Path(tmp) / str(i), edits)
                 for i, (name, edits) in enumerate(variants.items())}

        def run(root, *args):
            env = {**os.environ, "PYTHONPATH": str(root)}
            return subprocess.Popen([sys.executable, *args], cwd=root, env=env)

        builds = [run(root, "-c", "from fullsubnet_plus_torch.ops import nvcc; "
                                  "nvcc.build('lstm2_bwd')") for root in roots.values()]
        if [b.wait() for b in builds] != [0] * len(builds):
            raise SystemExit("a variant did not build")
        for name, root in roots.items():
            print(f"{name}: ptxas {registers_and_spills(root, SHAPES[shape][2])}")
        for dtype in dtypes:
            for name, root in roots.items():
                if dtype not in table[name][0]:
                    continue
                print(f"{dtype} {name}: ", end="", flush=True)
                form = ("rule" if shape == "fb" else
                        "tile" if tile or name == "the tile form" else "wave")
                if run(root, str(Path(__file__).resolve()), "--time", dtype, shape,
                       form).wait() != 0:
                    raise SystemExit(f"{dtype} {name} failed")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_here(sys.argv[2], sys.argv[3], sys.argv[4])
    else:
        args = [a for a in sys.argv[1:] if a not in ("--fb", "--tile")]
        chosen = tuple(args) or DTYPES
        if not set(chosen) <= set(DTYPES):
            raise SystemExit(f"dtypes: {DTYPES}")
        main(chosen, "fb" if "--fb" in sys.argv[1:] else "shipped", "--tile" in sys.argv[1:])
