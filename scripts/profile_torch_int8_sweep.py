"""Where a step of K5's sweep goes (`int8_sweep_kernel`, and with `--fb`
`int8_sweep_cluster_kernel`, fullsubnet_plus_torch/csrc/lstm2_int8_fwd.cu).

    python3 scripts/profile_torch_int8_sweep.py        (from the repo's root)
    python3 scripts/profile_torch_int8_sweep.py --fb   (the cluster form)

Needs an NVIDIA GPU and nvcc. Copies the package into a temporary directory
once per variant and edits the copy: as it is; with each s8 mma.sync
replaced by one integer operation on its operands (the loads stay, the
tensor-core products go); without x W1's bf16 product; without the weight
loads (the products run on register values); without the fc; without the
cells' activations (no expf or tanhf); and with the chunk loop unrolled 1 or
4 times instead of 2. It builds the variants' K5 libraries in parallel,
prints the registers and spills of their R 16, 384-thread sweep, then, one
variant after another, times K5 at T 255 with CUDA events (median of 3) at
N 16 (one CTA alone: a step's latency without contention for L2) and N
2056 (the serving fold: one wave of 129 CTAs on 132 SMs), both at R 16, and
prints microseconds per step.

With `--fb`, the cluster form at FullSubNet's full-band shape (D 257, H
512, O 257), as `scripts/profile_torch_fwd_sweep.py` splits the forward's:
as it is; without the products (each warp still waits for its owners'
blocks, so the exchange stays whole); without their weight loads; without
the exchange (no block copies, no mbarrier waits, no cluster barrier
halves in the loop); without the block copies alone (the cluster barrier
kept); without the two cells' activations (the gates' sums kept); the
exchange alone (the products and the activations out: the step floor of
this design); and the chunk loop unrolled twice instead of not at all. It prints
the registers and spills of each variant's cluster function and times K5
(`lstm2_int8_fc`, which takes the cluster form there) at T 195 at N 8 (a
batch of 8: one cluster) and N 18 (two clusters).

The variants that take work out compute wrong outputs; they only time.
Imports nothing of JAX.
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
KERNEL = "csrc/lstm2_int8_fwd.cu"
D, H, O, T = 34, 384, 2, 255
FOLDS = (16, 2056)
FB, FB_T, FB_FOLDS = (257, 512, 257), 195, (8, 18)
LOOP = "#pragma unroll 2\n  for (int kc = 0; kc < chunks; ++kc) {"
# variant: [(text, its replacement), ...] in KERNEL
VARIANTS = {
    "as committed": [],
    "without the s8 products": [
        ("mma_s8(d, a[0], b.x, b.y);\n    mma_s8(d, a[1], b.z, b.w);",
         "d[0] += (int)(a[0][0] ^ a[0][3] ^ a[1][0] ^ a[1][3] ^ b.x ^ b.y ^ b.z ^ b.w);"),
    ],
    "without x W1": [
        ("mma_pass<Bf16Mma, MT>(gates, xa[bb]", "if (0) mma_pass<Bf16Mma, MT>(gates, xa[bb]"),
    ],
    "without the weight loads": [
        ("nb[i] = __ldg(nxt + i * nst);", "nb[i] = make_uint4(kc * 0x01010101u, i, kc + i, 0u);"),
    ],
    "without the fc": [
        ("if (t > 0)\n      fc_mma<MT>", "if (t < 0)\n      fc_mma<MT>"),
    ],
    "without the activations": [
        ("const float i = sigm(gates[mt][0][e]), f = sigm(gates[mt][1][e]);\n"
         "        const float g = tanhf(gates[mt][2][e]), o = sigm(gates[mt][3][e]);",
         "const float i = gates[mt][0][e], f = gates[mt][1][e];\n"
         "        const float g = gates[mt][2][e], o = gates[mt][3][e];"),
        ("h[p] = o * tanhf(c);", "h[p] = o * c;"),
    ],
    "the chunk loop not unrolled": [(LOOP, LOOP.replace("unroll 2", "unroll 1"))],
    "the chunk loop unrolled 4 times": [(LOOP, LOOP.replace("unroll 2", "unroll 4"))],
}

# the cluster form's variants (`--fb`), edits of the same file
CL_PRODUCTS_OUT = [  # wait(v) stays: the exchange is whole
    ("""    uint32_t a[2][4];
    const uint2 addr = a_of(v);
    ldmatrix_x4(a[0], addr.x);
    ldmatrix_x4(a[1], addr.y);
#pragma unroll
    for (int g = 0; g < 4; ++g) P::mma(acc[g], a, b[g]);
    if (kFc && v < fc_n) {
      const int o = fc_owner(v);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t fa[2][4];
        load_a(fa, fc_a(o + half));
        Bf16Mma::mma(facc, fa, f[half]);
      }
    }
""", ""),
]
CL_LOADS_OUT = [
    ("b[g] = __ldg(B + k + g * ns);", "b[g] = make_uint4(0x01010101u, g, 0u, 1u);"),
    ("nb[g] = __ldg(B + kn + g * ns);",
     "nb[g] = make_uint4(0x01010101u + (uint32_t)kn, g, 0u, 1u);"),
    ("      f[0] = __ldg(F + (size_t)o * 32);\n      f[1] = __ldg(F + (size_t)(o + 1) * 32);",
     "      f[0] = make_uint4(o, 1u, 0u, 1u);\n      f[1] = make_uint4(o, 2u, 0u, 1u);"),
    ("      nf[0] = __ldg(F + (size_t)o * 32);\n      nf[1] = __ldg(F + (size_t)(o + 1) * 32);",
     "      nf[0] = make_uint4(o, 1u, 0u, 1u);\n      nf[1] = make_uint4(o, 2u, 0u, 1u);"),
]
CL_COPIES_OUT = [  # no block sent, none awaited, no bytes armed
    ("    for (int k = 1; k < C; ++k) {", "    for (int k = 1; k < 1; ++k) {"),
    ("                mbar_wait(bar(0, p, o), (uint32_t)(t >> 1) & 1u);",
     "                (void)0;"),
    ("                mbar_wait(bar(1, pq, o), (uint32_t)((t - 1) >> 1) & 1u);",
     "                (void)0;"),
    ("      if (o != c) mbar_wait(bar(1, pl, o), (uint32_t)((steps - 1) >> 1) & 1u);\n", ""),
    ("    arm(0, 0);  // h1q_0\n    arm(0, 1);  // h1q_1\n", ""),
    ("    arm(1, 0);  // h2_0 (h2_1's at the end of step 0)\n", ""),
    ("      arm(0, p);   // h1q_{t+2}\n      arm(1, pq);  // h2_{t+1}\n", ""),
]
CL_EXCHANGE_OUT = CL_COPIES_OUT + [  # the pre-loop arrive and the closing wait stay paired
    ("    cluster_wait();       // every peer has read the blocks of step t - 2 these copies "
     "overwrite\n", ""),
    ("    cluster_arrive();  // this CTA has read h1q_{t-1} and h2_{t-1}\n", ""),
]
CL_CELLS_OUT = [
    ("const float h = cell(pre, c1);", "const float h = (pre[0] + pre[1] + pre[2] + pre[3]) * c1;"),
    ("const float h = cell(pre, c2);", "const float h = (pre[0] + pre[1] + pre[2] + pre[3]) * c2;"),
]
CL_LOOP = "#pragma unroll 1\n  for (int v = 0; v < n; ++v) {"
FB_VARIANTS = {
    "as committed": [],
    "without the products": CL_PRODUCTS_OUT,
    "without their weight loads": CL_LOADS_OUT,
    "without the exchange and its barriers": CL_EXCHANGE_OUT,
    "without the block copies": CL_COPIES_OUT,
    "without the two cells' activations": CL_CELLS_OUT,
    "the exchange alone": CL_PRODUCTS_OUT + CL_CELLS_OUT,
    "chunk loop unrolled twice": [(CL_LOOP, CL_LOOP.replace("unroll 1", "unroll 2"))],
}


def make_variant(root: Path, edits) -> Path:
    """A copy of the package under root with K5's source edited; each edited
    text must appear exactly once."""
    package = root / "fullsubnet_plus_torch"
    shutil.copytree(REPO / "fullsubnet_plus_torch", package,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = package / KERNEL
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{KERNEL} no longer has exactly one {old[:60]!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return root


def registers_and_spills(root: Path, fb: bool) -> str:
    """The registers and spill stores in the ptxas report (`-Xptxas -v`)
    that the variant's build kept: of the R 16, 384-thread tile sweep, or
    with `fb` of the cluster form."""
    report = next((root / "fullsubnet_plus_torch" / "_build").glob("lstm2_int8_fwd_*.ptxas.txt"))
    name = "int8_sweep_cluster_kernel" if fb else "int8_sweep_kernelILi1ELi384"
    out, function = [], None
    for line in report.read_text().splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1]
        elif function and name in function:
            if m := re.search(r"(\d+) bytes spill stores", line):
                out.append(f"{m[1]} B spill stores")
            elif m := re.search(r"Used (\d+) registers", line):
                out.append(f"{m[1]} registers")
    return ", ".join(out)


def time_here(fb: bool) -> None:
    """Run inside a variant's copy: K5's time at each fold, R 16 (the tile
    form), or with `fb` at the full-band folds in the cluster form."""
    import torch

    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2
    from fullsubnet_plus_torch.ops import lstm2_int8

    lstm2_int8.int8_rows_per_cta = lambda *_: 16
    (d, h, o), steps, folds = (FB, FB_T, FB_FOLDS) if fb else ((D, H, O), T, FOLDS)

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
    for n in folds:
        g = torch.Generator().manual_seed(n)
        lstm, fc = LSTM2(d, h), Linear(h, o)
        lstm.reset_parameters(g)
        fc.reset_parameters(g)
        w = lstm.to("cuda", torch.bfloat16).prepare_int8(fc.to("cuda", torch.bfloat16))
        x = torch.rand(n, d, steps, generator=g).mul_(2.0).to("cuda", torch.bfloat16)
        if lstm2_int8.int8_sweep_form(x, w) != (lstm2_int8.INT8_CLUSTER if fb else 0):
            raise SystemExit(f"N {n} does not take the {'cluster' if fb else 'tile'} form")
        k5 = ms(lambda: lstm2_int8.lstm2_int8_fc(x, w))
        cells.append(f"N {n}: {k5:.3f} ms, {k5 / steps * 1e3:.1f} us a step")
    print(" | ".join(cells), flush=True)


def main(fb: bool) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    with tempfile.TemporaryDirectory(prefix="int8_variants_") as tmp:
        roots = {name: make_variant(Path(tmp) / str(i), edits)
                 for i, (name, edits) in enumerate((FB_VARIANTS if fb else VARIANTS).items())}

        def run(root, *args):
            env = {**os.environ, "PYTHONPATH": str(root)}
            return subprocess.Popen([sys.executable, *args], cwd=root, env=env)

        builds = [run(root, "-c", "from fullsubnet_plus_torch.ops import nvcc; "
                                  "nvcc.build('lstm2_int8_fwd')") for root in roots.values()]
        if [b.wait() for b in builds] != [0] * len(builds):
            raise SystemExit("a variant did not build")
        for name, root in roots.items():
            print(f"{name}: ptxas {registers_and_spills(root, fb)}")
        for name, root in roots.items():
            print(f"{name}: ", end="", flush=True)
            args = ["--time", "--fb"] if fb else ["--time"]
            if run(root, str(Path(__file__).resolve()), *args).wait() != 0:
                raise SystemExit(f"{name} failed")


if __name__ == "__main__":
    fb = "--fb" in sys.argv[1:]
    if "--time" in sys.argv[1:]:
        time_here(fb)
    else:
        main(fb)
