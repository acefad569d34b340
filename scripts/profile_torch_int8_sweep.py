"""Where a step of K5's sweep goes (`int8_sweep_kernel`,
fullsubnet_plus_torch/csrc/lstm2_int8_fwd.cu).

    python3 scripts/profile_torch_int8_sweep.py        (from the repo's root)

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
prints microseconds per step. The variants that take work out compute wrong
outputs; they only time. Imports nothing of JAX.
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


def registers_and_spills(root: Path) -> str:
    """The R 16, 384-thread sweep's registers and spill stores in the ptxas
    report (`-Xptxas -v`) that the variant's build kept."""
    report = next((root / "fullsubnet_plus_torch" / "_build").glob("lstm2_int8_fwd_*.ptxas.txt"))
    out, function = [], None
    for line in report.read_text().splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1]
        elif function and "int8_sweep_kernelILi1ELi384" in function:
            if m := re.search(r"(\d+) bytes spill stores", line):
                out.append(f"{m[1]} B spill stores")
            elif m := re.search(r"Used (\d+) registers", line):
                out.append(f"{m[1]} registers")
    return ", ".join(out)


def time_here() -> None:
    """Run inside a variant's copy: K5's time at each fold, R 16."""
    import torch

    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2
    from fullsubnet_plus_torch.ops import lstm2_int8

    lstm2_int8.int8_rows_per_cta = lambda *_: 16

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
        w = lstm.to("cuda", torch.bfloat16).prepare_int8(fc.to("cuda", torch.bfloat16))
        x = torch.rand(n, D, T, generator=g).mul_(2.0).to("cuda", torch.bfloat16)
        k5 = ms(lambda: lstm2_int8.lstm2_int8_fc(x, w))
        cells.append(f"N {n}: {k5:.3f} ms, {k5 / T * 1e3:.1f} us a step")
    print(" | ".join(cells), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    with tempfile.TemporaryDirectory(prefix="int8_variants_") as tmp:
        roots = {name: make_variant(Path(tmp) / str(i), edits)
                 for i, (name, edits) in enumerate(VARIANTS.items())}

        def run(root, *args):
            env = {**os.environ, "PYTHONPATH": str(root)}
            return subprocess.Popen([sys.executable, *args], cwd=root, env=env)

        builds = [run(root, "-c", "from fullsubnet_plus_torch.ops import nvcc; "
                                  "nvcc.build('lstm2_int8_fwd')") for root in roots.values()]
        if [b.wait() for b in builds] != [0] * len(builds):
            raise SystemExit("a variant did not build")
        for name, root in roots.items():
            print(f"{name}: ptxas {registers_and_spills(root)}")
        for name, root in roots.items():
            print(f"{name}: ", end="", flush=True)
            if run(root, str(Path(__file__).resolve()), "--time").wait() != 0:
                raise SystemExit(f"{name} failed")


if __name__ == "__main__":
    if sys.argv[1:] == ["--time"]:
        time_here()
    else:
        main()
