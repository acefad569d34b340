"""Build-and-check of the port's forward sweep (K1 csrc/lstm2_fwd.cu and K2
csrc/lstm2_train_fwd.cu, `sweep_mma_kernel` in csrc/lstm2_fwd_sweep.cuh) in
float32 (three TF32 products a product) and bf16, and its time at each row
tile.

    python3 scripts/time_torch_fwd_tiles.py        (from the repo's root)

Needs an NVIDIA GPU. Builds the five kernels in parallel and prints the
forward sweeps' registers and spills (ptxas); in each dtype holds K1 and K2
at every row tile against their plain versions at three ragged folds (H 384,
64 with O 11, 512), checks that the tiles give the same bits and that K2's y
is K1's; then times K1 at the batch fold (N 2056, T 629), the weight
packing, and K2 and K1 at N 2304 and 771, T 195, at each tile (one warm-up,
median of 3, CUDA events). Imports nothing of JAX.
"""

import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fullsubnet_plus_torch.nn.layers import Linear  # noqa: E402
from fullsubnet_plus_torch.nn.lstm import LSTM2  # noqa: E402
from fullsubnet_plus_torch.ops import lstm2, nvcc  # noqa: E402
from fullsubnet_plus_torch.ops import lstm2_train as lt  # noqa: E402

SOURCES = ("lstm2_fwd", "lstm2_train_fwd", "lstm2_bwd", "lstm2_bwd_wgrad", "lstm2_int8_fwd")
DTYPES = (torch.float32, torch.bfloat16)


def snr(ref, out):
    ref, out = ref.double(), out.double()
    return float(10 * torch.log10(ref.pow(2).sum() / (out - ref).pow(2).sum().clamp_min(1e-300)))


def modules(dtype, hidden=384, out_dim=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    lstm, fc = LSTM2(34, hidden), Linear(hidden, out_dim)
    lstm.reset_parameters(g)
    fc.reset_parameters(g)
    return lstm.to("cuda", dtype), fc.to("cuda", dtype), g


def force(rows):
    """Both wrappers read this rule at call time."""
    lstm2.fwd_mma_rows_per_cta = lambda *_: rows


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


def main():
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    t0 = time.time()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(nvcc.build, SOURCES))
    print(f"built in {time.time() - t0:.1f}s")
    for lib in libs[:2]:
        for line in lib.with_name(lib.stem + ".ptxas.txt").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ", lib.stem[:16], line.strip()[:150])
    rule = lstm2.fwd_mma_rows_per_cta
    for dtype in DTYPES:
        floor = 80.0 if dtype == torch.float32 else 40.0
        for n, t, h, o in ((771, 37, 384, 2), (50, 9, 64, 11), (37, 5, 512, 3)):
            lstm, fc, g = modules(dtype, h, o)
            x = torch.rand(n, 34, t, generator=g).mul(2).to("cuda", dtype)
            w = lstm.packed(fc)
            ref = lstm2.lstm2_fc_reference(x, w).float()
            ys = []
            for rows in lstm2.FWD_MMA_ROWS_PER_CTA[dtype]:
                force(rows)
                y = lstm2.lstm2_fc(x, w)
                torch.cuda.synchronize()
                ys.append(y)
                y2, res = lt.lstm2_train_fwd(x, w)
                yr, rr = lt.lstm2_train_fwd_reference(x, w)
                torch.cuda.synchronize()
                worst = min(snr(a.float(), b.float()) for a, b in zip((yr, *rr), (y2, *res)))
                print(f"{str(dtype)[6:]} N{n} T{t} H{h} O{o} R{rows}: K1 SNR "
                      f"{snr(ref, y.float()):.1f} finite {bool(torch.isfinite(y.float()).all())}; "
                      f"K2 y==K1 {torch.equal(y2, y)}, min SNR {worst:.1f} (floor {floor:.0f})")
            print("  tiles agree:", all(torch.equal(ys[0], y) for y in ys[1:]))
    lstm2.fwd_mma_rows_per_cta = rule
    for dtype in DTYPES:
        lstm, fc, g = modules(dtype)
        x = torch.rand(2056, 34, 629, generator=g).mul(2).to("cuda", dtype)
        w = lstm.packed(fc)
        for rows in lstm2.FWD_MMA_ROWS_PER_CTA[dtype]:
            force(rows)
            print(f"K1 {str(dtype)[6:]} N2056 T629 R{rows}: "
                  f"{ms(lambda: lstm2.lstm2_fc(x, w)):.3f} ms")
        t0 = time.perf_counter()
        for _ in range(10):
            lstm2.pack_fwd_mma(w)
        torch.cuda.synchronize()
        print(f"pack_fwd_mma {str(dtype)[6:]}: {(time.perf_counter() - t0) / 10 * 1e3:.3f} ms "
              f"host+device")
        del x
        for n in (2304, 771):
            x = torch.rand(n, 34, 195, generator=g).mul(2).to("cuda", dtype)
            for rows in lstm2.FWD_MMA_ROWS_PER_CTA[dtype]:
                force(rows)
                print(f"K2 {str(dtype)[6:]} N{n} T195 R{rows}: "
                      f"{ms(lambda: lt.lstm2_train_fwd(x, w)):.3f} ms; "
                      f"K1 {ms(lambda: lstm2.lstm2_fc(x, w)):.3f} ms")
    lstm2.fwd_mma_rows_per_cta = rule


if __name__ == "__main__":
    main()
