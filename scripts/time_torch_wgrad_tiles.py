"""Build-and-check of the port's bf16 weight-gradient kernel (K3,
csrc/lstm2_bwd_wgrad.cu, `wgrad_mma_kernel`) and its time at each tile shape.

    python3 scripts/time_torch_wgrad_tiles.py        (from the repo's root)

Needs an NVIDIA GPU. Builds K3 and K4 in parallel and prints the
weight-gradient functions' registers and spills (ptxas) and HMMA
instructions (cuobjdump -sass); holds K3 in bf16 at every tile shape of
dU1, dW2, dU2 (`WGRAD_H_TILES`) against its plain version at two ragged
folds (N 150, T 7, H 64 and 384, the scratch cut to chunks of 3 steps) and
checks that a repeat gives the same bits. Then, at the training fold (N 2304,
D 34, H 384, O 2, T 195): K3 in bf16 at each tile (one warm-up, median of 3,
CUDA events) with the device time of its weight-gradient kernel
(torch.profiler) and its agreement with the plain version; the same four
products as bf16 cuBLAS GEMMs over all T (a yardstick the port never calls);
and in float32 and bf16, K3 against K4 plus `weight_grads`, the two forms
`FUSED_WGRAD` chooses between. With `--tiles-only`, only the bf16 times at
each tile (for timing edited copies of the package, each run from its own
root). Imports nothing of JAX.
"""

import argparse
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fullsubnet_plus_torch.nn.layers import Linear  # noqa: E402
from fullsubnet_plus_torch.nn.lstm import LSTM2  # noqa: E402
from fullsubnet_plus_torch.ops import nvcc  # noqa: E402
from fullsubnet_plus_torch.ops import lstm2_train as lt  # noqa: E402

N, D, H, O, T = 2304, 34, 384, 2, 195
WGRAD = re.compile(r"wgrad_(mma_)?kernel")


def snr(ref, out):
    ref, out = ref.double(), out.double()
    return float(10 * torch.log10(ref.pow(2).sum() / (out - ref).pow(2).sum().clamp_min(1e-300)))


def operands(n, t, hidden, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    lstm, fc = LSTM2(D, hidden), Linear(hidden, O)
    lstm.reset_parameters(g)
    fc.reset_parameters(g)
    lstm, fc = lstm.to("cuda", dtype), fc.to("cuda", dtype)
    x = torch.rand(n, D, t, generator=g).mul_(2.0).to("cuda", dtype)
    dy = torch.randn(n, t, O, generator=g).to("cuda", dtype)
    return x, dy, lstm.packed(fc)


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


def device_ms(fn) -> dict:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def report_build(lib) -> None:
    """ptxas registers and spills and the HMMA count of each weight-gradient function."""
    from torch.utils.cpp_extension import CUDA_HOME

    function = None
    for line in lib.with_name(lib.stem + ".ptxas.txt").read_text().splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1]
        elif function and WGRAD.search(function) and ("spill" in line or "registers" in line):
            print(f"  ptxas {function[:70]}: {line.strip()}")
    tool = os.path.join(CUDA_HOME, "bin", "cuobjdump") if CUDA_HOME else "cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True)
    counts, function = {}, None
    for line in sass.stdout.splitlines():
        if "Function : " in line:
            function = line.split("Function : ", 1)[1].strip()
            counts[function] = 0
        elif function is not None and " HMMA" in line:
            counts[function] += 1
    for function, count in counts.items():
        if WGRAD.search(function) or "sweep" in function:
            print(f"  {lib.stem}: {function} has {count} HMMA instructions")


def check_ragged() -> None:
    n, t = 150, 7
    for hidden in (64, 384):
        x, dy, w = operands(n, t, hidden, torch.bfloat16, seed=hidden)
        _, res = lt.lstm2_train_fwd_reference(x, w)
        lt.WGRAD_SCRATCH_BYTES = 3 * 2 * n * 4 * hidden * 2
        want = lt.lstm2_bwd_plain(dy, x, w, res, fused=True)
        for tile in [None, *range(len(lt.WGRAD_H_TILES))]:
            lt.force_wgrad_tile(tile)
            got = lt.lstm2_bwd(dy, x, w, res, fused=True)
            again = lt.lstm2_bwd(dy, x, w, res, fused=True)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            least = min(snr(a.float(), b.float()) for a, b in zip(want, got))
            print(f"ragged N={n} T={t} H={hidden} chunk 3, tile "
                  f"{'rule' if tile is None else lt.WGRAD_H_TILES[tile]}: least {least:.1f} dB, "
                  f"equal on a repeat: {same}")
        lt.force_wgrad_tile(None)
        lt.WGRAD_SCRATCH_BYTES = 32 << 20


def time_training_fold(tiles_only: bool) -> None:
    for dtype in (torch.bfloat16,) if tiles_only else (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        x, dy, w = operands(N, T, H, dtype, seed=3)
        _, res = lt.lstm2_train_fwd(x, w)
        k3 = lambda: lt.lstm2_bwd(dy, x, w, res, fused=True)  # noqa: E731
        if dtype == torch.bfloat16:
            want = lt.lstm2_bwd_plain(dy, x, w, res, fused=True)
            for tile in range(len(lt.WGRAD_H_TILES)):
                lt.force_wgrad_tile(tile)
                try:
                    got = k3()
                except RuntimeError as exc:  # a tile that does not fit an edited copy
                    print(f"bfloat16 K3 tile {lt.WGRAD_H_TILES[tile]}: {exc}")
                    continue
                least = min(snr(a.float(), b.float()) for a, b in zip(want, got))
                kernels = device_ms(k3)
                wgrad = sum(v for k, v in kernels.items() if WGRAD.search(k))
                sweep = sum(v for k, v in kernels.items() if "sweep" in k)
                print(f"bfloat16 K3 tile {lt.WGRAD_H_TILES[tile]}: {ms(k3):.3f} ms, "
                      f"weight-gradient kernel {wgrad:.3f} ms, sweep {sweep:.3f} ms "
                      f"(device), least {least:.1f} dB against the plain version")
            lt.force_wgrad_tile(None)
            del want
            if tiles_only:
                return
        sweep = lt.lstm2_bwd_sweep(dy, x, w, res)
        k3_ms = ms(k3)
        k4_ms = ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res))
        products_ms = ms(lambda: lt.weight_grads(x, res, sweep.dg1, sweep.dg2))
        print(f"{name} K3 {k3_ms:.3f} ms against K4 {k4_ms:.3f} + weight_grads "
              f"{products_ms:.3f} = {k4_ms + products_ms:.3f} ms")
        if dtype == torch.bfloat16:
            # the same four products, bf16 operands laid out beforehand
            x_flat = x.permute(2, 0, 1).reshape(T * N, D).contiguous()
            h1, h2 = res.h1.reshape(T * N, H), res.h2.reshape(T * N, H)
            zero = torch.zeros(N, H, dtype=dtype, device="cuda")
            h1p = torch.cat([zero, h1[:-N]]).contiguous()
            h2p = torch.cat([zero, h2[:-N]]).contiguous()
            g1, g2 = sweep.dg1.reshape(T * N, 4 * H), sweep.dg2.reshape(T * N, 4 * H)
            cublas = ms(lambda: (x_flat.t() @ g1, h1p.t() @ g1, h1.t() @ g2, h2p.t() @ g2))
            print(f"bfloat16 four products as cuBLAS GEMMs over all T: {cublas:.3f} ms")
        del sweep, res
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), torch.__version__, torch.version.cuda)
    parser = argparse.ArgumentParser()
    parser.add_argument("--tiles-only", action="store_true")
    tiles_only = parser.parse_args().tiles_only
    with ThreadPoolExecutor(3) as pool:
        libs = list(pool.map(nvcc.build, ("lstm2_bwd_wgrad", "lstm2_bwd", "lstm2_train_fwd")))
    report_build(libs[0])
    if not tiles_only:
        check_ragged()
    time_training_fold(tiles_only)


if __name__ == "__main__":
    main()
