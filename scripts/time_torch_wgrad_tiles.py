"""Build-and-check of the port's weight-gradient kernels (K3,
csrc/lstm2_bwd_wgrad.cu: on mma.sync `wgrad_mma_kernel` in bf16 and
`wgrad_tf32_kernel` in float32, on wgmma `wgrad_wgmma_kernel` and
`wgrad_wgmma_tf32_kernel`) and their time at each tile shape and scratch
size, with the two backward forms `FUSED_WGRAD` chooses between.

    python3 scripts/time_torch_wgrad_tiles.py        (from the repo's root)

Needs an NVIDIA GPU. Builds K2, K3 and K4 in parallel and prints the
weight-gradient functions' registers and spills (ptxas) and HMMA,
HMMA.1688.F32.TF32 and BF16 and TF32 HGMMA instructions (cuobjdump -sass);
holds K3 in both dtypes at
every tile shape of dU1, dW2, dU2 (`WGRAD_H_TILES`, `WGRAD_F32_TILES`)
against its plain version at ragged folds (N 150, T 7, H 64 and 384, and in
float32 D 257 H 512; the scratch cut to chunks of 3 steps) and checks that a
repeat gives the same bits. Then, at the training fold (N 2304, D 34, H 384,
O 2, T 195; one warm-up, median of 3, CUDA events): K3 in bf16 at each tile
with the device time of its weight-gradient kernel (torch.profiler); K3 in
float32 at each tile and at a scratch of 1, 2, 4, 8 and 16 steps, with the
device time of its reverse sweep, its weight-gradient kernel and the rest;
the same four products as bf16 cuBLAS GEMMs over all T (a yardstick the port
never calls); and in float32 and bf16, K3 against K4 plus `weight_grads`.
With `--folds`, at FullSubNet+'s training fold and FullSubNet's two (the
sub-band N 2304, D 32, H 384, O 2 and the full-band N 18, D 257, H 512, O
257; T 195): the weight-gradient kernel's device time at each tile in both
dtypes, and float32 K3 (at each scratch size) against K4 plus
`weight_grads`; `--folds-only` runs that part alone. With
`--tiles-only`, only the bf16 times at each tile (for timing edited copies
of the package, each run from its own root). Imports nothing of JAX.
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
# (name, N, (D, H, O)) of the float32 training folds
FOLDS = (("FullSubNet+ sub-band", N, (D, H, O)), ("FullSubNet sub-band", N, (32, 384, 2)),
         ("FullSubNet full-band", 18, (257, 512, 257)))
SCRATCH_STEPS = (1, 2, 4, 8, 16)  # float32 scratch sizes, in steps at N 2304, H 384
# the weight-gradient kernels: mma.sync (`wgrad_mma_kernel`, `wgrad_tf32_kernel`), wgmma
# (`wgrad_wgmma_kernel`, `wgrad_wgmma_tf32_kernel`) and the wgmma runs' reduction
WGRAD = re.compile(r"wgrad_(mma_|tf32_|wgmma_(tf32_)?)?kernel|wgmma_reduce_kernel")
TILES = {torch.bfloat16: lt.WGRAD_H_TILES, torch.float32: lt.WGRAD_F32_TILES}


def snr(ref, out):
    ref, out = ref.double(), out.double()
    return float(10 * torch.log10(ref.pow(2).sum() / (out - ref).pow(2).sum().clamp_min(1e-300)))


def operands(n, t, shape, dtype, seed=0):
    d, hidden, o = shape
    g = torch.Generator().manual_seed(seed)
    lstm, fc = LSTM2(d, hidden), Linear(hidden, o)
    lstm.reset_parameters(g)
    fc.reset_parameters(g)
    lstm, fc = lstm.to("cuda", dtype), fc.to("cuda", dtype)
    x = torch.rand(n, d, t, generator=g).mul_(2.0).to("cuda", dtype)
    dy = torch.randn(n, t, o, generator=g).to("cuda", dtype)
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


def split(fn) -> str:
    """One call's device time: the reverse sweep, the weight-gradient kernel, the rest."""
    kernels = device_ms(fn)
    wgrad = sum(v for k, v in kernels.items() if WGRAD.search(k))
    sweep = sum(v for k, v in kernels.items() if "sweep" in k)
    return (f"sweep {sweep:.3f} ms, weight-gradient kernel {wgrad:.3f} ms, rest "
            f"{sum(kernels.values()) - sweep - wgrad:.3f} ms (device)")


def scratch_bytes(steps: int, dtype: torch.dtype) -> int:
    """The scratch that holds `steps` steps at the training fold."""
    return steps * 2 * N * 4 * H * torch.tensor([], dtype=dtype).element_size()


def report_build(lib) -> None:
    """ptxas registers and spills and the HMMA counts of each weight-gradient function."""
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
            counts[function] = [0, 0, 0, 0]
        elif function is not None and " HMMA" in line:
            counts[function][0] += 1
            counts[function][1] += "HMMA.1688.F32.TF32" in line
        elif function is not None and " HGMMA" in line:
            counts[function][2] += ".BF16" in line
            counts[function][3] += ".TF32" in line
    for function, (hmma, tf32, hgmma_bf16, hgmma_tf32) in counts.items():
        if WGRAD.search(function) or "sweep" in function:
            print(f"  {lib.stem}: {function} has {hmma} HMMA instructions, {tf32} TF32; "
                  f"HGMMA {hgmma_bf16} BF16, {hgmma_tf32} TF32")


def check_ragged() -> None:
    n, t = 150, 7
    default = dict(lt.WGRAD_SCRATCH_BYTES), dict(lt.WAVE_SCRATCH_BYTES)
    for dtype, shapes in ((torch.bfloat16, ((34, 64), (34, 384))),
                          (torch.float32, ((34, 64), (34, 384), (257, 512)))):
        for d, hidden in shapes:
            x, dy, w = operands(n, t, (d, hidden, 2), dtype, seed=hidden)
            _, res = lt.lstm2_train_fwd_reference(x, w)
            lt.WGRAD_SCRATCH_BYTES[dtype] = lt.WAVE_SCRATCH_BYTES[dtype] = (
                3 * 2 * n * 4 * hidden * x.element_size())
            want = lt.lstm2_bwd_plain(dy, x, w, res, fused=True)
            for tile in [None, *range(len(TILES[dtype]))]:
                lt.force_wgrad_tile(tile, dtype)
                got = lt.lstm2_bwd(dy, x, w, res, fused=True)
                again = lt.lstm2_bwd(dy, x, w, res, fused=True)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                least = min(snr(a.float(), b.float()) for a, b in zip(want, got))
                print(f"ragged {str(dtype)[6:]} N={n} T={t} D={d} H={hidden} chunk 3, tile "
                      f"{'rule' if tile is None else TILES[dtype][tile]}: least {least:.1f} dB, "
                      f"equal on a repeat: {same}")
            lt.force_wgrad_tile(None, dtype)
            lt.WGRAD_SCRATCH_BYTES.update(default[0])
            lt.WAVE_SCRATCH_BYTES.update(default[1])


def time_bf16_tiles(x, dy, w, res) -> None:
    k3 = lambda: lt.lstm2_bwd(dy, x, w, res, fused=True)  # noqa: E731
    want = lt.lstm2_bwd_plain(dy, x, w, res, fused=True)
    for tile, shape in enumerate(lt.WGRAD_H_TILES):
        lt.force_wgrad_tile(tile)
        try:
            got = k3()
        except RuntimeError as exc:  # a tile that does not fit an edited copy
            print(f"bfloat16 K3 tile {shape}: {exc}")
            continue
        least = min(snr(a.float(), b.float()) for a, b in zip(want, got))
        print(f"bfloat16 K3 tile {shape}: {ms(k3):.3f} ms, {split(k3)}, least {least:.1f} dB "
              f"against the plain version")
    lt.force_wgrad_tile(None)


def time_f32_tiles(x, dy, w, res) -> None:
    """float32 K3 at each tile and scratch size: its time, its device split,
    its agreement with the plain version, and whether every scratch size
    gives the rule's tile the same weight gradients bit for bit."""
    k3 = lambda: lt.lstm2_bwd(dy, x, w, res, fused=True)  # noqa: E731
    want = lt.lstm2_bwd_plain(dy, x, w, res, fused=True)
    default, by_chunk = (dict(lt.WGRAD_SCRATCH_BYTES), dict(lt.WAVE_SCRATCH_BYTES)), {}
    for steps in SCRATCH_STEPS:
        lt.WGRAD_SCRATCH_BYTES[torch.float32] = lt.WAVE_SCRATCH_BYTES[torch.float32] = \
            scratch_bytes(steps, torch.float32)
        for tile in [None, *range(len(lt.WGRAD_F32_TILES))]:
            lt.force_wgrad_tile(tile, torch.float32)
            got = k3()
            least = min(snr(a.float(), b.float()) for a, b in zip(want, got))
            if tile is None:
                by_chunk[steps] = got
            name = "rule " + str(lt.wgrad_tiles(D, H, torch.float32)[1]) if tile is None \
                else lt.WGRAD_F32_TILES[tile]
            print(f"float32 K3 scratch {steps} steps, tile {name}: {ms(k3):.3f} ms, {split(k3)}, "
                  f"least {least:.1f} dB against the plain version")
            del got
        lt.force_wgrad_tile(None, torch.float32)
    lt.WGRAD_SCRATCH_BYTES.update(default[0])
    lt.WAVE_SCRATCH_BYTES.update(default[1])
    first = by_chunk[SCRATCH_STEPS[0]]
    for steps, got in by_chunk.items():
        same = [name for name, a, b in zip(first._fields, first, got) if torch.equal(a, b)]
        print(f"float32 K3 scratch {steps} steps against {SCRATCH_STEPS[0]}: equal bit for bit: "
              f"{same}; bias sums {snr(first.db1, got.db1):.1f} / {snr(first.db2, got.db2):.1f} dB")


def backward_forms(x, dy, w, res, tag: str) -> None:
    """K3 (at the scratch sizes for float32) against K4 + `weight_grads`."""
    name = str(x.dtype)[6:]
    sweep = lt.lstm2_bwd_sweep(dy, x, w, res)
    k4_ms = ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res))
    products_ms = ms(lambda: lt.weight_grads(x, res, sweep.dg1, sweep.dg2))
    del sweep
    k3 = lambda: lt.lstm2_bwd(dy, x, w, res, fused=True)  # noqa: E731
    if x.dtype == torch.float32:
        default = dict(lt.WGRAD_SCRATCH_BYTES), dict(lt.WAVE_SCRATCH_BYTES)
        k3_ms = {}
        for steps in SCRATCH_STEPS:
            lt.WGRAD_SCRATCH_BYTES[torch.float32] = lt.WAVE_SCRATCH_BYTES[torch.float32] = \
                scratch_bytes(steps, torch.float32)
            k3_ms[f"{steps} steps"] = round(ms(k3), 3)
        lt.WGRAD_SCRATCH_BYTES.update(default[0])
        lt.WAVE_SCRATCH_BYTES.update(default[1])
        k3_ms["default"] = round(ms(k3), 3)
    else:
        k3_ms = {"default": round(ms(k3), 3)}
    print(f"{tag} {name}: K3 {k3_ms} ms (scratch at N 2304, H 384) against K4 {k4_ms:.3f} + "
          f"weight_grads {products_ms:.3f} = {k4_ms + products_ms:.3f} ms; "
          f"FUSED_WGRAD's default takes {'K3' if lt.fused_wgrad(x.dtype) else 'K4'}")


def time_training_fold(tiles_only: bool) -> None:
    for dtype in (torch.bfloat16,) if tiles_only else (torch.bfloat16, torch.float32):
        x, dy, w = operands(N, T, (D, H, O), dtype, seed=3)
        _, res = lt.lstm2_train_fwd(x, w)
        if dtype == torch.bfloat16:
            time_bf16_tiles(x, dy, w, res)
            if tiles_only:
                return
        else:
            time_f32_tiles(x, dy, w, res)
        backward_forms(x, dy, w, res, f"training fold N={N} D={D} H={H}")
        if dtype == torch.bfloat16:
            # the same four products, bf16 operands laid out beforehand
            sweep = lt.lstm2_bwd_sweep(dy, x, w, res)
            x_flat = x.permute(2, 0, 1).reshape(T * N, D).contiguous()
            h1, h2 = res.h1.reshape(T * N, H), res.h2.reshape(T * N, H)
            zero = torch.zeros(N, H, dtype=dtype, device="cuda")
            h1p = torch.cat([zero, h1[:-N]]).contiguous()
            h2p = torch.cat([zero, h2[:-N]]).contiguous()
            g1, g2 = sweep.dg1.reshape(T * N, 4 * H), sweep.dg2.reshape(T * N, 4 * H)
            cublas = ms(lambda: (x_flat.t() @ g1, h1p.t() @ g1, h1.t() @ g2, h2p.t() @ g2))
            print(f"bfloat16 four products as cuBLAS GEMMs over all T: {cublas:.3f} ms")
            del sweep
        del res
        torch.cuda.empty_cache()


def time_folds() -> None:
    for tag, n, shape in FOLDS:
        for dtype in (torch.bfloat16, torch.float32):
            x, dy, w = operands(n, T, shape, dtype, seed=5)
            _, res = lt.lstm2_train_fwd(x, w)
            k3 = lambda: lt.lstm2_bwd(dy, x, w, res, fused=True)  # noqa: E731
            tiles = {}
            for tile, name in enumerate(TILES[dtype]):
                lt.force_wgrad_tile(tile, dtype)
                kernels = device_ms(k3)
                tiles["x".join(map(str, name))] = round(
                    sum(v for k, v in kernels.items() if WGRAD.search(k)), 3)
            lt.force_wgrad_tile(None, dtype)
            print(f"{tag} {str(dtype)[6:]} weight-gradient kernel by tile (device ms, one call "
                  f"each, the rule takes {lt.wgrad_tiles(shape[0], shape[1], dtype, n)[1]}): "
                  f"{tiles}")
            if dtype == torch.float32:
                backward_forms(x, dy, w, res, f"{tag} N={n} D={shape[0]} H={shape[1]} "
                                              f"O={shape[2]}")
            del res
            torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), torch.__version__, torch.version.cuda)
    parser = argparse.ArgumentParser()
    parser.add_argument("--tiles-only", action="store_true")
    parser.add_argument("--folds", action="store_true")
    parser.add_argument("--folds-only", action="store_true")
    args = parser.parse_args()
    with ThreadPoolExecutor(3) as pool:
        libs = list(pool.map(nvcc.build, ("lstm2_bwd_wgrad", "lstm2_bwd", "lstm2_train_fwd")))
    if args.folds_only:
        time_folds()
        return
    report_build(libs[0])
    if not args.tiles_only:
        check_ragged()
    time_training_fold(args.tiles_only)
    if args.folds:
        time_folds()


if __name__ == "__main__":
    main()
