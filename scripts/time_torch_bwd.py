"""The backward kernels K3 and K4 (their reverse sweep is
csrc/lstm2_bwd_sweep.cuh) beside cuDNN's LSTM + Linear backward, in
whichever checkout it runs from.

    python3 scripts/time_torch_bwd.py [float32] [bfloat16]          (from the repo's root)
    cd _parent && python3 ../scripts/time_torch_bwd.py [dtypes]     (another checkout)

Needs an NVIDIA GPU and nvcc; imports the package of the working directory
and nothing of JAX. Builds K3 and K4 in parallel, prints the card's name and
power limit, then for each dtype (both without an argument) K4
(`lstm2_bwd_sweep`) and K3 (`lstm2_bwd(fused=True)`) against their plain
versions (least SNR over the outputs; floors 80 dB float32, 40 dB bf16) at a
ragged fold (N 771, T 37) and at the training fold (N 2304, T 195), K3
equal to itself on a repeat; and at the training fold the median of 3
CUDA-event timings of K4, K4 + `weight_grads`, K3 and cuDNN's LSTM + Linear
backward (TF32 off, a yardstick), with K3's device time split into the
reverse sweep and the weight-gradient kernel (torch.profiler). The
residuals come from the plain forward.
"""

import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.getcwd())

from fullsubnet_plus_torch.nn.layers import Linear  # noqa: E402
from fullsubnet_plus_torch.nn.lstm import LSTM2  # noqa: E402
from fullsubnet_plus_torch.ops import lstm2_train as lt  # noqa: E402
from fullsubnet_plus_torch.ops import nvcc  # noqa: E402

D, H, O = 34, 384, 2
FLOOR = {torch.float32: 80.0, torch.bfloat16: 40.0}


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


def snr(ref, out):
    ref, out = ref.double(), out.double()
    return float(10 * torch.log10(ref.pow(2).sum() / (out - ref).pow(2).sum().clamp_min(1e-300)))


def operands(n, t, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    lstm, fc = LSTM2(D, H), Linear(H, O)
    lstm.reset_parameters(g)
    fc.reset_parameters(g)
    lstm, fc = lstm.to("cuda", dtype), fc.to("cuda", dtype)
    x = torch.rand(n, D, t, generator=g).mul_(2.0).to("cuda", dtype)
    dy = torch.randn(n, t, O, generator=g).to("cuda", dtype)
    return x, dy, lstm, fc


def device_ms(fn):
    """{kernel name: device ms} of one call of fn (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def cudnn_backward(lstm, fc, x, dy):
    ref = torch.nn.LSTM(D, H, num_layers=2, batch_first=True)
    ref.load_state_dict({k: v.float().cpu() for k, v in lstm.state_dict().items()})
    linear = torch.nn.Linear(H, O)
    linear.load_state_dict({k: v.float().cpu() for k, v in fc.state_dict().items()})
    ref, linear = ref.to("cuda", x.dtype), linear.to("cuda", x.dtype)
    ref.flatten_parameters()
    x_ntd = x.transpose(1, 2).contiguous().requires_grad_()
    wrt = (x_ntd, *ref.parameters(), *linear.parameters())
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = linear(ref(x_ntd)[0])

    def run():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return torch.autograd.grad(y, wrt, dy, retain_graph=True)

    return run


def main(dtypes):
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("float32 matmuls must run in full float32 (allow_tf32 is set)")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    print("tree:", os.getcwd(), flush=True)
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        list(pool.map(nvcc.build, ("lstm2_bwd", "lstm2_bwd_wgrad")))
    for dtype, n, t in ((dt, n, t) for dt in dtypes for n, t in ((771, 37), (2304, 195))):
        name = str(dtype)[6:]
        x, dy, lstm, fc = operands(n, t, dtype, seed=n + t)
        w = lstm.packed(fc)
        _, res = lt.lstm2_train_fwd_reference(x, w)
        ref = lt.lstm2_bwd_reference(dy, x, w, res)
        k4 = min(snr(a.float(), b.float())
                 for a, b in zip(ref[:3], lt.lstm2_bwd_sweep(dy, x, w, res)[:3]))
        want = lt.LSTM2Grads(ref.dx, *lt.weight_grads(x, res, ref.dg1, ref.dg2)[:4],
                             ref.db1, ref.db2)
        del ref
        got = lt.lstm2_bwd(dy, x, w, res, fused=True)
        again = lt.lstm2_bwd(dy, x, w, res, fused=True)
        k3 = min(snr(a.float(), b.float()) for a, b in zip(want, got))
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        del want, got, again
        print(f"N{n} T{t} {name} against the plain versions: K4 {k4:.1f} dB, K3 {k3:.1f} dB, "
              f"K3 equal on a repeat: {repeat}", flush=True)
        if min(k3, k4) < FLOOR[dtype] or not repeat:
            raise SystemExit(f"a {name} backward kernel disagrees with its plain version")
        if n != 2304:
            continue
        sweep = lt.lstm2_bwd_sweep(dy, x, w, res)
        k4_ms = ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res))
        outside_ms = ms(lambda: lt.weight_grads(x, res, sweep.dg1, sweep.dg2))
        del sweep
        k3_ms = ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True))
        split = device_ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True))
        sweep_ms = sum(v for k, v in split.items() if "sweep" in k)
        wgrad_ms = sum(v for k, v in split.items() if "wgrad" in k and "kernel" in k)
        torch.cuda.empty_cache()
        library_ms = ms(cudnn_backward(lstm, fc, x, dy))
        print(f"N{n} T{t} {name}: K4 {k4_ms:.3f} ms ({k4_ms / t * 1e3:.1f} us a step), "
              f"K4 + weight_grads {k4_ms + outside_ms:.3f} ms, K3 {k3_ms:.3f} ms (reverse "
              f"sweep {sweep_ms:.3f}, weight-gradient kernel {wgrad_ms:.3f} ms of device time), "
              f"cuDNN LSTM+Linear backward {library_ms:.3f} ms", flush=True)


if __name__ == "__main__":
    main([getattr(torch, name) for name in sys.argv[1:] or ("float32", "bfloat16")])
