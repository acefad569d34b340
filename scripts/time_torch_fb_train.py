"""The training kernels at FullSubNet's full-band shape (D 257, H 512, O 257)
and, for an A/B of two checkouts, a digest of K3's and K4's outputs at the
shipped training fold.

    python3 scripts/time_torch_fb_train.py                       (from the repo's root)
    python3 scripts/time_torch_fb_train.py --shipped             (the digest and times)
    cd _parent && python3 ../scripts/time_torch_fb_train.py --shipped   (another checkout)

Needs an NVIDIA GPU and nvcc; imports the package of the working directory
and nothing of JAX. Builds K2, K3 and K4 in parallel and prints the card's
name and power limit. Without `--shipped`, at the full-band fold of
configs/train.toml's batch (N 18, T 195) and at a ragged one (N 7, T 9),
in float32 and bf16: K2 (`lstm2_train_fwd`) against
`lstm2_train_fwd_reference`, K4 (`lstm2_bwd_sweep`) against
`lstm2_bwd_reference` and K3 (`lstm2_bwd(fused=True)`) against
`lstm2_bwd_plain` (least SNR over the outputs; floors 80 dB float32, 40 dB
bf16), K3 equal to itself on a repeat; at N 18 the median of 3 CUDA-event
timings of each beside its plain version. With `--shipped`, at N 2304, T
195, D 34, H 384, O 2 in both dtypes: a SHA-256 of K3's and of K4's outputs
from seeded operands (equal digests in two checkouts: the same results bit
for bit) and the median of 5 timings of each.
"""

import hashlib
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

FB, SHIPPED = (257, 512, 257), (34, 384, 2)
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


def operands(n, t, shape, dtype, seed):
    d, h, o = shape
    g = torch.Generator().manual_seed(seed)
    lstm, fc = LSTM2(d, h), Linear(h, o)
    lstm.reset_parameters(g)
    fc.reset_parameters(g)
    lstm, fc = lstm.to("cuda", dtype), fc.to("cuda", dtype)
    x = torch.rand(n, d, t, generator=g).mul_(2.0).to("cuda", dtype)
    dy = torch.randn(n, t, o, generator=g).to("cuda", dtype)
    return x, dy, lstm.packed(fc)


def full_band(dtypes):
    for dtype, (n, t) in ((dt, nt) for dt in dtypes for nt in ((7, 9), (18, 195))):
        name = str(dtype)[6:]
        x, dy, w = operands(n, t, FB, dtype, seed=n + t)
        y_ref, res_ref = lt.lstm2_train_fwd_reference(x, w)
        y, res = lt.lstm2_train_fwd(x, w)
        k2 = min(snr(a.float(), b.float()) for a, b in zip((y_ref, *res_ref), (y, *res)))
        ref = lt.lstm2_bwd_reference(dy, x, w, res_ref)
        k4 = min(snr(a.float(), b.float())
                 for a, b in zip(ref[:3], lt.lstm2_bwd_sweep(dy, x, w, res_ref)[:3]))
        want = lt.lstm2_bwd_plain(dy, x, w, res_ref, fused=True)
        got = lt.lstm2_bwd(dy, x, w, res_ref, fused=True)
        again = lt.lstm2_bwd(dy, x, w, res_ref, fused=True)
        k3 = min(snr(a.float(), b.float()) for a, b in zip(want, got))
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"fb N{n} T{t} {name} against the plain versions: K2 {k2:.1f} dB, K4 {k4:.1f} dB, "
              f"K3 {k3:.1f} dB, K3 equal on a repeat: {repeat}", flush=True)
        if min(k2, k3, k4) < FLOOR[dtype] or not repeat:
            raise SystemExit(f"a {name} training kernel disagrees with its plain version")
        if n != 18:
            continue
        times = {
            "K2": ms(lambda: lt.lstm2_train_fwd(x, w)),
            "K2 plain": ms(lambda: lt.lstm2_train_fwd_reference(x, w)),
            "K4": ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res)),
            "K4 plain": ms(lambda: lt.lstm2_bwd_reference(dy, x, w, res)),
            "K3": ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True)),
            "K3 plain": ms(lambda: lt.lstm2_bwd_plain(dy, x, w, res, True)),
        }
        print(f"fb N{n} T{t} {name} ms: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()),
              flush=True)


def shipped(dtypes):
    for dtype in dtypes:
        name = str(dtype)[6:]
        x, dy, w = operands(2304, 195, SHIPPED, dtype, seed=11)
        _, res = lt.lstm2_train_fwd_reference(x, w)
        outs = {"K3": lt.lstm2_bwd(dy, x, w, res, fused=True),
                "K4": lt.lstm2_bwd_sweep(dy, x, w, res)[:3]}
        torch.cuda.synchronize()
        for kernel, tensors in outs.items():
            sha = hashlib.sha256()
            for a in tensors:
                sha.update(a.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            print(f"shipped N2304 T195 {name} {kernel} digest {sha.hexdigest()[:16]}", flush=True)
        del outs
        times = {"K3": ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True), reps=5),
                 "K4": ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res), reps=5)}
        print(f"shipped N2304 T195 {name} ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items()), flush=True)
        torch.cuda.empty_cache()


def main(args):
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("float32 matmuls must run in full float32 (allow_tf32 is set)")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    print("tree:", os.getcwd(), flush=True)
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, together
        list(pool.map(nvcc.build, ("lstm2_train_fwd", "lstm2_bwd", "lstm2_bwd_wgrad")))
    dtypes = (torch.float32, torch.bfloat16)
    (shipped if "--shipped" in args else full_band)(dtypes)


if __name__ == "__main__":
    main(sys.argv[1:])
