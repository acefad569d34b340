"""The float32 forward of the fused LSTM (K1 `lstm2_fc`, K2 `lstm2_train_fwd`)
timed through its public entry points beside cuDNN's float32 LSTM + Linear
forward, in whichever checkout it runs from, so that two trees compare in
one call on one card:

    python3 scripts/time_torch_fwd_f32.py                        (this tree)
    cd _parent && python3 ../scripts/time_torch_fwd_f32.py       (another)

Needs an NVIDIA GPU; imports `fullsubnet_plus_torch` from the working
directory. Prints the card's name and power limit, the tree, K1 at the batch
fold (N 2056, T 629) and K2 at the training fold (N 2304, T 195), each with
cuDNN (TF32 off) and its least SNR against its plain version there (y, and
K2's residuals), and the kernels' SNR at a ragged fold (N 771, T 37). One
warm-up, median of 5, CUDA events. Imports nothing of JAX.
"""

import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

from fullsubnet_plus_torch.nn.layers import Linear  # noqa: E402
from fullsubnet_plus_torch.nn.lstm import LSTM2  # noqa: E402
from fullsubnet_plus_torch.ops import lstm2  # noqa: E402
from fullsubnet_plus_torch.ops import lstm2_train as lt  # noqa: E402

D, H, O = 34, 384, 2


def ms(fn, reps=5):
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


def flat(out):
    """y, or (y, residuals) -> the list of their tensors"""
    return [out] if torch.is_tensor(out) else [out[0], *out[1]]


def operands(n, t, seed):
    g = torch.Generator().manual_seed(seed)
    lstm, fc = LSTM2(D, H), Linear(H, O)
    lstm.reset_parameters(g)
    fc.reset_parameters(g)
    lstm, fc = lstm.cuda(), fc.cuda()
    x = torch.rand(n, D, t, generator=g).mul_(2.0).cuda()
    return x, lstm, fc


def cudnn(lstm, fc):
    ref = torch.nn.LSTM(D, H, num_layers=2, batch_first=True)
    ref.load_state_dict({k: v.cpu() for k, v in lstm.state_dict().items()})
    linear = torch.nn.Linear(H, O)
    linear.load_state_dict({k: v.cpu() for k, v in fc.state_dict().items()})
    ref, linear = ref.cuda(), linear.cuda()
    ref.flatten_parameters()

    def run(x):
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return linear(ref(x.transpose(1, 2).contiguous())[0])

    return run


def main():
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    print("tree:", os.getcwd())
    x, lstm, fc = operands(771, 37, seed=7)
    w = lstm.packed(fc)
    y, res = lt.lstm2_train_fwd(x, w)
    yr, rr = lt.lstm2_train_fwd_reference(x, w)
    k1 = lstm2.lstm2_fc(x, w)
    torch.cuda.synchronize()
    print(f"N771 T37: K1 {snr(lstm2.lstm2_fc_reference(x, w), k1):.1f} dB, K2 least "
          f"{min(snr(a, b) for a, b in zip((yr, *rr), (y, *res))):.1f} dB, "
          f"K2 y == K1 y {torch.equal(y, k1)}")
    for name, n, t, fn, plain in (
            ("K1 lstm2_fc", 2056, 629, lstm2.lstm2_fc, lstm2.lstm2_fc_reference),
            ("K2 lstm2_train_fwd", 2304, 195, lt.lstm2_train_fwd, lt.lstm2_train_fwd_reference)):
        x, lstm, fc = operands(n, t, seed=1)
        w = lstm.packed(fc)
        got, want = flat(fn(x, w)), flat(plain(x, w))
        agree = min(snr(b, a) for a, b in zip(got, want))
        del got, want
        kernel = ms(lambda: fn(x, w))
        library = cudnn(lstm, fc)
        print(f"{name} float32 N{n} T{t}: kernel {kernel:.3f} ms  "
              f"cuDNN LSTM+Linear {ms(lambda: library(x)):.3f} ms  "
              f"against the plain version {agree:.1f} dB")
        del x, w
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
