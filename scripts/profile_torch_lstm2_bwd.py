"""Where the port's fused-weight-gradient LSTM backward (K3,
fullsubnet_plus_torch/csrc/lstm2_bwd_wgrad.cu) spends its device time.

    python3 scripts/profile_torch_lstm2_bwd.py        (from the repo's root)

Needs an NVIDIA GPU. At the training fold (N 2304, D 34, H 384, O 2, T 195),
in float32 and bfloat16 and for three sizes of the dgates scratch (so three
chunk lengths), it runs `lstm2_bwd(fused=True)` under torch.profiler and
prints the device time of the reverse sweep and of the weight-gradient
kernel, then holds the result against the plain version. Imports nothing of
JAX.
"""

import os
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fullsubnet_plus_torch.nn.layers import Linear  # noqa: E402
from fullsubnet_plus_torch.nn.lstm import LSTM2  # noqa: E402
from fullsubnet_plus_torch.ops import lstm2_train as lt  # noqa: E402

N, D, H, O, T = 2304, 34, 384, 2, 195
SCRATCH_MIB = (8, 32, 128)


def snr_db(ref: torch.Tensor, out: torch.Tensor) -> float:
    ref, out = ref.double(), out.double()
    return float(10 * torch.log10(ref.pow(2).sum() / (out - ref).pow(2).sum().clamp_min(1e-300)))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(torch.cuda.get_device_name(0))
    default_scratch = dict(lt.WGRAD_SCRATCH_BYTES), dict(lt.WAVE_SCRATCH_BYTES)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(1)
        lstm, fc = LSTM2(D, H), Linear(H, O)
        lstm.reset_parameters(g)
        fc.reset_parameters(g)
        lstm, fc = lstm.to("cuda", dtype), fc.to("cuda", dtype)
        x = torch.rand(N, D, T, generator=g).mul_(2.0).to("cuda", dtype)
        dy = torch.randn(N, T, O, generator=g).to("cuda", dtype)
        w = lstm.packed(fc)
        _, res = lt.lstm2_train_fwd(x, w)
        for mib in SCRATCH_MIB:
            lt.WGRAD_SCRATCH_BYTES[dtype] = lt.WAVE_SCRATCH_BYTES[dtype] = mib << 20
            lt.lstm2_bwd(dy, x, w, res, fused=True)  # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                got = lt.lstm2_bwd(dy, x, w, res, fused=True)
                torch.cuda.synchronize()
            kernels = sorted((e for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA
                              and e.self_device_time_total > 0),
                             key=lambda e: -e.self_device_time_total)
            print(f"{str(dtype)[6:]} scratch {mib} MiB, chunk "
                  f"{lt.wgrad_chunk_steps(N, H, T, dtype)} steps: "
                  + " | ".join(f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.1f} ms"
                               for e in kernels[:3]))
        lt.WGRAD_SCRATCH_BYTES.update(default_scratch[0])
        lt.WAVE_SCRATCH_BYTES.update(default_scratch[1])
        ref = lt.lstm2_bwd_plain(dy, x, w, res, True)
        print(f"{str(dtype)[6:]} against the plain version: "
              + " ".join(f"{name} {snr_db(a.float(), b.float()):.1f} dB"
                         for name, a, b in zip(got._fields, ref, got)))
        del res, ref, got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
