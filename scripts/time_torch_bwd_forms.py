"""The reverse sweep's tile form against its wave form
(fullsubnet_plus_torch/csrc/lstm2_bwd_sweep.cuh: `sweep_mma_kernel`, a
launch of a CTA a row tile, against launches of a CTA an SM, each CTA a
work item of a row tile and WAVE_STEPS steps), both forced in one process on
one card, in float32 and bf16.

    python3 scripts/time_torch_bwd_forms.py [--quick]   (from the repo's root)

Needs an NVIDIA GPU and nvcc. At T 195 and H 384, O 2, for each fold: N 192
(12 CTAs of 16 rows: what the second wave at N 2304 costs), N 2112 (one full
wave on 132 SMs), N 2304 (the training fold of configs/train.toml: two
waves) at D 34, and FullSubNet's sub-band training fold (N 2304, D 32), it
checks that K4's dx and dgates in the wave form equal the tile form's bit
for bit, then times K4's sweep (`lstm2_bwd_sweep`) and K3 whole
(`lstm2_bwd`, fused) in each form with CUDA events (medians of 3 in turns,
tile, ring, ring, tile; the lower of a form's two), and prints milliseconds
and microseconds a step.
At N 2304, D 34 it also times the wave form's sweep and K3 at work items of
1, 2, 4 and 8 steps (WAVE_STEPS), K3 in the wave form with its dgates
scratch holding 2, 4, 8, 16 and 32 steps (WAVE_SCRATCH_BYTES) at each of
those, and prints the sweep's bound
(its products at the
peak rate of the type, float32 as three TF32 products each, against its
bytes) and cuDNN's LSTM + Linear backward at the same shapes (TF32 off; a
yardstick the port never calls). `--quick` takes N 2304 at D 34 alone.
The residuals come from K2. Prints the card's name and power limit first.
Imports nothing of JAX.
"""

import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

T, H, O = 195, 384, 2
FOLDS = (("N 192", 192, 34), ("N 2112", 2112, 34), ("N 2304", 2304, 34),
         ("FullSubNet sub-band N 2304", 2304, 32))
PEAK_TF32, PEAK_BF16, PEAK_BYTES = 494.7e12, 989e12, 3.35e12


def ms(fn, reps=3) -> float:
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


def sweep_bound_ms(n: int, d: int, dtype: torch.dtype) -> tuple[float, str]:
    """K4's least time: 2 N T ((D + 3H) 4H + H O) of products at the type's
    peak (float32: three TF32 products each) against the residuals and dy
    read once and the dgates and dx written once."""
    size = torch.tensor([], dtype=dtype).element_size()
    rows = n * T
    flops = 2 * rows * ((d + 3 * H) * 4 * H + H * O)
    t_ops = 3 * flops / PEAK_TF32 if dtype == torch.float32 else flops / PEAK_BF16
    nbytes = rows * (O + 18 * H + d) * size + (d + 3 * H) * 4 * H * size
    t_bytes = nbytes / PEAK_BYTES
    return (t_ops * 1e3, "operations") if t_ops >= t_bytes else (t_bytes * 1e3, "bytes")


def cudnn_bwd_ms(x, dy, dtype) -> float:
    """cuDNN's LSTM(D, H, 2) + Linear(H, O) backward at the same shapes
    (its own seeded weights: the time does not depend on them), TF32 off."""
    torch.manual_seed(0)
    ref = torch.nn.LSTM(x.shape[1], H, num_layers=2, batch_first=True).to("cuda", dtype)
    linear = torch.nn.Linear(H, O).to("cuda", dtype)
    x_ntd = x.transpose(1, 2).contiguous().requires_grad_()
    wrt = (x_ntd, *ref.parameters(), *linear.parameters())
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = linear(ref(x_ntd)[0])
        return ms(lambda: torch.autograd.grad(y, wrt, dy, retain_graph=True))


def main(quick: bool) -> None:
    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    folds = FOLDS[2:3] if quick else FOLDS
    for dtype in (torch.float32, torch.bfloat16):
        for tag, n, d in folds:
            g = torch.Generator().manual_seed(n + d)
            lstm, fc = LSTM2(d, H), Linear(H, O)
            lstm.reset_parameters(g)
            fc.reset_parameters(g)
            lstm, fc = lstm.to("cuda", dtype), fc.to("cuda", dtype)
            x = torch.rand(n, d, T, generator=g).mul_(2.0).to("cuda", dtype)
            dy = torch.randn(n, T, O, generator=g).to("cuda", dtype)
            w = lstm.packed(fc)
            _, res = lt.lstm2_train_fwd(x, w)
            out, times = {}, {}
            for form in (0, lt.SWEEP_WAVE):
                lt.SWEEP_FORM = form
                out[form] = lt.lstm2_bwd_sweep(dy, x, w, res)[:3]
            same = all(torch.equal(a, b) for a, b in zip(out[0], out[lt.SWEEP_WAVE]))
            del out
            for form in (0, lt.SWEEP_WAVE, lt.SWEEP_WAVE, 0):  # in turns
                lt.SWEEP_FORM = form
                k4 = ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res))
                k3 = ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True))
                times.setdefault(form, []).append((k4, k3))
            lt.SWEEP_FORM = None
            line = []
            for form, name in ((0, "tile"), (lt.SWEEP_WAVE, "wave")):
                k4 = min(v[0] for v in times[form])
                k3 = min(v[1] for v in times[form])
                line.append(f"{name}: sweep {k4:.3f} ms ({k4 / T * 1e3:.1f} us a step), "
                            f"K3 {k3:.3f} ms")
            extra = ""
            if tag == "N 2304" and d == 34:
                lt.SWEEP_FORM, rule = lt.SWEEP_WAVE, lt.WAVE_STEPS
                by_steps = {}
                for pk in (1, 2, 4, 8):
                    lt.WAVE_STEPS = pk
                    by_steps[pk] = (round(ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res)), 3),
                                    round(ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True)), 3))
                lt.SWEEP_FORM, lt.WAVE_STEPS = None, rule
                lt.SWEEP_FORM, scratch = lt.SWEEP_WAVE, lt.WAVE_SCRATCH_BYTES[dtype]
                by_scratch = {}
                for chunk in (2, 4, 8, 16, 32):
                    lt.WAVE_SCRATCH_BYTES[dtype] = chunk * 2 * n * 4 * H * x.element_size()
                    for pk in (1, 2, 4, 8):
                        lt.WAVE_STEPS = pk
                        by_scratch[f"{chunk}/{pk}"] = round(
                            ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True)), 3)
                lt.SWEEP_FORM, lt.WAVE_SCRATCH_BYTES[dtype], lt.WAVE_STEPS = None, scratch, rule
                extra = (f"; wave (sweep ms, K3 ms) by steps an item {by_steps} (WAVE_STEPS "
                         f"{rule}); wave K3 ms by scratch steps / steps an item {by_scratch} "
                         f"(the rule's scratch {lt.wgrad_chunk_steps(n, H, T, dtype, True)} "
                         f"steps)")
                bound_ms, by = sweep_bound_ms(n, d, dtype)
                del res
                torch.cuda.empty_cache()
                extra += (f"; sweep bound {bound_ms:.3f} ms ({by}); cuDNN LSTM+Linear backward "
                         f"{cudnn_bwd_ms(x, dy, dtype):.3f} ms")
            print(f"{str(dtype)[6:]} {tag} D {d}: {' | '.join(line)}; the wave form's dx "
                  f"and dgates equal the tile form's bit for bit: {same}{extra}", flush=True)
            if not same:
                raise SystemExit(f"{str(dtype)[6:]} {tag}: the forms disagree")
            del x, dy, w
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main("--quick" in sys.argv[1:])
