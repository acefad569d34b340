"""K5, the int8-recurrent forward (csrc/lstm2_int8_fwd.cu), beside K1 in
bf16, cuDNN's bf16 LSTM + Linear (a yardstick: neither computes the int8
function) and its bound, in whichever checkout it runs from.

    python3 scripts/time_torch_int8.py                    (from the repo's root)
    cd _parent && python3 ../scripts/time_torch_int8.py   (another checkout)

Needs an NVIDIA GPU and nvcc; imports the package of the working directory
and nothing of JAX. Builds K5 and K1 in parallel, prints the card's name and
power limit and K5's registers and spills (ptxas); holds K5 against its plain
version (>= 40 dB) and against itself on a repeat (bit-equal) at a ragged
fold (N 771, T 37) and at the serving fold (N 2056, T 255); then at the
serving fold, the int8 batch fold (N 2056, T 629) and N 2313 (9 utterances,
where R 16 needs two waves on 132 SMs and R 32 one) times K5 at each of its
row tiles where the checkout has them (`INT8_ROWS_PER_CTA`) and as its tile
rule chooses, K1 bf16 and cuDNN (one warm-up, median of 5, CUDA events),
beside the bound from the card's published peaks.
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
from fullsubnet_plus_torch.ops import lstm2, lstm2_int8, nvcc  # noqa: E402

D, H, O = 34, 384, 2
FLOOR = 40.0
PEAK_INT8_OPS, PEAK_BF16, PEAK_BYTES = 1979e12, 989e12, 3.35e12  # H100 SXM, dense


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


def bound_ms(n, t):
    """The int8 products at the int8 peak plus the bf16 ones at the bf16
    peak, against x, the weights, scales, biases and y over the memory rate
    (chip_smoke.py's int8_bound_ms)."""
    t_ops = 2 * n * t * 3 * H * 4 * H / PEAK_INT8_OPS + 2 * n * t * (D * 4 * H + H * O) / PEAK_BF16
    nbytes = (n * D * t * 2 + D * 4 * H * 2 + 3 * H * 4 * H + 4 * 4 * H * 4 + H * O * 4 + O * 4
              + n * t * O * 2)
    return max(t_ops, nbytes / PEAK_BYTES) * 1e3


def operands(n, t, seed):
    g = torch.Generator().manual_seed(seed)
    lstm, fc = LSTM2(D, H), Linear(H, O)
    lstm.reset_parameters(g)
    fc.reset_parameters(g)
    lstm, fc = lstm.to("cuda", torch.bfloat16), fc.to("cuda", torch.bfloat16)
    x = torch.rand(n, D, t, generator=g).mul_(2.0).to("cuda", torch.bfloat16)
    return x, lstm.prepare_int8(fc), lstm, fc


def cudnn(lstm, fc):
    ref = torch.nn.LSTM(D, H, num_layers=2, batch_first=True)
    ref.load_state_dict({k: v.float().cpu() for k, v in lstm.state_dict().items()})
    linear = torch.nn.Linear(H, O)
    linear.load_state_dict({k: v.float().cpu() for k, v in fc.state_dict().items()})
    ref, linear = ref.to("cuda", torch.bfloat16), linear.to("cuda", torch.bfloat16)
    ref.flatten_parameters()

    def run(x):
        with torch.no_grad():
            return linear(ref(x.transpose(1, 2).contiguous())[0])

    return run


def row_tiles():
    """{label: context setter} for each row tile the checkout has, then its rule."""
    tiles = getattr(lstm2_int8, "INT8_ROWS_PER_CTA", ())
    rule = getattr(lstm2_int8, "int8_rows_per_cta", None)

    def force(rows):
        def set_rule():
            lstm2_int8.int8_rows_per_cta = (lambda *_: rows) if rows else rule
        return set_rule

    return {**{f"R{rows}": force(rows) for rows in tiles}, "rule": force(None)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("float32 matmuls must run in full float32 (allow_tf32 is set)")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    print("tree:", os.getcwd(), flush=True)
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        lib = list(pool.map(nvcc.build, ("lstm2_int8_fwd", "lstm2_fwd")))[0]
    for line in lib.with_name(lib.stem + ".ptxas.txt").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas", line.strip()[:150])
    tiles = row_tiles()
    for n, t in ((771, 37), (2056, 255)):
        x, w, _, _ = operands(n, t, seed=n + t)
        ref = lstm2_int8.lstm2_int8_fc_reference(x, w).float()
        for label, set_rule in tiles.items():
            set_rule()
            out, again = lstm2_int8.lstm2_int8_fc(x, w), lstm2_int8.lstm2_int8_fc(x, w)
            torch.cuda.synchronize()
            s, equal = snr(ref, out.float()), torch.equal(out, again)
            print(f"N{n} T{t} K5 {label} against the plain version: {s:.1f} dB, "
                  f"max_abs {float((out.float() - ref).abs().max()):.3e}, "
                  f"equal on a repeat: {equal}", flush=True)
            if s < FLOOR or not equal:
                raise SystemExit("K5 disagrees with its plain version or with itself")
    for n, t in ((2056, 255), (2056, 629), (2313, 255)):
        x, w, lstm, fc = operands(n, t, seed=2)
        times = {}
        for label, set_rule in tiles.items():
            set_rule()
            times[label] = ms(lambda: lstm2_int8.lstm2_int8_fc(x, w))
        packed = lstm.packed(fc)
        k1_ms = ms(lambda: lstm2.lstm2_fc(x, packed))
        library = cudnn(lstm, fc)
        library_ms = ms(lambda: library(x))
        shown = "  ".join(f"{k} {v:.3f} ms ({v / t * 1e3:.1f} us a step)" for k, v in times.items())
        print(f"N{n} T{t}: K5 {shown}; K1 bf16 {k1_ms:.3f} ms; cuDNN bf16 LSTM+Linear "
              f"{library_ms:.3f} ms; bound {bound_ms(n, t):.3f} ms", flush=True)


if __name__ == "__main__":
    main()
