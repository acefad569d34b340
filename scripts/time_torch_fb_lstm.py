"""The fused LSTM kernels at FullSubNet's full-band shape (the `fb_model`:
D 257, H 512, O 257) and at FullSubNet+'s sub-band shape (D 34, H 384, O 2),
timed through the port's entry points beside their plain versions and
cuDNN, in whichever checkout it runs from, so that two trees compare in one
call on one card:

    python3 scripts/time_torch_fb_lstm.py                        (this tree)
    cd _parent && python3 ../scripts/time_torch_fb_lstm.py       (another)
    python3 scripts/time_torch_fb_lstm.py --folds                (K1's two forms over folds)

Needs an NVIDIA GPU; imports `fullsubnet_plus_torch` from the working
directory, and the operands, the cuDNN yardstick, the bounds and the timer
from the `chip_smoke.py` beside this script (so both state one bound).
Prints the card's name and power limit, the forward library's and K5's
registers and spills (ptxas), then:

  * at the full-band fold of a FullSubNet batch of 8 utterances padded to
    10 s (N 8, T 629): K1 `lstm2_fc` in float32 and bf16 and K5
    `lstm2_int8_fc`, each against its plain version (SNR, max abs), equal
    on a repeat, timed beside the plain version, cuDNN's LSTM(257, 512, 2)
    + Linear(512, 257) (float32 with TF32 off, bf16 for K5: a yardstick)
    and the bound, K1 and K5 in the form the rule takes there and, in a
    tree with their cluster forms, with the tile form forced too; and the
    three at a ragged fold (N 5, T 37);
  * at the sub-band batch fold (N 2056, T 629): K1 in float32 and bf16,
    timed (this tree's shipped shape; compare it with the parent's).

With `--folds`, K1 (in both dtypes) and K5 at the full-band shape, T 629,
over folds from N 8 to 2112 (132 row tiles: one tile-form CTA an SM), in
both forms forced (`FWD_SWEEP_FORM`, `INT8_SWEEP_FORM`), the median of 3
timings of each and which is faster: what `FWD_CLUSTER_MAX_ROWS` and
`INT8_CLUSTER_MAX_ROWS` are set from (the cluster forms' clusters run in
waves of the few the card holds at once). A tree without K5's cluster form
times K1 alone.

A tree whose float32 K1 refuses the full-band shape prints the refusal and
goes on. One warm-up, median of 5, CUDA events. Imports nothing of JAX.
"""

import importlib.util
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

from fullsubnet_plus_torch.ops import lstm2, lstm2_int8, nvcc  # noqa: E402

FB, SB = (257, 512, 257), (34, 384, 2)


def case(n, t, shape, dtype, seed, timed):
    """K1 in `dtype`, or K5 with `dtype` None, at fold (n, t) and `shape`."""
    if dtype is None:
        x, w, lstm, fc = smoke.int8_operands(n, t, seed, shape)
        kernel, plain, tag = lstm2_int8.lstm2_int8_fc, lstm2_int8.lstm2_int8_fc_reference, "K5"
    else:
        x, w, lstm, fc = smoke.lstm_operands(n, t, dtype, seed, shape)
        kernel, plain, tag = lstm2.lstm2_fc, lstm2.lstm2_fc_reference, f"K1 {str(dtype)[6:]}"
    tag += f" N={n} T={t} D={shape[0]} H={shape[1]} O={shape[2]}"
    try:
        out = kernel(x, w)
    except ValueError as exc:
        print(f"{tag}: refused ({exc})")
        return
    again = kernel(x, w)
    torch.cuda.synchronize()
    ref = plain(x, w).float()
    line = (f"{tag}: SNR {smoke.snr_db(ref, out.float()):.1f} dB, max abs "
            f"{float((out.float() - ref).abs().max()):.3e}, equal on a repeat "
            f"{torch.equal(out, again)}")
    module, attr, rule = ((lstm2, "FWD_SWEEP_FORM", "fwd_sweep_form") if dtype is not None
                          else (lstm2_int8, "INT8_SWEEP_FORM", "int8_sweep_form"))
    if timed and hasattr(module, attr):
        form = getattr(module, rule)(x, w)
        setattr(module, attr, 0)
        try:
            tile = smoke.cuda_ms(lambda: kernel(x, w), reps=5)
        finally:
            setattr(module, attr, None)
        line += (f"; the rule's form {f'clusters of {form}' if form else 'tiles'}, "
                 f"the tile form forced {tile:.3f} ms")
    if timed:
        library = smoke.cudnn_lstm(lstm, fc, dtype or torch.bfloat16)
        bound, _ = (smoke.int8_bound_ms(n, t, shape=shape) if dtype is None
                    else smoke.lstm_bound_ms(n, t, dtype, shape=shape))
        line += (f"; kernel {smoke.cuda_ms(lambda: kernel(x, w), reps=5):.3f} ms, plain "
                 f"{smoke.cuda_ms(lambda: plain(x, w), reps=3):.3f} ms, cuDNN "
                 f"{'bf16 ' if dtype is None else ''}"
                 f"{smoke.cuda_ms(lambda: library(x), reps=5):.3f} ms, bound {bound:.3f} ms")
    print(line)


FOLDS = (8, 18, 112, 256, 512, 768, 1024, 1536, 2112)


def folds():
    """K1 (float32, bf16) and K5 at the full-band shape, T 629, in both forms
    forced over FOLDS."""
    kernels = [(f"{str(dtype)[6:]} K1", dtype) for dtype in (torch.float32, torch.bfloat16)]
    if hasattr(lstm2_int8, "INT8_SWEEP_FORM"):
        kernels.append(("K5", None))
    for name, dtype in kernels:
        if dtype is None:
            module, attr, cluster = lstm2_int8, "INT8_SWEEP_FORM", lstm2_int8.INT8_CLUSTER
            kernel = lstm2_int8.lstm2_int8_fc
        else:
            module, attr, cluster = lstm2, "FWD_SWEEP_FORM", lstm2.FWD_CLUSTER
            kernel = lstm2.lstm2_fc
        faster = []
        for n in FOLDS:
            x, w, _, _ = (smoke.int8_operands(n, 629, n, FB) if dtype is None
                          else smoke.lstm_operands(n, 629, dtype, n, FB))
            times = {}
            for form, tag in ((cluster, "cluster form"), (0, "tile form")):
                setattr(module, attr, form)
                try:
                    times[tag] = smoke.cuda_ms(lambda: kernel(x, w), reps=3)
                finally:
                    setattr(module, attr, None)
            if times["cluster form"] < times["tile form"]:
                faster.append(n)
            rule = (lstm2_int8.int8_sweep_cluster(n, *FB) if dtype is None
                    else lstm2.fwd_sweep_cluster(n, *FB, dtype))
            print(f"fb N{n} T629 {name} ms: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
                  + f"; the rule takes {f'clusters of {rule}' if rule else 'the tile form'}",
                  flush=True)
            del x, w
            torch.cuda.empty_cache()
        print(f"fb {name}: the cluster form is faster at N {faster}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip().splitlines()[0]}; tree {os.getcwd()}")
    if "--folds" in sys.argv[1:]:
        folds()
        return
    for stem in ("lstm2_fwd", "lstm2_int8_fwd"):
        for function, (regs, stores, loads) in smoke.ptxas_functions(nvcc.build(stem)).items():
            print(f"  ptxas {stem}: {function[:70]}: {regs} registers, spill stores {stores} "
                  f"bytes, loads {loads}")
    for dtype in (torch.float32, torch.bfloat16):
        case(8, 629, FB, dtype, 11, timed=True)
        case(5, 37, FB, dtype, 12, timed=False)
    case(8, 629, FB, None, 13, timed=True)
    case(5, 37, FB, None, 14, timed=False)
    for dtype in (torch.float32, torch.bfloat16):
        case(2056, 629, SB, dtype, 1, timed=True)


if __name__ == "__main__":
    main()
