"""Build-and-check of the port's forward sweep (K1 csrc/lstm2_fwd.cu and K2
csrc/lstm2_train_fwd.cu, `sweep_mma_kernel` in csrc/lstm2_fwd_sweep.cuh) in
float32 (three TF32 products a product) and bf16, and its time at each row
tile and in each form (the tile form, a CTA a row tile for all the steps,
and the wave form, launches of a CTA an SM over items of a row tile and
FWD_WAVE_STEPS steps).

    python3 scripts/time_torch_fwd_tiles.py [--forms | --pair]   (from the repo's root)

Needs an NVIDIA GPU. Builds the five kernels in parallel and prints the
forward sweeps' registers and spills (ptxas); in each dtype holds K1 and K2
at every row tile and in the wave form (items of 1 and 4 steps) against
their plain versions at three ragged folds (H 384, 64 with O 11, 512),
checks that the tiles and forms give the same bits and that K2's y is K1's;
then times K1 at the batch fold (N 2056, T 629), the weight packing, and
K2 and K1 at N 2304 and 771, T 195, at each tile (one warm-up, median of 3,
CUDA events). With `--forms` it times instead, in each dtype, K2 at T 195
in the tile form forced (the rule's R, and in bf16 R 16 too) beside the
wave form, in turns (tile, wave, wave, tile; the lower of a form's two
medians), at N 192 (12 CTAs of 16 rows alone), 2112 (one full wave on 132
SMs), 2304 (the training fold: 144 tiles) and FullSubNet's sub-band
training fold (N 2304, D 32), with the forms' bits compared; the wave form
at 1, 2, 4, 8 and 16 steps an item at N 2304; K1 at N 2313 (a batch of 9
utterances, 145 tiles) and T 629 in both forms; and cuDNN's LSTM + Linear
forward at N 2304, T 195 (TF32 off; a yardstick the port never calls).
With `--pair` it builds K1 and K2 alone and times instead bf16 K1 and K2
in the pair form (a cluster of two CTAs a 32-row tile; in waves past the
pairs the card holds at once, which it prints) against the parent's form
(the tile form at the rule's R) in turns, beside cuDNN, at the batch and
training folds of D 34 and D 32 and at smaller folds (`PAIR_FOLDS`), each
fold's bits compared with the R 32 tile form's: what the rule
(`fwd_sweep_plan`) rests on.
Prints the card's name and power limit first. Imports nothing of JAX.
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
STEPS = lstm2.FWD_WAVE_STEPS  # the rule's steps an item


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
    """Both wrappers read this rule at call time (the tile form's R)."""
    lstm2.fwd_mma_rows_per_cta = lambda *_: rows


def form(value, rows=None):
    """Force the form (None: the rule's) and, for the tile form, its R."""
    lstm2.FWD_SWEEP_FORM = value
    if rows is not None:
        force(rows)


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


def check(rule) -> None:
    """K1 and K2 at every row tile and in the wave form against the plain
    versions at three ragged folds; the tiles' and forms' bits compared."""
    for dtype in DTYPES:
        floor = 80.0 if dtype == torch.float32 else 40.0
        for n, t, h, o in ((771, 37, 384, 2), (50, 9, 64, 11), (37, 5, 512, 3)):
            lstm, fc, g = modules(dtype, h, o)
            x = torch.rand(n, 34, t, generator=g).mul(2).to("cuda", dtype)
            w = lstm.packed(fc)
            ref = lstm2.lstm2_fc_reference(x, w).float()
            yr, rr = lt.lstm2_train_fwd_reference(x, w)
            outs = []
            runs = [(f"R{rows}", 0, rows, 1) for rows in lstm2.FWD_MMA_ROWS_PER_CTA[dtype]]
            runs += [(f"wave {pk}", lstm2.FWD_SWEEP_WAVE, None, pk) for pk in (1, 4)]
            for tag, value, rows, pk in runs:
                form(value, rows)
                lstm2.FWD_WAVE_STEPS = pk
                y = lstm2.lstm2_fc(x, w)
                y2, res = lt.lstm2_train_fwd(x, w)
                torch.cuda.synchronize()
                outs.append((y, *res))
                worst = min(snr(a.float(), b.float()) for a, b in zip((yr, *rr), (y2, *res)))
                print(f"{str(dtype)[6:]} N{n} T{t} H{h} O{o} {tag}: K1 SNR "
                      f"{snr(ref, y.float()):.1f} finite {bool(torch.isfinite(y.float()).all())}; "
                      f"K2 y==K1 {torch.equal(y2, y)}, min SNR {worst:.1f} (floor {floor:.0f})")
            same = all(torch.equal(a, b) for other in outs[1:] for a, b in zip(outs[0], other))
            print("  tiles and forms agree bit for bit:", same)
    form(None)
    lstm2.fwd_mma_rows_per_cta, lstm2.FWD_WAVE_STEPS = rule, STEPS


def timed(value, rows, fn) -> float:
    """ms of fn in the form `value` (and the tile form's R `rows`)."""
    form(value, rows)
    return ms(fn)


def in_turns(fns: dict) -> dict:
    """{name: the lower of two medians}, timed a, b, .., b, a."""
    order = list(fns) + list(fns)[::-1]
    out = {}
    for name in order:
        out[name] = min(out.get(name, float("inf")), fns[name]())
    return out


def cudnn_fwd_ms(lstm, fc, x) -> float:
    """cuDNN's LSTM(D, H, 2) + Linear(H, O) forward on x [N, D, T], TF32 off."""
    ref = torch.nn.LSTM(x.shape[1], lstm.hidden_size, num_layers=2, batch_first=True).to(
        "cuda", x.dtype)
    linear = torch.nn.Linear(lstm.hidden_size, fc.weight.shape[0]).to("cuda", x.dtype)
    x_ntd = x.transpose(1, 2).contiguous()
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return ms(lambda: linear(ref(x_ntd)[0]))


def forms(rule) -> None:
    """The tile form forced against the wave form, by fold and dtype."""
    wave = lstm2.FWD_SWEEP_WAVE
    for dtype in DTYPES:
        name = str(dtype)[6:]
        lstm, fc, g = modules(dtype)
        lstm32 = LSTM2(32, 384)  # FullSubNet's sub-band LSTM
        lstm32.reset_parameters(torch.Generator().manual_seed(3))
        lstm32 = lstm32.to("cuda", dtype)
        for tag, n, d in (("N 192", 192, 34), ("N 2112", 2112, 34), ("N 2304", 2304, 34),
                          ("FullSubNet sub-band N 2304", 2304, 32)):
            w = (lstm if d == 34 else lstm32).packed(fc)
            x = torch.rand(n, d, 195, generator=g).mul(2).to("cuda", dtype)
            tile_rows = lstm2.fwd_mma_row_tile(n, d, 384, 132, dtype)
            outs = {}
            for key, value, rows in (("tile", 0, tile_rows), ("wave", wave, None)):
                form(value, rows)
                outs[key] = (lambda y, res: (y, *res))(*lt.lstm2_train_fwd(x, w))
            same = all(torch.equal(a, b) for a, b in zip(outs["tile"], outs["wave"]))
            del outs
            def k2():
                return lt.lstm2_train_fwd(x, w)

            fns = {"tile": lambda: timed(0, tile_rows, k2), "wave": lambda: timed(wave, None, k2)}
            if tile_rows != 16:
                fns["tile R16"] = lambda: timed(0, 16, k2)
            got = in_turns(fns)
            form(None)
            lstm2.fwd_mma_rows_per_cta = rule
            rule_form = lstm2.fwd_form_name(lstm2.fwd_sweep_plan(n, d, 384, 2, dtype, 132)[0])
            print(f"K2 {name} {tag} D {d} T 195: " + ", ".join(
                f"{k} {v:.3f} ms ({v / 195 * 1e3:.1f} us a step)" for k, v in got.items())
                + f" (tile R {tile_rows}); y and residuals the same bits in both forms: {same}; "
                f"the rule takes the {rule_form} form", flush=True)
            if tag == "N 2304" and d == 34:
                by_steps = {}
                form(wave)
                for pk in (1, 2, 4, 8, 16):
                    lstm2.FWD_WAVE_STEPS = pk
                    by_steps[pk] = (round(ms(lambda: lt.lstm2_train_fwd(x, w)), 3),
                                    round(ms(lambda: lstm2.lstm2_fc(x, w)), 3))
                form(None)
                lstm2.FWD_WAVE_STEPS = STEPS
                print(f"K2 {name} N 2304 the wave form (K2 ms, K1 ms) by steps an item: "
                      f"{by_steps} (FWD_WAVE_STEPS {STEPS})", flush=True)
                print(f"cuDNN LSTM+Linear forward {name} N 2304 T 195: "
                      f"{cudnn_fwd_ms(lstm, fc, x):.3f} ms", flush=True)
            del x
            torch.cuda.empty_cache()
        w = lstm.packed(fc)
        for n, t in ((2313, 629), (2313, 195)):
            x = torch.rand(n, 34, t, generator=g).mul(2).to("cuda", dtype)
            tile_rows = lstm2.fwd_mma_row_tile(n, 34, 384, 132, dtype)
            outs = {}
            for key, value, rows in (("tile", 0, tile_rows), ("wave", wave, None)):
                form(value, rows)
                outs[key] = lstm2.lstm2_fc(x, w)
            same = torch.equal(outs["tile"], outs["wave"])
            def k1():
                return lstm2.lstm2_fc(x, w)

            got = in_turns({"tile": lambda: timed(0, tile_rows, k1),
                            "wave": lambda: timed(wave, None, k1)})
            form(None)
            lstm2.fwd_mma_rows_per_cta = rule
            print(f"K1 {name} N {n} T {t}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in got.items())
                  + f" (tile R {tile_rows}); the same bits in both forms: {same}", flush=True)
            del x
            torch.cuda.empty_cache()


# The bf16 folds `--pair` times: (kernel, N, D, T); D 34 is FullSubNet+'s
# sub-band LSTM, D 32 FullSubNet's. N 2056 a batch of 8 utterances of 10 s
# (T 629), N 2304 the training fold (T 195), N 1152 a card's half of it,
# N 2313 a batch of 9, and smaller batches down to one utterance (N 257)
PAIR_FOLDS = (("K1", 2056, 34, 629), ("K1", 2056, 32, 629), ("K2", 2304, 34, 195),
              ("K2", 2304, 32, 195), ("K1", 2313, 34, 629), ("K2", 1152, 34, 195),
              ("K1", 771, 34, 629), ("K2", 771, 34, 195), ("K1", 1542, 34, 629),
              ("K1", 514, 34, 629), ("K1", 257, 34, 629), ("K2", 192, 34, 195))


def pair_forms(rule) -> None:
    """bf16 K1 and K2 in the pair form (in one launch where the card holds
    the fold's pairs at once, else in waves of FWD_WAVE_STEPS steps an
    item) against the parent's form (the tile form at `fwd_mma_row_tile`'s
    R, what the rule gave before the pair form) in turns (pair, parent,
    parent, pair; the lower of a form's two medians of 3), with the R 32
    tile form's bits compared and cuDNN's LSTM + Linear forward beside, at
    PAIR_FOLDS."""
    dtype = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"pair clusters the card holds at once: D 34 {lstm2.fwd_pair_clusters(34, 384)}, "
          f"D 32 {lstm2.fwd_pair_clusters(32, 384)} ({sms} SMs)")
    nets = {}
    for d in (34, 32):
        g = torch.Generator().manual_seed(d)
        lstm, fc = LSTM2(d, 384), Linear(384, 2)
        lstm.reset_parameters(g)
        fc.reset_parameters(g)
        nets[d] = (lstm.to("cuda", dtype), fc.to("cuda", dtype), g)
    for kernel, n, d, t in PAIR_FOLDS:
        lstm, fc, g = nets[d]
        w = lstm.packed(fc)
        x = torch.rand(n, d, t, generator=g).mul(2).to("cuda", dtype)
        pair = lstm2.fwd_sweep_pair(n, d, 384, dtype, sms)
        parent_rows = lstm2.fwd_mma_row_tile(n, d, 384, sms, dtype)

        def call():
            return ((lstm2.lstm2_fc(x, w),) if kernel == "K1"
                    else (lambda y, res: (y, *res))(*lt.lstm2_train_fwd(x, w)))

        form(pair)
        got = call()
        form(0, 32)
        same = all(torch.equal(a, b) for a, b in zip(got, call()))
        lstm2.fwd_mma_rows_per_cta = rule
        del got
        got = in_turns({"pair": lambda: timed(pair, None, call),
                        "parent": lambda: timed(0, parent_rows, call)})
        form(None)
        lstm2.fwd_mma_rows_per_cta = rule
        library = cudnn_fwd_ms(lstm, fc, x)
        print(f"{kernel} bf16 N {n} D {d} T {t}: the pair form ({lstm2.fwd_form_name(pair)}) "
              f"{got['pair']:.3f} ms ({got['pair'] / t * 1e3:.1f} us a step), the parent's form "
              f"(tile R {parent_rows}) {got['parent']:.3f} ms ({got['parent'] / t * 1e3:.1f} us a "
              f"step), cuDNN LSTM+Linear forward {library:.3f} ms; the same bits as the R 32 tile "
              f"form: {same}; the rule takes the "
              f"{lstm2.fwd_form_name(lstm2.fwd_sweep_plan(n, d, 384, 2, dtype, sms)[0])} form",
              flush=True)
        del x
        torch.cuda.empty_cache()


def main():
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    if "--pair" in sys.argv[1:]:
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(nvcc.build, SOURCES[:2]))
        pair_forms(lstm2.fwd_mma_rows_per_cta)
        return
    t0 = time.time()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(nvcc.build, SOURCES))
    print(f"built in {time.time() - t0:.1f}s")
    for lib in libs[:2]:
        for line in lib.with_name(lib.stem + ".ptxas.txt").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ", lib.stem[:16], line.strip()[:150])
    rule = lstm2.fwd_mma_rows_per_cta
    check(rule)
    if "--forms" in sys.argv[1:]:
        forms(rule)
        return
    form(0)  # the tile form at each R
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
    form(None)
    lstm2.fwd_mma_rows_per_cta = rule


if __name__ == "__main__":
    main()
