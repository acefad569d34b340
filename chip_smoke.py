"""Smoke run of the PyTorch port (fullsubnet_plus_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. build the CUDA kernel (csrc/lstm2_fwd.cu) from the checkout;
  2. hold the kernel against its plain PyTorch version on the card at the
     main path's sub-band shape (fp32 >= 80 dB, bf16 >= 40 dB SNR) and at a
     ragged shape;
  3. time the kernel, the plain version and cuDNN's LSTM + Linear (a
     yardstick only), with CUDA events, beside the bound from the card's
     peaks;
  4. drive the main path, `fullsubnet_plus_torch.cli.enhance.run_enhance`,
     on 8 wavs of 3-10 s with a seeded full-width FullSubNet+ in float32 and
     bfloat16; check every output, that the kernel was launched, and the
     float32 waveforms against the same run through the plain LSTM (>= 60 dB);
  5. print the kernels' JSON line, the card's name and power limit, and
     the `{"ok": true, ...}` line last.

Imports nothing of JAX. Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

SR = 16000
BATCH = 8
# The main path's sub-band fold for a batch of 8 padded to 10 s: N = 8 * 257
# rows; T = 1 + (160000 + 256) // 256 STFT frames (the length-aware path
# extends the bucket by one hop) + 2 look-ahead frames = 629.
N_FULL, D, H, O, T_FULL = BATCH * 257, 34, 384, 2, 629
N_RAGGED, T_RAGGED = 3 * 257, 37
SNR_FLOOR = {torch.float32: 80.0, torch.bfloat16: 40.0}
WAVE_SNR_FLOOR = 60.0
MAIN_PATH_RUNS = 3  # run_enhance calls per dtype; the host clock of one batch is noisy
# H100 SXM published peaks (NVIDIA data sheet, dense): float32 outside the
# tensor cores, bf16 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def snr_db(ref: torch.Tensor, out: torch.Tensor) -> float:
    ref, out = ref.double(), out.double()
    return float(10 * torch.log10(ref.pow(2).sum() / (out - ref).pow(2).sum().clamp_min(1e-300)))


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of `fn` over `reps` runs, after `warmup` runs."""
    for _ in range(warmup):
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


def lstm_bound_ms(n: int, t: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for the fused forward on this card: the larger of its
    operations over the peak rate for its type and its bytes (inputs read
    once, output written once) over the memory rate."""
    size = torch.tensor([], dtype=dtype).element_size()
    flops = 2 * n * t * (D + 3 * H) * 4 * H + 2 * n * t * H * O
    nbytes = (n * D * t * size + (D + 3 * H) * 4 * H * size + 2 * 4 * H * 4 + H * O * 4 + O * 4
              + n * t * O * size)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lstm_operands(n: int, t: int, dtype: torch.dtype, seed: int):
    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2

    g = torch.Generator().manual_seed(seed)
    lstm, fc = LSTM2(D, H), Linear(H, O)
    lstm.reset_parameters(g)
    fc.reset_parameters(g)
    lstm, fc = lstm.to("cuda", dtype), fc.to("cuda", dtype)
    # a normalized sub-band input is positive with mean 1 (offline Laplace norm)
    x = torch.rand(n, D, t, generator=g).mul_(2.0).to("cuda", dtype)
    return x, lstm.packed(fc), lstm, fc


def phase_build() -> None:
    from fullsubnet_plus_torch.ops import lstm2

    t0 = time.perf_counter()
    lib = lstm2.build()
    print(f"[1] built {lib.name} in {time.perf_counter() - t0:.1f} s")
    ptxas = lib.with_name(lib.stem + ".ptxas.txt")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("    ptxas:", line.strip())


def phase_check() -> dict:
    from fullsubnet_plus_torch.ops import lstm2

    errors = {}
    for n, t in ((N_FULL, T_FULL), (N_RAGGED, T_RAGGED)):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, _, _ = lstm_operands(n, t, dtype, seed=n + t)
            out = lstm2.lstm2_fc(x, w).float()
            torch.cuda.synchronize()
            ref = lstm2.lstm2_fc_reference(x, w).float()
            if not torch.isfinite(out).all():
                fail(f"kernel output not finite at N={n} T={t} {dtype}")
            snr, err = snr_db(ref, out), float((out - ref).abs().max())
            print(f"[2] lstm2_fwd vs plain N={n} T={t} {str(dtype)[6:]}: "
                  f"max_abs {err:.3e}  SNR {snr:.1f} dB (floor {SNR_FLOOR[dtype]:.0f})")
            if snr < SNR_FLOOR[dtype]:
                fail(f"kernel disagrees with the plain version: {snr:.1f} dB")
            errors[(n, t, dtype)] = err
    return errors


def phase_time() -> dict:
    from fullsubnet_plus_torch.ops import lstm2

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, w, lstm, fc = lstm_operands(N_FULL, T_FULL, dtype, seed=1)
        kernel_ms = cuda_ms(lambda: lstm2.lstm2_fc(x, w), reps=5)
        plain_ms = cuda_ms(lambda: lstm2.lstm2_fc_reference(x, w), reps=3)
        # yardstick: cuDNN's 2-layer LSTM + Linear on the same input and
        # weights, never called by the port; float32 without TF32, so it
        # computes at the kernel's precision
        ref = torch.nn.LSTM(D, H, num_layers=2, batch_first=True)
        ref.load_state_dict({k: v.float().cpu() for k, v in lstm.state_dict().items()})
        ref = ref.to("cuda", dtype)  # .to() packs the weights for cuDNN
        linear = torch.nn.Linear(H, O)
        linear.load_state_dict({k: v.float().cpu() for k, v in fc.state_dict().items()})
        linear = linear.to("cuda", dtype)
        x_ntd = x.transpose(1, 2).contiguous()
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            ref.flatten_parameters()
            library_ms = cuda_ms(lambda: linear(ref(x_ntd)[0]), reps=5)
        bound_ms, bound_by = lstm_bound_ms(N_FULL, T_FULL, dtype)
        print(f"[3] {str(dtype)[6:]} N={N_FULL} T={T_FULL}: kernel {kernel_ms:.3f} ms  "
              f"plain {plain_ms:.3f} ms  cuDNN LSTM+Linear {library_ms:.3f} ms  "
              f"bound {bound_ms:.3f} ms ({bound_by})")
        times[dtype] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
    return times


def write_inputs(root: str) -> list[int]:
    from fullsubnet_plus_torch.data.wav import write_wav
    from fullsubnet_plus_torch.io.checkpoint import save_flat
    from fullsubnet_plus_torch.io.convert import jax_from_state_dict
    from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlus

    rng = np.random.default_rng(0)
    lengths = [int(s * SR) for s in rng.uniform(3.0, 10.0, BATCH - 1)] + [10 * SR]
    for i, n in enumerate(lengths):
        t = np.arange(n) / SR
        y = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n)
        write_wav(os.path.join(root, "noisy", f"utt{i}.wav"), y.astype(np.float32), SR)
    model = FullSubNetPlus().init_weights(torch.Generator().manual_seed(42))
    save_flat(os.path.join(root, "model.npz"), {"params": jax_from_state_dict(model.state_dict())},
              {"seed": 42})
    return lengths


def phase_main_path(root: str, lengths: list[int]) -> dict:
    from fullsubnet_plus_torch.cli import enhance as cli
    from fullsubnet_plus_torch.data.wav import read_wav
    from fullsubnet_plus_torch.nn import sequence
    from fullsubnet_plus_torch.ops import lstm2
    from fullsubnet_plus_torch.utils.config import load_config

    config = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "configs", "inference.toml"))

    def run(tag, dtype):
        return cli.run_enhance(config, os.path.join(root, "model.npz"), os.path.join(root, tag),
                               input_dirs=[os.path.join(root, "noisy")], batch_size=BATCH,
                               compute_dtype=dtype, device="cuda")

    def outputs(tag):
        return [read_wav(os.path.join(root, tag, f"utt{i}.wav")) for i in range(len(lengths))]

    run("warmup", None)  # CUDA context, cuBLAS and cuFFT plans; not timed
    launches, rates = {}, {}
    for tag, dtype in (("float32", None), ("bfloat16", "bfloat16")):
        lstm2.LAUNCHES = 0
        runs = [run(tag, dtype) for _ in range(MAIN_PATH_RUNS)]
        launches[tag] = lstm2.LAUNCHES
        each = [r["throughput_audio_s_per_s"] for r in runs]
        rates[tag] = statistics.median(each)
        print(f"[4] main path {tag}: {runs[0]['files']} files, {runs[0]['audio_seconds']:.2f} "
              f"audio-s a run, {MAIN_PATH_RUNS} runs: median {rates[tag]:.1f} audio-s/s "
              f"(each {', '.join(f'{r:.1f}' for r in each)}), "
              f"lstm2_fwd launches {launches[tag]}")
        if launches[tag] < 1:
            fail(f"the {tag} main path did not launch lstm2_fwd")
        for i, (y, n) in enumerate(zip(outputs(tag), lengths)):
            if y.shape != (n,) or not np.isfinite(y).all():
                fail(f"{tag} output {i}: shape {y.shape}, expected ({n},), or not finite")
            if abs(np.max(np.abs(y)) - 0.8) > 1e-3:
                fail(f"{tag} output {i}: peak {np.max(np.abs(y)):.4f}, expected 0.8")

    # the same float32 run with the plain LSTM in place of the kernel
    sequence.lstm2_fc = lstm2.lstm2_fc_reference
    try:
        run("float32_plain", None)
    finally:
        sequence.lstm2_fc = lstm2.lstm2_fc
    kernel = np.concatenate(outputs("float32"))
    plain = np.concatenate(outputs("float32_plain"))
    wave_snr = snr_db(torch.from_numpy(plain), torch.from_numpy(kernel))
    print(f"[4] float32 waveforms, kernel vs plain LSTM: {wave_snr:.1f} dB "
          f"(floor {WAVE_SNR_FLOOR:.0f})")
    if wave_snr < WAVE_SNR_FLOOR:
        fail(f"main-path waveforms disagree: {wave_snr:.1f} dB")
    bf16_snr = snr_db(torch.from_numpy(kernel),
                      torch.from_numpy(np.concatenate(outputs("bfloat16"))))
    print(f"[4] bfloat16 against float32 waveforms: {bf16_snr:.1f} dB (reported, no floor)")
    return {"launches": launches, "rates": rates}


def phase_profile(root: str, lengths: list[int]) -> None:
    """Where one float32 main-path batch spends device time (torch.profiler),
    and the device's idle share of the profiled wall time. Reported only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fullsubnet_plus_torch.cli.enhance import load_state_dict
    from fullsubnet_plus_torch.data.wav import read_wav
    from fullsubnet_plus_torch.enhance import Enhancer
    from fullsubnet_plus_torch.models import FULLSUBNET_PLUS

    enhancer = Enhancer(FULLSUBNET_PLUS, FULLSUBNET_PLUS.make_config({}),
                        load_state_dict(os.path.join(root, "model.npz")), device="cuda")
    batch = np.zeros((len(lengths), -(-max(lengths) // SR) * SR), np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = read_wav(os.path.join(root, "noisy", f"utt{i}.wav"))
    enhancer.enhance_batch(batch, lengths=lengths)
    walls = []
    for _ in range(3):  # unprofiled: the profiler's own overhead inflates wall time
        t0 = time.perf_counter()
        enhancer.enhance_batch(batch, lengths=lengths)  # returns numpy: synchronized
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        enhancer.enhance_batch(batch, lengths=lengths)
    # device-side events only: an operator's own entry repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[4] profile float32 batch: wall {wall_ms:.1f} ms (median of 3, unprofiled), "
          f"device busy {busy_ms:.1f} ms (profiled), "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        ms = e.self_device_time_total / 1e3
        print(f"    {ms:9.3f} ms {ms / max(busy_ms, 1e-9):6.1%} x{e.count:<4d} {e.key[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    try:
        import fullsubnet_plus_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port is not importable from here: {exc}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("float32 matmuls must run in full float32 (allow_tf32 is set)")

    t_start = time.perf_counter()
    phase_build()
    errors = phase_check()
    times = phase_time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        lengths = write_inputs(root)
        path = phase_main_path(root, lengths)
        phase_profile(root, lengths)
    print(f"phases 1-4 took {time.perf_counter() - t_start:.1f} s")

    f32, bf16 = times[torch.float32], times[torch.bfloat16]
    record = {
        "name": "lstm2_fwd",
        "route": "cuda",
        "source": "fullsubnet_plus_torch/csrc/lstm2_fwd.cu",
        "replaces": "fullsubnet_plus_tpu/ops/lstm_pallas.py:98 (_make_kernel)",
        "launches": sum(path["launches"].values()),
        "max_abs_err": errors[(N_FULL, T_FULL, torch.float32)],
        **f32,
        "shape": {"N": N_FULL, "D": D, "H": H, "O": O, "T": T_FULL, "dtype": "float32"},
        "bfloat16": {"max_abs_err": errors[(N_FULL, T_FULL, torch.bfloat16)], **bf16},
        "launches_by_run": path["launches"],
        "audio_s_per_s": path["rates"],
    }
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
