"""Smoke run of the PyTorch port (fullsubnet_plus_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. build both CUDA kernels from the checkout, in parallel:
     csrc/lstm2_fwd.cu (K1, float) and csrc/lstm2_int8_fwd.cu (K5, int8);
  2. hold each kernel against its plain PyTorch version on the card: K1 at
     the batch path's sub-band fold (fp32 >= 80 dB, bf16 >= 40 dB SNR), K5
     at the serving fold and at the batch path's (>= 40 dB), both at a
     ragged shape; check that the int8 weights K5 reads are the prepared
     ones;
  3. time each kernel, its plain version and a cuDNN LSTM + Linear (a
     yardstick only; for K5 also K1 in bf16 at the same shape), with CUDA
     events, beside the bound from the card's peaks;
  4. drive the batch path, `fullsubnet_plus_torch.cli.enhance.run_enhance`,
     on 8 wavs of 3-10 s with a seeded full-width FullSubNet+ in float32,
     bfloat16 and int8; check every output, that the kernels were launched,
     and the float32 and int8 waveforms against the same runs through the
     plain LSTMs (>= 60 dB and >= INT8_WAVE_SNR_FLOOR); profile one float32
     batch;
  5. drive the serving path: the daemon of `fullsubnet_plus_torch.cli.serve`
     (its default dtype, int8; 8 slots; in this process on a free port)
     serves 12 concurrent seeded clients of 3-10 s fed faster than real
     time; check every reply, zero tick failures, that K5 was launched, and
     each stream against the same stream drained offline through a
     StreamingEngine in int8 on the card (>= 60 dB); profile one serving
     batch;
  6. print the kernels' JSON line, the card's name and power limit, and
     the `{"ok": true, ...}` line last.

Imports nothing of JAX. Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SR = 16000
BATCH = 8
# The batch path's sub-band fold for a batch of 8 padded to 10 s: N = 8 * 257
# rows; T = 1 + (160000 + 256) // 256 STFT frames (the length-aware path
# extends the bucket by one hop) + 2 look-ahead frames = 629.
N_FULL, D, H, O, T_FULL = BATCH * 257, 34, 384, 2, 629
N_RAGGED, T_RAGGED = 3 * 257, 37
# The serving fold: 8 slots of 4 s chunks with 256 samples of pre-context,
# N = 8 * 257, T = 1 + (64256 + 256) // 256 + 2 = 255.
SLOTS, CHUNK_S = 8, 4
N_SERVE, T_SERVE = SLOTS * 257, 1 + (CHUNK_S * SR + 256 + 256) // 256 + 2
SNR_FLOOR = {torch.float32: 80.0, torch.bfloat16: 40.0}
INT8_SNR_FLOOR = 40.0
WAVE_SNR_FLOOR = 60.0
INT8_WAVE_SNR_FLOOR = 40.0  # kernel against plain int8 LSTM, through the bf16 model
MAIN_PATH_RUNS = 3  # run_enhance calls per dtype; the host clock of one batch is noisy
STREAMS = 12  # concurrent serving clients
FEED_SPEEDUP = 10.0  # clients send audio this many times faster than real time
# H100 SXM published peaks (NVIDIA data sheet, dense): float32 outside the
# tensor cores, bf16 and int8 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_INT8_OPS = 1979e12
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


def bound(t_ops_s: float, nbytes: int) -> tuple[float, str]:
    """(least ms, what bounds it) from the operations' time at peak and the
    bytes over the memory rate."""
    t_ops, t_bytes = t_ops_s * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lstm_bound_ms(n: int, t: int, dtype: torch.dtype) -> tuple[float, str]:
    """K1: its operations over the peak rate for its type, against its bytes
    (inputs read once, output written once)."""
    size = torch.tensor([], dtype=dtype).element_size()
    flops = 2 * n * t * (D + 3 * H) * 4 * H + 2 * n * t * H * O
    nbytes = (n * D * t * size + (D + 3 * H) * 4 * H * size + 2 * 4 * H * 4 + H * O * 4 + O * 4
              + n * t * O * size)
    return bound(flops / PEAK_FLOPS[dtype], nbytes)


def int8_bound_ms(n: int, t: int) -> tuple[float, str]:
    """K5: the int8 products (h1q U1q, [h1q|h2q][W2q;U2q]) at the int8 peak
    plus the bf16 ones (x W1, the fc) at the bf16 peak, against the bytes of
    x, the weights, scales, biases and the output."""
    t_ops = (2 * n * t * 3 * H * 4 * H / PEAK_INT8_OPS
             + 2 * n * t * (D * 4 * H + H * O) / PEAK_FLOPS[torch.bfloat16])
    nbytes = (n * D * t * 2 + D * 4 * H * 2 + 3 * H * 4 * H + 4 * 4 * H * 4 + H * O * 4 + O * 4
              + n * t * O * 2)
    return bound(t_ops, nbytes)


def lstm_modules(dtype: torch.dtype, seed: int):
    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2

    g = torch.Generator().manual_seed(seed)
    lstm, fc = LSTM2(D, H), Linear(H, O)
    lstm.reset_parameters(g)
    fc.reset_parameters(g)
    return lstm.to("cuda", dtype), fc.to("cuda", dtype), g


def lstm_input(n: int, t: int, dtype: torch.dtype, g: torch.Generator) -> torch.Tensor:
    # a normalized sub-band input is positive with mean 1 (offline Laplace norm)
    return torch.rand(n, D, t, generator=g).mul_(2.0).to("cuda", dtype)


def lstm_operands(n: int, t: int, dtype: torch.dtype, seed: int):
    lstm, fc, g = lstm_modules(dtype, seed)
    return lstm_input(n, t, dtype, g), lstm.packed(fc), lstm, fc


def int8_operands(n: int, t: int, seed: int):
    lstm, fc, g = lstm_modules(torch.bfloat16, seed)
    return lstm_input(n, t, torch.bfloat16, g), lstm.prepare_int8(fc), lstm, fc


def cudnn_lstm(lstm, fc, dtype: torch.dtype):
    """cuDNN's 2-layer LSTM + Linear with the same weights, never called by
    the port: float32 without TF32, so it computes at K1's precision."""
    ref = torch.nn.LSTM(D, H, num_layers=2, batch_first=True)
    ref.load_state_dict({k: v.float().cpu() for k, v in lstm.state_dict().items()})
    ref = ref.to("cuda", dtype)  # .to() packs the weights for cuDNN
    linear = torch.nn.Linear(H, O)
    linear.load_state_dict({k: v.float().cpu() for k, v in fc.state_dict().items()})
    linear = linear.to("cuda", dtype)

    def run(x):
        x_ntd = x.transpose(1, 2).contiguous()
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return linear(ref(x_ntd)[0])

    ref.flatten_parameters()
    return run


def phase_build() -> None:
    from fullsubnet_plus_torch.ops import lstm2, lstm2_int8

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        libs = list(pool.map(lambda m: m.build(), (lstm2, lstm2_int8)))
    print(f"[1] built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for lib in libs:
        ptxas = lib.with_name(lib.stem + ".ptxas.txt")
        for line in ptxas.read_text().splitlines() if ptxas.exists() else []:
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"    ptxas {lib.stem.rsplit('_', 1)[0]}:", line.strip()[:160])


def phase_check() -> dict:
    from fullsubnet_plus_torch.ops import lstm2, lstm2_int8

    errors = {}
    for n, t in ((N_FULL, T_FULL), (N_RAGGED, T_RAGGED)):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, _, _ = lstm_operands(n, t, dtype, seed=n + t)
            out = lstm2.lstm2_fc(x, w).float()
            torch.cuda.synchronize()
            ref = lstm2.lstm2_fc_reference(x, w).float()
            if not torch.isfinite(out).all():
                fail(f"lstm2_fwd output not finite at N={n} T={t} {dtype}")
            snr, err = snr_db(ref, out), float((out - ref).abs().max())
            print(f"[2] lstm2_fwd vs plain N={n} T={t} {str(dtype)[6:]}: "
                  f"max_abs {err:.3e}  SNR {snr:.1f} dB (floor {SNR_FLOOR[dtype]:.0f})")
            if snr < SNR_FLOOR[dtype]:
                fail(f"lstm2_fwd disagrees with the plain version: {snr:.1f} dB")
            errors[("lstm2_fwd", n, t, dtype)] = err
    for n, t in ((N_SERVE, T_SERVE), (N_FULL, T_FULL), (N_RAGGED, T_RAGGED)):
        x, w, lstm, _ = int8_operands(n, t, seed=n + t)
        check_prepared(lstm, w)
        out = lstm2_int8.lstm2_int8_fc(x, w).float()
        torch.cuda.synchronize()
        ref = lstm2_int8.lstm2_int8_fc_reference(x, w).float()
        if not torch.isfinite(out).all():
            fail(f"lstm2_int8_fwd output not finite at N={n} T={t}")
        snr, err = snr_db(ref, out), float((out - ref).abs().max())
        print(f"[2] lstm2_int8_fwd vs plain N={n} T={t}: max_abs {err:.3e}  "
              f"SNR {snr:.1f} dB (floor {INT8_SNR_FLOOR:.0f})")
        if snr < INT8_SNR_FLOOR:
            fail(f"lstm2_int8_fwd disagrees with the plain version: {snr:.1f} dB")
        errors[("lstm2_int8_fwd", n, t)] = err
    return errors


def check_prepared(lstm, w) -> None:
    """The packed words K5 reads unpack to the int8 weights, which are the
    numpy quantization of the module's bf16 weights."""
    from fullsubnet_plus_torch.ops.lstm2_int8 import prepare_quantized_lstm, unpack_k_quads

    def kq(p):
        return p.detach().to(torch.bfloat16).float().t().cpu().numpy()

    q = prepare_quantized_lstm(kq(lstm.weight_hh_l0),
                               np.concatenate([kq(lstm.weight_ih_l1), kq(lstm.weight_hh_l1)]))
    same = (torch.equal(unpack_k_quads(w.u1q_packed), w.u1q)
            and torch.equal(unpack_k_quads(w.w2q_packed), w.w2q)
            and all(np.array_equal(getattr(w, k).cpu().numpy(), q[k])
                    for k in ("u1q", "w2q", "s1", "s2")))
    if not same:
        fail("the int8 weights lstm2_int8_fwd reads are not the prepared ones")


def phase_time() -> dict:
    from fullsubnet_plus_torch.ops import lstm2, lstm2_int8

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, w, lstm, fc = lstm_operands(N_FULL, T_FULL, dtype, seed=1)
        kernel_ms = cuda_ms(lambda: lstm2.lstm2_fc(x, w), reps=5)
        plain_ms = cuda_ms(lambda: lstm2.lstm2_fc_reference(x, w), reps=3)
        library = cudnn_lstm(lstm, fc, dtype)
        library_ms = cuda_ms(lambda: library(x), reps=5)
        bound_ms, bound_by = lstm_bound_ms(N_FULL, T_FULL, dtype)
        print(f"[3] lstm2_fwd {str(dtype)[6:]} N={N_FULL} T={T_FULL}: kernel {kernel_ms:.3f} ms  "
              f"plain {plain_ms:.3f} ms  cuDNN LSTM+Linear {library_ms:.3f} ms  "
              f"bound {bound_ms:.3f} ms ({bound_by})")
        times[dtype] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
    # K5 at the serving fold; beside it K1 in bf16 and cuDNN's bf16 LSTM +
    # Linear on the same input and weights (yardsticks: neither computes
    # the int8-recurrent function, which no single PyTorch call does)
    x, w, lstm, fc = int8_operands(N_SERVE, T_SERVE, seed=2)
    packed = lstm.packed(fc)
    kernel_ms = cuda_ms(lambda: lstm2_int8.lstm2_int8_fc(x, w), reps=5)
    plain_ms = cuda_ms(lambda: lstm2_int8.lstm2_int8_fc_reference(x, w), reps=3)
    k1_ms = cuda_ms(lambda: lstm2.lstm2_fc(x, packed), reps=5)
    library = cudnn_lstm(lstm, fc, torch.bfloat16)
    library_ms = cuda_ms(lambda: library(x), reps=5)
    bound_ms, bound_by = int8_bound_ms(N_SERVE, T_SERVE)
    print(f"[3] lstm2_int8_fwd N={N_SERVE} T={T_SERVE}: kernel {kernel_ms:.3f} ms  "
          f"plain {plain_ms:.3f} ms  lstm2_fwd bf16 {k1_ms:.3f} ms  "
          f"cuDNN bf16 LSTM+Linear {library_ms:.3f} ms (yardstick)  "
          f"bound {bound_ms:.3f} ms ({bound_by})")
    times["int8"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by, lstm2_fwd_bf16_ms=k1_ms)
    return times


def write_inputs(root: str) -> list[int]:
    from fullsubnet_plus_torch.data.wav import write_wav
    from fullsubnet_plus_torch.io.checkpoint import save_flat
    from fullsubnet_plus_torch.io.convert import jax_from_state_dict
    from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlus

    rng = np.random.default_rng(0)
    lengths = [int(s * SR) for s in rng.uniform(3.0, 10.0, BATCH - 1)] + [10 * SR]
    for i, n in enumerate(lengths):
        write_wav(os.path.join(root, "noisy", f"utt{i}.wav"), noisy_utterance(rng, n), SR)
    model = FullSubNetPlus().init_weights(torch.Generator().manual_seed(42))
    save_flat(os.path.join(root, "model.npz"), {"params": jax_from_state_dict(model.state_dict())},
              {"seed": 42})
    return lengths


def noisy_utterance(rng: np.random.Generator, n: int) -> np.ndarray:
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def reset_launches() -> None:
    from fullsubnet_plus_torch.ops import lstm2, lstm2_int8

    lstm2.LAUNCHES = lstm2_int8.LAUNCHES = 0


def phase_batch_path(root: str, lengths: list[int]) -> dict:
    from fullsubnet_plus_torch.cli import enhance as cli
    from fullsubnet_plus_torch.cli.serve import kernel_launches
    from fullsubnet_plus_torch.data.wav import read_wav
    from fullsubnet_plus_torch.nn import sequence
    from fullsubnet_plus_torch.ops import lstm2, lstm2_int8
    from fullsubnet_plus_torch.utils.config import load_config

    config = load_config(os.path.join(REPO, "configs", "inference.toml"))

    def run(tag, dtype):
        return cli.run_enhance(config, os.path.join(root, "model.npz"), os.path.join(root, tag),
                               input_dirs=[os.path.join(root, "noisy")], batch_size=BATCH,
                               compute_dtype=dtype, device="cuda")

    def outputs(tag):
        return [read_wav(os.path.join(root, tag, f"utt{i}.wav")) for i in range(len(lengths))]

    run("warmup", None)  # CUDA context, cuBLAS and cuFFT plans; not timed
    run("warmup_int8", "int8")
    launches, rates = {}, {}
    for tag, dtype, kernel in (("float32", None, "lstm2_fwd"),
                               ("bfloat16", "bfloat16", "lstm2_fwd"),
                               ("int8", "int8", "lstm2_int8_fwd")):
        reset_launches()
        runs = [run(tag, dtype) for _ in range(MAIN_PATH_RUNS)]
        launches[tag] = kernel_launches()
        each = [r["throughput_audio_s_per_s"] for r in runs]
        rates[tag] = statistics.median(each)
        print(f"[4] batch path {tag}: {runs[0]['files']} files, {runs[0]['audio_seconds']:.2f} "
              f"audio-s a run, {MAIN_PATH_RUNS} runs: median {rates[tag]:.1f} audio-s/s "
              f"(each {', '.join(f'{r:.1f}' for r in each)}), launches {launches[tag]}")
        if launches[tag][kernel] < 1:
            fail(f"the {tag} batch path did not launch {kernel}")
        for i, (y, n) in enumerate(zip(outputs(tag), lengths)):
            if y.shape != (n,) or not np.isfinite(y).all():
                fail(f"{tag} output {i}: shape {y.shape}, expected ({n},), or not finite")
            if abs(np.max(np.abs(y)) - 0.8) > 1e-3:
                fail(f"{tag} output {i}: peak {np.max(np.abs(y)):.4f}, expected 0.8")

    # the same float32 and int8 runs with the plain LSTMs in place of the kernels
    sequence.lstm2_fc = lstm2.lstm2_fc_reference
    sequence.lstm2_int8_fc = lstm2_int8.lstm2_int8_fc_reference
    try:
        run("float32_plain", None)
        run("int8_plain", "int8")
    finally:
        sequence.lstm2_fc = lstm2.lstm2_fc
        sequence.lstm2_int8_fc = lstm2_int8.lstm2_int8_fc
    for tag, floor in (("float32", WAVE_SNR_FLOOR), ("int8", INT8_WAVE_SNR_FLOOR)):
        wave_snr = snr_db(torch.from_numpy(np.concatenate(outputs(f"{tag}_plain"))),
                          torch.from_numpy(np.concatenate(outputs(tag))))
        print(f"[4] {tag} waveforms, kernel vs plain LSTM: {wave_snr:.1f} dB (floor {floor:.0f})")
        if wave_snr < floor:
            fail(f"{tag} batch-path waveforms disagree: {wave_snr:.1f} dB")
    kernel = np.concatenate(outputs("float32"))
    for tag in ("bfloat16", "int8"):
        snr = snr_db(torch.from_numpy(kernel), torch.from_numpy(np.concatenate(outputs(tag))))
        print(f"[4] {tag} against float32 waveforms: {snr:.1f} dB (reported, no floor)")
    return {"launches": launches, "rates": rates}


def profile_batch(enhancer, batch: np.ndarray, lengths, tag: str) -> None:
    """Where one batch spends device time (torch.profiler), and the
    device's idle share of the wall time. Reported only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    print(f"{tag} wall {wall_ms:.1f} ms (median of 3, unprofiled), "
          f"device busy {busy_ms:.1f} ms (profiled), "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        ms = e.self_device_time_total / 1e3
        print(f"    {ms:9.3f} ms {ms / max(busy_ms, 1e-9):6.1%} x{e.count:<4d} {e.key[:90]}")


def phase_profile(root: str, lengths: list[int]) -> None:
    from fullsubnet_plus_torch.cli.enhance import load_state_dict
    from fullsubnet_plus_torch.data.wav import read_wav
    from fullsubnet_plus_torch.enhance import Enhancer
    from fullsubnet_plus_torch.models import FULLSUBNET_PLUS

    enhancer = Enhancer(FULLSUBNET_PLUS, FULLSUBNET_PLUS.make_config({}),
                        load_state_dict(os.path.join(root, "model.npz")), device="cuda")
    batch = np.zeros((len(lengths), -(-max(lengths) // SR) * SR), np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = read_wav(os.path.join(root, "noisy", f"utt{i}.wav"))
    profile_batch(enhancer, batch, lengths, "[4] profile float32 batch:")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stream_client(port: int, audio: np.ndarray, sr: int, results: dict, idx: int) -> None:
    """One client: header, audio in 0.25 s frames FEED_SPEEDUP times faster
    than real time, end of stream; then every reply frame up to the
    completion frame. Records the reply, whether it completed, and the wall
    seconds from the first frame sent to the completion frame."""
    from fullsubnet_plus_torch.cli.serve import _recv_frame, _send_frame

    frame = sr // 4
    t0 = time.perf_counter()
    conn = socket.create_connection(("127.0.0.1", port), timeout=120)
    try:
        _send_frame(conn, json.dumps({"sr": sr}).encode())
        for start in range(0, len(audio), frame):
            _send_frame(conn, audio[start: start + frame].tobytes())
            time.sleep(frame / sr / FEED_SPEEDUP)
        _send_frame(conn, b"")
        chunks, completed = [], False
        while True:
            reply = _recv_frame(conn)
            if reply is None:
                break
            if reply == b"":
                completed = True
                break
            chunks.append(np.frombuffer(reply, np.float32))
        out = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        results[idx] = (out, completed, time.perf_counter() - t0)
    finally:
        conn.close()


def phase_serve(config_path: str, checkpoint: str) -> dict:
    """The serving path: the daemon on the card with its default dtype,
    driven by STREAMS concurrent clients; then the same streams drained
    offline through a StreamingEngine on the same enhancer."""
    from fullsubnet_plus_torch.cli import serve as serve_cli
    from fullsubnet_plus_torch.serve import StreamingEngine

    args = serve_cli.parse_args(["-C", config_path, "-M", checkpoint, "--port",
                                 str(free_port()), "--slots", str(SLOTS), "--device", "cuda",
                                 "--tick", "0.05"])
    server = serve_cli.build_server(args, log=lambda *_: None)  # builds, warms up (K5)
    if args.dtype != "int8":
        fail(f"the daemon's default dtype is {args.dtype}, expected int8")
    sr = server.engine.enhancer.sr
    rng = np.random.default_rng(1)
    utts = [noisy_utterance(rng, int(s * sr)) for s in rng.uniform(3.0, 10.0, STREAMS)]
    rc = {}
    runner = threading.Thread(target=lambda: rc.setdefault("rc", server.serve_forever()))
    reset_launches()
    runner.start()
    results = {}
    t0 = time.perf_counter()
    clients = [threading.Thread(target=stream_client, args=(server.port, y, sr, results, i))
               for i, y in enumerate(utts)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = serve_cli.kernel_launches()
    stats = serve_cli.query_stats("127.0.0.1", server.port)
    server.request_shutdown()
    runner.join(timeout=60)
    if runner.is_alive() or rc.get("rc") != 0:
        fail(f"the daemon did not shut down cleanly (exit code {rc.get('rc')})")
    if sorted(results) != list(range(STREAMS)):
        fail(f"clients without a reply: {sorted(set(range(STREAMS)) - set(results))}")
    for i, y in enumerate(utts):
        out, completed, _ = results[i]
        if not completed or out.shape != y.shape or not np.isfinite(out).all():
            fail(f"stream {i}: completed={completed}, {out.shape} for {y.shape}, or not finite")
    if stats["tick_failures"] != 0:
        fail(f"{stats['tick_failures']} tick failures")
    if launches["lstm2_int8_fwd"] < 1:
        fail("the serving path did not launch lstm2_int8_fwd")

    offline = StreamingEngine(server.engine.enhancer, slots=SLOTS,
                              chunk_samples=CHUNK_S * sr)
    sids = [offline.open() for _ in utts]
    for sid, y in zip(sids, utts):
        offline.feed(sid, y)
        offline.close(sid)
    offline.drain()
    snrs = [snr_db(torch.from_numpy(offline.pull(sid)), torch.from_numpy(results[i][0]))
            for i, sid in enumerate(sids)]
    audio_s = sum(len(y) for y in utts) / sr
    rates = [len(y) / sr / results[i][2] for i, y in enumerate(utts)]
    lat = stats["busy_tick_ms"]
    print(f"[5] serving {STREAMS} streams ({audio_s:.2f} audio-s, fed at {FEED_SPEEDUP:g}x real "
          f"time) on {stats['device']}: all complete in {wall:.2f} s, {audio_s / wall:.1f} "
          f"audio-s/s together; per stream median {statistics.median(rates):.1f} audio-s/s "
          f"(min {min(rates):.1f}, max {max(rates):.1f})")
    print(f"[5] stats: busy-tick ms p50 {lat['p50']} p90 {lat['p90']} p99 {lat['p99']} "
          f"over {lat['window']} busy ticks of {stats['ticks']}; chunks "
          f"{stats['chunks_enhanced']}; tick failures {stats['tick_failures']}; "
          f"launches {launches}")
    print(f"[5] served against offline int8 engine: min {min(snrs):.1f} dB, median "
          f"{statistics.median(snrs):.1f} dB (floor {WAVE_SNR_FLOOR:.0f})")
    if min(snrs) < WAVE_SNR_FLOOR:
        fail(f"served audio disagrees with the offline engine: {min(snrs):.1f} dB")
    return {"launches": launches, "stats": stats, "audio_s_per_s": audio_s / wall,
            "stream_audio_s_per_s_median": statistics.median(rates), "min_snr_db": min(snrs),
            "enhancer": server.engine.enhancer, "engine": offline}


def profile_serving_batch(serve: dict) -> None:
    """One full serving batch ([8 slots, 256 + 4 s], every row a full
    chunk) through the int8 enhancer: where its device time goes."""
    engine = serve["engine"]
    rng = np.random.default_rng(3)
    rows = np.stack([noisy_utterance(rng, engine.in_len) for _ in range(SLOTS)])
    profile_batch(serve["enhancer"], rows, [engine.in_len] * SLOTS,
                  "[5] profile int8 serving batch:")


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
        batch = phase_batch_path(root, lengths)
        phase_profile(root, lengths)
        serve = phase_serve(os.path.join(REPO, "configs", "inference.toml"),
                            os.path.join(root, "model.npz"))
        profile_serving_batch(serve)
    print(f"phases 1-5 took {time.perf_counter() - t_start:.1f} s")

    f32, bf16, int8 = times[torch.float32], times[torch.bfloat16], times["int8"]
    k1 = {
        "name": "lstm2_fwd",
        "route": "cuda",
        "source": "fullsubnet_plus_torch/csrc/lstm2_fwd.cu",
        "replaces": "fullsubnet_plus_tpu/ops/lstm_pallas.py:98 (_make_kernel)",
        "launches": batch["launches"]["float32"]["lstm2_fwd"]
        + batch["launches"]["bfloat16"]["lstm2_fwd"],
        "max_abs_err": errors[("lstm2_fwd", N_FULL, T_FULL, torch.float32)],
        **f32,
        "shape": {"N": N_FULL, "D": D, "H": H, "O": O, "T": T_FULL, "dtype": "float32"},
        "bfloat16": {"max_abs_err": errors[("lstm2_fwd", N_FULL, T_FULL, torch.bfloat16)],
                     **bf16},
        "launches_by_run": {tag: batch["launches"][tag]["lstm2_fwd"]
                            for tag in ("float32", "bfloat16")},
        "audio_s_per_s": {tag: batch["rates"][tag] for tag in ("float32", "bfloat16")},
    }
    k5 = {
        "name": "lstm2_int8_fwd",
        "route": "cuda",
        "source": "fullsubnet_plus_torch/csrc/lstm2_int8_fwd.cu",
        "replaces": "fullsubnet_plus_tpu/ops/lstm_pallas.py:1022 (_make_quant_kernel)",
        "launches": serve["launches"]["lstm2_int8_fwd"],
        "max_abs_err": errors[("lstm2_int8_fwd", N_SERVE, T_SERVE)],
        **int8,
        "max_abs_err_batch_fold": errors[("lstm2_int8_fwd", N_FULL, T_FULL)],
        "library": "cuDNN bf16 LSTM + Linear (a yardstick, not the int8 function)",
        "shape": {"N": N_SERVE, "D": D, "H": H, "O": O, "T": T_SERVE, "dtype": "bf16/int8"},
        "launches_by_run": {"serve": serve["launches"]["lstm2_int8_fwd"],
                            "batch_int8": batch["launches"]["int8"]["lstm2_int8_fwd"]},
        "audio_s_per_s": {"batch_int8": batch["rates"]["int8"],
                          "serve_together": serve["audio_s_per_s"],
                          "serve_stream_median": serve["stream_audio_s_per_s_median"]},
        "serve_busy_tick_ms": serve["stats"]["busy_tick_ms"],
    }
    print(json.dumps({"kernels": [k1, k5]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
