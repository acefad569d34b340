"""Smoke run of the PyTorch port (fullsubnet_plus_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. build the five CUDA kernels from the checkout, in parallel:
     csrc/lstm2_fwd.cu (K1, float forward), csrc/lstm2_int8_fwd.cu (K5, int8
     forward) and the training step's csrc/lstm2_train_fwd.cu (K2, the
     residual-saving forward), csrc/lstm2_bwd_wgrad.cu (K3, the backward
     with the weight gradients inside) and csrc/lstm2_bwd.cu (K4, the
     backward that keeps the dgates); count the tensor-core (HMMA)
     instructions of the forward sweeps of K1 and K2, the reverse sweeps of
     K3 and K4 and K3's weight-gradient kernels (`cuobjdump -sass`): each
     bf16 sweep and the bf16 `wgrad_mma_kernel` must have them, the float32
     forward sweeps of K1 and K2, the float32 reverse sweeps of K3 and K4
     and each float32 `wgrad_tf32_kernel` (a function a tile shape) must
     have TF32 ones (HMMA.1688.F32.TF32: each float32 product as three TF32
     products), the wgmma weight-gradient kernels `wgrad_wgmma_kernel`
     (bf16) and `wgrad_wgmma_tf32_kernel` (float32) must have BF16 and
     TF32 HGMMA (wgmma) instructions, and no bf16 FMA sweep, FMA forward or
     reverse sweep or FMA `wgrad_kernel` may be compiled; the bf16 reverse
     sweep's two functions (`bwd::sweep_mma_kernel`, in K3's and K4's
     libraries) with their registers and spills, failing on more spill
     stores than BF16_SWEEP_SPILL_STORES allows; the forward's bf16 pair
     form (`fwd::sweep_pair_kernel`, two functions in each of K1's and K2's
     libraries) with its HMMA count, registers and spills, failing on no
     HMMA or more spill stores than PAIR_SWEEP_SPILL_STORES allows; the cluster forms of the
     forward and reverse sweeps (`fwd::` and `bwd::sweep_cluster_kernel`,
     two functions in each of the four libraries) must have HMMA and, in
     float32, TF32 HMMA instructions; print the float32 reverse sweeps'
     (`bwd::sweep_mma_kernel`, which the tile and wave forms run), the
     cluster forms' and the weight-gradient kernels' registers and spills
     (ptxas);
     K5's sweeps, the tile form `int8_sweep_kernel` and the cluster form
     `int8_sweep_cluster_kernel`, must have IMMA (s8) and HMMA (bf16)
     tensor-core instructions and no IDP (`__dp4a`) one, with their
     registers and spills printed;
  2. hold each kernel against the JAX kernel's outputs (the committed
     tests/fixtures/torch_kernel_fixture.npz, interpret mode on the CPU, at
     small ragged shapes; same floors) and against its plain PyTorch version
     on the card, printing the forward's row tile at each fold: K1 at
     the batch path's sub-band fold (fp32 >= 80 dB, bf16 >= 40 dB SNR), K5
     at the serving fold and at the batch path's (>= 40 dB), K2, K3 and K4
     at the training fold (same floors; K2's y equal to K1's bit for bit,
     K3 equal to itself on a repeat, the autograd Function's gradients
     through K3 against those through K4), all at a ragged shape too; K5
     equal to itself on a repeat at each fold, in the tile form at all
     three, and a digest of its output at the serving fold from the
     operands `scripts/time_torch_fb_train.py --shipped` makes (equal to
     another checkout's line where the bits are); check that the fragments
     K5 reads unpack to the prepared int8 weights; the forward sweep's form by
     the rule at each fold (the tile form at the shipped and FullSubNet
     sub-band folds, clusters of 16 at FullSubNet's full-band N 8 and 18),
     then K1 at FullSubNet's full-band shape (N 8, T 37) in the cluster form
     against its plain version and the tile form forced, equal on a repeat,
     K2's y equal to K1's, each launch counted by its form; bf16 K1 and K2
     in the pair form at the batch fold (one launch), the training fold
     and FullSubNet's sub-band training fold (in waves) against the plain
     versions (>= 40 dB), equal on a repeat, K2's y equal to K1's, y and
     the residuals equal to the R 32 tile form forced bit for bit, and the
     pairs the card holds at once no fewer than the rule assumes;
  3. time each kernel, its plain version and a cuDNN LSTM + Linear (a
     yardstick only; forward for K1, K2 and K5, backward for K3 and K4; for
     K5 also K1 in bf16 at the same shape), with CUDA events, beside the
     bound from the card's peaks (for the float32 sweeps, forward and
     reverse, and K3's float32 weight gradients, both: three TF32 products
     at the TF32 peak, and FMAs at the float32 peak); K1
     and K2 at each row tile of the tensor-core forward (bf16 R 16 and 32,
     float32 R 16) and the weight packing alone, K5 at each of its row
     tiles (R 16 and 32) at the serving fold; split K3's and K4's device
     time into the reverse sweep, K3's weight-gradient
     kernel and the rest (torch.profiler); that kernel beside its own bound,
     beside the same four products as cuBLAS GEMMs (bf16 over all T, a
     yardstick; float32: `weight_grads`, the unfused form's SGEMMs) and at
     each candidate tile of dU1, dW2, dU2 in both dtypes, each wgmma
     kernel beside the mma.sync kernel forced in the same call; K3 against K4
     plus `weight_grads` in both dtypes at the training fold and, in
     float32, at FullSubNet's sub-band and full-band training folds too
     (what `FUSED_WGRAD_BY_DTYPE` rests on); the reverse sweep's form by the
     rule (the wave form) against the tile form forced, K4's sweep
     and K3 whole, at the training fold and FullSubNet's sub-band training
     fold in both dtypes, the two forms' dx and dgates the same bits; bf16
     K1 at the batch fold and K2 at the training fold in the pair form
     against the parent's form (the tile form at its rule's R) in turns,
     beside cuDNN, and at the training folds and a batch of 9 the pair
     form beside the wave and tile forms forced, the bits compared;
  4. drive the batch path, `fullsubnet_plus_torch.cli.enhance.run_enhance`,
     on 8 wavs of 3-10 s with a seeded full-width FullSubNet+ in float32,
     bfloat16 and int8; check every output, that the kernels were launched,
     and the float32 and int8 waveforms against the same runs through the
     plain LSTMs (>= 60 dB and >= INT8_WAVE_SNR_FLOOR), K1's sweeps in the
     rule's form (float32 the tile form, bf16 the pair form); the pipelined CLI
     (a writer thread, batches in flight) over 4 copies of the 8 wavs, 4
     batches: its wavs equal a window of 1's byte for byte, and each
     dtype's audio-s/s and device idle share of the loop; profile one
     float32 and one bfloat16 batch, and the bf16 weight packing's device
     time;
  5. drive the serving path: the daemon of `fullsubnet_plus_torch.cli.serve`
     (its default dtype, int8; 8 slots; in this process on a free port)
     serves 12 concurrent seeded clients of 3-10 s fed faster than real
     time; check every reply, zero tick failures, that K5 was launched, and
     each stream against the same stream drained offline through a
     StreamingEngine in int8 on the card (>= 60 dB); profile one serving
     batch;
  6. drive the training path: `make_train_step` at the full width of
     configs/train.toml (batch 18 of 3.072 s, drop_band 2) on seeded
     waveforms and weights: a few steps in float32 and bfloat16 through
     K2 + K3 and in float32 through K2 + K4; every loss and gradient norm
     finite, nothing skipped, the launch counts as expected, every forward
     sweep in the rule's form (float32 the wave form, bf16 the pair form in
     waves) and every reverse sweep in the rule's (the
     wave form: 144 row tiles on 132 SMs) and K3's weight gradients in the
     rule's tile (the wgmma kernels), the float32 and bf16 K3 steps also
     with the tile form forced and with the mma.sync weight gradients
     forced, timed beside; then the plain
     versions' float32 run, and at each of its steps the same step from a
     copy of its state through the kernels (float32 K2 + K3 and K2 + K4,
     bf16 K2 + K3; each bf16 step's reverse sweeps printed by form),
     loss and gradient norm held to the plain step's, each
     trial launching its two kernels once and the plain step none; a NaN
     batch skipped with the state unchanged bit for bit; `make_eval_step`
     (K1); profile one float32 step, list its matrix product and
     convolution kernels and fail on a TF32 one;
  7. FullSubNet (the baseline) at full width (257 bins, full-band LSTM
     H 512, sub-band H 384, seed 42): K1 in float32 (>= 80 dB) and bf16
     (>= 40 dB) and K5 (>= 40 dB) at its full-band shape (D 257, H 512, O
     257) on the fold of a batch of 8 padded to 10 s (N 8, T 629) against
     their plain versions (K1 in the forward's cluster form and K5 in its
     own, each also against the tile form forced and equal on a repeat; K5
     also on the JAX fixture's `k5_fb` case), timed beside them, cuDNN
     and the bound (K1 and K5 also with the tile form forced), and the
     three at its sub-band shape (D 32, H 384, O 2; N 2056, T 629) against
     their plain versions at the same floors, equal on a repeat; the
     batch of 8 wavs through `run_enhance` with a FullSubNet config
     (`full_band_crm_mask`, written into the temporary directory) in
     float32, bfloat16 and int8, two launches a batch (the full-band and
     the sub-band LSTM; the full-band sweep in K1's or K5's cluster form,
     the sub-band one in the tile form, in bf16 K1's pair form), the
     waveforms of each dtype
     against the same run
     through the plain LSTMs (float32 >= 60 dB, bf16 and int8 >= 40 dB), a
     profile of each batch; one 30 s utterance through
     `overlapped_chunk`; the daemon serving a few streams of it in int8
     (zero tick failures, against the offline engine >= 60 dB);
  8. drive the training driver, `fullsubnet_plus_torch.cli.train` (its
     parse_args and build_trainer in this process, `--device cuda:0`: one
     card on any machine), at the full width of
     configs/train.toml on a seeded synthetic corpus in the DNS layout
     written into the temporary directory (72 clean utterances of 3.5-5 s,
     4 steps an epoch at batch 18, dynamic mixing with noise files and
     RIRs; with_reverb/ and no_reverb/ validation pairs of 3-10 s): float32
     for 2 epochs, then -R for the third, the same 3 epochs unbroken (both
     with deterministic algorithms), bf16 for 1 epoch. Each step launches
     K2 and its dtype's default backward once (`FUSED_WGRAD_BY_DTYPE`: K3
     in both) and the other never,
     each validation batch K1 once; every loss finite, no step skipped; the
     state -R resumed equal to the saved one bit for bit and epoch 3's train
     loss to the unbroken run's within TRAINER_RESUME_RTOL; best_model.npz
     at the epoch the gate last passed; every checkpoint read by the port's
     `.npz` reader with the JAX package's key set. Prints the `trainer` JSON
     line: per run the steps, the median step wall, the trainer's audio-s/s
     over the epochs' training wall, the loader-wait share, validation's
     eval and metric time, and a profile of one more epoch in each dtype;
  9. multi-device (parallel/mesh.py), each rank a process of this script in
     worker mode: (a) the data-parallel `make_train_step(mesh=)` at the width
     of configs/train.toml, 2 ranks of 9 rows over NCCL on 2 cards, or with
     one card 2 ranks sharing it (gloo, as `initialize_distributed` picks
     where ranks outnumber cards) and a 1-rank NCCL group of 18 rows,
     from a copy of phase 6's state: each rank's loss and gradient norm
     against the 1-rank step at batch 18 (float32 within phase 6's
     limits, bf16 within DP_BF16_*), K2 and the default backward once a step on
     every rank, the parameters bit-equal across ranks after 4 steps, the
     step walls beside the 1-rank ones; (b) `cli.train` through its rank
     flags as 2 ranks for 1 float32 epoch on phase 8's corpus: every rank
     finishes with the same loss, rank 0 alone writes files and validates
     (K1); (d) `make_train_step(mesh=)` on a mesh of 2 cards in this
     process (with one card, a mesh naming it twice) from (a)'s state at
     batch 18: rows over 'data' (2 x 1) and the sub-band fold over 'freq'
     with its backward (1 x 2, fold_sharding naming 'freq'), float32 and
     bf16 steps through the defaults against (a)'s 1-card step within phase 6's and
     DP_BF16_*'s limits, K2 and the backward once a step on each card or
     fold half (counted by card), the parameters after the float32 step
     (>= PARAM_SHARE_FLOOR within 1e-4) and after TRAIN_STEPS steps
     against the 1-card run's, the step walls beside (a)'s; K2, K3 and K4
     at a card's fold (N_CARD) against their plain versions and timed;
     (e) `cli.train` without rank flags for 1 float32 epoch on phase 8's
     corpus: `auto_mesh` over every visible card at the TOML's batch (no
     mesh on one card), K2 and the float32 default backward once a step and K1 once a validation batch
     on each card, its checkpoints; (c) `Enhancer(mesh=)` on phase 4's
     batch in float32, bf16 and int8, rows over 'data' and the fold over
     'freq', on 2 cards (with one, a mesh naming it twice), against the
     1-card Enhancer at phase 4's floors with K1 / K5 once a shard on its
     card; prints the `multi_device` JSON line;
 10. the model variants at full width (FullSubNet+ of configs/*.toml, seed
     42): (a) the SE, ECA, CBAM, DeepTSSE and TSSE_ATT attentions, (b)
     subband_num 2 with ECA and (c) the offline Gaussian and cumulative
     Laplace norms, each one float32 batch of 8 through
     `Enhancer.enhance_batch` (phase 4's wavs with their lengths; DeepTSSE,
     TSSE_ATT and subband_num 2, which JAX refuses to mask, 8 wavs of 10 s
     without), K1 once a batch and the waveforms against the same batch
     through the plain LSTM (>= 60 dB); CBAM also in bf16 (K1) and int8
     (K5), their model output (the compressed cIRM) against the plain
     LSTM's >= 40 dB, the waveforms printed beside it; (d) a GRU sub-band
     model's batch,
     finite and with no LSTM kernel launched, timed beside SE's, and the
     loop norms (forgetting, hybrid, sub-band forgetting) timed at the
     batch's shape; (e) the CBAM and TSSE_ATT train steps at
     configs/train.toml's batch through K2 + K4, K2 + K3 and bf16 K2 + K3
     from a copy of the plain step's state, held to phase 6's limits, and
     one float32 TSSE_ATT step profiled (no TF32 product); (f) the
     joint-mask and residual train steps through K2 + K4 against the plain
     step (loss 1e-4, gradient norm 1e-3); (g) the 2-D causal conv blocks
     (`CausalConvBlock` 16 -> 32 then `CausalTransConvBlock` back, on
     [8, 16, 257, 629]) in float32 against the CPU in eval and training
     mode, forward and gradients (>= 80 dB), the running statistics kept,
     profiled (no TF32 product) and timed; prints the `variants` JSON line;
 11. FullSubNet's training at full width (FSN_TOML's [model], seed 42, the
     batch of configs/train.toml: the full-band LSTM at N 18, D 257, H 512,
     O 257, T 195, where the reverse sweep takes its cluster form):
     (a) the sweep's form (clusters of 16 at N 18, the wave form at
     the shipped and sub-band folds), K2, K3 and K4 in float32 and bf16 against
     their plain versions (dx, every weight and bias gradient; >= 80 / 40
     dB; K2 and K4 with the tile form forced too; K2's y equal to K1's), K4's cluster form equal to
     itself with each cluster's rank 0 sending late, K3 equal on a repeat, each
     sweep counted by its form, with the reverse sweep's shared memory in
     each form; (b) the
     JAX fixture's full-band training cases; (c) the FullSubNet train step
     from the plain step's state through float32 K2 + K4, float32 K2 + K3
     and bf16 K2 + K3 (phase 6's limits; each step launching K2 and its
     backward twice: the full-band and the sub-band LSTM), the float32
     default timed and profiled (no TF32 product), its forward sweeps the
     cluster form at the full-band fold and the wave form at the sub-band
     one (bf16's the pair form in waves), its reverse sweeps the cluster form and the wave form, and
     timed again with the sub-band sweep's tile form forced and with K3's
     weight gradients on the mma.sync kernels forced;
     (d) one float32 epoch of
     the trainer (the CLI's functions) on phase 8's corpus, its checkpoints
     in the JAX package's FullSubNet keys, and one more epoch profiled;
     (e) K2, K3, K4 timed beside their plain versions, bounds and cuDNN,
     each also with the tile form forced;
 12. print the kernels' JSON line (with K1's, K2's and K5's form at each
     fold, and K3's and K4's reverse sweep's and bf16 sweep functions),
     the card's name and power limit, and
     the `{"ok": true, ...}` line last.

Imports nothing of JAX. Exits non-zero without CUDA. `python3 chip_smoke.py
--dp-rank|--cli-rank JOB RANK` is phase 9's worker, started by the script.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import importlib.util
import json
import os
import re
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
SCRIPT = os.path.abspath(__file__)  # phase 9 starts its ranks as this script's workers
SR = 16000
BATCH = 8
# The batch path's sub-band fold for a batch of 8 padded to 10 s: N = 8 * 257
# rows; T = 1 + (160000 + 256) // 256 STFT frames (the length-aware path
# extends the bucket by one hop) + 2 look-ahead frames = 629.
N_FULL, D, H, O, T_FULL = BATCH * 257, 34, 384, 2, 629
SB = (D, H, O)  # FullSubNet+'s sub-band LSTM: (D, H, O)
# FullSubNet's full-band LSTM (its `fb_model`): 257 bins in and out, H 512. Its
# fold of a batch of 8 padded to 10 s is N 8 rows, T 629.
FB = (257, 512, 257)
N_FB = BATCH
# FullSubNet's sub-band LSTM (its `sb_model`: 31 magnitude neighbours + 1
# full-band output in, H 384, O 2) on the batch's sub-band fold, N_FULL rows
FSN_SB = (32, 384, 2)
# FullSubNet's batch runs: (tag, run_enhance's compute_dtype, the kernel of both LSTMs)
FSN_DTYPES = (("float32", None, "lstm2_fwd"), ("bfloat16", "bfloat16", "lstm2_fwd"),
              ("int8", "int8", "lstm2_int8_fwd"))
FSN_STREAMS = 4  # serving clients of the FullSubNet daemon
FSN_LONG_S = 30  # seconds of the utterance through `overlapped_chunk`
N_RAGGED, T_RAGGED = 3 * 257, 37
# The serving fold: 8 slots of 4 s chunks with 256 samples of pre-context,
# N = 8 * 257, T = 1 + (64256 + 256) // 256 + 2 = 255.
SLOTS, CHUNK_S = 8, 4
N_SERVE, T_SERVE = SLOTS * 257, 1 + (CHUNK_S * SR + 256 + 256) // 256 + 2
# The training fold (configs/train.toml): batch 18 of 3.072 s with 2 drop-band
# groups leaves 18 * (257 // 2) rows; T = 49152 // 256 + 1 frames + 2 look-ahead.
TRAIN_BATCH, TRAIN_SAMPLES, TRAIN_STEPS = 18, 49152, 4
N_TRAIN, T_TRAIN = TRAIN_BATCH * (257 // 2), TRAIN_SAMPLES // 256 + 1 + 2
# Kernel against plain version. float32 differs by sum order and expf/tanhf
# only (measured 95-140 dB); in bf16 single roundings of h, the residuals and
# the dgates flip and carry through the recurrence, and a weight gradient
# sums N * T = 449,280 such terms (measured 55-80 dB).
SNR_FLOOR = {torch.float32: 80.0, torch.bfloat16: 40.0}
# Training through the kernels against the plain versions, step by step from
# the same state (the plain run's, at each of its TRAIN_STEPS steps): the loss
# and the gradient's global norm of one step from one state, where only sum
# order and expf / tanhf differ (a free-running trajectory is no measure: an
# early Adam step is lr * g / |g|, and an element whose gradient sits at
# Adam's eps takes either sign; scripts/train_divergence.py).
TRAIN_LOSS_RTOL, TRAIN_GRAD_NORM_RTOL = 1e-4, 1e-3
TRAIN_BF16_LOSS_RTOL = 0.1  # bf16 compute against the float32 plain run
# Phase 9: the 2-rank data-parallel step (9 rows a rank) against the 1-rank
# step at batch 18 from the same state: float32 within phase 6's limits;
# bf16, where the two batch sizes round differently in bf16 outside the LSTM
# (the convolutions' and products' algorithms by batch size), within these
DP_RANKS, DP_ROWS = 2, TRAIN_BATCH // 2
DP_BF16_LOSS_RTOL, DP_BF16_GRAD_NORM_RTOL = 1e-2, 0.1
# Phase 9 (d): the one-process training meshes, (name, [data, freq], the
# config's fold_sharding); on either, a card sweeps half of the training fold
TRAIN_MESHES = (("data", (2, 1), None), ("freq", (1, 2), ("data", "freq")))
N_CARD = N_TRAIN // 2
# (d): the share of parameters within 1e-4 of the 1-card run's after one
# float32 step from the same state (the CPU trajectory tests' 99 %)
PARAM_SHARE_FLOOR = 0.99
PIPELINE_COPIES = 4  # phase 4's pipelined run: each of the 8 wavs 4 times, 4 batches
INT8_SNR_FLOOR = 40.0
WAVE_SNR_FLOOR = 60.0
INT8_WAVE_SNR_FLOOR = 40.0  # kernel against plain int8 LSTM, through the bf16 model
BF16_WAVE_SNR_FLOOR = 40.0  # kernels against plain bf16 LSTMs, through the bf16 model
MAIN_PATH_RUNS = 3  # run_enhance calls per dtype; the host clock of one batch is noisy
STREAMS = 12  # concurrent serving clients
FEED_SPEEDUP = 10.0  # clients send audio this many times faster than real time
# H100 SXM published peaks (NVIDIA data sheet, dense): float32 outside the
# tensor cores, bf16 and int8 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32 = 494.7e12  # the float32 sweeps' products: three TF32 products each
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


KERNEL_SOURCES = ("lstm2_fwd", "lstm2_int8_fwd", "lstm2_train_fwd", "lstm2_bwd_wgrad",
                  "lstm2_bwd")  # csrc/<name>.cu
SWEEP_SOURCES = ("lstm2_fwd", "lstm2_train_fwd", "lstm2_bwd_wgrad", "lstm2_bwd")  # bf16 mma sweeps
FWD_SOURCES = ("lstm2_fwd", "lstm2_train_fwd")  # K1, K2: the float32 sweep on mma.sync too
BWD_SOURCES = ("lstm2_bwd_wgrad", "lstm2_bwd")  # K3, K4: the float32 reverse sweep likewise
TF32_HMMA = "HMMA.1688.F32.TF32"  # mma.sync m16n8k8 on TF32 operands, float32 sums
FIXTURE_GENERATOR = os.path.join(REPO, "tests", "fixtures", "gen_torch_kernel_fixture.py")
# K5's sweeps: the tile form `int8_sweep_kernel`, the cluster form `int8_sweep_cluster_kernel`
INT8_SWEEP = re.compile(r"int8_sweep_(cluster_)?kernel")
# K3's weight-gradient kernels: on mma.sync `wgrad_mma_kernel` (bf16), `wgrad_tf32_kernel`
# (float32, 3xTF32); on wgmma `wgrad_wgmma_kernel` (bf16), `wgrad_wgmma_tf32_kernel`
# (float32, 3xTF32) and the reduction of their runs' partials, `wgmma_reduce_kernel`;
# `wgrad_kernel` was the float32 FMA kernel, which must not come back
WGRAD_KERNEL = re.compile(r"wgrad_(mma_|tf32_|wgmma_(tf32_)?)?kernel|wgmma_reduce_kernel")
# spill store bytes allowed to the bf16 reverse sweep's functions by threads
# (`sweep_mma_kernel<bf16, 384 | 512>`): what ptxas gives its schedule (PERF.md); more fails
# phase 1
BF16_SWEEP_SPILL_STORES = {384: 264, 512: 56}
# spill store bytes allowed to the forward's bf16 pair form (`sweep_pair_kernel<bf16, kSave,
# 384 | 512>`, in K1's and K2's libraries; 384 threads at H 384): what ptxas gives it
# (PERF.md); more fails phase 1
PAIR_SWEEP_SPILL_STORES = {384: 0, 512: 28}
# kernel names of a matrix product or convolution that computes in TF32 (CUTLASS's
# s1688 / s16816 tensor-op GEMMs take float32 operands as TF32 unless named for bf16 / f16)
TF32_KERNEL = re.compile(r"tf32|s1688gemm(?!_bf16|_f16)|s16816gemm(?!_bf16|_f16)", re.IGNORECASE)


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


def lstm_bound_ms(n: int, t: int, dtype: torch.dtype, fma: bool = False,
                  shape=SB) -> tuple[float, str]:
    """K1 at `shape` (D, H, O): its operations over the peak rate for its
    type, against its bytes (inputs read once, output written once). float32
    runs each product as three TF32 products (TF32 peak); `fma` gives the FMA
    bound instead."""
    d, h, o = shape
    size = torch.tensor([], dtype=dtype).element_size()
    flops = 2 * n * t * (d + 3 * h) * 4 * h + 2 * n * t * h * o
    nbytes = (n * d * t * size + (d + 3 * h) * 4 * h * size + 2 * 4 * h * 4 + h * o * 4 + o * 4
              + n * t * o * size)
    return bound(sweep_ops_s(flops, dtype, fma), nbytes)


def sweep_ops_s(flops: float, dtype: torch.dtype, fma: bool = False) -> float:
    """Seconds of a sweep's products (forward or reverse) at the card's
    peak: bf16 on the tensor cores; float32 as three TF32 products each, or
    as FMAs."""
    if dtype == torch.float32 and not fma:
        return 3 * flops / PEAK_TF32
    return flops / PEAK_FLOPS[dtype]


def int8_bound_ms(n: int, t: int, shape=SB) -> tuple[float, str]:
    """K5 at `shape` (D, H, O): the int8 products (h1q U1q, [h1q|h2q][W2q;U2q])
    at the int8 peak plus the bf16 ones (x W1, the fc) at the bf16 peak,
    against the bytes of x, the weights, scales, biases and the output."""
    d, h, o = shape
    t_ops = (2 * n * t * 3 * h * 4 * h / PEAK_INT8_OPS
             + 2 * n * t * (d * 4 * h + h * o) / PEAK_FLOPS[torch.bfloat16])
    nbytes = (n * d * t * 2 + d * 4 * h * 2 + 3 * h * 4 * h + 4 * 4 * h * 4 + h * o * 4 + o * 4
              + n * t * o * 2)
    return bound(t_ops, nbytes)


def lstm_modules(dtype: torch.dtype, seed: int, shape=SB):
    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2

    d, h, o = shape
    g = torch.Generator().manual_seed(seed)
    lstm, fc = LSTM2(d, h), Linear(h, o)
    lstm.reset_parameters(g)
    fc.reset_parameters(g)
    return lstm.to("cuda", dtype), fc.to("cuda", dtype), g


def lstm_input(n: int, t: int, dtype: torch.dtype, g: torch.Generator, d: int = D) -> torch.Tensor:
    # a normalized input is positive with mean 1 (offline Laplace norm)
    return torch.rand(n, d, t, generator=g).mul_(2.0).to("cuda", dtype)


def lstm_operands(n: int, t: int, dtype: torch.dtype, seed: int, shape=SB):
    lstm, fc, g = lstm_modules(dtype, seed, shape)
    return lstm_input(n, t, dtype, g, shape[0]), lstm.packed(fc), lstm, fc


def int8_operands(n: int, t: int, seed: int, shape=SB):
    lstm, fc, g = lstm_modules(torch.bfloat16, seed, shape)
    return lstm_input(n, t, torch.bfloat16, g, shape[0]), lstm.prepare_int8(fc), lstm, fc


def cudnn_modules(lstm, fc, dtype: torch.dtype):
    """torch.nn.LSTM (cuDNN) and Linear with the same weights; yardsticks
    that the port never calls."""
    ref = torch.nn.LSTM(lstm.weight_ih_l0.shape[1], lstm.hidden_size, num_layers=2,
                        batch_first=True)
    ref.load_state_dict({k: v.float().cpu() for k, v in lstm.state_dict().items()})
    ref = ref.to("cuda", dtype)  # .to() packs the weights for cuDNN
    linear = torch.nn.Linear(*reversed(fc.weight.shape))
    linear.load_state_dict({k: v.float().cpu() for k, v in fc.state_dict().items()})
    return ref, linear.to("cuda", dtype)


def cudnn_lstm(lstm, fc, dtype: torch.dtype):
    """cuDNN's 2-layer LSTM + Linear forward: float32 without TF32, so it
    computes at K1's precision."""
    ref, linear = cudnn_modules(lstm, fc, dtype)

    def run(x):
        x_ntd = x.transpose(1, 2).contiguous()
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return linear(ref(x_ntd)[0])

    ref.flatten_parameters()
    return run


def sass_instruction_counts(lib, opcode: str, operand_type: str = "") -> dict:
    """{kernel function: count of `opcode` instructions (whose line also
    names `operand_type`, e.g. ".BF16")} in a built library (`cuobjdump
    -sass`, from the CUDA toolkit nvcc came from)."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME, "bin", "cuobjdump") if CUDA_HOME else "cuobjdump"
    proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass {lib.name}: {proc.stderr.strip()[:200]}")
    counts, function = {}, None
    for line in proc.stdout.splitlines():
        if "Function : " in line:
            function = line.split("Function : ", 1)[1].strip()
            counts[function] = 0
        elif function is not None and f" {opcode}" in line and operand_type in line:
            counts[function] += 1
    return counts


def ptxas_functions(lib) -> dict:
    """{kernel function: (registers, spill store bytes, spill load bytes)}
    from the ptxas report (`-Xptxas -v`) that nvcc.build keeps beside `lib`."""
    report = lib.with_name(lib.stem + ".ptxas.txt")
    out, function = {}, None
    for line in report.read_text().splitlines() if report.exists() else []:
        if "Compiling entry function" in line:
            function = line.split("'")[1]
            out[function] = [0, 0, 0]
        elif function is not None and (m := re.search(r"(\d+) bytes spill stores, "
                                                      r"(\d+) bytes spill loads", line)):
            out[function][1:] = [int(m[1]), int(m[2])]
        elif function is not None and (m := re.search(r"Used (\d+) registers", line)):
            out[function][0] = int(m[1])
    return {f: tuple(v) for f, v in out.items()}


def phase_build() -> dict:
    """Builds the kernels; returns the HMMA count of each sweep function in
    the libraries of K1 and K2 (forward) and K3 and K4 (reverse), and of
    K3's weight-gradient functions with their registers and spills."""
    from fullsubnet_plus_torch.ops import nvcc

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:  # one nvcc per source, together
        libs = list(pool.map(nvcc.build, KERNEL_SOURCES))
    print(f"[1] built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for lib in libs:
        ptxas = lib.with_name(lib.stem + ".ptxas.txt")
        for line in ptxas.read_text().splitlines() if ptxas.exists() else []:
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"    ptxas {lib.stem.rsplit('_', 1)[0]}:", line.strip()[:160])
    hmma = {}
    for lib in libs:
        stem = lib.stem.rsplit("_", 1)[0]
        if stem == "lstm2_int8_fwd":
            hmma[stem] = int8_functions(lib)
        if stem not in SWEEP_SOURCES:
            continue
        sweeps = {f: n for f, n in sass_instruction_counts(lib, "HMMA").items() if "sweep" in f}
        for function, n in sweeps.items():
            print(f"[1] {stem}: {function} has {n} HMMA instructions")
        mma = [n for f, n in sweeps.items() if "sweep_mma_kernel" in f and "bfloat16" in f]
        if not mma or min(mma) == 0:
            fail(f"{stem}: the bf16 sweep has no tensor-core instructions")
        if any("sweep_kernelI13__nv_bfloat16" in f for f in sweeps):
            fail(f"{stem}: a bf16 instantiation of the FMA sweep was compiled")
        if stem in FWD_SOURCES:
            hmma[f"{stem}_float32_sweep"] = check_float32_forward(lib, stem, sweeps)
            hmma[f"{stem}_cluster_sweep"] = cluster_functions(lib, stem)
            hmma[f"{stem}_pair_sweep"] = pair_functions(lib, stem, sweeps)
        if stem in BWD_SOURCES:
            hmma[f"{stem}_float32_sweep"] = check_float32_reverse(lib, stem, sweeps)
            hmma[f"{stem}_cluster_sweep"] = cluster_functions(lib, stem)
            hmma[f"{stem}_bf16_sweep"] = bf16_sweep_functions(lib, stem)
        hmma[stem] = sweeps
        if stem == "lstm2_bwd_wgrad":
            hmma["wgrad"] = wgrad_functions(lib)
    return hmma


def int8_functions(lib) -> dict:
    """K5's sweep runs every product on the tensor cores: each instantiation
    of the tile form `int8_sweep_kernel` and the cluster form
    `int8_sweep_cluster_kernel` has IMMA (the s8 products) and HMMA (x W1
    and the fc in bf16) instructions, and the library has no IDP (`__dp4a`)
    one. Returns {function: {imma, hmma, registers, spill bytes}} and prints
    them."""
    counts = {op: sass_instruction_counts(lib, op) for op in ("IMMA", "HMMA", "IDP")}
    ptxas = ptxas_functions(lib)
    out = {}
    for function in (f for f in counts["IMMA"] if INT8_SWEEP.search(f)):
        regs, spill_st, spill_ld = ptxas.get(function, (None, None, None))
        imma, hmma = counts["IMMA"][function], counts["HMMA"][function]
        print(f"[1] lstm2_int8_fwd: {function} has {imma} IMMA, {hmma} HMMA, "
              f"{counts['IDP'][function]} IDP instructions; ptxas: {regs} registers, "
              f"{spill_st} bytes spill stores, {spill_ld} bytes spill loads")
        out[function] = {"imma": imma, "hmma": hmma, "registers": regs,
                         "spill_store_bytes": spill_st, "spill_load_bytes": spill_ld}
    if not out or min(min(v["imma"], v["hmma"]) for v in out.values()) == 0:
        fail("lstm2_int8_fwd: the int8 sweep lacks IMMA or HMMA instructions")
    if not any("int8_sweep_cluster_kernel" in f for f in out):
        fail("lstm2_int8_fwd: the cluster form was not compiled")
    if any(counts["IDP"].values()):
        fail("lstm2_int8_fwd: __dp4a (IDP) instructions were compiled")
    return out


def check_float32_forward(lib, stem: str, sweeps: dict) -> dict:
    """K1's and K2's float32 sweep runs every product on the tensor cores
    as TF32 products: each float32 instantiation of `sweep_mma_kernel` (the
    tile and wave forms' kernel) has HMMA.1688.F32.TF32 instructions, and no
    FMA forward sweep is compiled. Returns {function: {tf32_hmma,
    registers, spill bytes}} and prints them."""
    tf32 = {f: n for f, n in sass_instruction_counts(lib, TF32_HMMA).items()
            if "sweep_mma_kernelIf" in f}
    ptxas = ptxas_functions(lib)
    out = {}
    for function, n in tf32.items():
        regs, spill_st, spill_ld = ptxas.get(function, (None, None, None))
        print(f"[1] {stem}: {function} has {n} {TF32_HMMA} instructions; ptxas: {regs} "
              f"registers, {spill_st} bytes spill stores, {spill_ld} bytes spill loads")
        out[function] = {"tf32_hmma": n, "registers": regs, "spill_store_bytes": spill_st,
                         "spill_load_bytes": spill_ld}
    if not tf32 or min(tf32.values()) == 0:
        fail(f"{stem}: the float32 forward sweep has no {TF32_HMMA} instructions")
    if any(f.startswith("_ZN3fwd12sweep_kernel") for f in sweeps):
        fail(f"{stem}: an FMA forward sweep was compiled")
    return out


def check_float32_reverse(lib, stem: str, sweeps: dict) -> dict:
    """K3's and K4's float32 reverse sweep runs its three products on the
    tensor cores as TF32 products: each float32 instantiation of
    `bwd::sweep_mma_kernel` has HMMA.1688.F32.TF32 instructions, and no FMA
    reverse sweep (`bwd::sweep_kernel`) is compiled. Returns {function:
    {tf32_hmma, registers, spill bytes}} and prints them."""
    tf32 = {f: n for f, n in sass_instruction_counts(lib, TF32_HMMA).items()
            if f.startswith("_ZN3bwd16sweep_mma_kernelIf")}
    ptxas = ptxas_functions(lib)
    out = {}
    for function, n in tf32.items():
        regs, spill_st, spill_ld = ptxas.get(function, (None, None, None))
        print(f"[1] {stem}: {function} has {n} {TF32_HMMA} instructions; ptxas: {regs} "
              f"registers, {spill_st} bytes spill stores, {spill_ld} bytes spill loads")
        out[function] = {"tf32_hmma": n, "registers": regs, "spill_store_bytes": spill_st,
                         "spill_load_bytes": spill_ld}
    if not tf32 or min(tf32.values()) == 0:
        fail(f"{stem}: the float32 reverse sweep has no {TF32_HMMA} instructions")
    if any(f.startswith("_ZN3bwd12sweep_kernel") for f in sweeps):
        fail(f"{stem}: an FMA reverse sweep was compiled")
    return out


def cluster_functions(lib, stem: str) -> dict:
    """A sweep's cluster form (`fwd::sweep_cluster_kernel<T, kSave>` in K1's
    and K2's libraries, `bwd::sweep_cluster_kernel<T>` in K3's and K4's; 32
    units a CTA): {function: {hmma, tf32_hmma, registers, spill bytes}},
    printed; fails unless both instantiations (float32, bf16) have HMMA
    instructions and the float32 one HMMA.1688.F32.TF32."""
    hmma, tf32 = (sass_instruction_counts(lib, op) for op in ("HMMA", TF32_HMMA))
    ptxas = ptxas_functions(lib)
    out = {}
    for function in (f for f in hmma if "sweep_cluster_kernel" in f):
        regs, spill_st, spill_ld = ptxas.get(function, (None, None, None))
        print(f"[1] {stem}: {function} has {hmma[function]} HMMA, {tf32[function]} "
              f"{TF32_HMMA} instructions; ptxas: {regs} registers, {spill_st} bytes spill "
              f"stores, {spill_ld} bytes spill loads")
        out[function] = {"hmma": hmma[function], "tf32_hmma": tf32[function], "registers": regs,
                         "spill_store_bytes": spill_st, "spill_load_bytes": spill_ld}
    if len(out) != 2 or min(v["hmma"] for v in out.values()) == 0:
        fail(f"{stem}: the cluster sweep's two functions lack tensor-core instructions")
    if any(v["tf32_hmma"] == 0 for f, v in out.items() if "kernelIf" in f):
        fail(f"{stem}: a float32 cluster sweep has no {TF32_HMMA} instructions")
    return out


def pair_functions(lib, stem: str, hmma: dict) -> dict:
    """The forward sweep's bf16 pair form in K1's and K2's libraries
    (`fwd::sweep_pair_kernel`, its 384- and 512-thread functions), with
    their HMMA counts (`hmma`: the library's sweeps'): {function: {hmma,
    registers, spill bytes}}, printed; fails unless both were compiled with
    HMMA instructions, or on more spill stores than PAIR_SWEEP_SPILL_STORES
    allows."""
    ptxas = ptxas_functions(lib)
    out = {}
    for function in (f for f in ptxas if "sweep_pair_kernel" in f):
        regs, spill_st, spill_ld = ptxas[function]
        threads = next((t for t in PAIR_SWEEP_SPILL_STORES if f"Li{t}E" in function), None)
        print(f"[1] {stem}: {function} (bf16 pair form, {threads} threads) has "
              f"{hmma.get(function, 0)} HMMA instructions; ptxas: {regs} registers, {spill_st} "
              f"bytes spill stores, {spill_ld} bytes spill loads (allowed: "
              f"{PAIR_SWEEP_SPILL_STORES.get(threads)} bytes spill stores)")
        out[function] = {"threads": threads, "hmma": hmma.get(function, 0), "registers": regs,
                         "spill_store_bytes": spill_st, "spill_load_bytes": spill_ld}
        if threads is None or spill_st > PAIR_SWEEP_SPILL_STORES[threads]:
            fail(f"{stem}: the pair form's {function} spills {spill_st} bytes, more than the "
                 f"{PAIR_SWEEP_SPILL_STORES.get(threads)} allowed")
    if len(out) != 2 or min(v["hmma"] for v in out.values()) == 0:
        fail(f"{stem}: the pair form's two functions were not both compiled with tensor-core "
             f"instructions")
    return out


def bf16_sweep_functions(lib, stem: str) -> dict:
    """The bf16 reverse sweep in K3's and K4's libraries (`bwd::sweep_mma_kernel`
    in bf16, its 384- and 512-thread functions): {function: {registers,
    spill bytes}}, printed; fails on more spill store bytes than
    BF16_SWEEP_SPILL_STORES allows."""
    ptxas = ptxas_functions(lib)
    out = {}
    for function in (f for f in ptxas if f.startswith("_ZN3bwd16sweep_mma_kernelI13__nv_bfloat16")):
        regs, spill_st, spill_ld = ptxas[function]
        threads = next((t for t in BF16_SWEEP_SPILL_STORES if f"Li{t}E" in function), None)
        print(f"[1] {stem}: {function} (bf16, {threads} threads) ptxas: {regs} registers, "
              f"{spill_st} bytes spill stores, {spill_ld} bytes spill loads (allowed: "
              f"{BF16_SWEEP_SPILL_STORES.get(threads)} bytes spill stores)")
        out[function] = {"threads": threads, "registers": regs, "spill_store_bytes": spill_st,
                         "spill_load_bytes": spill_ld}
        if threads is None or spill_st > BF16_SWEEP_SPILL_STORES[threads]:
            fail(f"{stem}: the bf16 reverse sweep {function} spills {spill_st} bytes, more than "
                 f"the {BF16_SWEEP_SPILL_STORES.get(threads)} allowed")
    if len(out) != 2:
        fail(f"{stem}: the bf16 reverse sweep's two functions were not both compiled")
    return out


def wgrad_functions(lib) -> dict:
    """K3's weight-gradient functions: {function: {hmma, tf32_hmma,
    hgmma_bf16, hgmma_tf32, registers, spill bytes}}, printed; fails unless
    the bf16 mma.sync one has HMMA instructions, each float32 mma.sync one
    (`wgrad_tf32_kernel`, a function a tile shape) HMMA.1688.F32.TF32, each
    bf16 `wgrad_wgmma_kernel` BF16 HGMMA (wgmma) instructions and each
    `wgrad_wgmma_tf32_kernel` TF32 HGMMA, and if any FMA `wgrad_kernel` was
    compiled."""
    hmma, tf32 = (sass_instruction_counts(lib, op) for op in ("HMMA", TF32_HMMA))
    hgmma_bf16, hgmma_tf32 = (sass_instruction_counts(lib, "HGMMA", kind)
                              for kind in (".BF16", ".TF32"))
    ptxas = ptxas_functions(lib)
    out = {}
    for function in (f for f in hmma if WGRAD_KERNEL.search(f)):
        regs, spill_st, spill_ld = ptxas.get(function, (None, None, None))
        print(f"[1] lstm2_bwd_wgrad: {function} has {hmma[function]} HMMA, {tf32[function]} "
              f"{TF32_HMMA}, {hgmma_bf16[function]} BF16 HGMMA, {hgmma_tf32[function]} TF32 "
              f"HGMMA instructions; ptxas: {regs} registers, {spill_st} bytes spill "
              f"stores, {spill_ld} bytes spill loads")
        out[function] = {"hmma": hmma[function], "tf32_hmma": tf32[function],
                         "hgmma_bf16": hgmma_bf16[function], "hgmma_tf32": hgmma_tf32[function],
                         "registers": regs, "spill_store_bytes": spill_st,
                         "spill_load_bytes": spill_ld}
    wgmma = [v["hgmma_bf16"] for f, v in out.items() if "wgrad_wgmma_kernel" in f]
    if not wgmma or min(wgmma) == 0:
        fail("lstm2_bwd_wgrad: the bf16 wgmma weight gradients have no BF16 HGMMA instructions")
    wgmma = [v["hgmma_tf32"] for f, v in out.items() if "wgrad_wgmma_tf32_kernel" in f]
    if not wgmma or min(wgmma) == 0:
        fail("lstm2_bwd_wgrad: the float32 wgmma weight gradients have no TF32 HGMMA "
             "instructions")
    mma = [v["hmma"] for f, v in out.items() if "wgrad_mma_kernel" in f]
    if not mma or min(mma) == 0:
        fail("lstm2_bwd_wgrad: the bf16 weight gradients have no tensor-core instructions")
    f32 = [v["tf32_hmma"] for f, v in out.items() if "wgrad_tf32_kernel" in f]
    if not f32 or min(f32) == 0:
        fail(f"lstm2_bwd_wgrad: the float32 weight gradients have no {TF32_HMMA} instructions")
    if any("wgrad_kernel" in f for f in out):
        fail("lstm2_bwd_wgrad: an FMA wgrad_kernel was compiled")
    return out


def fixture_generator():
    """tests/fixtures/gen_torch_kernel_fixture.py, loaded by path (it
    imports JAX only to make the fixture, never here)."""
    spec = importlib.util.spec_from_file_location("gen_torch_kernel_fixture", FIXTURE_GENERATOR)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_check_fixture(probed: bool = False, phase: str = "[2]") -> dict:
    """Each kernel through the port's entry points on the card against the
    JAX kernel's outputs in the committed fixture; {(kernel, dtype): least
    SNR}. `probed`: the full-band training cases (their weight gradients
    stored through probes; phase 11) instead of the others."""
    gen = fixture_generator()
    fixture = gen.load_fixture()
    least = {}
    for name, (kernel, n, t, d, h, o, dtype, _, fused) in gen.CASES.items():
        if gen.probed(name) != probed:
            continue
        reset_launches()
        got = gen.port_run(name, "cuda")
        torch.cuda.synchronize()
        launched = {k: v for k, v in all_launches().items() if v}
        snrs = {k: snr_db(torch.from_numpy(np.asarray(v)), torch.from_numpy(np.asarray(got[k])))
                for k, v in fixture[name].items()}
        floor = INT8_SNR_FLOOR if kernel == "k5" else SNR_FLOOR[getattr(torch, dtype)]
        worst_key = min(snrs, key=snrs.get)
        print(f"{phase} {name} (N={n} T={t} H={h} O={o}) against the JAX fixture: least "
              f"{snrs[worst_key]:.1f} dB ({worst_key}; floor {floor:.0f}); launches {launched}")
        names = {"k1": ["lstm2_fwd"], "k5": ["lstm2_int8_fwd"],
                 "train": ["lstm2_train_fwd", "lstm2_bwd_wgrad" if fused else "lstm2_bwd"]}[kernel]
        if sorted(launched) != sorted(names):
            fail(f"{name}: launches {launched}, expected one of each of {names}")
        if snrs[worst_key] < floor:
            fail(f"{name} disagrees with the JAX kernel: {snrs[worst_key]:.1f} dB at {worst_key}")
        for k in names:
            key = (k, dtype)
            least[key] = min(least.get(key, np.inf), snrs[worst_key])
    return least


@contextlib.contextmanager
def forced_row_tile(module, rule: str, rows: int):
    """Force a wrapper's row-tile rule, which it reads at call time: the
    forward sweep's (`lstm2.fwd_mma_rows_per_cta`, read by K1 and K2) or
    K5's (`lstm2_int8.int8_rows_per_cta`)."""
    saved = getattr(module, rule)
    setattr(module, rule, lambda *_: rows)
    try:
        yield
    finally:
        setattr(module, rule, saved)


def fwd_forms_at(n: int, shape) -> dict:
    """The forward sweep's form and row tile at fold n of `shape` (D, H, O)
    by the rule on this card, by dtype: {"float32": "wave R16", ...}, the
    form as FWD_SWEEP_FORMS names it."""
    from fullsubnet_plus_torch.ops import lstm2

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        form, rows = lstm2.fwd_sweep_plan(n, *shape, dtype, sms)
        out[str(dtype)[6:]] = f"{lstm2.fwd_form_name(form)} R{rows}"
    return out


def fwd_rule_form(n: int, shape, dtype: torch.dtype) -> str:
    """The forward sweep's form at fold n of `shape` in `dtype` by the rule
    on this card, as FWD_SWEEP_FORMS names it."""
    from fullsubnet_plus_torch.ops import lstm2

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return lstm2.fwd_form_name(lstm2.fwd_sweep_plan(n, *shape, dtype, sms)[0])


# The forward sweep's form at the sub-band folds that the measured rule
# gives, by dtype: at the batch folds (N 2056) the tile form in float32, the
# pair form in one launch in bf16 (65 pairs); at the training folds (N 2304,
# 144 row tiles of 16 on the H100's 132 SMs) the wave form in float32, the
# pair form in waves in bf16 (72 pairs on the 66 the card holds; PERF.md)
BATCH_FWD_FORM = {torch.float32: "tile", torch.bfloat16: "pair"}
TRAIN_FWD_FORM = {torch.float32: "wave", torch.bfloat16: "pair wave"}


def int8_form_name(n: int, shape) -> str:
    """K5's form at fold n of `shape` (D, H, O) by the rule, as
    INT8_SWEEP_FORMS names it."""
    from fullsubnet_plus_torch.ops import lstm2_int8

    form = lstm2_int8.int8_sweep_cluster(n, *shape)
    return f"cluster{form}" if form else "tile"


@contextlib.contextmanager
def forced_fwd_form(form: int):
    """Force the forward sweep's form (`lstm2.FWD_SWEEP_FORM`: 0 the tile
    form, 1 the wave form, 16 the cluster form), which K1 and K2 read at
    call time."""
    from fullsubnet_plus_torch.ops import lstm2

    lstm2.FWD_SWEEP_FORM = form
    try:
        yield
    finally:
        lstm2.FWD_SWEEP_FORM = None


def check_fwd_cluster() -> dict:
    """Phase 2: the forward sweep's form by the rule (the measured forms of
    BATCH_FWD_FORM at the batch folds and TRAIN_FWD_FORM at the training folds,
    clusters of 16 at FullSubNet's full-band folds, N 8 and 18), then K1 at
    the full-band shape on the
    batch's fold (N 8) at a ragged T in the cluster form against its plain
    version and against the tile form forced (the floors), equal on a
    repeat, K2's y equal to K1's bit for bit, each launch counted by its
    form. Returns {dtype: {max_abs_err, snr_db, snr_db_vs_tile, forms}}."""
    from fullsubnet_plus_torch.ops import lstm2
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        folds = {"FullSubNet+ batch N 2056": (N_FULL, *SB, BATCH_FWD_FORM[dtype]),
                 "FullSubNet+ training N 2304": (N_TRAIN, *SB, TRAIN_FWD_FORM[dtype]),
                 "FullSubNet sub-band N 2056": (N_FULL, *FSN_SB, BATCH_FWD_FORM[dtype]),
                 "FullSubNet sub-band training N 2304": (N_TRAIN, *FSN_SB,
                                                         TRAIN_FWD_FORM[dtype]),
                 "FullSubNet full-band N 8": (N_FB, *FB, "cluster16"),
                 "FullSubNet full-band N 18": (N_FB_TRAIN, *FB, "cluster16")}
        for fold, (n, d, h, o, want) in folds.items():
            if fwd_rule_form(n, (d, h, o), dtype) != want:
                fail(f"[2] the forward sweep's form at the {fold} fold, {dtype}: "
                     f"{fwd_rule_form(n, (d, h, o), dtype)}, expected {want}")
        x, w, _, _ = lstm_operands(N_FB, T_RAGGED, dtype, seed=17, shape=FB)
        lstm2.FWD_SWEEP_FORMS.clear()
        y, again = lstm2.lstm2_fc(x, w), lstm2.lstm2_fc(x, w)
        y2, _ = lt.lstm2_train_fwd(x, w)
        with forced_fwd_form(0):
            tile = lstm2.lstm2_fc(x, w)
        torch.cuda.synchronize()
        forms = dict(lstm2.FWD_SWEEP_FORMS)
        ref = lstm2.lstm2_fc_reference(x, w).float()
        snr, err = snr_db(ref, y.float()), float((y.float() - ref).abs().max())
        vs_tile, repeat, same = snr_db(tile.float(), y.float()), torch.equal(y, again), \
            torch.equal(y, y2)
        print(f"[2] lstm2_fwd {str(dtype)[6:]} at the fb_model shape N={N_FB} T={T_RAGGED} in "
              f"the cluster form: SNR {snr:.1f} dB against the plain version, {vs_tile:.1f} dB "
              f"against the tile form forced (floor {SNR_FLOOR[dtype]:.0f}), max_abs {err:.3e}, "
              f"equal on a repeat {repeat}, K2's y equal {same}; forward sweeps by form {forms}")
        if min(snr, vs_tile) < SNR_FLOOR[dtype] or not torch.isfinite(y.float()).all():
            fail(f"[2] the forward's cluster form disagrees at N={N_FB} {dtype}")
        if not (repeat and same):
            fail(f"[2] the forward's cluster form: equal on a repeat {repeat}, K2's y {same}")
        if forms != {"lstm2_fwd cluster16": 2, "lstm2_train_fwd cluster16": 1,
                     "lstm2_fwd tile": 1}:
            fail(f"[2] the forward sweeps' forms: {forms}")
        out[dtype] = dict(max_abs_err=err, snr_db=snr, snr_db_vs_tile=vs_tile, forms=forms)
    return out


def fwd_tile_at(n: int, dtype: torch.dtype) -> str:
    """The forward sweep's form and row tile at fold n of FullSubNet+'s
    sub-band shape by the rule on this card: "tile R32", "wave R16"."""
    return fwd_forms_at(n, SB)[str(dtype)[6:]]


def check_fwd_pair() -> dict:
    """Phase 2: bf16 K1 and K2 in the rule's pair form (`sweep_pair_kernel`,
    a cluster of two CTAs a 32-row tile) at FullSubNet+'s batch fold (N
    2056, one launch; T ragged), its training fold (N 2304, in waves) and
    FullSubNet's sub-band training fold (D 32): K1's y equal on a repeat,
    K2's y equal to K1's, y and the six residuals equal to the R 32 tile
    form forced bit for bit, each at least 40 dB against the plain versions
    (`lstm2_fc_reference`, `lstm2_train_fwd_reference`), each launch counted
    by its form. Returns {fold: {max_abs_err, min_snr_db, form, forms}}."""
    from fullsubnet_plus_torch.ops import lstm2
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    dtype, floor, out = torch.bfloat16, SNR_FLOOR[torch.bfloat16], {}
    for fold, n, t, shape in ((f"batch N {N_FULL}", N_FULL, T_RAGGED, SB),
                              (f"training N {N_TRAIN}", N_TRAIN, T_TRAIN, SB),
                              (f"FullSubNet sub-band training N {N_TRAIN}", N_TRAIN, T_RAGGED,
                               FSN_SB)):
        x, _, lstm, fc = train_operands(n, t, dtype, seed=n + t, shape=shape)
        w = lstm.packed(fc)
        rule = fwd_rule_form(n, shape, dtype)
        lstm2.FWD_SWEEP_FORMS.clear()
        y, again = lstm2.lstm2_fc(x, w), lstm2.lstm2_fc(x, w)
        y2, res = lt.lstm2_train_fwd(x, w)
        with forced_fwd_form(0), forced_row_tile(lstm2, "fwd_mma_rows_per_cta", 32):
            y_tile = lstm2.lstm2_fc(x, w)
            y2_tile, res_tile = lt.lstm2_train_fwd(x, w)
        torch.cuda.synchronize()
        forms = dict(lstm2.FWD_SWEEP_FORMS)
        same = (torch.equal(y, again), torch.equal(y, y2), torch.equal(y, y_tile)
                and torch.equal(y2_tile, y_tile)
                and all(torch.equal(a, b) for a, b in zip(res, res_tile)))
        del y_tile, y2_tile, res_tile
        y_ref, res_ref = lt.lstm2_train_fwd_reference(x, w)
        snr, err = worst((y_ref, *res_ref), (y, *res))
        del y_ref, res_ref, res
        print(f"[2] bf16 K1 and K2 at the {fold} T={t} D={shape[0]} in the {rule} form: least "
              f"SNR {snr:.1f} dB against the plain versions (y and the residuals; floor "
              f"{floor:.0f}), max_abs {err:.3e}; K1 equal on a repeat {same[0]}, K2's y equal "
              f"to K1's {same[1]}, y and the residuals equal to the R 32 tile form forced "
              f"{same[2]}; forward sweeps by form {forms}")
        if rule != (BATCH_FWD_FORM if n == N_FULL else TRAIN_FWD_FORM)[dtype]:
            fail(f"[2] the bf16 forward sweep's form at the {fold} fold: {rule}")
        if snr < floor or not all(same):
            fail(f"[2] the bf16 pair form at the {fold} fold: {snr:.1f} dB, equal on a repeat, "
                 f"to K1's, to the R 32 tile form: {same}")
        if forms != {f"lstm2_fwd {rule}": 2, f"lstm2_train_fwd {rule}": 1, "lstm2_fwd tile": 1,
                     "lstm2_train_fwd tile": 1}:
            fail(f"[2] the bf16 forward sweeps' forms at the {fold} fold: {forms}")
        out[fold] = dict(max_abs_err=err, min_snr_db=snr, form=rule, forms=forms)
        del x, y, y2
        torch.cuda.empty_cache()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    held = {d: lstm2.fwd_pair_clusters(d, H) for d in (SB[0], FSN_SB[0])}
    print(f"[2] pairs the card holds at once (cudaOccupancyMaxActiveClusters): {held}; the rule "
          f"assumes {sms // lstm2.FWD_PAIR_CTAS} ({sms} SMs)")
    if min(held.values()) < sms // lstm2.FWD_PAIR_CTAS:
        fail(f"[2] the card holds {held} pairs at once, fewer than the rule's "
             f"{sms // lstm2.FWD_PAIR_CTAS}: the pair form in one launch would take two waves")
    out["pairs_held"] = held
    return out


def rule_against_parent(fn, n: int, shape, dtype: torch.dtype) -> dict:
    """fn (a forward sweep at fold n of `shape`) in the rule's form against
    the parent's form (the tile form at `fwd_mma_row_tile`'s R, the form the
    rule gave before the pair form), timed in turns (rule, parent, parent,
    rule; the lower of a form's two medians of 3): {rule_form, ms,
    parent_form, parent_ms}."""
    from fullsubnet_plus_torch.ops import lstm2

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    best = {}
    for form in (None, 0, 0, None):
        if form is None:
            took = cuda_ms(fn, reps=3)
        else:
            with forced_fwd_form(0):
                took = cuda_ms(fn, reps=3)
        best[form] = min(best.get(form, np.inf), took)
    return {"rule_form": fwd_rule_form(n, shape, dtype), "ms": best[None],
            "parent_form": f"tile R{lstm2.fwd_mma_row_tile(n, shape[0], shape[1], sms, dtype)}",
            "parent_ms": best[0]}


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
            tile = f" (form and row tile {fwd_tile_at(n, dtype)})"
            print(f"[2] lstm2_fwd vs plain N={n} T={t} {str(dtype)[6:]}{tile}: "
                  f"max_abs {err:.3e}  SNR {snr:.1f} dB (floor {SNR_FLOOR[dtype]:.0f})")
            if snr < SNR_FLOOR[dtype]:
                fail(f"lstm2_fwd disagrees with the plain version: {snr:.1f} dB")
            errors[("lstm2_fwd", n, t, dtype)] = err
    for n, t in ((N_SERVE, T_SERVE), (N_FULL, T_FULL), (N_RAGGED, T_RAGGED)):
        x, w, lstm, _ = int8_operands(n, t, seed=n + t)
        check_prepared(lstm, w)
        lstm2_int8.INT8_SWEEP_FORMS.clear()
        out = lstm2_int8.lstm2_int8_fc(x, w)
        again = lstm2_int8.lstm2_int8_fc(x, w)
        torch.cuda.synchronize()
        if dict(lstm2_int8.INT8_SWEEP_FORMS) != {"lstm2_int8_fwd tile": 2}:
            fail(f"lstm2_int8_fwd at N={n} T={t}: forms {dict(lstm2_int8.INT8_SWEEP_FORMS)}, "
                 f"not the tile form")
        ref = lstm2_int8.lstm2_int8_fc_reference(x, w).float()
        out, repeat = out.float(), torch.equal(out, again)
        if not torch.isfinite(out).all():
            fail(f"lstm2_int8_fwd output not finite at N={n} T={t}")
        snr, err = snr_db(ref, out), float((out - ref).abs().max())
        print(f"[2] lstm2_int8_fwd vs plain N={n} T={t} (row tile {int8_tile_at(n)}): "
              f"max_abs {err:.3e}  SNR {snr:.1f} dB (floor {INT8_SNR_FLOOR:.0f}); "
              f"equal on a repeat: {repeat}")
        if snr < INT8_SNR_FLOOR:
            fail(f"lstm2_int8_fwd disagrees with the plain version: {snr:.1f} dB")
        if not repeat:
            fail(f"lstm2_int8_fwd is not bit-equal on a repeat at N={n} T={t}")
        errors[("lstm2_int8_fwd", n, t)] = err
    print(f"[2] shipped bfloat16 K5 N{N_SERVE} T{T_SERVE} digest {shipped_int8_digest()} (the "
          f"tile form; `scripts/time_torch_fb_train.py --shipped` prints the same line for a "
          f"checkout, equal where the results are equal bit for bit)")
    return errors


def shipped_int8_digest() -> str:
    """A SHA-256 (16 hex digits) of K5's output at the serving fold from
    the operands `scripts/time_torch_fb_train.py --shipped` makes (seed 12),
    so that this tree's digest compares with another checkout's."""
    import hashlib

    from fullsubnet_plus_torch.ops import lstm2_int8

    lstm, fc, g = lstm_modules(torch.bfloat16, 12)
    x = torch.rand(N_SERVE, D, T_SERVE, generator=g).mul_(2.0).to("cuda", torch.bfloat16)
    y = lstm2_int8.lstm2_int8_fc(x, lstm.prepare_int8(fc))
    return hashlib.sha256(y.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def check_prepared(lstm, w) -> None:
    """The fragments K5 reads (packed once by prepare_int8) unpack to the
    int8 weights, W1 with zero padding rows, W_fc and the scales and
    biases; the int8 weights are the numpy quantization of the module's
    bf16 weights."""
    from fullsubnet_plus_torch.ops.lstm2 import deinterleave_gates, unpack_mma_b
    from fullsubnet_plus_torch.ops.lstm2_int8 import prepare_quantized_lstm, unpack_s8_b

    def kq(p):
        return p.detach().to(torch.bfloat16).float().t().cpu().numpy()

    q = prepare_quantized_lstm(kq(lstm.weight_hh_l0),
                               np.concatenate([kq(lstm.weight_ih_l1), kq(lstm.weight_hh_l1)]))
    m, g = w.mma, 4 * H
    w1 = deinterleave_gates(unpack_mma_b(m.w1, g).t())
    same = (torch.equal(deinterleave_gates(unpack_s8_b(m.u1q, g, H).t()), w.u1q)
            and torch.equal(deinterleave_gates(unpack_s8_b(m.w2q, g, 2 * H).t()), w.w2q)
            and torch.equal(w1[:D], w.w1) and not w1[D:].any()
            and torch.equal(unpack_mma_b(m.fc, O).t().float(), w.fc_w)
            and all(torch.equal(deinterleave_gates(getattr(m, k)), getattr(w, k))
                    for k in ("s1", "b1", "s2", "b2"))
            and all(np.array_equal(getattr(w, k).cpu().numpy(), q[k])
                    for k in ("u1q", "w2q", "s1", "s2")))
    if not same:
        fail("the weights lstm2_int8_fwd reads are not the prepared ones")


def int8_tile_at(n: int) -> int:
    from fullsubnet_plus_torch.ops import lstm2_int8

    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    return lstm2_int8.int8_row_tile(n, D, H, sm_count)


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
        fma_ms = lstm_bound_ms(N_FULL, T_FULL, dtype, fma=True)[0]
        fma = f", as FMAs {fma_ms:.3f} ms" if dtype == torch.float32 else ""
        print(f"[3] lstm2_fwd {str(dtype)[6:]} N={N_FULL} T={T_FULL}: kernel {kernel_ms:.3f} ms  "
              f"plain {plain_ms:.3f} ms  cuDNN LSTM+Linear {library_ms:.3f} ms  "
              f"bound {bound_ms:.3f} ms ({bound_by}{fma})")
        times[dtype] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        if dtype == torch.float32:
            times[dtype]["bound_fma_ms"] = fma_ms
        times[dtype].update(row_tile_ms=time_row_tiles(lambda: lstm2.lstm2_fc(x, w), dtype),
                            row_tile=fwd_tile_at(N_FULL, dtype),
                            pack_ms=cuda_ms(lambda: lstm2.pack_fwd_mma(w), reps=5))
        print(f"[3] lstm2_fwd {str(dtype)[6:]} N={N_FULL} T={T_FULL} by row tile of the tile "
              f"form: {times[dtype]['row_tile_ms']} ms (the rule takes "
              f"{times[dtype]['row_tile']}); weight packing alone "
              f"{times[dtype]['pack_ms']:.3f} ms")
        if dtype == torch.bfloat16:
            turns = rule_against_parent(lambda: lstm2.lstm2_fc(x, w), N_FULL, SB, dtype)
            times[dtype]["forms_in_turns"] = turns
            print(f"[3] lstm2_fwd bf16 N={N_FULL} T={T_FULL}: the {turns['rule_form']} form "
                  f"{turns['ms']:.3f} ms, the parent's form ({turns['parent_form']}) "
                  f"{turns['parent_ms']:.3f} ms, in turns; cuDNN LSTM+Linear {library_ms:.3f} ms")
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
    row_tile_ms = {}
    for rows in lstm2_int8.INT8_ROWS_PER_CTA:
        with forced_row_tile(lstm2_int8, "int8_rows_per_cta", rows):
            row_tile_ms[rows] = round(cuda_ms(lambda: lstm2_int8.lstm2_int8_fc(x, w), reps=3), 3)
    print(f"[3] lstm2_int8_fwd N={N_SERVE} T={T_SERVE} by row tile: {row_tile_ms} ms "
          f"(the rule takes {int8_tile_at(N_SERVE)})")
    times["int8"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by, lstm2_fwd_bf16_ms=k1_ms,
                         row_tile_ms=row_tile_ms, row_tile=int8_tile_at(N_SERVE))
    return times


def time_row_tiles(fn, dtype: torch.dtype) -> dict:
    """{R: median ms of fn} at each row tile of the forward sweep's tile form
    in `dtype`."""
    from fullsubnet_plus_torch.ops import lstm2

    out = {}
    for rows in lstm2.FWD_MMA_ROWS_PER_CTA[dtype]:
        with forced_row_tile(lstm2, "fwd_mma_rows_per_cta", rows), forced_fwd_form(0):
            out[rows] = round(cuda_ms(fn, reps=3), 3)
    return out


def train_operands(n: int, t: int, dtype: torch.dtype, seed: int, shape=SB):
    """Seeded operands of the training kernels at `shape` (D, H, O): x [N,
    D, T], the cotangent dy [N, T, O], the LSTM and its Linear."""
    lstm, fc, g = lstm_modules(dtype, seed, shape)
    x = lstm_input(n, t, dtype, g, shape[0])
    dy = torch.randn(n, t, shape[2], generator=g).to("cuda", dtype)
    return x, dy, lstm, fc


def worst(refs, outs) -> tuple[float, float]:
    """(least SNR in dB, largest absolute error) over pairs of tensors."""
    pairs = [(r.float(), o.float()) for r, o in zip(refs, outs)]
    if not all(torch.isfinite(o).all() for _, o in pairs):
        fail("a training kernel's output is not finite")
    return (min(snr_db(r, o) for r, o in pairs),
            max(float((o - r).abs().max()) for r, o in pairs))


def phase_check_train() -> dict:
    """K2, K3 and K4 against their plain versions at the training fold and
    at a ragged one (N not a multiple of the row tile, T odd)."""
    from fullsubnet_plus_torch.ops import lstm2, lstm2_train as lt

    def function_grads(x, dy, lstm, fc, fused):
        before, lt.FUSED_WGRAD = lt.FUSED_WGRAD, fused
        try:
            xg, tensors = x.detach().requires_grad_(), lstm.tensors(fc)
            return torch.autograd.grad(lt.lstm2_fc_train(xg, *tensors), (xg, *tensors), dy)
        finally:
            lt.FUSED_WGRAD = before

    errors = {}
    for n, t in ((N_TRAIN, T_TRAIN), (N_RAGGED, T_RAGGED)):
        for dtype in (torch.float32, torch.bfloat16):
            floor, tag = SNR_FLOOR[dtype], f"N={n} T={t} {str(dtype)[6:]}"
            x, dy, lstm, fc = train_operands(n, t, dtype, seed=n + t + 1)
            w = lstm.packed(fc)
            y_ref, res_ref = lt.lstm2_train_fwd_reference(x, w)
            y, res = lt.lstm2_train_fwd(x, w)
            torch.cuda.synchronize()
            same_primal = torch.equal(y, lstm2.lstm2_fc(x, w))
            k2 = worst((y_ref, *res_ref), (y, *res))
            # the backward kernels read the plain forward's residuals, so
            # only the backward differs from the plain backward
            ref = lt.lstm2_bwd_reference(dy, x, w, res_ref)
            sweep = lt.lstm2_bwd_sweep(dy, x, w, res_ref)
            k4 = worst(ref[:3], sweep[:3])
            want = lt.LSTM2Grads(ref.dx, *lt.weight_grads(x, res_ref, ref.dg1, ref.dg2)[:4],
                                 ref.db1, ref.db2)
            del ref, sweep
            got = lt.lstm2_bwd(dy, x, w, res_ref, fused=True)
            again = lt.lstm2_bwd(dy, x, w, res_ref, fused=True)
            torch.cuda.synchronize()
            k3 = worst(want, got)
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            del want, got, again, y_ref, res_ref, y, res
            forms = worst(function_grads(x, dy, lstm, fc, False),
                          function_grads(x, dy, lstm, fc, True))
            tag += f" (forward {fwd_tile_at(n, dtype)})"
            print(f"[2] training kernels vs plain {tag} (floor {floor:.0f} dB): "
                  f"lstm2_train_fwd {k2[0]:.1f} dB max_abs {k2[1]:.3e}, y equal to "
                  f"lstm2_fwd's: {same_primal}; lstm2_bwd {k4[0]:.1f} dB max_abs {k4[1]:.3e}; "
                  f"lstm2_bwd_wgrad {k3[0]:.1f} dB max_abs {k3[1]:.3e}, equal on a repeat: "
                  f"{repeat}; Function's gradients through K3 vs through K4 {forms[0]:.1f} dB")
            if not same_primal:
                fail(f"lstm2_train_fwd's y differs from lstm2_fwd's at {tag}")
            if not repeat:
                fail(f"lstm2_bwd_wgrad is not deterministic at {tag}")
            for name, (snr, _) in (("lstm2_train_fwd", k2), ("lstm2_bwd", k4),
                                   ("lstm2_bwd_wgrad", k3), ("K3 vs K4 gradients", forms)):
                if snr < floor:
                    fail(f"{name} disagrees at {tag}: {snr:.1f} dB")
            for name, (snr, err) in (("lstm2_train_fwd", k2), ("lstm2_bwd", k4),
                                     ("lstm2_bwd_wgrad", k3)):
                errors[(name, n, t, dtype)] = {"max_abs_err": err, "min_snr_db": snr}
            torch.cuda.empty_cache()
    return errors


def train_bounds(dtype: torch.dtype, fma: bool = False, shape=SB, n: int = N_TRAIN,
                 t: int = T_TRAIN) -> dict:
    """Least ms of K2, K3 and K4 at `shape` (D, H, O) on the fold N x T
    (default: the training fold): operations at the peak rate of the type
    against bytes (each input read once, each output written once; h_{t-1}
    and c_{t-1} are the arrays of h and c read again). In float32 the
    forward and reverse sweeps and K3's weight gradients run each product as
    three TF32 products at the TF32 peak (`fma`: as FMAs at the float32
    peak)."""
    D, H, O = shape  # noqa: N806 - the module's names for the shape
    size = torch.tensor([], dtype=dtype).element_size()
    rows = n * t
    weights = (D + 3 * H) * 4 * H * size + H * O * 4
    sweep_flops = 2 * rows * ((D + 3 * H) * 4 * H + H * O)  # forward and reverse sweep alike
    wgrad_flops = 2 * rows * (D + 3 * H) * 4 * H
    fwd_bytes = rows * (D + O + 12 * H) * size + weights + 2 * 4 * H * 4 + O * 4
    bwd_bytes = rows * (O + 10 * H + 8 * H + D) * size + weights
    wgrad_bytes = rows * (O + D + 12 * H + D) * size + weights + ((D + 3 * H) * 4 * H + 8 * H) * 4
    sweep_s = sweep_ops_s(sweep_flops, dtype, fma)
    return {"lstm2_train_fwd": bound(sweep_s, fwd_bytes),
            "lstm2_bwd": bound(sweep_s, bwd_bytes),
            "lstm2_bwd_wgrad": bound(sweep_s + sweep_ops_s(wgrad_flops, dtype, fma), wgrad_bytes)}


def wgrad_bound(dtype: torch.dtype, fma: bool = False) -> tuple[float, str]:
    """Least ms of K3's weight-gradient kernel alone at the training fold:
    its products 2 N T (D + 3H) 4H at the type's tensor-core peak (float32:
    three TF32 products each at the TF32 peak; `fma`: FMAs at the float32
    peak), against x, h1 and h2 read once and the float32 accumulators read
    and written once a chunk (the chunk's dgates come from the sweep through
    the scratch)."""
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    size = torch.tensor([], dtype=dtype).element_size()
    rows = N_TRAIN * T_TRAIN
    wave = lt.bwd_sweep_form(N_TRAIN, D, H, O, dtype, torch.cuda.get_device_properties(
        0).multi_processor_count) == lt.SWEEP_WAVE  # its own scratch size
    chunks = -(-T_TRAIN // lt.wgrad_chunk_steps(N_TRAIN, H, T_TRAIN, dtype, wave))
    flops = 2 * rows * (D + 3 * H) * 4 * H
    nbytes = rows * (D + 2 * H) * size + chunks * 2 * (D + 3 * H) * 4 * H * 4
    return bound(sweep_ops_s(flops, dtype, fma), nbytes)


def bf16_gemm_products(x, res, dg1, dg2):
    """The four weight-gradient products over all T as bf16 cuBLAS GEMMs on
    operands laid out beforehand (x [T N, D], h1, h2 and the shifted h1, h2
    [T N, H], the dgates [T N, 4H]): a yardstick that the port never calls."""
    steps, n, hidden = res.h1.shape
    x_flat = x.permute(2, 0, 1).reshape(steps * n, -1).contiguous()
    h1, h2 = res.h1.reshape(steps * n, hidden), res.h2.reshape(steps * n, hidden)
    zero = h1.new_zeros(n, hidden)
    h1p, h2p = torch.cat([zero, h1[:-n]]), torch.cat([zero, h2[:-n]])
    g1, g2 = dg1.reshape(steps * n, -1), dg2.reshape(steps * n, -1)
    return lambda: (x_flat.t() @ g1, h1p.t() @ g1, h1.t() @ g2, h2p.t() @ g2)


def wgrad_ms_by_tile(call, dtype: torch.dtype) -> dict:
    """{tile of dU1, dW2, dU2: device ms of the weight-gradient kernel in one
    call of `call`} for each candidate shape of `dtype` (torch.profiler;
    float32's named with its slice rows)."""
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    tiles = lt.WGRAD_F32_TILES if dtype == torch.float32 else lt.WGRAD_H_TILES
    out = {}
    for shape, tile in enumerate(tiles):
        lt.force_wgrad_tile(shape, dtype)
        try:
            kernels = device_ms_by_kernel(call)
        finally:
            lt.force_wgrad_tile(None, dtype)
        out["x".join(map(str, tile))] = round(sum(v for k, v in kernels.items()
                                                  if WGRAD_KERNEL.search(k)), 3)
    return out


def device_ms_by_kernel(fn) -> dict:
    """{kernel name: device ms} of one call of `fn` under torch.profiler,
    after one unprofiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def phase_time_train() -> dict:
    """K2, K4 (its outside products apart) and K3 at the training fold,
    beside their plain versions, their bounds and cuDNN's LSTM + Linear
    forward and backward (never called by the port); K3's and K4's device
    time split into the reverse sweep, the weight-gradient kernel and the
    rest, that kernel beside its own bound and, in bf16, beside the same
    four products as bf16 cuBLAS GEMMs over all T (a yardstick) and at each
    candidate tile, each wgmma kernel beside the mma.sync kernel forced in
    the same call; K3 against K4 plus `weight_grads`, the two forms
    `FUSED_WGRAD` chooses between."""
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, dy, lstm, fc = train_operands(N_TRAIN, T_TRAIN, dtype, seed=3)
        w = lstm.packed(fc)
        _, res = lt.lstm2_train_fwd(x, w)
        sweep = lt.lstm2_bwd_sweep(dy, x, w, res)
        ms = {
            "lstm2_train_fwd": cuda_ms(lambda: lt.lstm2_train_fwd(x, w), reps=3),
            "lstm2_bwd": cuda_ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res), reps=3),
            "lstm2_bwd_wgrad": cuda_ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True), reps=3),
        }
        outside_ms = cuda_ms(lambda: lt.weight_grads(x, res, sweep.dg1, sweep.dg2), reps=3)
        cublas_ms = (cuda_ms(bf16_gemm_products(x, res, sweep.dg1, sweep.dg2), reps=3)
                     if dtype == torch.bfloat16 else None)
        del sweep
        split = {}
        k3_call = lambda: lt.lstm2_bwd(dy, x, w, res, fused=True)  # noqa: E731
        for name, call in (("lstm2_bwd_wgrad", k3_call),
                           ("lstm2_bwd", lambda: lt.lstm2_bwd_sweep(dy, x, w, res))):
            kernels = device_ms_by_kernel(call)
            sweep_ms = sum(v for k, v in kernels.items() if "sweep" in k)
            wgrad_ms = sum(v for k, v in kernels.items() if WGRAD_KERNEL.search(k))
            split[name] = {"sweep_ms": sweep_ms, "wgrad_kernel_ms": wgrad_ms,
                           "other_ms": sum(kernels.values()) - sweep_ms - wgrad_ms}
        k3, k4 = split["lstm2_bwd_wgrad"], split["lstm2_bwd"]
        print(f"[3] {str(dtype)[6:]} device time of one call (torch.profiler): lstm2_bwd_wgrad "
              f"reverse sweep {k3['sweep_ms']:.3f} ms, wgrad_kernel {k3['wgrad_kernel_ms']:.3f} "
              f"ms, other {k3['other_ms']:.3f} ms; lstm2_bwd reverse sweep "
              f"{k4['sweep_ms']:.3f} ms, other {k4['other_ms']:.3f} ms")
        wgrad_bound_ms, wgrad_bound_by = wgrad_bound(dtype)
        yardstick = (f"; the same four products as bf16 cuBLAS GEMMs over all T {cublas_ms:.3f} "
                     f"ms (yardstick), float32 weight_grads {outside_ms:.3f} ms"
                     if cublas_ms is not None else
                     f" (as FMAs {wgrad_bound(dtype, fma=True)[0]:.3f} ms); weight_grads, the same "
                     f"four products as float32 cuBLAS SGEMMs, {outside_ms:.3f} ms")
        print(f"[3] {str(dtype)[6:]} K3's weight-gradient kernel {k3['wgrad_kernel_ms']:.3f} ms, "
              f"bound {wgrad_bound_ms:.3f} ms ({wgrad_bound_by}){yardstick}")
        tile_ms = wgrad_ms_by_tile(k3_call, dtype)
        print(f"[3] {str(dtype)[6:]} weight-gradient kernel by tile of dU1, dW2, dU2 (device ms, "
              f"one call each): {tile_ms} (the rule takes {lt.wgrad_tiles(D, H, dtype)[1]})")
        shapes = lt.WGRAD_F32_TILES if dtype == torch.float32 else lt.WGRAD_H_TILES
        mma_label = "x".join(map(str, shapes[mma_sync_wgrad_tile(dtype, N_TRAIN)]))
        library = (f"bf16 cuBLAS GEMMs {cublas_ms:.3f} ms" if cublas_ms is not None else
                   f"float32 cuBLAS SGEMMs (weight_grads) {outside_ms:.3f} ms")
        for label, wgmma_ms in ((k, v) for k, v in tile_ms.items() if "wgmma" in k):
            print(f"[3] {str(dtype)[6:]} wgmma weight-gradient kernel {label} {wgmma_ms:.3f} ms "
                  f"beside the mma.sync kernel {mma_label} forced in the same call "
                  f"{tile_ms[mma_label]:.3f} ms, bound {wgrad_bound_ms:.3f} ms, {library}")
        tiles = time_row_tiles(lambda: lt.lstm2_train_fwd(x, w), dtype)
        print(f"[3] lstm2_train_fwd {str(dtype)[6:]} N={N_TRAIN} T={T_TRAIN} by row tile of the "
              f"tile form: {tiles} ms (the rule takes {fwd_tile_at(N_TRAIN, dtype)})")
        turns = (rule_against_parent(lambda: lt.lstm2_train_fwd(x, w), N_TRAIN, SB, dtype)
                 if dtype == torch.bfloat16 else None)
        plain = {
            "lstm2_train_fwd": cuda_ms(lambda: lt.lstm2_train_fwd_reference(x, w), reps=2),
            "lstm2_bwd": cuda_ms(lambda: lt.lstm2_bwd_reference(dy, x, w, res), reps=2),
            "lstm2_bwd_wgrad": cuda_ms(lambda: lt.lstm2_bwd_plain(dy, x, w, res, True), reps=2),
        }
        del res
        torch.cuda.empty_cache()

        ref, linear = cudnn_modules(lstm, fc, dtype)
        x_ntd = x.transpose(1, 2).contiguous().requires_grad_()
        wrt = (x_ntd, *ref.parameters(), *linear.parameters())

        def library_fwd():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return linear(ref(x_ntd)[0])

        def library_bwd(y):
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return torch.autograd.grad(y, wrt, dy, retain_graph=True)

        fwd_ms = cuda_ms(library_fwd, reps=3)
        if turns:
            print(f"[3] lstm2_train_fwd bf16 N={N_TRAIN} T={T_TRAIN}: the {turns['rule_form']} "
                  f"form {turns['ms']:.3f} ms, the parent's form ({turns['parent_form']}) "
                  f"{turns['parent_ms']:.3f} ms, in turns; cuDNN LSTM+Linear forward "
                  f"{fwd_ms:.3f} ms")
        y_lib = library_fwd()
        bwd_ms = cuda_ms(lambda: library_bwd(y_lib), reps=3)
        del y_lib
        library = {"lstm2_train_fwd": fwd_ms, "lstm2_bwd": bwd_ms, "lstm2_bwd_wgrad": bwd_ms}
        bounds, fma_bounds = train_bounds(dtype), train_bounds(dtype, fma=True)
        for name in ms:
            bound_ms, bound_by = bounds[name]
            extra = (f" (+ {outside_ms:.3f} ms for the weight-gradient products outside)"
                     if name == "lstm2_bwd" else "")
            fma_ms = fma_bounds[name][0]
            fma = f", as FMAs {fma_ms:.3f} ms" if dtype == torch.float32 else ""
            side = "forward" if name == "lstm2_train_fwd" else "backward"
            print(f"[3] {name} {str(dtype)[6:]} N={N_TRAIN} T={T_TRAIN}: kernel {ms[name]:.3f} ms"
                  f"{extra}  plain {plain[name]:.3f} ms  cuDNN LSTM+Linear {side} "
                  f"{library[name]:.3f} ms  bound {bound_ms:.3f} ms ({bound_by}{fma})")
            times[(name, dtype)] = dict(ms=ms[name], plain_ms=plain[name],
                                        library_ms=library[name], bound_ms=bound_ms,
                                        bound_by=bound_by)
            if name in split:
                times[(name, dtype)]["sweep_ms"] = split[name]["sweep_ms"]
            if dtype == torch.float32:
                times[(name, dtype)]["bound_fma_ms"] = fma_ms
            if name == "lstm2_train_fwd":
                times[(name, dtype)].update(row_tile_ms=tiles, row_tile=fwd_tile_at(N_TRAIN, dtype))
                if turns:
                    times[(name, dtype)]["forms_in_turns"] = turns
        times[("lstm2_bwd_wgrad", dtype)].update(
            wgrad_kernel_ms=k3["wgrad_kernel_ms"], wgrad_bound_ms=wgrad_bound_ms,
            wgrad_bound_by=wgrad_bound_by, wgrad_tile_ms=tile_ms,
            wgrad_mma_sync_ms=tile_ms[mma_label],
            wgrad_library_ms=cublas_ms if dtype == torch.bfloat16 else outside_ms)
        times[("lstm2_bwd", dtype)]["outside_products_ms"] = outside_ms
        fused_ms, unfused_ms = ms["lstm2_bwd_wgrad"], ms["lstm2_bwd"] + outside_ms
        print(f"[3] {str(dtype)[6:]} backward forms: K3 {fused_ms:.3f} ms, K4 + weight_grads "
              f"{unfused_ms:.3f} ms; FUSED_WGRAD's default takes "
              f"{'K3' if lt.fused_wgrad(dtype) else 'K4'}")
        torch.cuda.empty_cache()
    times[("lstm2_bwd_wgrad", torch.float32)]["backward_forms_by_fold"] = backward_forms_by_fold()
    for dtype, by_fold in fwd_forms_by_fold().items():
        times[("lstm2_train_fwd", dtype)]["fwd_forms_by_fold"] = by_fold
    forms = sweep_forms_by_fold()
    for name in ("lstm2_bwd", "lstm2_bwd_wgrad"):
        for dtype in (torch.float32, torch.bfloat16):
            times[(name, dtype)]["sweep_forms_by_fold"] = {
                tag: {k: v for k, v in by.items() if k in ("form", "same_bits", name, "tile")}
                for tag, by in forms[dtype].items()}
    return times


def fwd_forms_by_fold() -> dict:
    """The forward sweep's wave form against its tile form forced (at the
    tile form's own row tile, `fwd_mma_row_tile`), and in bf16 the rule's
    pair form (in waves) beside them: K2 at FullSubNet+'s and FullSubNet's
    sub-band training folds (N 2304, T 195) and K1 at a batch of 9
    utterances (N 2313, 145 row tiles, 73 pairs, T 629), in both dtypes: the
    y (and K2's six residuals) the same bits in every form, timed in turns
    (pair, wave, tile, tile, wave, pair; the lower of a form's two medians
    of 3), beside cuDNN's LSTM + Linear forward on the same input (TF32
    off; never called by the port). Returns {dtype: {fold: {"rule",
    "wave", "tile", ("pair",) "library", "same_bits"}}}."""
    from fullsubnet_plus_torch.ops import lstm2
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        out[dtype] = {}
        for tag, kernel, n, t, shape in (("fullsubnet_plus K2", "K2", N_TRAIN, T_TRAIN, SB),
                                         ("fullsubnet_sb K2", "K2", N_TRAIN, T_TRAIN, FSN_SB),
                                         ("batch of 9 K1", "K1", 2313, T_FULL, SB)):
            x, _, lstm, fc = train_operands(n, t, dtype, seed=6, shape=shape)
            w = lstm.packed(fc)

            def call():
                if kernel == "K1":
                    return (lstm2.lstm2_fc(x, w),)
                y, res = lt.lstm2_train_fwd(x, w)
                return (y, *res)

            got, ms = {}, {}
            pair = lstm2.fwd_sweep_plan(n, *shape, dtype, sms)[0]
            forms = [lstm2.FWD_SWEEP_WAVE, 0]
            if pair in (lstm2.FWD_PAIR, lstm2.FWD_PAIR_WAVE):
                forms.insert(0, pair)
            for form in forms + forms[::-1]:
                with forced_fwd_form(form):
                    if form not in got:
                        got[form] = call()
                    ms.setdefault(form, []).append(cuda_ms(call, reps=3))
            same = all(torch.equal(a, b) for f in forms[1:] for a, b in zip(got[forms[0]], got[f]))
            del got
            torch.cuda.empty_cache()
            library = cudnn_lstm(lstm, fc, dtype)
            library_ms = cuda_ms(lambda: library(x), reps=3)
            best = {f: min(v) for f, v in ms.items()}
            rule = fwd_rule_form(n, shape, dtype)
            paired = (f"the {lstm2.fwd_form_name(forms[0])} form {best[forms[0]]:.3f} ms, "
                      if len(forms) == 3 else "")
            print(f"[3] {kernel} {str(dtype)[6:]} {tag} N={n} D={shape[0]} T={t}: {paired}the "
                  f"wave form {best[lstm2.FWD_SWEEP_WAVE]:.3f} ms, the tile form forced "
                  f"{best[0]:.3f} ms (R {lstm2.fwd_mma_row_tile(n, shape[0], H, sms, dtype)}), "
                  f"cuDNN LSTM+Linear forward {library_ms:.3f} ms; the rule takes the {rule} "
                  f"form; y{' and the residuals' if kernel == 'K2' else ''} the same bits in "
                  f"every form: {same}")
            if not same:
                fail(f"[3] the forward's forms disagree at {tag} {dtype}")
            out[dtype][tag] = {"rule": rule, "wave": best[lstm2.FWD_SWEEP_WAVE], "tile": best[0],
                               "library": library_ms, "same_bits": same, "N": n, "T": t}
            if len(forms) == 3:
                out[dtype][tag]["pair"] = best[forms[0]]
            del x, w, library
            torch.cuda.empty_cache()
    return out


def sweep_forms_by_fold() -> dict:
    """The reverse sweep's form by the rule (`bwd_sweep_form` on this card:
    the wave form at the training fold) against the tile form forced,
    at FullSubNet+'s training fold and FullSubNet's sub-band training fold
    (N 2304, T 195) in both dtypes: K4's dx and dgates the same bits in both
    forms; K4's sweep and K3 whole timed in turns (rule, tile, tile, rule;
    the lower of a form's two medians of 3)."""
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        out[dtype] = {}
        for tag, shape in (("fullsubnet_plus", SB), ("fullsubnet_sb", FSN_SB)):
            x, dy, lstm, fc = train_operands(N_TRAIN, T_TRAIN, dtype, seed=5, shape=shape)
            w = lstm.packed(fc)
            _, res = lt.lstm2_train_fwd(x, w)
            form = lt.bwd_sweep_form(N_TRAIN, *shape, dtype, sms)
            got, ms = {}, {}
            for f in (form, 0, 0, form):
                lt.SWEEP_FORM = f
                try:
                    if f not in got:
                        got[f] = lt.lstm2_bwd_sweep(dy, x, w, res)[:3]
                    ms.setdefault(f, []).append(
                        (cuda_ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res), reps=3),
                         cuda_ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True), reps=3)))
                finally:
                    lt.SWEEP_FORM = None
            same = all(torch.equal(a, b) for a, b in zip(got[form], got[0]))
            del got, res
            torch.cuda.empty_cache()
            best = {f: (min(v[0] for v in runs), min(v[1] for v in runs)) for f, runs in ms.items()}
            name = lt.sweep_form_name(form)
            print(f"[3] {str(dtype)[6:]} {tag} N={N_TRAIN} D={shape[0]} T={T_TRAIN}: the rule's "
                  f"{name} form: sweep (lstm2_bwd) {best[form][0]:.3f} ms, K3 {best[form][1]:.3f} "
                  f"ms; the tile form forced: sweep {best[0][0]:.3f} ms, K3 {best[0][1]:.3f} ms; "
                  f"dx and dgates the same bits in both: {same}")
            if not same:
                fail(f"the reverse sweep's {name} and tile forms disagree at {tag} {dtype}")
            out[dtype][tag] = {"form": name, "same_bits": same,
                               "lstm2_bwd": best[form][0], "lstm2_bwd_wgrad": best[form][1],
                               "tile": {"lstm2_bwd": best[0][0], "lstm2_bwd_wgrad": best[0][1]}}
    return out


def backward_forms_by_fold() -> dict:
    """float32 K3 against K4 + `weight_grads` at each fold float32 training
    runs (T 195): FullSubNet+'s training fold and FullSubNet's sub-band and
    full-band ones, the median of 3 CUDA-event timings each; what
    FUSED_WGRAD_BY_DTYPE[float32] rests on."""
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    out = {}
    for tag, n, shape in (("fullsubnet_plus", N_TRAIN, SB), ("fullsubnet_sb", N_TRAIN, FSN_SB),
                          ("fullsubnet_fb", N_FB_TRAIN, FB)):
        x, dy, lstm, fc = train_operands(n, T_TRAIN, torch.float32, seed=7, shape=shape)
        w = lstm.packed(fc)
        _, res = lt.lstm2_train_fwd(x, w)
        sweep = lt.lstm2_bwd_sweep(dy, x, w, res)
        k3_ms = cuda_ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True), reps=3)
        k4_ms = cuda_ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res), reps=3)
        products_ms = cuda_ms(lambda: lt.weight_grads(x, res, sweep.dg1, sweep.dg2), reps=3)
        del sweep, res
        torch.cuda.empty_cache()
        print(f"[3] float32 backward forms at {tag} N={n} D={shape[0]} H={shape[1]} "
              f"O={shape[2]} T={T_TRAIN}: K3 {k3_ms:.3f} ms, K4 + weight_grads {k4_ms:.3f} + "
              f"{products_ms:.3f} = {k4_ms + products_ms:.3f} ms; FUSED_WGRAD's default takes "
              f"{'K3' if lt.fused_wgrad(torch.float32) else 'K4'}")
        out[tag] = {"shape": {"N": n, "D": shape[0], "H": shape[1], "O": shape[2], "T": T_TRAIN},
                    "k3_ms": k3_ms, "k4_ms": k4_ms, "weight_grads_ms": products_ms}
    return out


def train_pair(rng: np.random.Generator, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(noisy, clean): a tone with a little noise, and the same under more noise."""
    t = np.arange(n) / SR
    clean = 0.3 * np.sin(2 * np.pi * rng.uniform(100.0, 400.0) * t) + 0.02 * rng.standard_normal(n)
    return ((clean + 0.1 * rng.standard_normal(n)).astype(np.float32),
            clean.astype(np.float32))


@contextlib.contextmanager
def training_kernels(fused: bool, plain: bool = False):
    """The training step's LSTM backward form for the duration: K2 + K3
    (`fused`) or K2 + K4, or with `plain` the plain versions of both."""
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    kernels, form = (lt.lstm2_train_fwd, lt.lstm2_bwd), lt.FUSED_WGRAD
    lt.FUSED_WGRAD = fused
    if plain:
        lt.lstm2_train_fwd, lt.lstm2_bwd = lt.lstm2_train_fwd_reference, lt.lstm2_bwd_plain
    try:
        yield
    finally:
        lt.FUSED_WGRAD = form
        lt.lstm2_train_fwd, lt.lstm2_bwd = kernels


def float32_backward() -> str:
    """The backward kernel float32 training launches by default
    (`FUSED_WGRAD_BY_DTYPE`): K3 (`lstm2_bwd_wgrad`) or K4 (`lstm2_bwd`)."""
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    return "lstm2_bwd_wgrad" if lt.fused_wgrad(torch.float32) else "lstm2_bwd"


def same_state_check(state, make_step, batches, phase: str = "[6]", per_step: int = 1,
                     fwd_folds=((N_TRAIN, SB),)) -> tuple:
    """Phase 6's agreement check, well posed: the plain float32 run takes its
    TRAIN_STEPS steps, and before each one the same step from a copy of its
    state runs through the kernels (float32 K2 + K3, float32 K2 + K4, bf16
    K2 + K3). Each kernel step's loss and gradient norm are held to the
    plain step's from the same state: float32 within TRAIN_LOSS_RTOL and
    TRAIN_GRAD_NORM_RTOL, bf16's loss within TRAIN_BF16_LOSS_RTOL; the bf16
    steps' reverse sweeps are printed by form, and their forward sweeps
    (K2's launches at `fwd_folds`, (N, shape) a launch of a step) held to
    the rule's forms (the pair form at the sub-band folds). Returns (each
    form's worst loss and gradient-norm gaps, the kernel steps' launches
    summed); `phase` tags the lines. A step launches the forward and the
    backward kernel `per_step` times each (FullSubNet: 2, its full-band and
    sub-band LSTMs)."""
    from fullsubnet_plus_torch.ops import lstm2
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    forms = (("float32_k3", torch.float32, True), ("float32_k4", torch.float32, False),
             ("bfloat16_k3", torch.bfloat16, True))
    bf16_fwd = dict(collections.Counter(f"lstm2_train_fwd {fwd_rule_form(n, shape, torch.bfloat16)}"
                                        for n, shape in fwd_folds))
    steps = {dtype: make_step(dtype) for dtype in (torch.float32, torch.bfloat16)}
    gaps = {tag: [] for tag, _, _ in forms}
    counted = collections.Counter()
    for i, (noisy, clean) in enumerate(batches):
        trials, sweeps = {}, {}
        for tag, dtype, fused in forms:
            reset_launches()
            with training_kernels(fused):
                _, m = steps[dtype](copy.deepcopy(state), noisy, clean)
            if dtype == torch.bfloat16:
                sweeps[tag] = dict(lt.SWEEP_FORMS)
                if dict(lstm2.FWD_SWEEP_FORMS) != bf16_fwd:
                    fail(f"{phase} train {tag} step {i}: the forward sweeps took the forms "
                         f"{dict(lstm2.FWD_SWEEP_FORMS)}, not {bf16_fwd}")
            launches = all_launches()
            counted.update(launches)
            expect = {k: 0 for k in launches}
            expect.update({"lstm2_train_fwd": per_step,
                           "lstm2_bwd_wgrad" if fused else "lstm2_bwd": per_step})
            if launches != expect:
                fail(f"{phase} train {tag} step {i} from the plain run's state: launches "
                     f"{launches}, expected {expect}")
            trials[tag] = {k: float(v) for k, v in m.items()}
        reset_launches()
        with training_kernels(True, plain=True):
            state, m = steps[torch.float32](state, noisy, clean)
        if any(all_launches().values()):
            fail(f"{phase} the plain step {i} launched kernels: {all_launches()}")
        plain = {k: float(v) for k, v in m.items()}
        for tag, m in trials.items():
            gaps[tag].append((abs(m["loss"] - plain["loss"]) / abs(plain["loss"]),
                              abs(m["grad_norm"] - plain["grad_norm"]) / abs(plain["grad_norm"])))
        print(f"{phase} step {i} from the plain run's state: plain loss {plain['loss']:.6f}, "
              f"grad norm {plain['grad_norm']:.6f}; "
              + "; ".join(f"{tag} {trials[tag]['loss']:.6f} / {trials[tag]['grad_norm']:.6f}"
                          for tag in trials)
              + f"; the bf16 reverse sweeps by form: {sweeps}, forward sweeps by form {bf16_fwd}")
    worst = {}
    for tag, dtype, _ in forms:
        worst[tag] = (max(g[0] for g in gaps[tag]), max(g[1] for g in gaps[tag]))
        f32 = dtype == torch.float32
        loss_rtol, norm_rtol = ((TRAIN_LOSS_RTOL, TRAIN_GRAD_NORM_RTOL) if f32
                                else (TRAIN_BF16_LOSS_RTOL, None))
        print(f"{phase} {tag} against the plain float32 step from the same state, over "
              f"{len(gaps[tag])} steps: loss within {worst[tag][0]:.2e} (limit {loss_rtol:g}), "
              f"gradient norm within {worst[tag][1]:.2e} (limit {norm_rtol or 'none'})")
        if worst[tag][0] > loss_rtol or (norm_rtol and worst[tag][1] > norm_rtol):
            fail(f"{phase} train {tag} disagrees with the plain step from the same state")
    return worst, counted


def phase_train() -> dict:
    """The training path: `make_train_step` at the full width of
    configs/train.toml, through the kernels and through their plain
    versions; then `make_eval_step`."""
    from fullsubnet_plus_torch.models import get_model
    from fullsubnet_plus_torch.ops import lstm2
    from fullsubnet_plus_torch.ops import lstm2_train as lt
    from fullsubnet_plus_torch.train import loss, step
    from fullsubnet_plus_torch.utils.config import load_config

    toml = load_config(os.path.join(REPO, "configs", "train.toml"))
    model_def = get_model(toml["model"]["path"])
    config = model_def.make_config(toml["model"]["args"])
    acoustics = {k: toml["acoustics"][k] for k in ("n_fft", "hop_length", "win_length")}
    data = toml["train_dataset"]
    shape = (data["dataloader"]["batch_size"],
             round(data["args"]["sub_sample_length"] * data["args"]["sr"]))
    if shape != (TRAIN_BATCH, TRAIN_SAMPLES) or config.num_groups_in_drop_band != 2:
        fail(f"configs/train.toml gives a batch of {shape}, not the training fold's")
    optimizer = step.make_optimizer(
        **toml["optimizer"], clip_grad_norm=toml["trainer"]["train"]["clip_grad_norm_value"])
    loss_fn = loss.get_loss(toml["loss_function"]["name"])
    rng = np.random.default_rng(4)
    batches = [tuple(np.stack(rows) for rows in
                     zip(*(train_pair(rng, TRAIN_SAMPLES) for _ in range(TRAIN_BATCH))))
               for _ in range(TRAIN_STEPS)]
    audio_s = TRAIN_BATCH * TRAIN_SAMPLES / SR

    def make_step(dtype):
        return step.make_train_step(model_def, config, optimizer, loss_fn, compute_dtype=dtype,
                                    device="cuda", **acoustics)

    def seeded_state():
        model = model_def.module_cls(config).init_weights(torch.Generator().manual_seed(42))
        return step.init_train_state(model, optimizer, device="cuda")

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(tag, dtype, fused, form=None, fwd_form=None, mma_sync_wgrad=False):
        """TRAIN_STEPS steps from the seeded state; metrics, walls, launches
        (the reverse sweep in `form` and the forward in `fwd_form` where
        given, else the rule's; K3's weight gradients on the mma.sync kernel
        with `mma_sync_wgrad`, else in the rule's tile)."""
        state = seeded_state()
        train_step = make_step(dtype)
        reset_launches()
        metrics, walls = [], []
        lt.SWEEP_FORM, lstm2.FWD_SWEEP_FORM = form, fwd_form
        try:
            with training_kernels(fused), (forced_mma_sync_wgrad() if mma_sync_wgrad
                                           else contextlib.nullcontext()):
                for noisy, clean in batches:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = train_step(state, noisy, clean)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                    metrics.append({k: float(v) for k, v in m.items()})
        finally:
            lt.SWEEP_FORM = lstm2.FWD_SWEEP_FORM = None
        launches = all_launches()
        backward = "lstm2_bwd_wgrad" if fused else "lstm2_bwd"
        expect = {k: 0 for k in launches}
        expect.update({"lstm2_train_fwd": TRAIN_STEPS, backward: TRAIN_STEPS})
        form = lt.bwd_sweep_form(N_TRAIN, D, H, O, dtype, sms) if form is None else form
        name = lt.sweep_form_name(form)
        if dict(lt.SWEEP_FORMS) != {f"{backward} {name}": TRAIN_STEPS}:
            fail(f"train {tag}: the shipped fold's reverse sweeps took the forms "
                 f"{dict(lt.SWEEP_FORMS)}, not the {name} form once a step")
        if fused:  # K3's weight gradients in the tile the rule takes at the training fold
            wgrad = lt.wgrad_tiles(D, H, dtype)[1]
            if mma_sync_wgrad:
                wgrad = (lt.WGRAD_F32_TILES if dtype == torch.float32
                         else lt.WGRAD_H_TILES)[mma_sync_wgrad_tile(dtype, N_TRAIN)]
            wgrad = f"lstm2_bwd_wgrad {'x'.join(map(str, wgrad))}"
            if dict(lt.WGRAD_TILES) != {wgrad: TRAIN_STEPS}:
                fail(f"train {tag}: K3's weight gradients took the tiles "
                     f"{dict(lt.WGRAD_TILES)}, not {wgrad} once a step")
        fwd_name = (fwd_rule_form(N_TRAIN, SB, dtype) if fwd_form is None
                    else lstm2.fwd_form_name(fwd_form))
        if dict(lstm2.FWD_SWEEP_FORMS) != {f"lstm2_train_fwd {fwd_name}": TRAIN_STEPS}:
            fail(f"train {tag}: the shipped fold's forward sweeps took the forms "
                 f"{dict(lstm2.FWD_SWEEP_FORMS)}, not the {fwd_name} form once a step")
        wall = statistics.median(walls[1:])  # the first step warms up cuBLAS and cuFFT plans
        print(f"[6] train {tag} (forward: the {fwd_name} form, reverse sweep: the {name} form): "
              f"loss {', '.join(f'{m['loss']:.6f}' for m in metrics)}; "
              f"grad norm {', '.join(f'{m['grad_norm']:.4f}' for m in metrics)}; step wall "
              f"median {wall:.1f} ms (each {', '.join(f'{w:.0f}' for w in walls)}), "
              f"{audio_s / wall * 1e3:.1f} audio-s/s; launches {launches}")
        for m in metrics:
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
                fail(f"train {tag}: loss or gradient norm not finite: {m}")
            if m["skipped"] != 0.0:
                fail(f"train {tag}: a step was skipped")
        if launches != expect:
            fail(f"train {tag}: launches {launches}, expected {expect}")
        if int(state.step) != TRAIN_STEPS or int(state.opt_state.count) != TRAIN_STEPS:
            fail(f"train {tag}: step {int(state.step)}, Adam count {int(state.opt_state.count)}")
        return {"state": state, "metrics": metrics, "wall_ms": wall, "launches": launches,
                "audio_s_per_s": audio_s / wall * 1e3, "sweep_form": name, "fwd_form": fwd_name,
                "wgrad_tiles": dict(lt.WGRAD_TILES), "sweep_forms": dict(lt.SWEEP_FORMS),
                "fwd_sweep_forms": dict(lstm2.FWD_SWEEP_FORMS)}

    runs = {"float32_k3": run("float32 K2+K3", torch.float32, True),
            "bfloat16_k3": run("bfloat16 K2+K3", torch.bfloat16, True),
            "float32_k4": run("float32 K2+K4", torch.float32, False)}
    # the same steps with the tile form forced: a comparison, not the main path
    tile_runs = {"float32_k3": run("float32 K2+K3, the tile form forced", torch.float32, True, 0),
                 "bfloat16_k3": run("bfloat16 K2+K3, the tile form forced", torch.bfloat16,
                                    True, 0)}
    for key, tile in tile_runs.items():
        print(f"[6] {key} step wall median: the {runs[key]['sweep_form']} form "
              f"{runs[key]['wall_ms']:.1f} ms, the tile form forced {tile['wall_ms']:.1f} ms")
        runs[key]["tile_form_wall_ms"] = tile["wall_ms"]
    # and with the forward's tile form forced (its rule's R; the reverse sweep the rule's)
    for key, dtype in (("float32_k3", torch.float32), ("bfloat16_k3", torch.bfloat16)):
        if runs[key]["fwd_form"] == "tile":
            continue
        tile = run(f"{str(dtype)[6:]} K2+K3, the forward's tile form forced", dtype, True,
                   fwd_form=0)
        print(f"[6] {key} step wall median: the forward's {runs[key]['fwd_form']} form "
              f"{runs[key]['wall_ms']:.1f} ms, its tile form forced {tile['wall_ms']:.1f} ms")
        runs[key]["fwd_tile_form_wall_ms"] = tile["wall_ms"]
    # and with K3's weight gradients on the mma.sync kernel the rule took before wgmma
    for key, dtype in (("float32_k3", torch.float32), ("bfloat16_k3", torch.bfloat16)):
        old = run(f"{str(dtype)[6:]} K2+K3, the mma.sync weight gradients forced", dtype, True,
                  mma_sync_wgrad=True)
        print(f"[6] {key} step wall median: K3's weight gradients in the rule's tile "
              f"{runs[key]['wall_ms']:.1f} ms, on the mma.sync kernel forced "
              f"{old['wall_ms']:.1f} ms")
        runs[key]["mma_sync_wgrad_wall_ms"] = old["wall_ms"]
    same_state_check(seeded_state(), make_step, batches)

    # a NaN in one noisy waveform: the update is rejected on the device
    state = runs["float32_k3"]["state"]
    before = [t.clone() for t in (*state.model.parameters(), state.opt_state.mu,
                                  state.opt_state.nu)]
    noisy, clean = batches[0]
    bad = noisy.copy()
    bad[3, 1000] = np.nan
    train_step = make_step(torch.float32)
    state, m = train_step(state, bad, clean)
    after = (*state.model.parameters(), state.opt_state.mu, state.opt_state.nu)
    unchanged = all(torch.equal(a, b) for a, b in zip(before, after))
    print(f"[6] NaN batch: skipped {float(m['skipped'])}, state unchanged bit for bit: "
          f"{unchanged}, step {int(state.step)}, Adam count {int(state.opt_state.count)}")
    if (float(m["skipped"]) != 1.0 or not unchanged or int(state.step) != TRAIN_STEPS + 1
            or int(state.opt_state.count) != TRAIN_STEPS):
        fail("the NaN batch was not skipped cleanly")

    reset_launches()
    eval_step = step.make_eval_step(model_def, config, loss_fn, device="cuda", **acoustics)
    eval_loss, enhanced = eval_step(state.model, noisy, clean)
    torch.cuda.synchronize()
    eval_launches = all_launches()
    print(f"[6] eval step: loss {float(eval_loss):.6f}, enhanced {tuple(enhanced.shape)}, "
          f"launches {eval_launches}")
    if (not np.isfinite(float(eval_loss)) or tuple(enhanced.shape) != noisy.shape
            or not torch.isfinite(enhanced).all()):
        fail("the eval step's loss or waveform is wrong")
    if eval_launches["lstm2_fwd"] < 1 or eval_launches["lstm2_train_fwd"] != 0:
        fail(f"the eval step's launches: {eval_launches}")

    def one_step():
        train_step(state, noisy, clean)
        torch.cuda.synchronize()

    backward = "K3" if lt.fused_wgrad(torch.float32) else "K4 + weight_grads"
    kernels = profile_call(one_step, f"[6] profile float32 train step (K2 in the "
                                     f"{fwd_rule_form(N_TRAIN, SB, torch.float32)} form + "
                                     f"{backward}, the default form):")
    check_no_tf32(kernels, "[6] the float32 train step")
    return {"runs": {k: {f: v[f] for f in ("metrics", "wall_ms", "launches", "audio_s_per_s",
                                            "sweep_form", "fwd_form", "tile_form_wall_ms",
                                            "fwd_tile_form_wall_ms", "mma_sync_wgrad_wall_ms",
                                            "wgrad_tiles", "sweep_forms", "fwd_sweep_forms")
                                  if f in v}
                     for k, v in runs.items()},
            "eval_launches": eval_launches,
            # phase 9 starts from a copy of the float32 K2 + K4 run's state
            "state": runs["float32_k4"]["state"].state_dict(),
            "batches": {"noisy": np.stack([b[0] for b in batches]),
                        "clean": np.stack([b[1] for b in batches])}}


def write_inputs(root: str) -> list[int]:
    from fullsubnet_plus_torch.data.wav import write_wav
    from fullsubnet_plus_torch.io import convert
    from fullsubnet_plus_torch.io.checkpoint import save_flat
    from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlus

    rng = np.random.default_rng(0)
    lengths = [int(s * SR) for s in rng.uniform(3.0, 10.0, BATCH - 1)] + [10 * SR]
    for i, n in enumerate(lengths):
        write_wav(os.path.join(root, "noisy", f"utt{i}.wav"), noisy_utterance(rng, n), SR)
    model = FullSubNetPlus().init_weights(torch.Generator().manual_seed(42))
    save_flat(os.path.join(root, "model.npz"),
              {"params": convert.jax_from_state_dict(model.state_dict())}, {"seed": 42})
    return lengths


def noisy_utterance(rng: np.random.Generator, n: int) -> np.ndarray:
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def reset_launches() -> None:
    from fullsubnet_plus_torch.ops import lstm2, lstm2_int8, lstm2_train

    lstm2.LAUNCHES.clear()
    lstm2_int8.LAUNCHES.clear()
    for name in lstm2_train.LAUNCHES:
        lstm2_train.LAUNCHES[name] = 0
    lstm2_train.LAUNCHES_BY_CARD.clear()
    lstm2_train.SWEEP_FORMS.clear()
    lstm2_train.WGRAD_TILES.clear()
    lstm2.FWD_SWEEP_FORMS.clear()
    lstm2_int8.INT8_SWEEP_FORMS.clear()


def all_launches() -> dict:
    """The five kernels' launch counts since the last reset."""
    from fullsubnet_plus_torch.cli.serve import kernel_launches
    from fullsubnet_plus_torch.ops import lstm2_train

    return {**kernel_launches(), **lstm2_train.LAUNCHES}


def phase_batch_path(root: str, lengths: list[int]) -> dict:
    from fullsubnet_plus_torch.cli import enhance as cli
    from fullsubnet_plus_torch.cli.serve import kernel_launches
    from fullsubnet_plus_torch.data.wav import read_wav
    from fullsubnet_plus_torch.ops import lstm2
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
    launches, rates, forms = {}, {}, {}
    for tag, dtype, kernel in (("float32", None, "lstm2_fwd"),
                               ("bfloat16", "bfloat16", "lstm2_fwd"),
                               ("int8", "int8", "lstm2_int8_fwd")):
        reset_launches()
        runs = [run(tag, dtype) for _ in range(MAIN_PATH_RUNS)]
        launches[tag] = kernel_launches()
        if kernel == "lstm2_fwd":  # each batch (N 2056) in the rule's form for its dtype
            forms[tag] = dict(lstm2.FWD_SWEEP_FORMS)
            want = {f"lstm2_fwd {BATCH_FWD_FORM[getattr(torch, tag)]}": launches[tag][kernel]}
            print(f"[4] batch path {tag}: forward sweeps by form {forms[tag]}")
            if forms[tag] != want:
                fail(f"the {tag} batch path's forward sweeps took the forms {forms[tag]}, not "
                     f"{want}")
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
    with plain_lstms():
        run("float32_plain", None)
        run("int8_plain", "int8")
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
    return {"launches": launches, "rates": rates, "fwd_forms": forms}


def loop_device_time(fn, span: str) -> tuple:
    """(device busy ms, span wall ms) of one profiled call of `fn`, both
    within the CPU span named `span`: the device's kernels and copies that
    start inside the span, and the span's own length, on the profiler's
    one clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    spans = [e for e in events if e.name == span and e.device_type == DeviceType.CPU]
    if len(spans) != 1:
        fail(f"the trace holds {len(spans)} spans named {span!r}, not 1")
    t0, t1 = spans[0].time_range.start, spans[0].time_range.end
    busy_us = sum(e.time_range.elapsed_us() for e in events
                  if e.device_type == DeviceType.CUDA and e.name != span
                  and not getattr(e, "is_user_annotation", False)
                  and t0 <= e.time_range.start < t1)
    return busy_us / 1e3, (t1 - t0) / 1e3


def phase_pipelined(root: str, lengths: list[int]) -> dict:
    """Phase 4's pipelined batch CLI: `run_enhance` over PIPELINE_COPIES
    copies of the 8 wavs (4 batches of 8, as many as it keeps in flight) in
    each dtype, with the CLI's window of batches in flight (IN_FLIGHT) and,
    in turns, with a window of 1 (each batch written before the next is
    dispatched: the serial loop the pipelining replaced), each into its own
    directory. Every wav of the window's run must equal the serial run's
    byte for byte. For each: the audio-s/s of `run_enhance`'s loop (median
    of MAIN_PATH_RUNS) and the device's idle share of that loop (device
    time inside the loop's span over the span's wall, both from one
    profiled call; the Enhancer's set-up lies outside the span); the
    kernel launched once a batch."""
    import shutil

    from fullsubnet_plus_torch.cli import enhance as cli
    from fullsubnet_plus_torch.cli.serve import kernel_launches
    from fullsubnet_plus_torch.data.wav import read_wav
    from fullsubnet_plus_torch.utils.config import load_config

    config = load_config(os.path.join(REPO, "configs", "inference.toml"))
    many = os.path.join(root, "noisy_pipelined")
    os.makedirs(many, exist_ok=True)
    names = [f"copy{c}_utt{i}" for c in range(PIPELINE_COPIES) for i in range(len(lengths))]
    for c in range(PIPELINE_COPIES):
        for i in range(len(lengths)):
            shutil.copy(os.path.join(root, "noisy", f"utt{i}.wav"),
                        os.path.join(many, f"copy{c}_utt{i}.wav"))
    batches = PIPELINE_COPIES * len(lengths) // BATCH
    window = cli.IN_FLIGHT

    def out_dir(tag, in_flight):
        return os.path.join(root, f"pipelined_{tag}_window{in_flight}")

    def run(tag, dtype, in_flight):
        cli.IN_FLIGHT = in_flight
        try:
            return cli.run_enhance(config, os.path.join(root, "model.npz"),
                                   out_dir(tag, in_flight), input_dirs=[many],
                                   batch_size=BATCH, compute_dtype=dtype, device="cuda")
        finally:
            cli.IN_FLIGHT = window

    out = {}
    for tag, dtype, kernel in (("float32", None, "lstm2_fwd"),
                               ("bfloat16", "bfloat16", "lstm2_fwd"),
                               ("int8", "int8", "lstm2_int8_fwd")):
        run(tag, dtype, window)  # warm
        rates = {window: [], 1: []}
        reset_launches()
        for _ in range(MAIN_PATH_RUNS):  # in turns: the window, then serial
            for in_flight in (window, 1):
                rates[in_flight].append(run(tag, dtype, in_flight))
        launches = kernel_launches()
        if launches[kernel] != 2 * MAIN_PATH_RUNS * batches:
            fail(f"the pipelined {tag} batch path launched {launches}, not {kernel} "
                 f"{2 * MAIN_PATH_RUNS * batches} times")
        differ = []
        for name, n in zip(names, lengths * PIPELINE_COPIES):
            paths = [os.path.join(out_dir(tag, w), f"{name}.wav") for w in (window, 1)]
            y = read_wav(paths[0])
            if y.shape != (n,) or not np.isfinite(y).all():
                fail(f"pipelined {tag} output {name}: shape {y.shape} or not finite")
            with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
                if a.read() != b.read():
                    differ.append(name)
        print(f"[4] pipelined {tag}: {len(names) - len(differ)} of {len(names)} wavs of the "
              f"window-{window} run equal the window-1 run's byte for byte")
        if differ:
            fail(f"the pipelined {tag} batch path wrote other bytes than the serial one: "
                 f"{differ}")
        out[tag] = {"launches": launches[kernel], "bytes_equal_to_serial": True}
        for in_flight, label in ((window, "pipelined"), (1, "serial")):
            each = [r["throughput_audio_s_per_s"] for r in rates[in_flight]]
            wall_ms = statistics.median(r["wall_seconds"] for r in rates[in_flight]) * 1e3
            busy_ms, span_ms = loop_device_time(lambda: run(tag, dtype, in_flight),
                                                cli.LOOP_SPAN)
            if busy_ms > span_ms:
                fail(f"[4] {label} {tag}: device busy {busy_ms:.3f} ms exceeds the loop's "
                     f"wall {span_ms:.3f} ms in one trace")
            idle = 1 - busy_ms / span_ms
            out[tag][label] = {"in_flight": in_flight, "audio_s_per_s": statistics.median(each),
                               "each": each, "loop_wall_ms": wall_ms,
                               "profiled_loop_wall_ms": span_ms, "device_busy_ms": busy_ms,
                               "idle_share": idle}
            print(f"[4] {label} batch path {tag} ({in_flight} in flight; {batches} batches of "
                  f"{BATCH}): median {out[tag][label]['audio_s_per_s']:.1f} audio-s/s (each "
                  f"{', '.join(f'{r:.1f}' for r in each)}), loop wall {wall_ms:.1f} ms; in one "
                  f"profiled loop: wall {span_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle "
                  f"share {idle:.3f}")
    return out


PROFILES = {}  # profile_call's tag: wall ms, device busy ms, idle share


def profile_call(fn, tag: str) -> list:
    """Where one call of `fn` (which must return synchronized) spends device
    time (torch.profiler), and the device's idle share of the wall time.
    Reported only (and kept in PROFILES); returns the device-side events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    walls = []
    for _ in range(3):  # unprofiled: the profiler's own overhead inflates wall time
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    # device-side events only: an operator's own entry repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    PROFILES[tag] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "idle_share": max(0.0, 1 - busy_ms / wall_ms)}
    print(f"{tag} wall {wall_ms:.1f} ms (median of 3, unprofiled), "
          f"device busy {busy_ms:.1f} ms (profiled), "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        ms = e.self_device_time_total / 1e3
        print(f"    {ms:9.3f} ms {ms / max(busy_ms, 1e-9):6.1%} x{e.count:<4d} {e.key[:90]}")
    return kernels


def phase_profile(root: str, lengths: list[int]) -> None:
    from fullsubnet_plus_torch.cli.enhance import load_state_dict
    from fullsubnet_plus_torch.data.wav import read_wav
    from fullsubnet_plus_torch.enhance import Enhancer
    from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
    from fullsubnet_plus_torch.ops import lstm2

    batch = np.zeros((len(lengths), -(-max(lengths) // SR) * SR), np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = read_wav(os.path.join(root, "noisy", f"utt{i}.wav"))
    for dtype in ("float32", "bfloat16"):
        enhancer = Enhancer(FULLSUBNET_PLUS, FULLSUBNET_PLUS.make_config({}),
                            load_state_dict(os.path.join(root, "model.npz")), device="cuda",
                            compute_dtype=dtype)
        # enhance_batch returns numpy: synchronized
        profile_call(lambda: enhancer.enhance_batch(batch, lengths=lengths),
                     f"[4] profile {dtype} batch:")
    sb = enhancer.model.sb_model  # the bf16 one: its K1 call packs the weights first
    w = sb.sequence_model.packed(sb.fc_output_layer)
    pack_ms = sum(device_ms_by_kernel(lambda: lstm2.pack_fwd_mma(w)).values())
    print(f"[4] of the bfloat16 batch: the weight packing for K1 (pack_fwd_mma, once a "
          f"batch) {pack_ms:.3f} ms of device time")


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


def phase_serve(config_path: str, checkpoint: str, streams: int = STREAMS,
                tag: str = "[5]") -> dict:
    """The serving path: the daemon on the card with its default dtype,
    driven by `streams` concurrent clients; then the same streams drained
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
    utts = [noisy_utterance(rng, int(s * sr)) for s in rng.uniform(3.0, 10.0, streams)]
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
    if sorted(results) != list(range(streams)):
        fail(f"clients without a reply: {sorted(set(range(streams)) - set(results))}")
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
    print(f"{tag} serving {streams} streams ({audio_s:.2f} audio-s, fed at {FEED_SPEEDUP:g}x real "
          f"time) on {stats['device']}: all complete in {wall:.2f} s, {audio_s / wall:.1f} "
          f"audio-s/s together; per stream median {statistics.median(rates):.1f} audio-s/s "
          f"(min {min(rates):.1f}, max {max(rates):.1f})")
    print(f"{tag} stats: busy-tick ms p50 {lat['p50']} p90 {lat['p90']} p99 {lat['p99']} "
          f"over {lat['window']} busy ticks of {stats['ticks']}; chunks "
          f"{stats['chunks_enhanced']}; tick failures {stats['tick_failures']}; "
          f"launches {launches}")
    print(f"{tag} served against offline int8 engine: min {min(snrs):.1f} dB, median "
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
    profile_call(lambda: serve["enhancer"].enhance_batch(rows, lengths=[engine.in_len] * SLOTS),
                 "[5] profile int8 serving batch:")


FSN_TOML = """\
# FullSubNet (the baseline), the reference's fullsubnet inference settings
[acoustics]
n_fft = 512
win_length = 512
sr = 16000
hop_length = 256

[inferencer]
type = "full_band_crm_mask"

[inferencer.args]
n_neighbor = 15

[model]
path = "fullsubnet.model.fullsubnet.Model"

[model.args]
num_freqs = 257
look_ahead = 2
sequence_model = "LSTM"
fb_num_neighbors = 0
sb_num_neighbors = 15
fb_output_activate_function = "ReLU"
sb_output_activate_function = false
fb_model_hidden_size = 512
sb_model_hidden_size = 384
weight_init = false
norm_type = "offline_laplace_norm"
num_groups_in_drop_band = 2
"""


def write_fullsubnet_inputs(root: str) -> tuple[str, str]:
    """(config path, checkpoint path): FSN_TOML and a seeded full-width
    FullSubNet (seed 42) as a JAX-format .npz, in `root`."""
    from fullsubnet_plus_torch.io import convert
    from fullsubnet_plus_torch.io.checkpoint import save_flat
    from fullsubnet_plus_torch.models.fullsubnet import FullSubNet

    config_path, checkpoint = os.path.join(root, "fullsubnet.toml"), os.path.join(root, "fsn.npz")
    with open(config_path, "w") as f:
        f.write(FSN_TOML)
    model = FullSubNet().init_weights(torch.Generator().manual_seed(42))
    save_flat(checkpoint, {"params": convert.jax_from_state_dict(model.state_dict())}, {"seed": 42})
    return config_path, checkpoint


def check_fullsubnet_sub_band() -> dict:
    """K1 in float32 and bf16 and K5 at FullSubNet's sub-band shape (D 32,
    H 384, O 2) on the fold of a batch of 8 padded to 10 s (N 2056, T 629),
    each against its plain version (K1 and K5 equal on a repeat); the
    kernel's time beside it."""
    from fullsubnet_plus_torch.ops import lstm2, lstm2_int8

    out = {}
    for tag, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16), ("int8", None)):
        if dtype is None:
            x, w, _, _ = int8_operands(N_FULL, T_FULL, seed=10, shape=FSN_SB)
            name, kernel, plain, floor = ("lstm2_int8_fwd", lstm2_int8.lstm2_int8_fc,
                                          lstm2_int8.lstm2_int8_fc_reference, INT8_SNR_FLOOR)
        else:
            x, w, _, _ = lstm_operands(N_FULL, T_FULL, dtype, seed=9, shape=FSN_SB)
            name, kernel, plain, floor = ("lstm2_fwd", lstm2.lstm2_fc, lstm2.lstm2_fc_reference,
                                          SNR_FLOOR[dtype])
        y, again = kernel(x, w), kernel(x, w)
        torch.cuda.synchronize()
        ref = plain(x, w).float()
        snr, err = snr_db(ref, y.float()), float((y.float() - ref).abs().max())
        repeat = torch.equal(y, again)
        out[tag] = dict(ms=cuda_ms(lambda: kernel(x, w), reps=3), max_abs_err=err, snr_db=snr)
        print(f"[7] {name} {tag} at the sb_model shape N={N_FULL} T={T_FULL} "
              f"D={FSN_SB[0]} H={FSN_SB[1]} O={FSN_SB[2]}: SNR {snr:.1f} dB (floor "
              f"{floor:.0f}), max_abs {err:.3e}, equal on a repeat {repeat}; kernel "
              f"{out[tag]['ms']:.3f} ms")
        if not torch.isfinite(y.float()).all() or snr < floor or not repeat:
            fail(f"{name} {tag} at the sb_model shape: {snr:.1f} dB, equal on a "
                 f"repeat {repeat}")
    return out


def phase_fullsubnet_kernels() -> dict:
    """K1 in float32 and bf16 and K5 at FullSubNet's full-band shape (D 257,
    H 512, O 257) on the fold of a batch of 8 padded to 10 s (N 8, T 629),
    each in its cluster form: against its plain version and the tile form
    forced, equal on a repeat, timed beside the tile form forced, the plain
    version, cuDNN's LSTM(257, 512, 2) + Linear(512, 257) and the bound (K5:
    `check_int8_full_band`); then the three at the sub-band shape
    (`check_fullsubnet_sub_band`)."""
    from fullsubnet_plus_torch.ops import lstm2

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, w, lstm, fc = lstm_operands(N_FB, T_FULL, dtype, seed=7, shape=FB)
        lstm2.FWD_SWEEP_FORMS.clear()
        y, again = lstm2.lstm2_fc(x, w), lstm2.lstm2_fc(x, w)
        with forced_fwd_form(0):
            tile = lstm2.lstm2_fc(x, w)
        torch.cuda.synchronize()
        forms, repeat = dict(lstm2.FWD_SWEEP_FORMS), torch.equal(y, again)
        y, tile = y.float(), tile.float()
        ref = lstm2.lstm2_fc_reference(x, w).float()
        snr, err, vs_tile = snr_db(ref, y), float((y - ref).abs().max()), snr_db(tile, y)
        if not torch.isfinite(y).all() or min(snr, vs_tile) < SNR_FLOOR[dtype] or not repeat:
            fail(f"lstm2_fwd at the fb_model shape {dtype}: {snr:.1f} dB against the plain "
                 f"version, {vs_tile:.1f} against the tile form, equal on a repeat {repeat}")
        if forms != {"lstm2_fwd cluster16": 2, "lstm2_fwd tile": 1}:
            fail(f"[7] lstm2_fwd at the fb_model shape: forward sweeps by form {forms}")
        library = cudnn_lstm(lstm, fc, dtype)
        bound_ms, bound_by = lstm_bound_ms(N_FB, T_FULL, dtype, shape=FB)
        with forced_fwd_form(0):
            tile_ms = cuda_ms(lambda: lstm2.lstm2_fc(x, w), reps=3)
        out[dtype] = dict(ms=cuda_ms(lambda: lstm2.lstm2_fc(x, w), reps=5), tile_form_ms=tile_ms,
                          plain_ms=cuda_ms(lambda: lstm2.lstm2_fc_reference(x, w), reps=3),
                          library_ms=cuda_ms(lambda: library(x), reps=5), bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_err=err, snr_db=snr,
                          snr_db_vs_tile=vs_tile, form=f"cluster{lstm2.FWD_CLUSTER}")
        print(f"[7] lstm2_fwd {str(dtype)[6:]} at the fb_model shape N={N_FB} T={T_FULL} "
              f"D={FB[0]} H={FB[1]} O={FB[2]}, the cluster form: SNR {snr:.1f} dB (floor "
              f"{SNR_FLOOR[dtype]:.0f}), {vs_tile:.1f} dB against the tile form forced, "
              f"max_abs {err:.3e}, equal on a repeat; kernel {out[dtype]['ms']:.3f} ms  tile "
              f"form forced {tile_ms:.3f} ms  plain {out[dtype]['plain_ms']:.3f} ms  cuDNN "
              f"LSTM+Linear {out[dtype]['library_ms']:.3f} ms  bound {bound_ms:.4f} ms "
              f"({bound_by}); forward sweeps by form {forms}")
    out["int8"] = check_int8_full_band()
    out["sub_band"] = check_fullsubnet_sub_band()
    return out


@contextlib.contextmanager
def forced_int8_form(form: int):
    """Force K5's form (`lstm2_int8.INT8_SWEEP_FORM`: 0 the tile form, 16
    the cluster form), which its wrapper reads at call time."""
    from fullsubnet_plus_torch.ops import lstm2_int8

    lstm2_int8.INT8_SWEEP_FORM = form
    try:
        yield
    finally:
        lstm2_int8.INT8_SWEEP_FORM = None


def check_int8_full_band() -> dict:
    """K5 at FullSubNet's full-band shape on the fold of a batch of 8
    padded to 10 s (N 8, T 629), in the cluster form by the rule: against
    its plain version and against the tile form forced (>= 40 dB), equal on
    a repeat, each launch counted by its form; the JAX fixture's `k5_fb`
    case (N 7, T 9) through the cluster form (>= 40 dB); timed beside the
    tile form forced, the plain version, cuDNN's bf16 LSTM(257, 512, 2) +
    Linear(512, 257) (a yardstick: not the int8 function) and the bound."""
    from fullsubnet_plus_torch.ops import lstm2_int8

    x, w, lstm, fc = int8_operands(N_FB, T_FULL, seed=8, shape=FB)
    lstm2_int8.INT8_SWEEP_FORMS.clear()
    y, again = lstm2_int8.lstm2_int8_fc(x, w), lstm2_int8.lstm2_int8_fc(x, w)
    with forced_int8_form(0):
        tile = lstm2_int8.lstm2_int8_fc(x, w)
    torch.cuda.synchronize()
    forms, repeat = dict(lstm2_int8.INT8_SWEEP_FORMS), torch.equal(y, again)
    y, tile = y.float(), tile.float()
    ref = lstm2_int8.lstm2_int8_fc_reference(x, w).float()
    snr, err, vs_tile = snr_db(ref, y), float((y - ref).abs().max()), snr_db(tile, y)
    gen = fixture_generator()
    lstm2_int8.INT8_SWEEP_FORMS.clear()
    fixture_y = gen.port_run("k5_fb", "cuda")["y"]
    fixture_forms = dict(lstm2_int8.INT8_SWEEP_FORMS)
    vs_jax = snr_db(torch.from_numpy(gen.load_fixture()["k5_fb"]["y"]), torch.from_numpy(fixture_y))
    if (not torch.isfinite(y).all() or min(snr, vs_tile, vs_jax) < INT8_SNR_FLOOR
            or not repeat):
        fail(f"lstm2_int8_fwd at the fb_model shape: {snr:.1f} dB against the plain version, "
             f"{vs_tile:.1f} against the tile form, {vs_jax:.1f} against the JAX fixture, "
             f"equal on a repeat {repeat}")
    cluster = f"lstm2_int8_fwd cluster{lstm2_int8.INT8_CLUSTER}"
    if forms != {cluster: 2, "lstm2_int8_fwd tile": 1} or fixture_forms != {cluster: 1}:
        fail(f"[7] lstm2_int8_fwd at the fb_model shape: forms {forms}, the fixture's "
             f"{fixture_forms}")
    library = cudnn_lstm(lstm, fc, torch.bfloat16)
    bound_ms, bound_by = int8_bound_ms(N_FB, T_FULL, shape=FB)
    with forced_int8_form(0):
        tile_ms = cuda_ms(lambda: lstm2_int8.lstm2_int8_fc(x, w), reps=3)
    out = dict(ms=cuda_ms(lambda: lstm2_int8.lstm2_int8_fc(x, w), reps=5), tile_form_ms=tile_ms,
               plain_ms=cuda_ms(lambda: lstm2_int8.lstm2_int8_fc_reference(x, w), reps=3),
               library_ms=cuda_ms(lambda: library(x), reps=5), bound_ms=bound_ms,
               bound_by=bound_by, max_abs_err=err, snr_db=snr, snr_db_vs_tile=vs_tile,
               jax_fixture_snr_db=vs_jax, form=f"cluster{lstm2_int8.INT8_CLUSTER}")
    print(f"[7] lstm2_int8_fwd at the fb_model shape N={N_FB} T={T_FULL}, the cluster form: "
          f"SNR {snr:.1f} dB (floor {INT8_SNR_FLOOR:.0f}), {vs_tile:.1f} dB against the tile "
          f"form forced, max_abs {err:.3e}, equal on a repeat; the JAX fixture's k5_fb "
          f"{vs_jax:.1f} dB; kernel {out['ms']:.3f} ms  tile form forced {tile_ms:.3f} ms  plain "
          f"{out['plain_ms']:.3f} ms  cuDNN bf16 LSTM+Linear {out['library_ms']:.3f} ms "
          f"(yardstick)  bound {bound_ms:.4f} ms ({bound_by}); forms {forms}")
    return out


def phase_fullsubnet(root: str, lengths: list[int]) -> dict:
    """FullSubNet at full width (257 bins, fb H 512, sb H 384, seed 42)
    through its entry points: the batch of 8 wavs through `run_enhance` with
    a FullSubNet config in float32, bf16 and int8 (each batch launches K1,
    or K5 in int8, once per LSTM), the float32 waveforms against the same
    runs through the plain LSTMs, a profile of each batch, one 30 s
    utterance through `overlapped_chunk`, and the daemon serving a few
    streams (int8)."""
    from fullsubnet_plus_torch.cli import enhance as cli
    from fullsubnet_plus_torch.cli.serve import kernel_launches
    from fullsubnet_plus_torch.data.wav import read_wav
    from fullsubnet_plus_torch.enhance import Enhancer
    from fullsubnet_plus_torch.models import FULLSUBNET
    from fullsubnet_plus_torch.ops import lstm2, lstm2_int8
    from fullsubnet_plus_torch.utils.config import load_config

    config_path, checkpoint = write_fullsubnet_inputs(root)
    config = load_config(config_path)
    model_def = FULLSUBNET
    model_config = model_def.make_config(config["model"]["args"])
    state_dict = cli.load_state_dict(checkpoint)

    def run(tag, dtype):
        return cli.run_enhance(config, checkpoint, os.path.join(root, tag),
                               input_dirs=[os.path.join(root, "noisy")], batch_size=BATCH,
                               compute_dtype=dtype, device="cuda")

    def outputs(tag):
        return [read_wav(os.path.join(root, tag, f"utt{i}.wav")) for i in range(len(lengths))]

    run("fsn_warmup", None)
    run("fsn_warmup_int8", "int8")
    launches, rates, walls, forms = {}, {}, {}, {}
    for tag, dtype, kernel in FSN_DTYPES:
        reset_launches()
        runs = [run(f"fsn_{tag}", dtype) for _ in range(MAIN_PATH_RUNS)]
        launches[tag] = kernel_launches()
        each = [r["throughput_audio_s_per_s"] for r in runs]
        rates[tag] = statistics.median(each)
        walls[tag] = statistics.median(r["wall_seconds"] for r in runs)
        print(f"[7] FullSubNet batch {tag}: {runs[0]['files']} files, "
              f"{runs[0]['audio_seconds']:.2f} audio-s a run, {MAIN_PATH_RUNS} runs: median "
              f"{rates[tag]:.1f} audio-s/s (each {', '.join(f'{r:.1f}' for r in each)}), "
              f"wall {walls[tag] * 1e3:.1f} ms; launches {launches[tag]}")
        # one batch a run, and each batch runs both LSTMs through the kernel
        want = {k: 0 for k in launches[tag]}
        want[kernel] = 2 * MAIN_PATH_RUNS
        if launches[tag] != want:
            fail(f"the FullSubNet {tag} batch launched {launches[tag]}, expected {want}")
        # the full-band LSTM in the cluster form, the sub-band one in the tile form (in bf16
        # K1's pair form)
        forms[tag] = dict(lstm2.FWD_SWEEP_FORMS if kernel == "lstm2_fwd"
                          else lstm2_int8.INT8_SWEEP_FORMS)
        sub_band = BATCH_FWD_FORM[getattr(torch, tag)] if kernel == "lstm2_fwd" else "tile"
        if forms[tag] != {f"{kernel} cluster16": MAIN_PATH_RUNS,
                          f"{kernel} {sub_band}": MAIN_PATH_RUNS}:
            fail(f"the FullSubNet {tag} batch's sweeps by form: {forms[tag]}")
        for i, (y, n) in enumerate(zip(outputs(f"fsn_{tag}"), lengths)):
            if y.shape != (n,) or not np.isfinite(y).all():
                fail(f"FullSubNet {tag} output {i}: shape {y.shape}, expected ({n},)")
            if abs(np.max(np.abs(y)) - 0.8) > 1e-3:
                fail(f"FullSubNet {tag} output {i}: peak {np.max(np.abs(y)):.4f}")

    # the same runs with the plain LSTMs in place of the kernels, both LSTMs
    with plain_lstms():
        for tag, dtype, _ in FSN_DTYPES:
            run(f"fsn_{tag}_plain", dtype)
    wave_snr = {}
    for tag, floor in (("float32", WAVE_SNR_FLOOR), ("bfloat16", BF16_WAVE_SNR_FLOOR),
                       ("int8", INT8_WAVE_SNR_FLOOR)):
        wave_snr[tag] = snr_db(torch.from_numpy(np.concatenate(outputs(f"fsn_{tag}_plain"))),
                               torch.from_numpy(np.concatenate(outputs(f"fsn_{tag}"))))
        print(f"[7] FullSubNet {tag} waveforms, kernels vs plain LSTMs: {wave_snr[tag]:.1f} dB "
              f"(floor {floor:.0f})")
        if wave_snr[tag] < floor:
            fail(f"FullSubNet {tag} waveforms disagree: {wave_snr[tag]:.1f} dB")

    batch = np.zeros((len(lengths), -(-max(lengths) // SR) * SR), np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = read_wav(os.path.join(root, "noisy", f"utt{i}.wav"))
    profiles = {}
    for dtype in ("float32", "bfloat16", "int8"):
        enhancer = Enhancer(model_def, model_config, state_dict, device="cuda",
                            inference_type="full_band_crm_mask", compute_dtype=dtype)
        tag = f"[7] profile FullSubNet {dtype} batch:"
        profile_call(lambda: enhancer.enhance_batch(batch, lengths=lengths), tag)
        profiles[dtype] = PROFILES[tag]

    enhancer = Enhancer(model_def, model_config, state_dict, device="cuda",
                        inference_type="overlapped_chunk")
    rng = np.random.default_rng(5)
    long = noisy_utterance(rng, FSN_LONG_S * SR)
    enhancer.enhance_batch(long[None])  # warm up the chunk batch's shapes
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    long_out = enhancer.enhance_batch(long[None])
    long_wall = time.perf_counter() - t0
    long_launches = kernel_launches()
    print(f"[7] FullSubNet overlapped_chunk on one {FSN_LONG_S} s utterance: wall "
          f"{long_wall * 1e3:.1f} ms, {FSN_LONG_S / long_wall:.1f} audio-s/s; launches "
          f"{long_launches}")
    if (long_out.shape != (1, len(long)) or not np.isfinite(long_out).all()
            or long_launches["lstm2_fwd"] < 2):
        fail("FullSubNet overlapped_chunk: wrong output or no K1 launch")

    serve = phase_serve(config_path, checkpoint, streams=FSN_STREAMS, tag="[7] FullSubNet")
    if serve["launches"]["lstm2_int8_fwd"] % 2:
        fail(f"the FullSubNet daemon's launches {serve['launches']}: not two a batch")
    return {"launches": launches, "forms": forms, "rates": rates, "walls": walls,
            "wave_snr_db": wave_snr, "profiles": profiles,
            "overlapped_chunk": {"wall_ms": long_wall * 1e3, "launches": long_launches},
            "serve": {k: serve[k] for k in ("launches", "audio_s_per_s",
                                            "stream_audio_s_per_s_median", "min_snr_db")}
            | {"tick_failures": serve["stats"]["tick_failures"],
               "busy_tick_ms": serve["stats"]["busy_tick_ms"]}}


# Phase 8: the training driver. A seeded synthetic corpus in the DNS layout
# (numpy, nothing downloaded): TRAINER_CLEAN clean utterances of 3.5-5 s, enough
# for 4 steps an epoch at batch 18; noise files of 10 s; RIRs of 0.3-0.5 s; the
# three list files; with_reverb/ and no_reverb/ validation sets of noisy/clean
# pairs of 3-10 s.
TRAINER_CLEAN, TRAINER_NOISES, TRAINER_RIRS, TRAINER_VALID = 72, 8, 6, 6
TRAINER_STEPS = TRAINER_CLEAN // TRAIN_BATCH  # an epoch's steps
TRAINER_EPOCHS = 3  # the float32 runs: 2 epochs then -R for the third, and 3 unbroken
TRAINER_RESUME_RTOL = 1e-6  # epoch 3's train loss after -R against the unbroken run's


def speech_like(rng: np.random.Generator, n: int) -> np.ndarray:
    """A voiced, syllable-modulated harmonic series with a gliding pitch and
    pauses: something the metrics and the mixing's loudness steps can work on."""
    t = np.arange(n) / SR
    f0 = rng.uniform(100.0, 220.0) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.3, 1.0) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(k * phase) / k for k in range(1, 9))
    syllables = np.clip(np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t), 0.0, None) ** 0.5
    pauses = (np.sin(2 * np.pi * rng.uniform(0.2, 0.4) * t + rng.uniform(0, np.pi)) > -0.7)
    y = voiced * syllables * pauses + 0.003 * rng.standard_normal(n)
    return (0.3 * y / np.max(np.abs(y))).astype(np.float32)


def write_trainer_corpus(root: str) -> dict:
    """The corpus under root/corpus; returns the paths the TOML needs."""
    from scipy.signal import lfilter

    from fullsubnet_plus_torch.data.wav import write_wav

    rng = np.random.default_rng(8)
    base = os.path.join(root, "corpus")
    lists = {"clean": [], "noise": [], "rir": []}
    for i in range(TRAINER_CLEAN):
        path = os.path.join(base, "clean", f"clean_{i:03d}.wav")
        write_wav(path, speech_like(rng, int(rng.uniform(3.5, 5.0) * SR)), SR)
        lists["clean"].append(path)
    for i in range(TRAINER_NOISES):
        # white, then progressively redder noise (a one-pole low-pass)
        noise = lfilter([1.0], [1.0, -0.12 * i], rng.standard_normal(10 * SR))
        path = os.path.join(base, "noise", f"noise_{i}.wav")
        write_wav(path, (0.2 * noise / np.max(np.abs(noise))).astype(np.float32), SR)
        lists["noise"].append(path)
    for i in range(TRAINER_RIRS):
        n = int(rng.uniform(0.3, 0.5) * SR)
        rir = rng.standard_normal(n) * np.exp(-np.arange(n) / (rng.uniform(0.03, 0.08) * SR))
        rir[0] = 1.0
        path = os.path.join(base, "rir", f"rir_{i}.wav")
        write_wav(path, (rir / np.max(np.abs(rir))).astype(np.float32), SR, subtype="FLOAT")
        lists["rir"].append(path)
    for kind, paths in lists.items():
        with open(os.path.join(base, f"{kind}.txt"), "w") as f:
            f.write("\n".join(paths) + "\n")
    valid_dirs = []
    for split in ("with_reverb", "no_reverb"):
        d = os.path.join(base, "test_set", split)
        for i in range(TRAINER_VALID):
            n = int(rng.uniform(3.0, 10.0) * SR)
            clean = speech_like(rng, n)
            noisy = clean + 0.05 * rng.standard_normal(n).astype(np.float32)
            write_wav(os.path.join(d, "clean", f"clean_fileid_{i}.wav"), clean, SR)
            write_wav(os.path.join(d, "noisy", f"book_snr{i}_fileid_{i}.wav"), noisy, SR)
        valid_dirs.append(d)
    return {"lists": {k: os.path.join(base, f"{k}.txt") for k in lists}, "valid": valid_dirs}


def trainer_toml(root: str, corpus: dict, name: str, model: dict | None = None) -> str:
    """configs/train.toml with the corpus paths, a save_dir under root and
    TRAINER_EPOCHS epochs (and `model` for its [model] table); returns its
    path."""
    from fullsubnet_plus_torch.utils.config import dump_config, load_config

    config = load_config(os.path.join(REPO, "configs", "train.toml"))
    if model is not None:
        config["model"] = model
    config["meta"]["save_dir"] = os.path.join(root, "runs", name)
    args = config["train_dataset"]["args"]
    for kind in ("clean", "noise", "rir"):
        args[f"{kind}_dataset"] = corpus["lists"][kind]
    config["validation_dataset"]["args"]["dataset_dir_list"] = corpus["valid"]
    config["trainer"]["train"]["epochs"] = TRAINER_EPOCHS
    path = os.path.join(root, f"train_{name}.toml")
    dump_config(config, path)
    return path


def jax_checkpoint_keys(model: str = "fullsubnet_plus") -> set:
    """The keys of the JAX package's latest_model.npz for `model`: the
    parameter tree's paths (io/convert.py's key table, held equal to JAX's
    by tests/test_torch_checkpoint.py) under params/ and Adam's mu/ and nu/,
    Adam's count and the step."""
    from fullsubnet_plus_torch.io.checkpoint import ADAM_PREFIX
    from fullsubnet_plus_torch.io.convert import key_table

    paths = [p for p, _, _ in key_table(model=model)]
    return ({f"params/{p}" for p in paths} | {f"{ADAM_PREFIX}/{m}/{p}" for m in ("mu", "nu")
                                               for p in paths}
            | {f"{ADAM_PREFIX}/count", "step"})


class MemoryLoader:
    """One epoch's batches of a BatchLoader, synthesized once and then
    yielded from memory for every epoch."""

    def __init__(self, loader, epoch: int):
        self.batches = list(loader.epoch(epoch))

    def epoch(self, epoch: int):
        yield from self.batches


def build_trainer(config_path: str, *flags: str, device: str = "cuda:0"):
    """The CLI's own path in this process (parse_args, then build_trainer);
    `.train()` is the rest of its main. `--device cuda:0` trains on one card
    on any machine; a bare "cuda" takes `auto_mesh` of every visible card."""
    from fullsubnet_plus_torch.cli import train as cli
    from fullsubnet_plus_torch.utils.config import load_config

    args = cli.parse_args(["-C", config_path, "--device", device, *flags])
    return cli.build_trainer(load_config(config_path), args)


def run_trainer(trainer, phase: str = "[8]") -> dict:
    """Train; the kernels' launches during the run."""
    reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    print(f"{phase} {len(trainer.history)} epoch(s) trained and validated in "
          f"{time.perf_counter() - t0:.1f} s")
    return all_launches()


def check_trainer_run(tag: str, trainer, launches: dict, bf16: bool,
                      prior_scores: tuple = (), model: str = "fullsubnet_plus",
                      per_step: int = 1, phase: str = "[8]") -> dict:
    """The run's launches, losses and files (after `prior_scores`, the
    (epoch, score) pairs of the runs it resumed); its figures. A train step
    launches the forward and the backward kernel, and a validation batch K1,
    `per_step` times each (FullSubNet: 2, its two LSTMs)."""
    from fullsubnet_plus_torch.io.checkpoint import load_flat

    epochs = [r for r in trainer.history if "train_loss" in r]
    steps = sum(r["steps"] for r in epochs)
    valid = [r["validation"] for r in epochs]
    valid_batches = sum(v["batches"] for v in valid)
    backward = "lstm2_bwd_wgrad" if bf16 else float32_backward()
    want = {k: 0 for k in launches}
    want.update({"lstm2_train_fwd": per_step * steps, backward: per_step * steps,
                 "lstm2_fwd": per_step * valid_batches})
    if launches != want:
        fail(f"trainer {tag}: launches {launches}, expected {want} ({steps} steps, "
             f"{valid_batches} validation batches)")
    if steps != len(epochs) * TRAINER_STEPS or len(valid) != len(epochs):
        fail(f"trainer {tag}: {steps} steps and {len(valid)} validations in "
             f"{len(epochs)} epochs")
    for r in epochs:
        if (r["skipped"] or not np.isfinite(r["train_loss"])
                or not all(np.isfinite(v) for v in r["validation"]["losses"].values())):
            fail(f"trainer {tag} epoch {r['epoch']}: {r}")
    ckpt_dir = trainer.ckpt.ckpt_dir
    keys = jax_checkpoint_keys(model)
    params = {k for k in keys if k.startswith("params/")}
    for name in ["latest_model.npz", "best_model.npz"] + [f"model_{r['epoch']:04d}.npz"
                                                         for r in epochs]:
        path = os.path.join(ckpt_dir, name)
        if not os.path.exists(path):
            fail(f"trainer {tag}: no {name}")
        flat, meta = load_flat(path)
        want_keys = params if name.startswith("model_") else keys
        if set(flat) != want_keys or not {"epoch", "best_score", "lr"} <= set(meta):
            fail(f"trainer {tag}: {name} holds {len(flat)} keys (want {len(want_keys)}: "
                 f"missing {sorted(want_keys - set(flat))[:3]}, extra "
                 f"{sorted(set(flat) - want_keys)[:3]}), meta {meta}")
    # best_model.npz is the last epoch whose score reached the best so far
    scores = [*prior_scores, *((r["epoch"], r["validation"]["score"]) for r in epochs)]
    best, gated = -np.inf, None
    for epoch, score in scores:
        if score >= best:
            best, gated = score, epoch
    _, best_meta = load_flat(os.path.join(ckpt_dir, "best_model.npz"))
    if best_meta["epoch"] != gated or best_meta["best_score"] != best:
        fail(f"trainer {tag}: best_model.npz {best_meta}, the gate passed last at epoch "
             f"{gated} (scores {scores})")
    wall = sum(r["wall_s"] for r in epochs)
    walls = [w for r in epochs for w in r["step_walls_ms"][1:]]
    out = {"epochs": [r["epoch"] for r in epochs], "steps": steps,
           "train_loss": [r["train_loss"] for r in epochs],
           "median_step_wall_ms": statistics.median(walls) if walls else None,
           "audio_s_per_s": steps * TRAIN_BATCH * TRAIN_SAMPLES / SR / wall,
           "loader_wait_share": sum(r["loader_wait_s"] for r in epochs) / wall,
           "validation": {"scores": scores, "best_epoch": best_meta["epoch"],
                          "batches": valid_batches, "eval_s": [v["eval_s"] for v in valid],
                          "metrics_s": [v["metrics_s"] for v in valid],
                          "metric_means": valid[-1]["metrics"]},
           "launches": launches}
    print(f"{phase} trainer {tag}: epochs {out['epochs']}, {steps} steps, train loss "
          f"{', '.join(f'{v:.6f}' for v in out['train_loss'])}; median step wall "
          f"{out['median_step_wall_ms']} ms, {out['audio_s_per_s']:.1f} audio-s/s over the "
          f"epochs' training wall, loader-wait share {out['loader_wait_share']:.3f}; "
          f"validation scores {scores}, eval {out['validation']['eval_s']} s, metrics "
          f"{out['validation']['metrics_s']} s; best_model.npz epoch {best_meta['epoch']}; "
          f"launches {launches}")
    return out


def phase_trainer(root: str) -> dict:
    """The training CLI at the full width of configs/train.toml on a seeded
    corpus: float32 2 epochs, then -R for the third; the same 3 epochs
    unbroken; bf16 1 epoch. The float32 runs use deterministic algorithms
    (torch.use_deterministic_algorithms, deterministic cuDNN), so the -R run
    can be held to the unbroken one; each dtype's default is profiled over
    one more epoch."""
    from fullsubnet_plus_torch.data import native
    from fullsubnet_plus_torch.io.checkpoint import flat_from_train_state, load_flat

    t0 = time.perf_counter()
    others = sorted(t.name for t in threading.enumerate() if t is not threading.main_thread())
    corpus = write_trainer_corpus(root)
    paths = {name: trainer_toml(root, corpus, name) for name in ("resumed", "unbroken", "bf16")}
    t1 = time.perf_counter()
    native_mixing = native.available()  # g++ builds the library here, not in an epoch
    print(f"[8] corpus written in {t1 - t0:.1f} s; native mixing {native_mixing} (ready in "
          f"{time.perf_counter() - t1:.1f} s); threads besides the main one: {others}")
    runs = {}
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        first = build_trainer(paths["resumed"], "--epochs", "2")
        runs["float32_epochs_1_2"] = check_trainer_run("float32 epochs 1-2", first,
                                                       run_trainer(first), False)
        saved, _ = load_flat(first.ckpt.latest_path)
        live = flat_from_train_state(first.state)
        resumed = build_trainer(paths["resumed"], "-R")
        restored = flat_from_train_state(resumed.state)
        runs["float32_resumed_epoch_3"] = check_trainer_run(
            "float32 -R epoch 3", resumed, run_trainer(resumed), False,
            prior_scores=tuple(runs["float32_epochs_1_2"]["validation"]["scores"]))
        unbroken = build_trainer(paths["unbroken"])
        runs["float32_unbroken"] = check_trainer_run("float32 unbroken", unbroken,
                                                     run_trainer(unbroken), False)
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic = before[2]

    # -R resumed the saved state (which is the live one) bit for bit
    equal = (set(saved) == set(restored) == set(live)
             and all(saved[k].dtype == restored[k].dtype == live[k].dtype
                     and np.array_equal(saved[k], restored[k])
                     and np.array_equal(saved[k], live[k]) for k in saved))
    after = runs["float32_resumed_epoch_3"]["train_loss"][-1]
    straight = runs["float32_unbroken"]["train_loss"][TRAINER_EPOCHS - 1]
    rel = abs(after - straight) / abs(straight)
    print(f"[8] -R resumed the saved state bit for bit: {equal}; epoch {TRAINER_EPOCHS} "
          f"train loss after -R {after:.9f}, unbroken {straight:.9f}, relative {rel:.2e} "
          f"(limit {TRAINER_RESUME_RTOL:g})")
    if not equal:
        fail("the state -R resumed differs from the saved one")
    if rel > TRAINER_RESUME_RTOL or runs["float32_resumed_epoch_3"]["epochs"] != [3]:
        fail(f"epoch {TRAINER_EPOCHS} after -R differs from the unbroken run's")

    bf16 = build_trainer(paths["bf16"], "--bf16", "--epochs", "1")
    runs["bfloat16"] = check_trainer_run("bf16", bf16, run_trainer(bf16), True)

    # the device's busy and idle share over one more epoch of each dtype
    # (each dtype's default algorithms) fed by the loader (profiled), then
    # the wall of the same epoch's batches kept in memory: what the host's
    # mixing costs (its idle share from the profiled epoch's busy time)
    profiles = {}
    for tag, trainer in (("float32", unbroken), ("bfloat16", bf16)):
        epoch = trainer.history[-1]["epoch"] + 1

        def one_epoch(trainer=trainer, epoch=epoch):
            trainer._train_epoch(epoch)
            torch.cuda.synchronize()

        def summary_of(records, wall_ms, busy_ms):
            return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                    "idle_share": max(0.0, 1 - busy_ms / wall_ms),
                    "audio_s_per_s": TRAINER_STEPS * TRAIN_BATCH * TRAIN_SAMPLES / SR
                    / wall_ms * 1e3,
                    "loader_wait_share": sum(r["loader_wait_s"] for r in records)
                    / sum(r["wall_s"] for r in records),
                    "median_step_wall_ms": statistics.median(
                        w for r in records for w in r["step_walls_ms"][1:])}

        label = f"[8] profile trainer {tag} epoch ({TRAINER_STEPS} steps, fed by the loader):"
        start = len(trainer.history)
        profile_call(one_epoch, label)
        busy = PROFILES[label]["device_busy_ms"]
        profiles[tag] = {"loader": summary_of(trainer.history[start:],
                                              PROFILES[label]["wall_ms"], busy)}
        loader, trainer.train_loader = trainer.train_loader, MemoryLoader(trainer.train_loader,
                                                                           epoch)
        one_epoch()
        start, walls = len(trainer.history), []
        for _ in range(3):
            t0 = time.perf_counter()
            one_epoch()
            walls.append((time.perf_counter() - t0) * 1e3)
        trainer.train_loader = loader
        profiles[tag]["in_memory"] = summary_of(trainer.history[start:],
                                                statistics.median(walls), busy)
        for feed, figures in profiles[tag].items():
            print(f"[8] trainer {tag} epoch fed by {feed}: "
                  + ", ".join(f"{k} {v:.4g}" for k, v in figures.items()))
    summary = {"runs": runs, "profile_epoch": profiles, "native_mixing": native_mixing,
               "float32_runs_deterministic": True, "resume_bit_equal": equal,
               "epoch3_rel_diff": rel}
    print(json.dumps({"trainer": summary}))
    return {**summary, "corpus": corpus}  # phase 11 trains FullSubNet on the same corpus


# Phase 9: multi-device. Ranks run as this script in worker mode
# (`--dp-rank` / `--cli-rank JOB RANK`), each its own process, one card each.

def jax_modules() -> list:
    import sys

    return [m for m in sys.modules
            if m == "jax" or m.startswith(("jax.", "jaxlib", "fullsubnet_plus_tpu"))]


def rank_group(job: dict, rank: int):
    """This worker's process group and its 1 x 1 mesh part (its card)."""
    import datetime

    import torch.distributed as dist

    from fullsubnet_plus_torch.parallel import mesh as pmesh

    device = torch.device(job["devices"][rank])
    pmesh.TIMEOUT_S = 300  # a rank whose peer died fails the phase soon
    if job["world"] > 1:
        pmesh.initialize_distributed(job["coordinator"], job["world"], rank, device=device)
    else:  # a 1-rank group: initialize_distributed leaves one process alone
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=f"tcp://{job['coordinator']}",
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=pmesh.TIMEOUT_S))
    return device, pmesh.make_mesh(job["world"], 1, devices=[device])


def train_setup():
    """(model_def, config, optimizer, loss_fn, acoustics) of configs/train.toml."""
    from fullsubnet_plus_torch.models import get_model
    from fullsubnet_plus_torch.train import loss, step
    from fullsubnet_plus_torch.utils.config import load_config

    toml = load_config(os.path.join(REPO, "configs", "train.toml"))
    model_def = get_model(toml["model"]["path"])
    config = model_def.make_config(toml["model"]["args"])
    optimizer = step.make_optimizer(
        **toml["optimizer"], clip_grad_norm=toml["trainer"]["train"]["clip_grad_norm_value"])
    acoustics = {k: toml["acoustics"][k] for k in ("n_fft", "hop_length", "win_length")}
    return model_def, config, optimizer, loss.get_loss(toml["loss_function"]["name"]), acoustics


def state_from(saved: dict, device):
    """A TrainState on `device` holding `saved` (TrainState.state_dict())."""
    from fullsubnet_plus_torch.train import step

    model_def, config, optimizer, _, _ = train_setup()
    state = step.init_train_state(model_def.module_cls(config), optimizer, device=device)
    return state.load_state_dict(saved)


def card_launches() -> dict:
    """The training kernels' launch counts by kernel and card since the last
    reset ("lstm2_bwd cuda:1")."""
    from fullsubnet_plus_torch.ops import lstm2_train

    return dict(lstm2_train.LAUNCHES_BY_CARD)


def dp_step_runs(state_of, make_step, batches, rows, keep_params: bool = False) -> dict:
    """One step of each dtype from the saved state on batch 0's `rows`
    (metrics and launches), then TRAIN_STEPS float32 steps (walls, the time
    until each step returns to the host, launches, the parameters' digest); with `keep_params` the parameters after the
    float32 step and after the steps, flat on the host."""
    import hashlib

    out = {}
    for tag, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        train_step = make_step(dtype)
        state = state_of()
        reset_launches()
        _, m = train_step(state, batches["noisy"][0][rows], batches["clean"][0][rows])
        torch.cuda.synchronize()
        out[tag] = {"metrics": {k: float(v) for k, v in m.items()}, "launches": all_launches(),
                    "launches_by_card": card_launches()}
        if keep_params:
            out[tag]["params"] = flat_params(state)
    train_step, state, walls, hosts = make_step(torch.float32), state_of(), [], []
    reset_launches()
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batches["noisy"][i][rows], batches["clean"][i][rows])
        hosts.append((time.perf_counter() - t0) * 1e3)  # until the step returns, unsynced
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    digest = hashlib.sha256()
    for p in state.model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    out["steps"] = {"walls_ms": walls, "median_wall_ms": statistics.median(walls[1:]),
                    "median_host_ms": statistics.median(hosts[1:]),
                    "launches": all_launches(), "launches_by_card": card_launches(),
                    "params_sha256": digest.hexdigest(),
                    "last": {k: float(v) for k, v in m.items()},
                    "state_devices": sorted({str(t.device) for t in (
                        *state.model.parameters(), state.opt_state.mu, state.opt_state.nu)})}
    if keep_params:
        out["steps"]["params"] = flat_params(state)
    return out


def flat_params(state) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).cpu() for p in state.model.parameters()])


def dp_rank_main(job_path: str, rank: str) -> None:
    """Worker: one rank of phase 9's data-parallel step check."""
    import torch.distributed as dist

    from fullsubnet_plus_torch.train import step

    job, rank = json.load(open(job_path)), int(rank)
    device, mesh = rank_group(job, rank)
    model_def, config, optimizer, loss_fn, acoustics = train_setup()
    saved = torch.load(job["state"])
    batches = np.load(job["batches"])
    rows = slice(rank * job["rows"], (rank + 1) * job["rows"])

    def make_step(dtype):
        return step.make_train_step(model_def, config, optimizer, loss_fn, compute_dtype=dtype,
                                    mesh=mesh, **acoustics)

    out = dp_step_runs(lambda: state_from(saved, device), make_step, batches, rows)
    out.update(rank=rank, world=job["world"], backend=dist.get_backend(), device=str(device),
               card=torch.cuda.get_device_name(device), mesh=mesh.shape,
               jax_modules=jax_modules())
    print("DP_RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def cli_rank_main(job_path: str, rank: str) -> None:
    """Worker: one rank of the training CLI, through its flags (parse_args
    and build_trainer, then train, as its main does)."""
    import torch.distributed as dist

    from fullsubnet_plus_torch.cli import train as cli
    from fullsubnet_plus_torch.utils.config import load_config

    job, rank = json.load(open(job_path)), int(rank)
    flags = ["-C", job["configs"][rank], "--device", job["devices"][rank], "--epochs", "1",
             "--coordinator", job["coordinator"], "--num-hosts", str(job["world"]),
             "--host-id", str(rank)]
    args = cli.parse_args(flags)
    trainer = cli.build_trainer(load_config(args.configuration), args)
    reset_launches()
    trainer.train()
    torch.cuda.synchronize()
    epochs = [r for r in trainer.history if "train_loss" in r]
    out = {"rank": rank, "backend": dist.get_backend(), "primary": trainer.is_primary,
           "launches": all_launches(),
           "train_loss": [r["train_loss"] for r in epochs],
           "steps": sum(r["steps"] for r in epochs), "wall_s": sum(r["wall_s"] for r in epochs),
           "median_step_wall_ms": statistics.median(
               w for r in epochs for w in r["step_walls_ms"][1:]),
           "loader_wait_s": sum(r["loader_wait_s"] for r in epochs),
           "validation_batches": sum(r.get("validation", {}).get("batches", 0)
                                     for r in trainer.history),
           "jax_modules": jax_modules()}
    print("DP_RESULT " + json.dumps(out), flush=True)


def run_ranks(mode: str, job: dict, root: str, tag: str) -> list:
    """Start `job["world"]` workers of `mode` together; their results."""
    job = {**job, "coordinator": f"127.0.0.1:{free_port()}"}
    path = os.path.join(root, f"job_{tag}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    procs = [subprocess.Popen(["python3", SCRIPT, mode, path, str(r)], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(job["world"])]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        lines = [ln for ln in log.splitlines() if ln.startswith("DP_RESULT ")]
        if p.returncode != 0 or len(lines) != 1:
            fail(f"[9] {tag} rank {r} exited {p.returncode}:\n{log[-4000:]}")
        results.append(json.loads(lines[0][len("DP_RESULT "):]))
    return results


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def phase_data_parallel(root: str, saved: dict, batches: dict, cards: list) -> dict:
    """(a) The data-parallel step at configs/train.toml's width: DP_RANKS
    ranks of DP_ROWS rows on two cards over NCCL, or with one card two
    ranks sharing it (gloo: `initialize_distributed` picks it where the ranks
    outnumber the cards) and then a 1-rank NCCL group of all TRAIN_BATCH rows;
    each against the 1-rank step at TRAIN_BATCH from the same state (a copy
    of phase 6's), launches per step per rank, parameters bit-equal across
    ranks after TRAIN_STEPS steps, the step walls beside the 1-rank ones."""
    from fullsubnet_plus_torch.train import step

    torch.cuda.empty_cache()  # the ranks' processes share the card with this one
    model_def, config, optimizer, loss_fn, acoustics = train_setup()
    state_path = os.path.join(root, "dp_state.pt")
    torch.save(saved, state_path)
    batch_path = os.path.join(root, "dp_batches.npz")
    np.savez(batch_path, **batches)

    def make_step(dtype):
        return step.make_train_step(model_def, config, optimizer, loss_fn, compute_dtype=dtype,
                                    device=cards[0], **acoustics)

    one = dp_step_runs(lambda: state_from(saved, cards[0]), make_step, batches, slice(None),
                       keep_params=True)
    print(f"[9] 1 rank, batch {TRAIN_BATCH}: float32 step returns to the host after "
          f"{one['steps']['median_host_ms']:.1f} ms (median); float32 loss "
          f"{one['float32']['metrics']['loss']:.6f} grad norm "
          f"{one['float32']['metrics']['grad_norm']:.6f}; bf16 "
          f"{one['bfloat16']['metrics']['loss']:.6f} / "
          f"{one['bfloat16']['metrics']['grad_norm']:.6f}; float32 step wall median "
          f"{one['steps']['median_wall_ms']:.1f} ms")
    nccl = "nccl" if cards[0].startswith("cuda") else "gloo"
    groups = ([(nccl, DP_RANKS, cards[:2])] if len(cards) >= 2 else
              [("gloo", DP_RANKS, cards * 2), (nccl, 1, cards)])
    out = {"one_rank": one, "runs": {}}
    for backend, world, devices in groups:
        tag = f"{backend}_{world}"
        ranks = run_ranks("--dp-rank", {"world": world, "devices": devices,
                                        "rows": TRAIN_BATCH // world, "state": state_path,
                                        "batches": batch_path}, root, tag)
        print(f"[9] data-parallel {tag}: backend {[r['backend'] for r in ranks]}, {world} "
              f"rank(s) on {[r['device'] for r in ranks]} ({ranks[0]['card']}), mesh "
              f"{ranks[0]['mesh']}")
        if any(r["backend"] != backend for r in ranks):
            fail(f"[9] {tag}: the ranks' process group is not {backend}")
        for r in ranks:
            if r["jax_modules"]:
                fail(f"[9] rank {r['rank']} imported {r['jax_modules']}")
            for form, backward, loss_rtol, norm_rtol in (
                    ("float32", float32_backward(), TRAIN_LOSS_RTOL, TRAIN_GRAD_NORM_RTOL),
                    ("bfloat16", "lstm2_bwd_wgrad", DP_BF16_LOSS_RTOL, DP_BF16_GRAD_NORM_RTOL)):
                m, ref = r[form]["metrics"], one[form]["metrics"]
                gaps = (rel(m["loss"], ref["loss"]), rel(m["grad_norm"], ref["grad_norm"]))
                print(f"[9] {tag} rank {r['rank']} {form}: loss {m['loss']:.6f} grad norm "
                      f"{m['grad_norm']:.6f}, against 1 rank {gaps[0]:.2e} / {gaps[1]:.2e} "
                      f"(limits {loss_rtol:g} / {norm_rtol:g}); launches {r[form]['launches']}")
                if gaps[0] > loss_rtol or gaps[1] > norm_rtol or m["skipped"] != 0.0:
                    fail(f"[9] {tag} rank {r['rank']} {form} disagrees with the 1-rank step")
                want = {k: 0 for k in r[form]["launches"]}
                want.update({"lstm2_train_fwd": 1, backward: 1})
                if r[form]["launches"] != want:
                    fail(f"[9] {tag} rank {r['rank']} {form} launches {r[form]['launches']}")
            want = {k: 0 for k in r["steps"]["launches"]}
            want.update({"lstm2_train_fwd": TRAIN_STEPS, float32_backward(): TRAIN_STEPS})
            if r["steps"]["launches"] != want:
                fail(f"[9] {tag} rank {r['rank']} float32 steps launched {r['steps']['launches']}")
        digests = {r["steps"]["params_sha256"] for r in ranks}
        print(f"[9] {tag}: after {TRAIN_STEPS} float32 steps parameters bit-equal across "
              f"ranks: {len(digests) == 1}; step wall median "
              f"{[round(r['steps']['median_wall_ms'], 1) for r in ranks]} ms (each "
              f"{[[round(w) for w in r['steps']['walls_ms']] for r in ranks]}) against "
              f"{one['steps']['median_wall_ms']:.1f} on 1 rank; global batch "
              f"{TRAIN_BATCH} at {TRAIN_BATCH * TRAIN_SAMPLES / SR / max(r['steps']['median_wall_ms'] for r in ranks) * 1e3:.1f} audio-s/s "
              f"against {TRAIN_BATCH * TRAIN_SAMPLES / SR / one['steps']['median_wall_ms'] * 1e3:.1f}")
        if len(digests) != 1:
            fail(f"[9] {tag}: parameters differ across ranks after {TRAIN_STEPS} steps")
        out["runs"][tag] = ranks
    return out


def phase_cli_ranks(root: str, cards: list, one_rank: float | None = None) -> dict:
    """(b) `cli.train` as the same ranks through its flags for 1 float32
    epoch on phase 8's corpus (each rank its own save_dir in its config, so
    rank 1's shows what it wrote): every rank finishes, only rank 0 wrote
    files, the losses are equal, K2 and the float32 default backward
    (`float32_backward`) once a step on every rank and K1
    once a validation batch on rank 0 alone. `one_rank`: phase 8's 1-rank
    trainer audio-s/s, printed beside the ranks'."""
    corpus = {"lists": {k: os.path.join(root, "corpus", f"{k}.txt")
                        for k in ("clean", "noise", "rir")},
              "valid": [os.path.join(root, "corpus", "test_set", s)
                        for s in ("with_reverb", "no_reverb")]}
    torch.cuda.empty_cache()
    backend, devices = (("nccl", cards[:2]) if len(cards) >= 2 and cards[0].startswith("cuda")
                        else ("gloo", (cards * 2)[:2]))
    configs = [trainer_toml(root, corpus, f"dp_rank{r}") for r in range(DP_RANKS)]
    save_dirs = [os.path.join(root, "runs", f"dp_rank{r}") for r in range(DP_RANKS)]
    ranks = run_ranks("--cli-rank", {"world": DP_RANKS, "devices": devices,
                                     "configs": configs}, root, "cli")
    if any(r["backend"] != backend for r in ranks):
        fail(f"[9] the CLI's ranks chose {[r['backend'] for r in ranks]}, not {backend}")
    audio = [r["steps"] * TRAIN_BATCH * DP_RANKS * TRAIN_SAMPLES / SR / r["wall_s"] for r in ranks]
    written = sorted(os.path.relpath(os.path.join(d, f), save_dirs[0])
                     for d, _, files in os.walk(save_dirs[0]) for f in files)
    print(f"[9] cli.train as {DP_RANKS} {backend} ranks on {devices}, 1 float32 epoch: losses "
          f"{[r['train_loss'] for r in ranks]}, {ranks[0]['steps']} steps a rank at batch "
          f"{TRAIN_BATCH} a rank, median step wall {[round(r['median_step_wall_ms'], 1) for r in ranks]} ms, "
          f"trainer {[round(a, 1) for a in audio]} audio-s/s (global batch "
          f"{TRAIN_BATCH * DP_RANKS}; 1 rank in phase 8: {one_rank}); launches {[r['launches'] for r in ranks]}; rank 0 wrote "
          f"{written}; rank 1's save_dir exists: {os.path.exists(save_dirs[1])}")
    if ranks[0]["train_loss"] != ranks[1]["train_loss"] or not ranks[0]["steps"]:
        fail("[9] the CLI's ranks disagree on the epoch's loss")
    if os.path.exists(save_dirs[1]) or not {"train.log", "config.toml", "run_complete.json",
                                            "checkpoints/latest_model.npz"} <= set(written):
        fail("[9] not rank 0 alone wrote the run's files")
    for r in ranks:
        want = {k: 0 for k in r["launches"]}
        want.update({"lstm2_train_fwd": r["steps"], float32_backward(): r["steps"],
                     "lstm2_fwd": r["validation_batches"]})
        if (r["launches"] != want or r["primary"] != (r["rank"] == 0) or r["jax_modules"]
                or (r["rank"] == 0) != (r["validation_batches"] > 0)):
            fail(f"[9] CLI rank {r['rank']}: launches {r['launches']}, validation batches "
                 f"{r['validation_batches']}, primary {r['primary']}")
    return {"backend": backend, "devices": devices, "ranks": ranks, "audio_s_per_s": audio}


def check_card_fold() -> dict:
    """K2, K3 and K4 at a card's fold of (d) (N_CARD, T_TRAIN) in both
    dtypes: against their plain versions at phase 2's floors, and timed
    beside their bounds."""
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, dy, lstm, fc = train_operands(N_CARD, T_TRAIN, dtype, seed=N_CARD + 5)
        w = lstm.packed(fc)
        y_ref, res_ref = lt.lstm2_train_fwd_reference(x, w)
        y, res = lt.lstm2_train_fwd(x, w)
        k2 = worst((y_ref, *res_ref), (y, *res))
        del y, res
        ref = lt.lstm2_bwd_reference(dy, x, w, res_ref)
        k4 = worst(ref[:3], lt.lstm2_bwd_sweep(dy, x, w, res_ref)[:3])
        want = lt.LSTM2Grads(ref.dx, *lt.weight_grads(x, res_ref, ref.dg1, ref.dg2)[:4],
                             ref.db1, ref.db2)
        del ref
        k3 = worst(want, lt.lstm2_bwd(dy, x, w, res_ref, fused=True))
        del want, y_ref
        ms = {"lstm2_train_fwd": cuda_ms(lambda: lt.lstm2_train_fwd(x, w), reps=3),
              "lstm2_bwd": cuda_ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res_ref), reps=3),
              "lstm2_bwd_wgrad": cuda_ms(lambda: lt.lstm2_bwd(dy, x, w, res_ref, fused=True),
                                         reps=3)}
        bounds = train_bounds(dtype, n=N_CARD)
        for name, (snr, err) in (("lstm2_train_fwd", k2), ("lstm2_bwd", k4),
                                 ("lstm2_bwd_wgrad", k3)):
            out[(name, dtype)] = {"ms": ms[name], "bound_ms": bounds[name][0],
                                  "bound_by": bounds[name][1], "min_snr_db": snr,
                                  "max_abs_err": err}
            print(f"[9] (d) {name} {str(dtype)[6:]} at a card's fold N={N_CARD} T={T_TRAIN}: "
                  f"{ms[name]:.3f} ms, bound {bounds[name][0]:.3f} ms ({bounds[name][1]}); "
                  f"against plain {snr:.1f} dB max_abs {err:.3e} (floor "
                  f"{SNR_FLOOR[dtype]:.0f} dB)")
            if snr < SNR_FLOOR[dtype]:
                fail(f"[9] {name} disagrees at N={N_CARD}: {snr:.1f} dB")
        del res_ref
        torch.cuda.empty_cache()
    return out


def profile_by_card(fn) -> dict:
    """One call of `fn` (which must return synchronized) under
    torch.profiler: {card index: device busy ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    busy = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.device_index] += e.self_device_time_total / 1e3
    return dict(sorted(busy.items()))


def param_gap(a: torch.Tensor, b: torch.Tensor) -> dict:
    diff = (a - b).abs()
    return {"max_abs_diff": float(diff.max()),
            "share_within_1e-4": float((diff <= 1e-4).double().mean()),
            "equal": bool((diff == 0).all())}


def phase_train_mesh(saved: dict, batches: dict, cards: list, one: dict, ranks: dict) -> dict:
    """(d) `make_train_step(mesh=)` on a mesh of two cards in one process at
    configs/train.toml's width and batch, from (a)'s copy of phase 6's
    state: the rows over 'data' (2 x 1) and the sub-band fold over 'freq'
    (1 x 2, fold_sharding naming it), on 2 cards, or with one card on a mesh
    that names it twice (the two copies of the model, or the fold's two
    halves, then share it). Each mesh's float32 and bf16 step (K2 and each
    dtype's default backward) against (a)'s 1-card step within phase 6's and DP_BF16_*'s limits,
    K2 and the backward once a step on each card or fold half (counted by
    card), the state on the mesh's first card, the parameters after that
    float32 step against the 1-card step's (PARAM_SHARE_FLOOR) and after
    TRAIN_STEPS float32 steps beside the 1-card run's, and the step walls
    beside the 1-card and the 2-rank ones (`ranks`: (a)'s runs); then the
    kernels at a card's fold (`check_card_fold`)."""
    import dataclasses

    from fullsubnet_plus_torch.parallel import make_mesh
    from fullsubnet_plus_torch.train import step

    torch.cuda.empty_cache()
    model_def, config, optimizer, loss_fn, acoustics = train_setup()
    devices = (cards * 2)[:2]
    rank_walls = {tag: [round(r["steps"]["median_wall_ms"], 1) for r in rs]
                  for tag, rs in ranks.items()}
    out = {"devices": devices, "meshes": {}}
    for name, shape, fold in TRAIN_MESHES:
        mesh = make_mesh(*shape, devices=devices)
        mesh_config = dataclasses.replace(config, fold_sharding=fold)

        def make_step(dtype, mesh=mesh, mesh_config=mesh_config):
            return step.make_train_step(model_def, mesh_config, optimizer, loss_fn,
                                        compute_dtype=dtype, mesh=mesh, **acoustics)

        run = dp_step_runs(lambda: state_from(saved, devices[0]), make_step, batches,
                           slice(None), keep_params=True)
        tag = f"mesh {shape[0]}x{shape[1]} on {devices} (fold_sharding {fold})"
        for form, backward, loss_rtol, norm_rtol in (
                ("float32", float32_backward(), TRAIN_LOSS_RTOL, TRAIN_GRAD_NORM_RTOL),
                ("bfloat16", "lstm2_bwd_wgrad", DP_BF16_LOSS_RTOL, DP_BF16_GRAD_NORM_RTOL)):
            m, ref = run[form]["metrics"], one[form]["metrics"]
            gaps = (rel(m["loss"], ref["loss"]), rel(m["grad_norm"], ref["grad_norm"]))
            print(f"[9] (d) {tag} {form}: loss {m['loss']:.6f} grad norm {m['grad_norm']:.6f}, "
                  f"against 1 card {gaps[0]:.2e} / {gaps[1]:.2e} (limits {loss_rtol:g} / "
                  f"{norm_rtol:g}); launches by card {run[form]['launches_by_card']}")
            if gaps[0] > loss_rtol or gaps[1] > norm_rtol or m["skipped"] != 0.0:
                fail(f"[9] (d) {tag} {form} disagrees with the 1-card step")
            want = {k: 0 for k in run[form]["launches"]}
            want.update({"lstm2_train_fwd": 2, backward: 2})
            by_card = {f"{k} {d}": devices.count(d) for k in ("lstm2_train_fwd", backward)
                       for d in devices}
            if run[form]["launches"] != want or run[form]["launches_by_card"] != by_card:
                fail(f"[9] (d) {tag} {form}: launches {run[form]['launches']} by card "
                     f"{run[form]['launches_by_card']}, expected {want}, {by_card}")
        steps = run["steps"]
        want = {k: 0 for k in steps["launches"]}
        want.update({"lstm2_train_fwd": 2 * TRAIN_STEPS, float32_backward(): 2 * TRAIN_STEPS})
        by_card = {f"{k} {d}": TRAIN_STEPS * devices.count(d)
                   for k in ("lstm2_train_fwd", float32_backward()) for d in devices}
        if steps["launches"] != want or steps["launches_by_card"] != by_card:
            fail(f"[9] (d) {tag} float32 steps launched {steps['launches']} by card "
                 f"{steps['launches_by_card']}")
        if steps["state_devices"] != [devices[0]] or not np.isfinite(steps["last"]["loss"]):
            fail(f"[9] (d) {tag}: the state lies on {steps['state_devices']}, last step "
                 f"{steps['last']}")
        params = {n: param_gap(r.pop("params"), o["params"])
                  for n, r, o in (("one_step", run["float32"], one["float32"]),
                                  (f"{TRAIN_STEPS}_steps", steps, one["steps"]))}
        print(f"[9] (d) {tag}: the float32 parameters against the 1-card run's after its step "
              f"from the same state {params['one_step']} and after {TRAIN_STEPS} steps "
              f"{params[f'{TRAIN_STEPS}_steps']}; step wall median {steps['median_wall_ms']:.1f} "
              f"ms (each {[round(w) for w in steps['walls_ms']]}) against "
              f"{one['steps']['median_wall_ms']:.1f} on 1 card and {rank_walls} as 2 ranks (a)")
        # an Adam step moves each parameter by about lr sign(g): from the same
        # state the runs differ only where a gradient near 0 flips sign; a
        # free-running trajectory is no measure (phase 6's note), so it is shown
        if (params["one_step"]["share_within_1e-4"] < PARAM_SHARE_FLOOR
                or not all(np.isfinite(p["max_abs_diff"]) for p in params.values())):
            fail(f"[9] (d) {tag}: the parameters disagree with the 1-card run's: {params}")
        train_step, state = make_step(torch.float32), state_from(saved, devices[0])

        def one_step():
            train_step(state, batches["noisy"][0], batches["clean"][0])
            torch.cuda.synchronize()

        busy = profile_by_card(one_step)
        print(f"[9] (d) {tag}: a float32 step returns to the host after "
              f"{steps['median_host_ms']:.1f} ms of its {steps['median_wall_ms']:.1f} ms wall "
              f"(median); device busy by card {busy} ms (torch.profiler, one step)")
        out["meshes"][name] = {**run, "shape": list(shape), "fold_sharding": fold,
                               "params_vs_one_card": params, "busy_ms_by_card": busy}
    out["card_fold"] = check_card_fold()
    return out


def phase_cli_mesh(root: str, corpus: dict, cards: list) -> dict:
    """(e) `cli.train` without rank flags (`--device cuda`) for one float32
    epoch on phase 8's `corpus`, in this process: it trains on `auto_mesh` of
    every visible card at the TOML's batch (with one card, no mesh),
    validates over the same cards and writes its checkpoints; K2 and the
    float32 default backward once a step on each card, K1 once a validation
    batch on each."""
    from fullsubnet_plus_torch.parallel import auto_mesh

    torch.cuda.empty_cache()
    trainer = build_trainer(trainer_toml(root, corpus, "cli_mesh"), "--epochs", "1",
                            device="cuda")
    mesh, expect = trainer.mesh, auto_mesh(TRAIN_BATCH, devices=cards)
    print(f"[9] (e) cli.train without rank flags on {len(cards)} visible card(s) chose "
          f"{mesh}; validation batch {trainer.valid_batch_size}")
    if ((mesh is None) != (expect is None)
            or (mesh is not None and mesh.data_devices != expect.data_devices)
            or (len(cards) >= 2 and (mesh is None or mesh.local_data < 2))):
        fail(f"[9] (e) cli.train chose {mesh}, auto_mesh over {cards} gives {expect}")
    launches = run_trainer(trainer, "[9] (e)")
    by_card = card_launches()
    out = check_trainer_run("cli mesh", trainer, launches, bf16=False,
                            per_step=mesh.local_data if mesh else 1, phase="[9] (e)")
    steps = out["steps"]
    want = {f"{k} {d}": steps for k in ("lstm2_train_fwd", float32_backward())
            for d in (mesh.data_devices if mesh else [torch.device(cards[0])])}
    print(f"[9] (e) launches by card {by_card}")
    if by_card != want:
        fail(f"[9] (e) launches by card {by_card}, expected {want}")
    return {**out, "mesh": repr(mesh), "launches_by_card": by_card}


def phase_mesh_enhancer(root: str, lengths: list[int], cards: list) -> dict:
    """(c) `Enhancer(mesh=)` on phase 4's batch of 8 in float32, bf16 and
    int8: rows over 'data' (2 x 1), and the fold over 'freq' (1 x 2,
    fold_sharding ("data", "freq")), on 2 cards, or with one card on a mesh
    that names it twice (the two shards, or the fold's two halves, then
    share it: the mesh path through the kernels, no scaling figure); each
    against the 1-card Enhancer at phase 4's floors, K1 / K5 launched once
    for each shard or fold half on its card; the batch's audio-s/s on the
    mesh and on 1 card."""
    from fullsubnet_plus_torch.cli.enhance import load_state_dict
    from fullsubnet_plus_torch.data.wav import read_wav
    from fullsubnet_plus_torch.enhance import Enhancer
    from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
    from fullsubnet_plus_torch.ops import lstm2, lstm2_int8
    from fullsubnet_plus_torch.parallel import make_mesh

    devices = (cards * 2)[:2]
    batch = np.zeros((len(lengths), -(-max(lengths) // SR) * SR), np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = read_wav(os.path.join(root, "noisy", f"utt{i}.wav"))
    audio_s = sum(lengths) / SR
    state = load_state_dict(os.path.join(root, "model.npz"))
    out = {"devices": devices}
    for tag, dtype, floor, counts in (("float32", None, WAVE_SNR_FLOOR, lstm2),
                                      ("bfloat16", "bfloat16", BF16_WAVE_SNR_FLOOR, lstm2),
                                      ("int8", "int8", INT8_WAVE_SNR_FLOOR, lstm2_int8)):
        def timed(enhancer):
            enhancer.enhance_batch(batch, lengths=lengths)  # warm
            walls = []
            for _ in range(MAIN_PATH_RUNS):
                t0 = time.perf_counter()
                y = enhancer.enhance_batch(batch, lengths=lengths)
                walls.append(time.perf_counter() - t0)
            return y, audio_s / statistics.median(walls)

        ref, rate1 = timed(Enhancer(FULLSUBNET_PLUS, FULLSUBNET_PLUS.make_config({}), state,
                                    compute_dtype=dtype, device=devices[0]))
        out[tag] = {"one_card_audio_s_per_s": rate1}
        for name, shape, fold in (("data", (2, 1), None), ("fold", (1, 2), ["data", "freq"])):
            config = FULLSUBNET_PLUS.make_config({"fold_sharding": fold} if fold else {})
            enhancer = Enhancer(FULLSUBNET_PLUS, config, state, compute_dtype=dtype,
                                mesh=make_mesh(*shape, devices=devices))
            reset_launches()
            y = enhancer.enhance_batch(batch, lengths=lengths)
            by_card = dict(counts.LAUNCHES)
            _, rate2 = timed(enhancer)
            snr = snr_db(torch.from_numpy(ref), torch.from_numpy(y))
            out[tag][name] = {"snr_db": snr, "launches_by_card": by_card,
                              "audio_s_per_s": rate2}
            print(f"[9] Enhancer(mesh={shape[0]}x{shape[1]} on {devices}, fold {fold}) {tag}: "
                  f"against 1 card {snr:.1f} dB (floor {floor:.0f}); launches by card "
                  f"{by_card}; {rate2:.1f} audio-s/s on the mesh against {rate1:.1f} on 1 card")
            want = {d: devices.count(d) for d in devices}
            if snr < floor or by_card != want:
                fail(f"[9] Enhancer(mesh=) {name} {tag}: {snr:.1f} dB, launches {by_card}, "
                     f"expected {want}")
    return out


# Phase 10: the model variants at full width (FullSubNet+ of configs/*.toml, seed
# 42): (tag, config overrides, masked). Masked runs take phase 4's 8 wavs with
# their lengths; the rest, whose attention or sub-band grouping JAX refuses to
# mask, 8 wavs of 10 s without lengths (N 2056, T 629 either way).
VARIANT_RUNS = (
    ("SE", {"channel_attention_model": "SE"}, True),
    ("ECA", {"channel_attention_model": "ECA"}, True),
    ("CBAM", {"channel_attention_model": "CBAM"}, True),
    ("DeepTSSE", {"channel_attention_model": "DeepTSSE"}, False),
    ("TSSE_ATT", {"channel_attention_model": "TSSE_ATT"}, False),
    ("subband2_ECA", {"subband_num": 2, "channel_attention_model": "ECA"}, False),
    ("offline_gaussian_norm", {"norm_type": "offline_gaussian_norm"}, True),
    ("cumulative_laplace_norm", {"norm_type": "cumulative_laplace_norm"}, True),
)
VARIANT_TRAIN = ("CBAM", "TSSE_ATT")  # (e): their train steps through K2 + K4 and K2 + K3
LOOP_NORMS = ("forgetting_norm", "hybrid_norm", "sband_forgetting_norm")
JOINT_ALPHA = 0.5  # (f): both steps' blend of their two losses
# bf16 and int8 batches against the plain LSTMs', over 3 seeds x 3 attentions
# on an H100 (scripts/variant_snr_seeds.py): the model's output (compressed
# cIRM) 52-60 dB, the waveform 35.6-57.7 dB
VARIANT_CIRM_SNR_FLOOR = 40.0
VARIANT_WAVE_SNR_FLOOR = 30.0
# (g): the 2-D causal conv blocks at an encoder's width on one batch of
# configs/inference.toml: [B, C, F, T] = [8, 16, 257, 629], 16 -> 32 channels
CAUSAL_SHAPE = (BATCH, 16, 257, T_FULL)
CAUSAL_OUT_CHANNELS = 32


@contextlib.contextmanager
def plain_lstms():
    """The batch path's LSTMs through their plain versions for the duration."""
    from fullsubnet_plus_torch.nn import sequence
    from fullsubnet_plus_torch.ops import lstm2, lstm2_int8

    sequence.lstm2_fc = lstm2.lstm2_fc_reference
    sequence.lstm2_int8_fc = lstm2_int8.lstm2_int8_fc_reference
    try:
        yield
    finally:
        sequence.lstm2_fc = lstm2.lstm2_fc
        sequence.lstm2_int8_fc = lstm2_int8.lstm2_int8_fc


def check_no_tf32(kernels: list, what: str) -> None:
    """List the matrix products and convolutions among profiled kernels and
    fail on a TF32 one."""
    products = [e for e in kernels if re.search(r"gemm|conv|cudnn|cutlass|xmma", e.key, re.I)]
    for e in products:
        print(f"{what}: matrix product / convolution "
              f"{e.self_device_time_total / 1e3:.3f} ms x{e.count} {e.key[:150]}")
    tf32 = [e.key for e in products if TF32_KERNEL.search(e.key)]
    if tf32:
        fail(f"{what} ran TF32 kernels: {tf32}")


def card_and_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def causal_conv_blocks() -> dict:
    """(g) `CausalConvBlock` (16 -> 32, F 257 -> 128) then
    `CausalTransConvBlock` (32 -> 16, F back to 257) in float32 on the card,
    seeded with random BatchNorm2d statistics, against the same modules on
    the CPU: the outputs in eval and training mode, and in training mode
    the gradients of sum(out * w) with respect to x and every parameter, each
    >= SNR_FLOOR (the conv biases', zero, SNR_FLOOR below the BN biases'
    on both sides); training mode leaves the running statistics as they
    were. The training forward and backward profiled: no TF32 product (no
    cuDNN convolution), and timed beside the card's name and power limit."""
    from fullsubnet_plus_torch.nn.layers import reset_parameters
    from fullsubnet_plus_torch.nn.tcn import CausalConvBlock, CausalTransConvBlock

    g = torch.Generator().manual_seed(42)
    b, c, f, t = CAUSAL_SHAPE
    blocks = torch.nn.ModuleList([CausalConvBlock(c, CAUSAL_OUT_CHANNELS),
                                  CausalTransConvBlock(CAUSAL_OUT_CHANNELS, c)])
    reset_parameters(blocks, g)
    with torch.no_grad():
        for block in blocks:
            n = block.norm.weight.shape[0]
            block.norm.weight.copy_(0.5 + torch.rand(n, generator=g))
            block.norm.bias.copy_(torch.rand(n, generator=g) - 0.5)
            block.norm.running_mean.copy_(0.6 * torch.rand(n, generator=g) - 0.3)
            block.norm.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=g))
    x = torch.randn(CAUSAL_SHAPE, generator=g)
    w = torch.randn(CAUSAL_SHAPE, generator=g)
    on_card = copy.deepcopy(blocks).to("cuda")
    x_card, w_card = x.to("cuda"), w.to("cuda")
    stats = {k: v.clone() for k, v in on_card.named_buffers()}

    def run(mods, xx, training):
        return mods[1](mods[0](xx, training=training), training=training)

    def train_grads(mods, xx, ww):
        xx = xx.clone().requires_grad_(True)
        mods.zero_grad(set_to_none=True)
        (run(mods, xx, True) * ww).sum().backward()
        return {"x": xx.grad, **{k: p.grad for k, p in mods.named_parameters()}}

    snrs = {}
    with torch.no_grad():
        for mode, training in (("eval", False), ("train", True)):
            ref = run(blocks, x, training)
            out = run(on_card, x_card, training)
            if out.shape != (b, c, f, t) or not torch.isfinite(out).all():
                fail(f"[10] the causal conv blocks gave {tuple(out.shape)}, finite "
                     f"{bool(torch.isfinite(out).all())}, expected {CAUSAL_SHAPE}")
            snrs[mode] = snr_db(ref, out.cpu())
    ref_grads = train_grads(blocks, x, w)
    grads = {k: v.cpu() for k, v in train_grads(on_card, x_card, w_card).items()}
    # BatchNorm2d's batch mean takes a conv bias out: its gradient is zero,
    # a sum of float32 noise, held on both sides SNR_FLOOR below the same
    # block's BN bias gradient (the sum without the mean taken out)
    zero = [k for k in ref_grads if k.endswith("conv.bias")]
    grad_snrs = {k: snr_db(ref_grads[k], grads[k]) for k in ref_grads if k not in zero}
    snrs["train_grads"] = min(grad_snrs.values())
    snrs["zero_grads"] = min(
        snr_db(ref_grads[k.replace("conv", "norm")], ref_grads[k.replace("conv", "norm")] + d[k])
        for d in (ref_grads, grads) for k in zero)
    changed = [k for k, v in on_card.named_buffers() if not torch.equal(v, stats[k])]
    card = card_and_limit()
    print(f"[10] causal conv blocks [{b}, {c}, {f}, {t}] -> {CAUSAL_OUT_CHANNELS} ch -> back, "
          f"float32 on the card against the CPU: eval {snrs['eval']:.1f} dB, train "
          f"{snrs['train']:.1f} dB, train gradients (worst of x and "
          f"{len(grad_snrs) - 1} parameters) {snrs['train_grads']:.1f} dB (floor "
          f"{SNR_FLOOR[torch.float32]:g}); the conv biases' zero gradients "
          f"{snrs['zero_grads']:.1f} dB below the BN biases'")
    print(f"[10] causal conv blocks' gradient SNR by tensor: "
          + ", ".join(f"{k} {v:.1f}" for k, v in grad_snrs.items()))
    if min(snrs.values()) < SNR_FLOOR[torch.float32]:
        fail(f"[10] the causal conv blocks disagree with the CPU: {snrs}")
    if changed:
        fail(f"[10] the causal conv blocks' training mode changed the buffers {changed}")

    def train_step():
        train_grads(on_card, x_card, w_card)
        torch.cuda.synchronize()

    tag = "[10] profile causal conv blocks float32 train forward + backward:"
    check_no_tf32(profile_call(train_step, tag), "[10] the causal conv blocks")
    with torch.no_grad():
        ms = {mode: cuda_ms(lambda: run(on_card, x_card, training), reps=5)
              for mode, training in (("eval", False), ("train", True))}
    ms["train_fwd_bwd"] = cuda_ms(lambda: train_grads(on_card, x_card, w_card), reps=5)
    # the forward's least time: the two products' float32 FMAs (each block
    # multiplies [B F' T, 16 * 6] rows by 32 columns or back), x read and
    # the output written once
    flops = 2 * 2 * b * ((f - 3) // 2 + 1) * t * c * 6 * CAUSAL_OUT_CHANNELS
    fwd_bound = bound(flops / PEAK_FLOPS[torch.float32], 2 * x.numel() * 4)
    print(f"[10] causal conv blocks float32 on {card}: forward eval {ms['eval']:.3f} ms, "
          f"train {ms['train']:.3f} ms, train forward + backward {ms['train_fwd_bwd']:.3f} ms; "
          f"the forward's bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]}, {flops / 1e9:.2f} "
          f"GFLOP, {2 * x.numel() * 4 / 1e6:.1f} MB)")
    return {"shape": list(CAUSAL_SHAPE), "out_channels": CAUSAL_OUT_CHANNELS,
            "snr_db_vs_cpu": snrs, "ms": ms, "forward_bound_ms": fwd_bound[0],
            "forward_bound_by": fwd_bound[1], "card": card, "profile": PROFILES[tag]}


def variant_batch(model_config, batch, lengths, dtype, kernel, floors, tag) -> dict:
    """One batch of a variant through `Enhancer.enhance_batch` on the card
    (a warm-up, then the timed run whose launches are counted: `kernel` once
    and nothing else, or nothing with `kernel` None), and the same batch
    through the plain LSTMs: the waveforms and the model's output (the
    compressed cIRM, which the LSTM kernel feeds through its Linear) against
    the plain run's. `floors` maps "snr_db_vs_plain" (the waveform) and
    "cirm_snr_db_vs_plain" to the floors they are held to (None: no
    comparison). The waveform of an untrained model in bf16 or int8 is
    ill-conditioned (its small mask crosses zero at the loud bins;
    scripts/variant_snr_seeds.py measures both), so there the cIRM is held
    to the tighter floor."""
    from fullsubnet_plus_torch.enhance import Enhancer
    from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
    from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlus

    model = FullSubNetPlus(model_config).init_weights(torch.Generator().manual_seed(42))
    enhancer = Enhancer(FULLSUBNET_PLUS, model_config, model.state_dict(), device="cuda",
                        compute_dtype=dtype)
    enhancer.enhance_batch(batch, lengths=lengths)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = enhancer.enhance_batch(batch, lengths=lengths)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in all_launches().items() if v}
    audio_s = (sum(lengths) if lengths is not None else batch.size) / SR
    out = {"launches": launches, "wall_ms": wall * 1e3, "audio_s_per_s": audio_s / wall}
    if y.shape != batch.shape or not np.isfinite(y).all():
        fail(f"[10] {tag}: output {y.shape} not finite or not {batch.shape}")
    if launches != ({kernel: 1} if kernel else {}):
        fail(f"[10] {tag}: launches {launches}, expected {kernel} once")
    if floors is None:
        print(f"[10] {tag}: wall {out['wall_ms']:.1f} ms, {out['audio_s_per_s']:.1f} audio-s/s, "
              f"launches {launches}")
        return out

    @torch.inference_mode()
    def cirm():
        noisy = torch.from_numpy(batch).cuda()
        lens = None if lengths is None else torch.as_tensor(lengths, device="cuda")
        mag, real, imag, valid = enhancer._spectrum(noisy, lens)
        return enhancer._model(mag[:, None], real[:, None], imag[:, None], valid_frames=valid)

    crm = cirm()
    with plain_lstms():
        plain = enhancer.enhance_batch(batch, lengths=lengths)
        plain_crm = cirm()
    out["snr_db_vs_plain"] = snr_db(torch.from_numpy(plain), torch.from_numpy(y))
    out["cirm_snr_db_vs_plain"] = snr_db(plain_crm, crm)
    print(f"[10] {tag}: wall {out['wall_ms']:.1f} ms, {out['audio_s_per_s']:.1f} audio-s/s, "
          f"launches {launches}; against the plain LSTM: waveform "
          f"{out['snr_db_vs_plain']:.1f} dB, cIRM {out['cirm_snr_db_vs_plain']:.1f} dB "
          f"(floors {floors})")
    for key, floor in floors.items():
        if out[key] < floor:
            fail(f"[10] {tag}: {key} {out[key]:.1f} dB (floor {floor:.0f})")
    return out


def variant_train_setup(overrides: dict):
    """(model_def, config, optimizer, loss_fn, acoustics, one training batch)
    at configs/train.toml's width and batch, the model config overridden."""
    import dataclasses as dc

    from fullsubnet_plus_torch.models import get_model
    from fullsubnet_plus_torch.train import loss, step
    from fullsubnet_plus_torch.utils.config import load_config

    toml = load_config(os.path.join(REPO, "configs", "train.toml"))
    model_def = get_model(toml["model"]["path"])
    config = dc.replace(model_def.make_config(toml["model"]["args"]), **overrides)
    acoustics = {k: toml["acoustics"][k] for k in ("n_fft", "hop_length", "win_length")}
    optimizer = step.make_optimizer(
        **toml["optimizer"], clip_grad_norm=toml["trainer"]["train"]["clip_grad_norm_value"])
    rng = np.random.default_rng(4)
    batch = tuple(np.stack(rows) for rows in
                  zip(*(train_pair(rng, TRAIN_SAMPLES) for _ in range(TRAIN_BATCH))))
    return model_def, config, optimizer, loss.get_loss(toml["loss_function"]["name"]), \
        acoustics, batch


def seeded_train_state(model_def, config, optimizer):
    from fullsubnet_plus_torch.train import step

    model = model_def.module_cls(config).init_weights(torch.Generator().manual_seed(42))
    return step.init_train_state(model, optimizer, device="cuda")


def joint_and_residual_steps() -> dict:
    """(f) `make_joint_mask_train_step` and `make_residual_train_step` on
    FullSubNet+ at configs/train.toml's batch: the joint step's cRM is the
    model's training forward (drop_band inside) and its RM the noisy
    magnitude's sigmoid; the residual step's cIRM the model's forward
    without drop_band and its enhanced spectrum the noisy one times the
    decompressed cIRM. One step each through K2 + K4 from a copy of the
    state, against the plain step from the same state."""
    from fullsubnet_plus_torch.dsp.mask import complex_mul, decompress_cirm
    from fullsubnet_plus_torch.train import step

    model_def, config, optimizer, loss_fn, acoustics, (noisy, clean) = variant_train_setup({})

    def joint_forward(model, mag, real, imag):
        crm = model(mag[:, None], real[:, None], imag[:, None], training=True)
        return torch.sigmoid(mag)[:, None], crm

    def residual_forward(model, mag, real, imag):
        cirm = model(mag[:, None], real[:, None], imag[:, None])
        d = decompress_cirm(cirm.permute(0, 2, 3, 1))
        r, i = complex_mul(real, imag, d[..., 0], d[..., 1])
        return cirm, torch.stack([r, i], dim=1)

    out = {}
    for tag, make, forward, kw in (
            ("joint_mask", step.make_joint_mask_train_step, joint_forward,
             {"num_groups": config.num_groups_in_drop_band}),
            ("residual", step.make_residual_train_step, residual_forward, {})):
        run = make(forward, optimizer, loss_fn, alpha=JOINT_ALPHA, device="cuda", **kw,
                   **acoustics)
        state = seeded_train_state(model_def, config, optimizer)
        reset_launches()
        with training_kernels(False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = run(copy.deepcopy(state), noisy, clean)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: v for k, v in all_launches().items() if v}
        reset_launches()
        with training_kernels(True, plain=True):
            _, plain = run(state, noisy, clean)
        if any(all_launches().values()):
            fail(f"[10] the plain {tag} step launched kernels: {all_launches()}")
        m, plain = ({k: float(v) for k, v in d.items()} for d in (m, plain))
        gaps = (abs(m["loss"] - plain["loss"]) / abs(plain["loss"]),
                abs(m["grad_norm"] - plain["grad_norm"]) / abs(plain["grad_norm"]))
        out[tag] = {"loss": m["loss"], "grad_norm": m["grad_norm"], "plain": plain,
                    "rel_gap": gaps, "launches": launches, "wall_ms": wall * 1e3}
        print(f"[10] {tag} step K2 + K4: loss {m['loss']:.6f} / grad norm {m['grad_norm']:.6f} "
              f"against plain {plain['loss']:.6f} / {plain['grad_norm']:.6f} (gaps "
              f"{gaps[0]:.2e} / {gaps[1]:.2e}, limits {TRAIN_LOSS_RTOL:g} / "
              f"{TRAIN_GRAD_NORM_RTOL:g}); wall {wall * 1e3:.1f} ms; launches {launches}")
        if launches != {"lstm2_train_fwd": 1, "lstm2_bwd": 1}:
            fail(f"[10] the {tag} step launched {launches}, expected K2 and K4 once")
        if not (np.isfinite(m["loss"]) and gaps[0] <= TRAIN_LOSS_RTOL
                and gaps[1] <= TRAIN_GRAD_NORM_RTOL):
            fail(f"[10] the {tag} step disagrees with the plain step")
    return out


def phase_variants(root: str, lengths: list[int]) -> dict:
    """Phase 10: the model zoo on the card at full width. (a) the five other
    attentions, (b) subband_num 2 with ECA and (c) two norms, each one
    float32 batch through K1 against the plain LSTM; CBAM also in bf16 (K1)
    and int8 (K5); (d) a GRU sub-band model (no LSTM kernel), timed beside
    (a)'s SE batch, and the loop norms timed at the batch's shape; (e) the
    CBAM and TSSE_ATT train steps through K2 + K4 and K2 + K3 against the
    plain step from the same state; (f) the joint-mask and residual steps;
    (g) the 2-D causal conv blocks against the CPU."""
    import dataclasses as dc

    from fullsubnet_plus_torch.data.wav import read_wav
    from fullsubnet_plus_torch.dsp import norms
    from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
    from fullsubnet_plus_torch.train import step

    t_start = time.perf_counter()
    base = FULLSUBNET_PLUS.make_config({})
    padded = np.zeros((len(lengths), -(-max(lengths) // SR) * SR), np.float32)
    for i, n in enumerate(lengths):
        padded[i, :n] = read_wav(os.path.join(root, "noisy", f"utt{i}.wav"))
    rng = np.random.default_rng(10)
    even = np.stack([noisy_utterance(rng, 10 * SR) for _ in range(BATCH)])
    runs = {}
    for tag, overrides, masked in VARIANT_RUNS:
        batch, lens = (padded, lengths) if masked else (even, None)
        runs[tag] = variant_batch(dc.replace(base, **overrides), batch, lens, None, "lstm2_fwd",
                                  {"snr_db_vs_plain": WAVE_SNR_FLOOR}, f"{tag} float32")
    cbam = dc.replace(base, channel_attention_model="CBAM")
    low = {"snr_db_vs_plain": VARIANT_WAVE_SNR_FLOOR,
           "cirm_snr_db_vs_plain": VARIANT_CIRM_SNR_FLOOR}
    runs["CBAM_bfloat16"] = variant_batch(cbam, padded, lengths, "bfloat16", "lstm2_fwd", low,
                                          "CBAM bfloat16")
    runs["CBAM_int8"] = variant_batch(cbam, padded, lengths, "int8", "lstm2_int8_fwd", low,
                                      "CBAM int8")
    runs["GRU"] = variant_batch(dc.replace(base, sequence_model="GRU"), padded, lengths, None,
                                None, None, "GRU sub-band model float32")
    print(f"[10] the GRU sub-band batch {runs['GRU']['wall_ms']:.1f} ms against SE's LSTM "
          f"batch through K1 {runs['SE']['wall_ms']:.1f} ms")
    x = torch.rand(BATCH, 257, T_FULL, device="cuda") + 0.1
    loop_norms = {name: cuda_ms(lambda: getattr(norms, name)(x), reps=3)
                  for name in LOOP_NORMS}
    print(f"[10] the loop norms on [{BATCH}, 257, {T_FULL}] (a loop over frames): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in loop_norms.items()))

    train = {}
    for name in VARIANT_TRAIN:
        model_def, config, optimizer, loss_fn, acoustics, batch = variant_train_setup(
            {"channel_attention_model": name})

        def make_step(dtype):
            return step.make_train_step(model_def, config, optimizer, loss_fn,
                                        compute_dtype=dtype, device="cuda", **acoustics)

        gaps, launches = same_state_check(seeded_train_state(model_def, config, optimizer),
                                          make_step, [batch], phase=f"[10] {name}")
        train[name] = {"rel_gaps": gaps, "launches": {k: v for k, v in launches.items() if v}}
        if name == "TSSE_ATT":  # what the new paths reach in float32: no TF32 product
            float32_step, state = make_step(torch.float32), seeded_train_state(
                model_def, config, optimizer)

            def one_step():
                float32_step(state, *batch)
                torch.cuda.synchronize()

            check_no_tf32(profile_call(one_step, "[10] profile TSSE_ATT float32 train step:"),
                          "[10] the TSSE_ATT float32 train step")
            train[name]["profile"] = PROFILES["[10] profile TSSE_ATT float32 train step:"]
    steps = joint_and_residual_steps()
    causal = causal_conv_blocks()
    wall = time.perf_counter() - t_start
    print(f"phase 10 took {wall:.1f} s")
    return {"runs": runs, "loop_norms_ms": loop_norms, "train": train, "steps": steps,
            "causal_conv": causal, "wall_s": wall}


# Phase 11: FullSubNet's training step at full width: FSN_TOML's [model] at
# configs/train.toml's batch (18 of 3.072 s, T 195), both LSTMs through the
# training kernels: the full-band one at N 18 (a row a batch item), D 257,
# H 512, O 257, where the reverse sweep's dx is output-stationary, and the
# sub-band one after drop_band at N 18 * 128, D 32, H 384, O 2.
N_FB_TRAIN = TRAIN_BATCH


def fsn_model_table() -> dict:
    """FSN_TOML's [model] table (path and args)."""
    import tomllib

    return tomllib.loads(FSN_TOML)["model"]


def check_fsn_train_kernels() -> tuple[dict, dict]:
    """(a) and (e): K2, K3 and K4 at the full-band fold of FullSubNet's train
    step (N 18, T 195) in float32 and bf16 against their plain versions on
    the same operands (y and the residuals; dx, every weight gradient and
    both bias gradients; K4's dgates too), K3 equal to itself on a repeat;
    then each timed beside its plain version, its bound and cuDNN's
    LSTM(257, 512, 2) + Linear forward or backward (TF32 off; a yardstick).
    Returns ({(kernel, dtype): {"max_abs_err", "min_snr_db"}}, {(kernel,
    dtype): times})."""
    from fullsubnet_plus_torch.ops import lstm2
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    n, t = N_FB_TRAIN, T_TRAIN
    for dtype in (torch.float32, torch.bfloat16):
        forms = {form: lt.bwd_shared_memory_bytes(16, *FB, dtype, ksplit=form == "k-split")
                 for form in ("k-split", "output-stationary")}
        forms["cluster"] = lt.bwd_cluster_shared_memory_bytes(*FB, dtype)
        print(f"[11] reverse sweep's shared memory at D {FB[0]}, H {FB[1]}, O {FB[2]}, "
              f"{str(dtype)[6:]}: tile form " + ", ".join(f"{k} {v:,} bytes" for k, v in forms.items())
              + f"; the tile form takes {'k-split' if lt.bwd_dx_ksplit(16, *FB, dtype) else 'output-stationary'}")
        if lt.bwd_dx_ksplit(16, *FB, dtype) or forms["output-stationary"] > 232448:
            fail("the full-band reverse sweep does not take the output-stationary dx that fits")
        # the form: clusters of 16 at N 18, the wave form at the shipped and
        # sub-band folds (more row tiles than the card's SMs)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        folds = {"full-band N 18": (n, *FB), "shipped N 2304": (N_TRAIN, D, H, O),
                 "FullSubNet sub-band N 2304": (N_TRAIN, *FSN_SB)}
        for fold, (rows, *shape) in folds.items():
            form = lt.bwd_sweep_form(rows, *shape, dtype, sms)
            fwd = fwd_rule_form(rows, shape, dtype)
            print(f"[11] {str(dtype)[6:]} {fold}: the rule takes the "
                  f"{lt.sweep_form_name(form)} form for the reverse sweep, the {fwd} form for "
                  f"the forward")
            want = 16 if fold.startswith("full-band") else (
                lt.SWEEP_WAVE if -(-N_TRAIN // 16) > sms else 0)
            if form != want:
                fail(f"[11] the reverse sweep's form at the {fold} fold: {form}")
            if fwd != ("cluster16" if fold.startswith("full-band") else TRAIN_FWD_FORM[dtype]):
                fail(f"[11] the forward sweep's form at the {fold} fold: {fwd}")
    errors, times = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        floor, tag = SNR_FLOOR[dtype], f"N={n} T={t} {str(dtype)[6:]}"
        x, dy, lstm, fc = train_operands(n, t, dtype, seed=11, shape=FB)
        w = lstm.packed(fc)
        y_ref, res_ref = lt.lstm2_train_fwd_reference(x, w)
        lstm2.FWD_SWEEP_FORMS.clear()
        y, res = lt.lstm2_train_fwd(x, w)
        y_k1 = lstm2.lstm2_fc(x, w)
        with forced_fwd_form(0):
            y_tile, res_tile = lt.lstm2_train_fwd(x, w)
        torch.cuda.synchronize()
        fwd_forms, k1_same = dict(lstm2.FWD_SWEEP_FORMS), torch.equal(y, y_k1)
        k2 = worst((y_ref, *res_ref), (y, *res))
        k2_tile = worst((y_tile, *res_tile), (y, *res))
        del y_k1, y_tile, res_tile
        print(f"[11] lstm2_train_fwd {tag} in the cluster form: {k2[0]:.1f} dB against the "
              f"plain version, {k2_tile[0]:.1f} dB against the tile form forced (y and the "
              f"residuals), y equal to K1's: {k1_same}; forward sweeps by form {fwd_forms}")
        if not k1_same or min(k2_tile[0], k2[0]) < floor:
            fail(f"[11] K2's cluster form at the full-band {tag}: y equal to K1's {k1_same}, "
                 f"{k2_tile[0]:.1f} dB against the tile form")
        if fwd_forms != {"lstm2_train_fwd cluster16": 1, "lstm2_fwd cluster16": 1,
                         "lstm2_train_fwd tile": 1}:
            fail(f"[11] the full-band forward sweeps' forms: {fwd_forms}")
        lt.SWEEP_FORMS.clear()
        sweep_ref = lt.lstm2_bwd_reference(dy, x, w, res_ref)
        sweep = lt.lstm2_bwd_sweep(dy, x, w, res_ref)
        dgates = worst(sweep_ref[1:3], sweep[1:3])
        lt.SWEEP_LATE_SENDS = 1
        try:  # rank 0 of each cluster sends after its products: the same bits
            late = lt.lstm2_bwd_sweep(dy, x, w, res_ref)[:3]
            late = all(torch.equal(a, b) for a, b in zip(sweep[:3], late))
        finally:
            lt.SWEEP_LATE_SENDS = 0
        lt.SWEEP_FORM = 0
        try:  # the tile form forced, against the plain sweep
            tile = worst(sweep_ref[:3], lt.lstm2_bwd_sweep(dy, x, w, res_ref)[:3])
        finally:
            lt.SWEEP_FORM = None
        del sweep_ref, sweep
        k4 = worst(lt.lstm2_bwd_plain(dy, x, w, res_ref, fused=False),
                   lt.lstm2_bwd(dy, x, w, res_ref, fused=False))
        got = lt.lstm2_bwd(dy, x, w, res_ref, fused=True)
        again = lt.lstm2_bwd(dy, x, w, res_ref, fused=True)
        torch.cuda.synchronize()
        k3 = worst(lt.lstm2_bwd_plain(dy, x, w, res_ref, fused=True), got)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again, y_ref, res_ref, y
        print(f"[11] full-band training kernels vs plain {tag} (floor {floor:.0f} dB): "
              f"lstm2_train_fwd {k2[0]:.1f} dB max_abs {k2[1]:.3e}; lstm2_bwd (dx, the weight "
              f"gradients from its dgates, db) {k4[0]:.1f} dB max_abs {k4[1]:.3e}, its dgates "
              f"{dgates[0]:.1f} dB; lstm2_bwd_wgrad {k3[0]:.1f} dB max_abs {k3[1]:.3e}, equal "
              f"on a repeat: {repeat}; the tile form forced: lstm2_bwd's dx and dgates "
              f"{tile[0]:.1f} dB; rank 0 sending late, the same bits: {late}; sweeps by "
              f"form {dict(lt.SWEEP_FORMS)}")
        if not repeat:
            fail(f"lstm2_bwd_wgrad is not deterministic at the full-band {tag}")
        if not late:
            fail(f"lstm2_bwd's cluster form changes with rank 0 sending late at {tag}")
        if dict(lt.SWEEP_FORMS) != {"lstm2_bwd cluster16": 3, "lstm2_bwd_wgrad cluster16": 2,
                                    "lstm2_bwd tile": 1}:
            fail(f"[11] the full-band sweeps' forms: {dict(lt.SWEEP_FORMS)}")
        for name, (snr, _) in (("lstm2_train_fwd", k2), ("lstm2_bwd", k4),
                               ("lstm2_bwd dgates", dgates), ("lstm2_bwd_wgrad", k3),
                               ("lstm2_bwd, the tile form", tile)):
            if snr < floor:
                fail(f"{name} disagrees at the full-band {tag}: {snr:.1f} dB")
        for name, (snr, err) in (("lstm2_train_fwd", k2), ("lstm2_bwd", k4),
                                 ("lstm2_bwd_wgrad", k3)):
            errors[(name, dtype)] = {"max_abs_err": err, "min_snr_db": snr}

        ms = {"lstm2_train_fwd": cuda_ms(lambda: lt.lstm2_train_fwd(x, w), reps=3),
              "lstm2_bwd": cuda_ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res), reps=3),
              "lstm2_bwd_wgrad": cuda_ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True),
                                         reps=3)}
        lt.SWEEP_FORM = 0
        try:  # the tile form forced, in the same call
            tile_ms = {"lstm2_bwd": cuda_ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res), reps=3),
                       "lstm2_bwd_wgrad": cuda_ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True),
                                                  reps=3)}
        finally:
            lt.SWEEP_FORM = None
        with forced_fwd_form(0):
            tile_ms["lstm2_train_fwd"] = cuda_ms(lambda: lt.lstm2_train_fwd(x, w), reps=3)
        plain = {"lstm2_train_fwd": cuda_ms(lambda: lt.lstm2_train_fwd_reference(x, w), reps=2),
                 "lstm2_bwd": cuda_ms(lambda: lt.lstm2_bwd_reference(dy, x, w, res), reps=2),
                 "lstm2_bwd_wgrad": cuda_ms(lambda: lt.lstm2_bwd_plain(dy, x, w, res, True),
                                            reps=2)}
        del res
        ref, linear = cudnn_modules(lstm, fc, dtype)
        x_ntd = x.transpose(1, 2).contiguous().requires_grad_()
        wrt = (x_ntd, *ref.parameters(), *linear.parameters())

        def library_fwd():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return linear(ref(x_ntd)[0])

        fwd_ms = cuda_ms(library_fwd, reps=3)
        y_lib = library_fwd()

        def library_bwd():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return torch.autograd.grad(y_lib, wrt, dy, retain_graph=True)

        bwd_ms = cuda_ms(library_bwd, reps=3)
        del y_lib
        library = {"lstm2_train_fwd": fwd_ms, "lstm2_bwd": bwd_ms, "lstm2_bwd_wgrad": bwd_ms}
        bounds = train_bounds(dtype, shape=FB, n=n, t=t)
        for name in ms:
            side = "forward" if name == "lstm2_train_fwd" else "backward"
            form = (f" (cluster form; tile form forced {tile_ms[name]:.3f} ms)"
                    if name in tile_ms else "")
            print(f"[11] {name} {str(dtype)[6:]} full-band N={n} T={t}: kernel {ms[name]:.3f} ms"
                  f"{form}  plain {plain[name]:.3f} ms  cuDNN LSTM+Linear {side} "
                  f"{library[name]:.3f} ms  bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")
            times[(name, dtype)] = dict(ms=ms[name], plain_ms=plain[name],
                                        library_ms=library[name], bound_ms=bounds[name][0],
                                        bound_by=bounds[name][1])
            if name in tile_ms:
                times[(name, dtype)]["tile_form_ms"] = tile_ms[name]
        torch.cuda.empty_cache()
    return errors, times


@contextlib.contextmanager
def forced_sub_band_fwd_tile_form():
    """The forward sweep's tile form (at its own row tile) forced wherever
    the rule would take the wave form (FullSubNet's sub-band training
    fold); the cluster form stays."""
    from fullsubnet_plus_torch.ops import lstm2

    rule = lstm2.fwd_sweep_plan

    def tile_for_wave(n, d_in, hidden, out_dim, dtype, sm_count=lstm2.SM_COUNT):
        form, rows = rule(n, d_in, hidden, out_dim, dtype, sm_count)
        if form != lstm2.FWD_SWEEP_WAVE:
            return form, rows
        return 0, lstm2.fwd_mma_row_tile(n, d_in, hidden, sm_count, dtype)

    lstm2.fwd_sweep_plan = tile_for_wave
    try:
        yield
    finally:
        lstm2.fwd_sweep_plan = rule


def mma_sync_wgrad_tile(dtype: torch.dtype, n: int) -> int:
    """The WGRAD_H_TILES / WGRAD_F32_TILES index of the mma.sync tile that the
    rule took before the wgmma kernels on a fold of n rows: bf16 64 x 128;
    float32 128 x 128 with 64-row slices by bulk copies, with 32-row
    cp.async slices below 64 rows a step."""
    return 0 if dtype == torch.bfloat16 else (2 if n < 64 else 4)


@contextlib.contextmanager
def forced_mma_sync_wgrad():
    """K3's weight gradients on the mma.sync kernel the rule took before the
    wgmma kernels, at each launch's fold (a comparison)."""
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    launch = lt._launch_bwd_wgrad

    def old_kernel(dy, x, w, res):
        before = lt.force_wgrad_tile(mma_sync_wgrad_tile(x.dtype, x.shape[0]), x.dtype)
        try:
            return launch(dy, x, w, res)
        finally:
            lt.force_wgrad_tile(before, x.dtype)

    lt._launch_bwd_wgrad = old_kernel
    try:
        yield
    finally:
        lt._launch_bwd_wgrad = launch


@contextlib.contextmanager
def forced_sub_band_tile_form():
    """The reverse sweep's tile form forced wherever the rule would take the
    wave form (FullSubNet's sub-band fold); the cluster form stays."""
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    rule = lt.bwd_sweep_form

    def tile_for_wave(*args, **kwargs):
        form = rule(*args, **kwargs)
        return 0 if form == lt.SWEEP_WAVE else form

    lt.bwd_sweep_form = tile_for_wave
    try:
        yield
    finally:
        lt.bwd_sweep_form = rule


def fsn_train_setup():
    """FullSubNet (FSN_TOML's [model]) with configs/train.toml's optimizer,
    loss and acoustics, and TRAIN_STEPS seeded batches of its shape."""
    from fullsubnet_plus_torch.models import get_model
    from fullsubnet_plus_torch.train import loss, step
    from fullsubnet_plus_torch.utils.config import load_config

    toml = load_config(os.path.join(REPO, "configs", "train.toml"))
    table = fsn_model_table()
    model_def = get_model(table["path"])
    config = model_def.make_config(table["args"])
    acoustics = {k: toml["acoustics"][k] for k in ("n_fft", "hop_length", "win_length")}
    optimizer = step.make_optimizer(
        **toml["optimizer"], clip_grad_norm=toml["trainer"]["train"]["clip_grad_norm_value"])
    rng = np.random.default_rng(11)
    batches = [tuple(np.stack(rows) for rows in
                     zip(*(train_pair(rng, TRAIN_SAMPLES) for _ in range(TRAIN_BATCH))))
               for _ in range(TRAIN_STEPS)]
    return model_def, config, optimizer, loss.get_loss(toml["loss_function"]["name"]), \
        acoustics, batches


def phase_fullsubnet_train(root: str, corpus: dict) -> dict:
    """Phase 11: FullSubNet's training at full width. (a) and (e)
    `check_fsn_train_kernels`; (b) the full-band training cases of the JAX
    fixture; (c) the train step from the plain step's state, through
    float32 K2 + K4, float32 K2 + K3 and bf16 K2 + K3 (phase 6's limits,
    each step launching its two kernels twice), then the float32 default
    form timed and profiled (no TF32 product); (d) one float32 trainer
    epoch through the CLI's functions on phase 8's corpus, and one more
    profiled."""
    from fullsubnet_plus_torch.ops import lstm2
    from fullsubnet_plus_torch.ops import lstm2_train as lt
    from fullsubnet_plus_torch.train import step

    t_start = time.perf_counter()
    errors, times = check_fsn_train_kernels()
    fixture_snr = phase_check_fixture(probed=True, phase="[11]")

    model_def, config, optimizer, loss_fn, acoustics, batches = fsn_train_setup()

    def make_step(dtype):
        return step.make_train_step(model_def, config, optimizer, loss_fn, compute_dtype=dtype,
                                    device="cuda", **acoustics)

    def seeded_state():
        model = model_def.module_cls(config).init_weights(torch.Generator().manual_seed(42))
        return step.init_train_state(model, optimizer, device="cuda")

    gaps, step_launches = same_state_check(seeded_state(), make_step, batches,
                                           phase="[11] FullSubNet", per_step=2,
                                           fwd_folds=((N_FB_TRAIN, FB), (N_TRAIN, FSN_SB)))
    state, train_step = seeded_state(), make_step(torch.float32)
    noisy, clean = batches[0]
    reset_launches()  # and the sweeps' forms
    walls = []
    for noisy, clean in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, noisy, clean)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if not (np.isfinite(float(m["loss"])) and float(m["skipped"]) == 0.0):
            fail(f"[11] FullSubNet float32 step: {m}")
    default_launches = all_launches()
    backward = float32_backward()
    want = {k: 0 for k in default_launches}
    want.update({"lstm2_train_fwd": 2 * TRAIN_STEPS, backward: 2 * TRAIN_STEPS})
    if default_launches != want:
        fail(f"[11] FullSubNet float32 steps: launches {default_launches}, expected {want}")
    # the full-band sweep clustered, the sub-band one in the rule's form at N 2304
    sub_band = lt.sweep_form_name(lt.bwd_sweep_form(
        N_TRAIN, *FSN_SB, torch.float32, torch.cuda.get_device_properties(0).multi_processor_count))
    forms = dict(lt.SWEEP_FORMS)
    if forms != {f"{backward} cluster16": TRAIN_STEPS, f"{backward} {sub_band}": TRAIN_STEPS}:
        fail(f"[11] FullSubNet float32 steps: the reverse sweeps' forms {forms}")
    fwd_forms = dict(lstm2.FWD_SWEEP_FORMS)  # K2 likewise
    sub_band_fwd = fwd_rule_form(N_TRAIN, FSN_SB, torch.float32)
    if fwd_forms != {"lstm2_train_fwd cluster16": TRAIN_STEPS,
                     f"lstm2_train_fwd {sub_band_fwd}": TRAIN_STEPS}:
        fail(f"[11] FullSubNet float32 steps: the forward sweeps' forms {fwd_forms}")
    wall = statistics.median(walls[1:])
    audio_s = TRAIN_BATCH * TRAIN_SAMPLES / SR

    def forced_walls(forced) -> float:
        """The same steps from the seeded state with `forced` (a comparison):
        the median wall of the last three."""
        forced_state, forced_walls = seeded_state(), []
        for noisy, clean in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with forced():
                forced_state, _ = train_step(forced_state, noisy, clean)
            torch.cuda.synchronize()
            forced_walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(forced_walls[1:])

    tile_wall = forced_walls(forced_sub_band_tile_form)
    fwd_tile_wall = forced_walls(forced_sub_band_fwd_tile_form)
    mma_wall = forced_walls(forced_mma_sync_wgrad)
    print(f"[11] FullSubNet float32 train step (the default form, K2 + "
          f"{'K3' if backward == 'lstm2_bwd_wgrad' else 'K4 + weight_grads'}; the sub-band "
          f"forward in the {sub_band_fwd} form, the sub-band reverse sweep in the {sub_band} "
          f"form): wall median {wall:.1f} ms (each {', '.join(f'{w:.0f}' for w in walls)}), "
          f"{audio_s / wall * 1e3:.1f} audio-s/s; launches {default_launches}, reverse sweeps "
          f"by form {forms}, forward sweeps by form {fwd_forms}; with the sub-band reverse "
          f"sweep's tile form forced {tile_wall:.1f} ms, with the sub-band forward's tile form "
          f"forced {fwd_tile_wall:.1f} ms, with K3's weight gradients on the mma.sync kernels "
          f"forced {mma_wall:.1f} ms")

    def one_step():
        train_step(state, noisy, clean)
        torch.cuda.synchronize()

    label = "[11] profile FullSubNet float32 train step:"
    check_no_tf32(profile_call(one_step, label), "[11] the FullSubNet float32 train step")

    path = trainer_toml(root, corpus, "fullsubnet", model=fsn_model_table())
    trainer = build_trainer(path, "--epochs", "1")
    trainer_run = check_trainer_run("FullSubNet float32", trainer,
                                    run_trainer(trainer, phase="[11]"), False,
                                    model="fullsubnet", per_step=2, phase="[11]")
    epoch = trainer.history[-1]["epoch"] + 1

    def one_epoch():
        trainer._train_epoch(epoch)
        torch.cuda.synchronize()

    epoch_label = f"[11] profile FullSubNet trainer float32 epoch ({TRAINER_STEPS} steps):"
    profile_call(one_epoch, epoch_label)
    trainer_run["profile_epoch"] = PROFILES[epoch_label]
    took = time.perf_counter() - t_start
    print(f"[11] FullSubNet trainer float32: {trainer_run['audio_s_per_s']:.1f} audio-s/s over "
          f"the epoch's training wall, idle share {PROFILES[epoch_label]['idle_share']:.3f} of "
          f"a profiled epoch, launches {trainer_run['launches']}")
    print(f"phase 11 took {took:.1f} s")
    return {"errors": errors, "times": times, "fixture_snr": fixture_snr,
            "steps": {"rel_gaps": gaps, "launches": {k: v for k, v in step_launches.items() if v},
                      "float32_default": {"wall_ms": wall, "audio_s_per_s": audio_s / wall * 1e3,
                                          "sub_band_tile_form_wall_ms": tile_wall,
                                          "sub_band_fwd_tile_form_wall_ms": fwd_tile_wall,
                                          "mma_sync_wgrad_wall_ms": mma_wall,
                                          "launches": default_launches, "sweep_forms": forms,
                                          "fwd_sweep_forms": fwd_forms,
                                          "profile": PROFILES[label]}},
            "trainer": trainer_run, "wall_s": took}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    try:
        import fullsubnet_plus_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port is not importable from here: {exc}")
    card = card_and_limit()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("float32 matmuls must run in full float32 (allow_tf32 is set)")

    t_start = time.perf_counter()
    hmma = phase_build()
    fixture_snr = phase_check_fixture()
    errors = phase_check()
    fwd_cluster = check_fwd_cluster()
    fwd_pair = check_fwd_pair()
    train_errors = phase_check_train()
    times = phase_time()
    train_times = phase_time_train()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        lengths = write_inputs(root)
        batch = phase_batch_path(root, lengths)
        pipelined = phase_pipelined(root, lengths)
        phase_profile(root, lengths)
        serve = phase_serve(os.path.join(REPO, "configs", "inference.toml"),
                            os.path.join(root, "model.npz"))
        profile_serving_batch(serve)
        train = phase_train()
        fb_kernels = phase_fullsubnet_kernels()
        fsn = phase_fullsubnet(root, lengths)
        t_trainer = time.perf_counter()
        trainer = phase_trainer(root)
        print(f"phase 8 took {time.perf_counter() - t_trainer:.1f} s")
        t_multi = time.perf_counter()
        cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        dp = phase_data_parallel(root, train["state"], train["batches"], cards)
        dp_cli = phase_cli_ranks(root, cards,
                                 trainer["runs"]["float32_unbroken"]["audio_s_per_s"])
        train_mesh = phase_train_mesh(train["state"], train["batches"], cards, dp["one_rank"],
                                      dp["runs"])
        cli_mesh = phase_cli_mesh(root, trainer["corpus"], cards)
        mesh = phase_mesh_enhancer(root, lengths, cards)
        multi = {"data_parallel": {tag: [{k: r[k] for k in ("rank", "device", "backend")}
                                         | {"float32": r["float32"]["metrics"],
                                            "bfloat16": r["bfloat16"]["metrics"],
                                            "median_step_wall_ms": r["steps"]["median_wall_ms"]}
                                         for r in ranks] for tag, ranks in dp["runs"].items()},
                 "one_rank": {"float32": dp["one_rank"]["float32"]["metrics"],
                              "bfloat16": dp["one_rank"]["bfloat16"]["metrics"],
                              "median_step_wall_ms": dp["one_rank"]["steps"]["median_wall_ms"],
                              "median_step_host_ms": dp["one_rank"]["steps"]["median_host_ms"]},
                 "cli": {k: dp_cli[k] for k in ("backend", "devices", "audio_s_per_s")}
                 | {"train_loss": dp_cli["ranks"][0]["train_loss"],
                    "median_step_wall_ms": [r["median_step_wall_ms"] for r in dp_cli["ranks"]]},
                 "train_mesh": {"devices": train_mesh["devices"], **{
                     name: {"shape": r["shape"], "fold_sharding": r["fold_sharding"],
                            "float32": r["float32"]["metrics"],
                            "bfloat16": r["bfloat16"]["metrics"],
                            "launches_by_card": {f: r[f]["launches_by_card"]
                                                 for f in ("float32", "bfloat16")},
                            "median_step_wall_ms": r["steps"]["median_wall_ms"],
                            "median_step_host_ms": r["steps"]["median_host_ms"],
                            "busy_ms_by_card": r["busy_ms_by_card"],
                            "params_vs_one_card": r["params_vs_one_card"]}
                     for name, r in train_mesh["meshes"].items()},
                     "card_fold": {f"{k} {str(dt)[6:]}": v
                                   for (k, dt), v in train_mesh["card_fold"].items()}},
                 "cli_mesh": {k: cli_mesh[k] for k in ("mesh", "steps", "train_loss",
                                                       "median_step_wall_ms", "audio_s_per_s",
                                                       "launches_by_card")},
                 "mesh_enhancer": mesh,
                 "pipelined_batch": pipelined}
        print(json.dumps({"multi_device": multi}))
        print(f"phase 9 took {time.perf_counter() - t_multi:.1f} s")
        print(f"phases 1-9 took {time.perf_counter() - t_start:.1f} s")
        variants = phase_variants(root, lengths)
        fsn_train = phase_fullsubnet_train(root, trainer["corpus"])

    def multi_launches(name: str) -> dict:
        """Phase 9's and phase 4's pipelined runs' launches of a kernel."""
        out = {}
        for tag, ranks in dp["runs"].items():
            for r in ranks:
                for form in ("float32", "bfloat16"):
                    out[f"dp_{tag}_rank{r['rank']}_{form}_step"] = r[form]["launches"][name]
                out[f"dp_{tag}_rank{r['rank']}_float32_steps"] = r["steps"]["launches"][name]
        for r in dp_cli["ranks"]:
            out[f"cli_{dp_cli['backend']}_rank{r['rank']}"] = r["launches"][name]
        for layout, r in train_mesh["meshes"].items():
            for form in ("float32", "bfloat16"):
                out[f"train_mesh_{layout}_{form}_step"] = r[form]["launches"][name]
            out[f"train_mesh_{layout}_float32_steps"] = r["steps"]["launches"][name]
        out["cli_mesh"] = cli_mesh["launches"][name]
        forward = {"lstm2_fwd": ("float32", "bfloat16"), "lstm2_int8_fwd": ("int8",)}
        for tag in forward.get(name, ()):
            for layout in ("data", "fold"):
                out[f"mesh_{layout}_{tag}"] = sum(mesh[tag][layout]["launches_by_card"].values())
            out[f"batch_pipelined_and_serial_{tag}"] = pipelined[tag]["launches"]
        return {k: v for k, v in out.items() if v}

    t_runs = trainer["runs"]

    def fsn_train_launches(name: str) -> dict:
        """Phase 11's launches of a kernel: the same-state steps, the
        default float32 steps, the trainer epoch (with its validation)."""
        steps = fsn_train["steps"]
        out = {"fullsubnet_steps_same_state": steps["launches"].get(name, 0),
               "fullsubnet_steps_float32": steps["float32_default"]["launches"].get(name, 0),
               "fullsubnet_trainer": fsn_train["trainer"]["launches"].get(name, 0)}
        return {k: v for k, v in out.items() if v}

    def trainer_launches(name: str) -> dict:
        """Phase 8's launches of a kernel: K1 in validation alone, K2-K4 in
        the train steps alone (check_trainer_run holds each run to that)."""
        if name == "lstm2_fwd":
            return {"trainer_float32": 0, "trainer_bf16": 0,
                    "trainer_validation": sum(r["launches"][name] for r in t_runs.values())}
        return {"trainer_float32": sum(r["launches"][name] for tag, r in t_runs.items()
                                       if tag.startswith("float32")),
                "trainer_bf16": t_runs["bfloat16"]["launches"][name], "trainer_validation": 0}

    v_runs = variants["runs"]

    def variant_launches(name: str) -> dict:
        """Phase 10's launches of a kernel, by run."""
        out = {f"variants_{tag}": r["launches"].get(name, 0) for tag, r in v_runs.items()}
        out.update({f"variants_train_{v}": r["launches"].get(name, 0)
                    for v, r in variants["train"].items()})
        out.update({f"variants_{tag}_step": r["launches"].get(name, 0)
                    for tag, r in variants["steps"].items()})
        return {k: v for k, v in out.items() if v}

    print(json.dumps({"variants": {
        "runs": {tag: {k: r[k] for k in ("snr_db_vs_plain", "cirm_snr_db_vs_plain",
                                         "launches", "wall_ms", "audio_s_per_s") if k in r}
                 for tag, r in v_runs.items()},
        "loop_norms_ms": variants["loop_norms_ms"],
        "train": variants["train"],
        "steps": variants["steps"], "causal_conv": variants["causal_conv"],
        "wall_s": variants["wall_s"]}}))

    f32, bf16, int8 = times[torch.float32], times[torch.bfloat16], times["int8"]
    k1 = {
        "name": "lstm2_fwd",
        "route": "cuda",
        "source": "fullsubnet_plus_torch/csrc/lstm2_fwd.cu",
        "replaces": "fullsubnet_plus_tpu/ops/lstm_pallas.py:98 (_make_kernel)",
        "launches": batch["launches"]["float32"]["lstm2_fwd"]
        + batch["launches"]["bfloat16"]["lstm2_fwd"] + train["eval_launches"]["lstm2_fwd"]
        + fsn["launches"]["float32"]["lstm2_fwd"] + fsn["launches"]["bfloat16"]["lstm2_fwd"]
        + fsn["overlapped_chunk"]["launches"]["lstm2_fwd"]
        + sum(trainer_launches("lstm2_fwd").values()) + sum(multi_launches("lstm2_fwd").values())
        + sum(variant_launches("lstm2_fwd").values())
        + sum(fsn_train_launches("lstm2_fwd").values()),
        "max_abs_err": errors[("lstm2_fwd", N_FULL, T_FULL, torch.float32)],
        **f32,
        "shape": {"N": N_FULL, "D": D, "H": H, "O": O, "T": T_FULL, "dtype": "float32"},
        "bfloat16": {"max_abs_err": errors[("lstm2_fwd", N_FULL, T_FULL, torch.bfloat16)],
                     **bf16},
        "launches_by_run": {**{tag: batch["launches"][tag]["lstm2_fwd"]
                               for tag in ("float32", "bfloat16")},
                            "eval_step": train["eval_launches"]["lstm2_fwd"],
                            **{f"fullsubnet_{tag}": fsn["launches"][tag]["lstm2_fwd"]
                               for tag in ("float32", "bfloat16")},
                            "fullsubnet_overlapped_chunk":
                                fsn["overlapped_chunk"]["launches"]["lstm2_fwd"],
                            **trainer_launches("lstm2_fwd"), **multi_launches("lstm2_fwd"),
                            **variant_launches("lstm2_fwd"), **fsn_train_launches("lstm2_fwd")},
        "fullsubnet_fb": {
            "shape": {"N": N_FB, "D": FB[0], "H": FB[1], "O": FB[2], "T": T_FULL},
            "float32": fb_kernels[torch.float32], "bfloat16": fb_kernels[torch.bfloat16],
            "launches_per_batch": {tag: fsn["launches"][tag]["lstm2_fwd"] // MAIN_PATH_RUNS
                                   for tag in ("float32", "bfloat16")},
            "batch": {tag: {"audio_s_per_s": fsn["rates"][tag], "wall_ms": fsn["walls"][tag] * 1e3,
                            **fsn["profiles"][tag]} for tag in ("float32", "bfloat16")},
            "wave_snr_db_vs_plain": {tag: fsn["wave_snr_db"][tag]
                                     for tag in ("float32", "bfloat16")},
        },
        "fullsubnet_sb": {
            "shape": {"N": N_FULL, "D": FSN_SB[0], "H": FSN_SB[1], "O": FSN_SB[2], "T": T_FULL},
            **{tag: fb_kernels["sub_band"][tag] for tag in ("float32", "bfloat16")},
        },
        "audio_s_per_s": {tag: batch["rates"][tag] for tag in ("float32", "bfloat16")},
        "sweep_hmma": hmma["lstm2_fwd"],
        "float32_sweep_functions": hmma["lstm2_fwd_float32_sweep"],
        "cluster_sweep_functions": hmma["lstm2_fwd_cluster_sweep"],
        "batch_of_9_forms": {str(dt)[6:]: train_times[("lstm2_train_fwd", dt)][
            "fwd_forms_by_fold"]["batch of 9 K1"] for dt in (torch.float32, torch.bfloat16)},
        "fwd_form_by_fold": {
            **{fold: fwd_forms_at(rows, shape) for fold, rows, shape in (
                (f"N {N_FULL} T {T_FULL} (batch)", N_FULL, SB),
                ("N 2313 (a batch of 9)", 2313, SB),
                (f"fullsubnet_fb N {N_FB}", N_FB, FB),
                (f"fullsubnet_sb N {N_FULL}", N_FULL, FSN_SB))},
            **{f"fullsubnet_batch_{tag}": fsn["forms"][tag] for tag in ("float32", "bfloat16")}},
        "fullsubnet_fb_cluster_check": {str(dt)[6:]: v for dt, v in fwd_cluster.items()},
        "pair_sweep_functions": hmma["lstm2_fwd_pair_sweep"],
        "bf16_pair_check": fwd_pair,
        "bf16_launches_by_form": {"batch_bfloat16": batch["fwd_forms"]["bfloat16"],
                                  "fullsubnet_batch_bfloat16": fsn["forms"]["bfloat16"]},
        "jax_fixture_min_snr_db": {dt: fixture_snr[("lstm2_fwd", dt)]
                                   for dt in ("float32", "bfloat16")},
    }
    k5 = {
        "name": "lstm2_int8_fwd",
        "route": "cuda",
        "source": "fullsubnet_plus_torch/csrc/lstm2_int8_fwd.cu",
        "replaces": "fullsubnet_plus_tpu/ops/lstm_pallas.py:1022 (_make_quant_kernel)",
        "launches": serve["launches"]["lstm2_int8_fwd"]
        + fsn["launches"]["int8"]["lstm2_int8_fwd"] + fsn["serve"]["launches"]["lstm2_int8_fwd"]
        + sum(multi_launches("lstm2_int8_fwd").values())
        + sum(variant_launches("lstm2_int8_fwd").values()),
        "max_abs_err": errors[("lstm2_int8_fwd", N_SERVE, T_SERVE)],
        **int8,
        "max_abs_err_batch_fold": errors[("lstm2_int8_fwd", N_FULL, T_FULL)],
        "library": "cuDNN bf16 LSTM + Linear (a yardstick, not the int8 function)",
        "shape": {"N": N_SERVE, "D": D, "H": H, "O": O, "T": T_SERVE, "dtype": "bf16/int8"},
        "launches_by_run": {"serve": serve["launches"]["lstm2_int8_fwd"],
                            "batch_int8": batch["launches"]["int8"]["lstm2_int8_fwd"],
                            "fullsubnet_batch_int8": fsn["launches"]["int8"]["lstm2_int8_fwd"],
                            "fullsubnet_serve": fsn["serve"]["launches"]["lstm2_int8_fwd"],
                            **multi_launches("lstm2_int8_fwd"),
                            **variant_launches("lstm2_int8_fwd")},
        "fullsubnet_fb": {
            "shape": {"N": N_FB, "D": FB[0], "H": FB[1], "O": FB[2], "T": T_FULL},
            **fb_kernels["int8"],
            "launches_per_batch": fsn["launches"]["int8"]["lstm2_int8_fwd"] // MAIN_PATH_RUNS,
            "batch_int8": {"audio_s_per_s": fsn["rates"]["int8"],
                           "wall_ms": fsn["walls"]["int8"] * 1e3, **fsn["profiles"]["int8"]},
            "wave_snr_db_vs_plain": fsn["wave_snr_db"]["int8"],
            "serve": fsn["serve"],
        },
        "fullsubnet_sb": {
            "shape": {"N": N_FULL, "D": FSN_SB[0], "H": FSN_SB[1], "O": FSN_SB[2], "T": T_FULL},
            **fb_kernels["sub_band"]["int8"],
        },
        "audio_s_per_s": {"batch_int8": batch["rates"]["int8"],
                          "serve_together": serve["audio_s_per_s"],
                          "serve_stream_median": serve["stream_audio_s_per_s_median"]},
        "serve_busy_tick_ms": serve["stats"]["busy_tick_ms"],
        "jax_fixture_min_snr_db": fixture_snr[("lstm2_int8_fwd", "bfloat16")],
        "sweep_functions": hmma["lstm2_int8_fwd"],
        "int8_form_by_fold": {
            **{fold: int8_form_name(rows, shape) for fold, rows, shape in (
                (f"N {N_SERVE} T {T_SERVE} (serving)", N_SERVE, SB),
                (f"N {N_FULL} T {T_FULL} (batch)", N_FULL, SB),
                (f"fullsubnet_fb N {N_FB}", N_FB, FB),
                (f"fullsubnet_sb N {N_FULL}", N_FULL, FSN_SB))},
            "fullsubnet_batch_int8": fsn["forms"]["int8"]},
    }
    runs = train["runs"]

    def train_kernel(name, source, replaces, launch_runs):
        from fullsubnet_plus_torch.ops import lstm2_train as lt

        f32, bf16 = (train_times[(name, dt)] for dt in (torch.float32, torch.bfloat16))
        extra = {"sweep_hmma": hmma[name]} if name in hmma else {}
        if f"{name}_float32_sweep" in hmma:
            extra["float32_sweep_functions"] = hmma[f"{name}_float32_sweep"]
        if f"{name}_cluster_sweep" in hmma:
            extra["cluster_sweep_functions"] = hmma[f"{name}_cluster_sweep"]
        if f"{name}_bf16_sweep" in hmma:
            extra["bf16_sweep_functions"] = hmma[f"{name}_bf16_sweep"]
        if name in ("lstm2_bwd", "lstm2_bwd_wgrad"):
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            extra["sweep_form_by_fold"] = {  # the same in both dtypes at these folds
                **{fold: lt.sweep_form_name(lt.bwd_sweep_form(rows, *shape, torch.float32, sms))
                   for fold, rows, shape in (
                       (f"N {N_TRAIN} T {T_TRAIN} (training)", N_TRAIN, SB),
                       (f"N {N_CARD} (a card's half)", N_CARD, SB),
                       (f"fullsubnet_fb_train N {N_FB_TRAIN}", N_FB_TRAIN, FB),
                       (f"fullsubnet_sb_train N {N_TRAIN}", N_TRAIN, FSN_SB))},
                "train_steps": {r: runs[r].get("sweep_form") for r in launch_runs},
                "fullsubnet_steps_float32": fsn_train["steps"]["float32_default"]["sweep_forms"]}
        if name == "lstm2_train_fwd":
            extra["pair_sweep_functions"] = hmma["lstm2_train_fwd_pair_sweep"]
            extra["launches_by_form"] = {r: runs[r]["fwd_sweep_forms"] for r in launch_runs}
            extra["fwd_form_by_fold"] = {
                **{fold: fwd_forms_at(rows, shape) for fold, rows, shape in (
                    (f"N {N_TRAIN} T {T_TRAIN} (training)", N_TRAIN, SB),
                    (f"N {N_CARD} (a card's half)", N_CARD, SB),
                    (f"fullsubnet_fb_train N {N_FB_TRAIN}", N_FB_TRAIN, FB),
                    (f"fullsubnet_sb_train N {N_TRAIN}", N_TRAIN, FSN_SB))},
                "train_steps": {r: runs[r].get("fwd_form") for r in launch_runs},
                "fullsubnet_steps_float32":
                    fsn_train["steps"]["float32_default"]["fwd_sweep_forms"]}
        if name == "lstm2_bwd_wgrad":
            extra["wgrad_functions"] = hmma["wgrad"]
            # the main path's K3 launches by the tile of their weight-gradient kernel
            extra["wgrad_launches_by_tile"] = {r: runs[r].get("wgrad_tiles") for r in launch_runs}
        fb = {tag: {**fsn_train["errors"][(name, dt)], **fsn_train["times"][(name, dt)]}
              for tag, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16))}
        return {
            "name": name,
            "route": "cuda",
            "source": f"fullsubnet_plus_torch/csrc/{source}",
            "replaces": f"fullsubnet_plus_tpu/ops/lstm_pallas.py:{replaces}",
            "launches": sum(runs[r]["launches"][name] for r in launch_runs)
            + sum(trainer_launches(name).values()) + sum(multi_launches(name).values())
            + sum(variant_launches(name).values()) + sum(fsn_train_launches(name).values()),
            **train_errors[(name, N_TRAIN, T_TRAIN, torch.float32)],
            **f32,
            "shape": {"N": N_TRAIN, "D": D, "H": H, "O": O, "T": T_TRAIN, "dtype": "float32"},
            "bfloat16": {**train_errors[(name, N_TRAIN, T_TRAIN, torch.bfloat16)], **bf16},
            "launches_by_run": {**{r: runs[r]["launches"][name] for r in launch_runs},
                                **trainer_launches(name), **multi_launches(name),
                                **variant_launches(name), **fsn_train_launches(name)},
            "library": "cuDNN LSTM + Linear, "
                       + ("forward" if name == "lstm2_train_fwd" else "backward"),
            "train_step": {r: {"wall_ms": runs[r]["wall_ms"],
                               "tile_form_wall_ms": runs[r].get("tile_form_wall_ms"),
                               "fwd_tile_form_wall_ms": runs[r].get("fwd_tile_form_wall_ms"),
                               "mma_sync_wgrad_wall_ms": runs[r].get("mma_sync_wgrad_wall_ms"),
                               "audio_s_per_s": runs[r]["audio_s_per_s"]} for r in launch_runs},
            "jax_fixture_min_snr_db": {dt: fixture_snr[(name, dt)]
                                       for dt in ("float32", "bfloat16")},
            "fullsubnet_fb_train": {
                "shape": {"N": N_FB_TRAIN, "D": FB[0], "H": FB[1], "O": FB[2], "T": T_TRAIN},
                **fb,
                "launches_per_step": "1 a FullSubNet train step (and 1 at the sub-band shape)",
                "jax_fixture_min_snr_db": {dt: fsn_train["fixture_snr"].get((name, dt))
                                           for dt in ("float32", "bfloat16")},
                "train_step_float32": fsn_train["steps"]["float32_default"]["wall_ms"],
                "train_step_float32_sub_band_tile_form":
                    fsn_train["steps"]["float32_default"]["sub_band_tile_form_wall_ms"],
                "train_step_float32_sub_band_fwd_tile_form":
                    fsn_train["steps"]["float32_default"]["sub_band_fwd_tile_form_wall_ms"],
                "train_step_float32_mma_sync_wgrad":
                    fsn_train["steps"]["float32_default"]["mma_sync_wgrad_wall_ms"]},
            "card_fold": {"shape": {"N": N_CARD, "D": D, "H": H, "O": O, "T": T_TRAIN},
                          **{tag: train_mesh["card_fold"][(name, dt)] for tag, dt in (
                              ("float32", torch.float32), ("bfloat16", torch.bfloat16))}},
            **extra,
        }

    k2 = train_kernel("lstm2_train_fwd", "lstm2_train_fwd.cu", "322 (_residual_kernel)",
                      ("float32_k3", "bfloat16_k3", "float32_k4"))
    k3 = train_kernel("lstm2_bwd_wgrad", "lstm2_bwd_wgrad.cu", "472 (_make_bwd_kernel_fused)",
                      ("float32_k3", "bfloat16_k3"))
    k4 = train_kernel("lstm2_bwd", "lstm2_bwd.cu", "415 (_make_bwd_kernel)", ("float32_k4",))
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import sys

    if len(sys.argv) == 4 and sys.argv[1] in ("--dp-rank", "--cli-rank"):
        (dp_rank_main if sys.argv[1] == "--dp-rank" else cli_rank_main)(*sys.argv[2:])
    else:
        main()
