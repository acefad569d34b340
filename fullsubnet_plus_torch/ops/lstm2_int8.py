"""int8-recurrent 2-layer LSTM forward with the output Linear: build-time
quantization, wrapper, plain version, launch count and build of the CUDA
kernel csrc/lstm2_int8_fwd.cu. The serving default (compute_dtype="int8").

Replaces the TPU kernel `_make_quant_kernel` launched by
`stacked_lstm2_quantized` (fullsubnet_plus_tpu/ops/lstm_pallas.py:1022,
:1084, pallas_call at :1127). Per step t, for every row n of the [N, D, T]
fold (gate order i, f, g, o):

    g1 = (x_t W1)_f32 + (h1q U1q)_int32 * s1 + b1
    h1, c1 = cell(g1, c1);   h1q = clip(rint(127 h1), -127, 127)
    g2 = ([h1q | h2q] [W2q; U2q])_int32 * s2 + b2
    h2, c2 = cell(g2, c2);   h2q = clip(rint(127 h2), -127, 127)
    y_t = bf16(h2) W_fc + b_fc                          out [N, T, O] bf16

x and W1 are bfloat16 with float32 products. U1 and [W2; U2] are int8 with
one scale per column, quantized once at build time by
`prepare_quantized_lstm`; the scales already hold h's 1/127. h is carried
as int8 at the fixed scale 127 (it lies in (-1, 1)); c and the cell run in
float32; the fc reads h2 before quantization, rounded to bf16. Rounding is
half to even throughout, as jnp.round.

The kernel runs every product on the tensor cores (mma.sync: s8 m16n8k32
with int32 sums for the int8 products, bf16 m16n8k16 with float32 sums for
x W1 and the fc), from weights packed once into fragment order with the
gate columns interleaved (`pack_int8_mma`, called by `LSTM2.prepare_int8`).
Its sweep runs in one of two forms that `int8_sweep_cluster` chooses by the
fold's shape: the tile form (a CTA a row tile) or, at FullSubNet's
full-band folds (H 512, a few row tiles), the cluster form (a cluster of 16
CTAs a row tile, each owning 32 hidden units, h1q and h2q all-gathered as
int8 blocks through distributed shared memory).

`lstm2_int8_fc` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor, or raises; it never falls back, not
to the tile form when the cluster form is refused either.
`lstm2_int8_fc_split` runs it over the fold's rows split across several
cards, each with its own copy of the prepared weights and its slice's form
by the same rule (the counterpart of `stacked_lstm2_quantized_sharded`,
lstm_pallas.py:1163-1168). The kernel is built with nvcc at first use
(ops/nvcc.py).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from fullsubnet_plus_torch.ops import nvcc
from fullsubnet_plus_torch.ops.lstm2 import (
    SMEM_LIMIT,
    fewest_waves_tile,
    fold_split,
    interleave_gates,
    lstm_cell,
    pack_mma_b,
    x_cols,
)

H_QUANT_SCALE = 127.0
# kernel launches through lstm2_int8_fc by card ("cuda:0", ...) since import (or last
# clear); the total is sum(LAUNCHES.values())
LAUNCHES: Counter = Counter()
# the sweep's launches by form: "lstm2_int8_fwd cluster16", "lstm2_int8_fwd tile"
INT8_SWEEP_FORMS: Counter = Counter()

# The sweep's form (csrc/lstm2_int8_fwd.cu): None the one `int8_sweep_cluster`
# chooses, 0 the tile form (`int8_sweep_kernel`: a CTA a tile of rows),
# INT8_CLUSTER the cluster form (`int8_sweep_cluster_kernel`: a cluster of 16
# CTAs a tile of 16 rows, each owning 32 hidden units). Set to time the forms.
INT8_SWEEP_FORM: int | None = None
INT8_CLUSTER = 16  # CTAs of a cluster (CLUSTER_SIZE in the .cu): H = 16 x 32
INT8_CLUSTER_UNITS = 32  # hidden units a CTA of the cluster form owns (CL_UNITS)
INT8_CLUSTER_KPARTS = 4  # k-parts of each of its products (CL_KPARTS)
INT8_CLUSTER_X_KPARTS = 2  # layer 1's k-parts that run x W1; the others h1q U1q (CL_X_KPARTS)
INT8_CLUSTER_FC_TILES = 4  # fc n-tiles a CTA of it may own (CL_FC_TILES)
# bytes of a row of an h1 block [h1q | pad] and of an h2 block [h2q | bf16(h2) | pad]
INT8_CLUSTER_Q_PITCH, INT8_CLUSTER_H2_PITCH = 48, 112
# The most rows the rule gives the cluster form: the largest fold at which
# it measured faster than the tile form on the H100 (its clusters run in
# waves of 7 at most; at T 629, N 256 20.5 ms against 33.5, N 512 34.3
# against 34.2: PERF.md, `scripts/time_torch_fb_lstm.py --folds`)
INT8_CLUSTER_MAX_ROWS = 256

INT8_ROWS_PER_CTA = (16, 32)  # the sweep's row tiles: one or two m16 tiles
MAX_ROWS_32_HIDDEN = 384  # R 32 is built for blocks of up to 384 threads only
PAD_BYTES = 16  # pad of an operand row (PAD_BYTES in csrc/lstm2_int8_fwd.cu)
MAX_HIDDEN = 512  # the kernel's __launch_bounds__: one thread per hidden unit
_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


class Int8MmaWeights(NamedTuple):
    """The sweep's operands (`pack_int8_mma`): u1q = U1q^T and w2q =
    [W2q; U2q]^T as s8 fragments (`pack_s8_b`), w1 = (W1 padded with zero
    rows to x_cols(D))^T and fc = W_fc^T (O padded to n-tiles of 8) as bf16
    fragments (`pack_mma_b`), the gate columns interleaved
    (`interleave_gates`; the fc has none); s1, b1, s2, b2 [4H] float32,
    interleaved alike."""

    u1q: torch.Tensor
    w1: torch.Tensor
    w2q: torch.Tensor
    fc: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor


class LSTM2Int8Weights(NamedTuple):
    """Operands of the int8-recurrent forward (nn/lstm.py LSTM2.prepare_int8).

    w1 [D, 4H] bfloat16; u1q [H, 4H] and w2q [2H, 4H] ([W2; U2]) int8 with
    column scales s1, s2 [4H] float32 (1/127 of h included); b1, b2 [4H],
    fc_w [H, O] and fc_b [O] float32 (bf16 values): what the plain version
    reads. mma: the same weights packed once for the kernel."""

    w1: torch.Tensor
    u1q: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2q: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    fc_w: torch.Tensor
    fc_b: torch.Tensor
    mma: Int8MmaWeights


def _quantize_columns(w):
    """[K, M] -> (int8 [K, M], float32 [M] scale / H_QUANT_SCALE): the same
    numpy arithmetic as the JAX package's prepare_quantized_lstm."""
    w = np.asarray(w).astype(np.float32)
    amax = np.abs(w).max(axis=0)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return wq, scale / H_QUANT_SCALE


def prepare_quantized_lstm(u1, w2) -> dict:
    """Build-time per-column symmetric int8 quantization (numpy only) of U1
    [H, 4H] and [W2; U2] [2H, 4H]: scale = amax / 127 (1.0 for an all-zero
    column), round half to even, clip to +-127. Returns {"u1q", "s1",
    "w2q", "s2"}; the arrays equal those of
    fullsubnet_plus_tpu/ops/lstm_pallas.py:992 for the same weights (its
    scales are [1, 4H], these [4H])."""
    u1q, s1 = _quantize_columns(u1)
    w2q, s2 = _quantize_columns(w2)
    return {"u1q": u1q, "s1": s1, "w2q": w2q, "s2": s2}


def pack_s8_b(w: torch.Tensor) -> torch.Tensor:
    """An int8 weight [n, K] whose row c holds the K products' weights of
    output column c (the "col" B operand of mma.sync m16n8k32) -> its
    fragments [ceil(n / 8), ceil(K / 64), 32, 16] in the order the lanes read
    them: n-tile nt, chunk kp (k-steps 2kp and 2kp + 1 of 32), lane 4g + t
    holds, for each k-step ks, w[8nt + g, 32(2kp + ks) + 4t + 0..3] and
    w[8nt + g, 32(2kp + ks) + 16 + 4t + 0..3]. So a warp reads 512
    contiguous bytes a chunk, 16 a lane, as `pack_mma_b`'s bf16 fragments.
    Rows past n and columns past K are zero, so any K packs."""
    n, k = w.shape
    tiles, chunks = -(-n // 8), -(-k // 64)
    w = torch.nn.functional.pad(w, (0, 64 * chunks - k, 0, 8 * tiles - n))
    # (nt, g, kp, ks, half, t, pos) -> (nt, kp, g, t, ks, half, pos)
    return (w.reshape(tiles, 8, chunks, 2, 2, 4, 4).permute(0, 2, 1, 5, 3, 4, 6)
            .reshape(tiles, chunks, 32, 16).contiguous())


def unpack_s8_b(packed: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The inverse of `pack_s8_b`: [n, K]."""
    tiles, chunks = packed.shape[:2]
    return (packed.reshape(tiles, chunks, 8, 4, 2, 2, 4).permute(0, 2, 1, 4, 5, 3, 6)
            .reshape(8 * tiles, 64 * chunks)[:n, :k])


def pack_int8_mma(w1, u1q, s1, b1, w2q, s2, b2, fc_w) -> Int8MmaWeights:
    """The kernel's operands from the plain ones (`LSTM2Int8Weights`'
    fields), on their device: once per prepared model, never per call (1.77
    MB of s8 and 0.2 MB of bf16 fragments at D 34, H 384). W_fc^T is
    rounded to bf16, exact for the bf16 values it holds, and its K (H) is
    padded with zero columns to whole chunks, so any H packs."""
    d_in, hidden = w1.shape[0], u1q.shape[0]
    w1 = torch.nn.functional.pad(w1, (0, 0, 0, x_cols(d_in) - d_in))
    fc = torch.nn.functional.pad(fc_w.t().to(torch.bfloat16), (0, -hidden % 32))

    def fragments(m, pack):  # [K, 4H] -> the fragments of its interleaved transpose
        return pack(interleave_gates(m).t())

    def gates(v):
        return interleave_gates(v).contiguous()

    return Int8MmaWeights(fragments(u1q, pack_s8_b), fragments(w1, pack_mma_b),
                          fragments(w2q, pack_s8_b), pack_mma_b(fc), gates(s1), gates(b1),
                          gates(s2), gates(b2))


def _quantize_h(h):
    return torch.clamp(torch.round(h * H_QUANT_SCALE), -127.0, 127.0)


def lstm2_int8_fc_reference(x: torch.Tensor, w: LSTM2Int8Weights) -> torch.Tensor:
    """The plain version: a Python loop over T with the kernel's cast
    points. x [N, D, T] bf16 -> [N, T, O] bf16.

    The integer products run as float32 matmuls of the int8 values, which
    is exact: every partial sum is an integer of size at most
    2H * 127 * 127 (1.24e7 at H = 384), below 2^24. So it needs no integer
    matmul and computes the same on the CPU and on the card, where float32
    matmuls must not use TF32 (it raises if they may)."""
    if x.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("lstm2_int8_fc_reference needs full float32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is True")
    n, _, steps = x.shape
    hidden = w.u1q.shape[0]
    w1, u1q, w2q = w.w1.float(), w.u1q.float(), w.w2q.float()
    h1q = x.new_zeros(n, hidden, dtype=torch.float32)
    c1, h2q, c2 = torch.zeros_like(h1q), torch.zeros_like(h1q), torch.zeros_like(h1q)
    out = []
    for t in range(steps):
        h1, c1 = lstm_cell(x[:, :, t].float() @ w1 + (h1q @ u1q) * w.s1 + w.b1, c1)
        h1q = _quantize_h(h1)
        h2, c2 = lstm_cell((torch.cat([h1q, h2q], dim=-1) @ w2q) * w.s2 + w.b2, c2)
        h2q = _quantize_h(h2)
        out.append(h2.to(torch.bfloat16).float() @ w.fc_w + w.fc_b)
    return torch.stack(out, dim=1).to(torch.bfloat16)


def lstm2_int8_fc(x: torch.Tensor, w: LSTM2Int8Weights) -> torch.Tensor:
    """x [N, D, T] bf16 (the model's channel-major fold) -> [N, T, O] bf16."""
    if x.device.type == "cpu":
        _check(x, w)
        return lstm2_int8_fc_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"lstm2_int8_fc: unsupported device {x.device}")
    return _launch(x, w)


def lstm2_int8_fc_split(x: torch.Tensor, weights, devices) -> torch.Tensor:
    """`lstm2_int8_fc` over the fold split across `devices` (ops/lstm2.py
    `fold_split`), with `weights[i]` the prepared operands on `devices[i]`."""
    return fold_split(lstm2_int8_fc, x, weights, devices)


def shared_memory_bytes(rows: int, d_in: int, hidden: int) -> int:
    """Dynamic shared memory of one block of R = rows (shared_bytes in
    lstm2_int8_fwd.cu): two operand buffers of R int8 rows [h1q | h2q | pad]
    and R bf16 rows [x (x_cols(D)) | bf16(h2) | pad], the pads 16 bytes, and
    c1, c2 [R * H] float32. Nothing grows with O."""
    q_pitch = 2 * hidden + PAD_BYTES
    x_pitch = 2 * (x_cols(d_in) + hidden) + PAD_BYTES
    return 2 * rows * (q_pitch + x_pitch) + 2 * 4 * rows * hidden


def int8_rows_per_cta(n: int, sm_count: int) -> int:
    """The sweep's row tile R: the one that sweeps the fold in the fewest
    waves of one CTA per SM, and of two that tie the smaller. A step's time
    grows with the CTA's m-tiles (each SM pulls every weight fragment from
    L2 once a step whatever R is, but R 32 runs twice the products and
    cells on one SM): on the H100 at N 2056, one wave either way, R 16 took
    8.90 ms at T 255 and 22.0 at T 629 (35 µs a step), R 32 11.8 and 28.2
    (45-46 µs; PERF.md, scripts/time_torch_int8.py). So R 32 pays only
    where it saves a wave."""
    return fewest_waves_tile(n, sm_count, INT8_ROWS_PER_CTA)


def int8_row_tile(n: int, d_in: int, hidden: int, sm_count: int) -> int:
    """`int8_rows_per_cta`, or 16 where 32 needs more shared memory than a
    block has or H > 384; raises where 16 does not fit either."""
    rows = int8_rows_per_cta(n, sm_count)
    if rows != 16 and (hidden > MAX_ROWS_32_HIDDEN
                       or shared_memory_bytes(rows, d_in, hidden) > SMEM_LIMIT):
        rows = 16
    if shared_memory_bytes(rows, d_in, hidden) > SMEM_LIMIT:
        raise ValueError("lstm2_int8_fc: D and H need more shared memory than a block has")
    return rows


def int8_cluster_shared_memory_bytes(d_in: int, hidden: int) -> int:
    """csrc/lstm2_int8_fwd.cu, the cluster form (`cluster_shared_bytes`): a
    CTA of a cluster of C = H / 32 holds an 8-byte mbarrier for each layer,
    step parity and owner, the tile's h1q and h2q for both step parities as
    C owners' blocks of 16 rows ([h1q 32 | pad 16] bytes and [h2q 32 |
    bf16(h2) 64 | pad 16]), the x tile [16][x_cols + 8] bf16, and 32-bit
    words the k-part partials [4][4 gates][16][40] and the fc's [4 n-tiles]
    [4][16][8]. O does not enter: the fc's n-tiles are spread over the
    cluster. 141,056 bytes at D 257, H 512."""
    owners = hidden // INT8_CLUSTER_UNITS
    return (8 * 4 * owners
            + 2 * owners * 16 * (INT8_CLUSTER_Q_PITCH + INT8_CLUSTER_H2_PITCH)
            + 2 * 16 * (x_cols(d_in) + PAD_BYTES // 2)
            + 4 * (INT8_CLUSTER_KPARTS * 4 * 16 * (INT8_CLUSTER_UNITS + 8)
                   + INT8_CLUSTER_FC_TILES * INT8_CLUSTER_KPARTS * 16 * 8))


def int8_sweep_cluster(n: int, d_in: int, hidden: int, out_dim: int) -> int:
    """The sweep's form for a fold of n rows, by its shape alone:
    INT8_CLUSTER, the cluster form (a cluster of 16 CTAs a row tile of 16,
    each owning 32 hidden units, h1q and h2q all-gathered through
    distributed shared memory; the clusters run in waves where the card
    holds fewer at once), where H = 16 x 32, D <= H, the fc's n-tiles spread
    at most 4 a CTA (O <= 512), n <= INT8_CLUSTER_MAX_ROWS and a CTA's
    shared memory fits a block: FullSubNet's full-band folds; else 0, the
    tile form (a CTA a row tile), which the shipped folds (H 384) and
    FullSubNet's sub-band fold take. The launch takes the form it is given:
    one refused raises, none falls back. (csrc/lstm2_int8_fwd.cu's
    `cluster_runs` checks the shape again.)"""
    if hidden != INT8_CLUSTER * INT8_CLUSTER_UNITS or d_in > hidden:
        return 0
    if -(-out_dim // 8) > INT8_CLUSTER_FC_TILES * INT8_CLUSTER or n > INT8_CLUSTER_MAX_ROWS:
        return 0
    fits = int8_cluster_shared_memory_bytes(d_in, hidden) <= SMEM_LIMIT
    return INT8_CLUSTER if fits else 0


def int8_sweep_form(x: torch.Tensor, w: LSTM2Int8Weights) -> int:
    """The form a sweep of x takes: INT8_SWEEP_FORM when set, else
    `int8_sweep_cluster`'s."""
    if INT8_SWEEP_FORM is not None:
        return INT8_SWEEP_FORM
    n, d, _ = x.shape
    return int8_sweep_cluster(n, d, w.u1q.shape[0], w.fc_w.shape[1])


def _check(x: torch.Tensor, w: LSTM2Int8Weights) -> None:
    n, d, _ = x.shape
    hidden = w.u1q.shape[0]
    out_dim = w.fc_w.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"lstm2_int8_fc: x dtype {x.dtype} (bfloat16)")
    g = 4 * hidden
    vec = ((g,), torch.float32)
    expect = {
        "w1": ((d, g), torch.bfloat16), "u1q": ((hidden, g), torch.int8), "s1": vec,
        "b1": vec, "w2q": ((2 * hidden, g), torch.int8), "s2": vec, "b2": vec,
        "fc_w": ((hidden, out_dim), torch.float32), "fc_b": ((out_dim,), torch.float32),
    }
    expect_mma = {
        "u1q": ((g // 8, -(-hidden // 64), 32, 16), torch.int8),
        "w1": ((g // 8, x_cols(d) // 32, 32, 8), torch.bfloat16),
        "w2q": ((g // 8, -(-2 * hidden // 64), 32, 16), torch.int8),
        "fc": ((-(-out_dim // 8), -(-hidden // 32), 32, 8), torch.bfloat16),
        "s1": vec, "b1": vec, "s2": vec, "b2": vec,
    }
    for where, fields, prefix in ((w, expect, ""), (w.mma, expect_mma, "mma.")):
        for name, (shape, dtype) in fields.items():
            t = getattr(where, name)
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"lstm2_int8_fc: {prefix}{name} is {tuple(t.shape)} {t.dtype}, "
                                 f"expected {shape} {dtype}")
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"lstm2_int8_fc: {prefix}{name} must be contiguous on {x.device}")
    if n == 0:
        raise ValueError("lstm2_int8_fc: empty fold")


def _launch(x: torch.Tensor, w: LSTM2Int8Weights) -> torch.Tensor:
    _check(x, w)
    n, d, steps = x.shape
    hidden, out_dim = w.u1q.shape[0], w.fc_w.shape[1]
    if hidden % 32 or hidden > MAX_HIDDEN:
        raise ValueError(f"lstm2_int8_fc: hidden {hidden} must be a multiple of 32, "
                         f"<= {MAX_HIDDEN}")
    form = int8_sweep_form(x, w)
    if form:
        rows = 16
    else:
        sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
        rows = int8_row_tile(n, d, hidden, sm_count)
    x_tnd = x.permute(2, 0, 1).contiguous()  # [T, N, D]: a step's rows are contiguous
    out = torch.empty(n, steps, out_dim, dtype=torch.bfloat16, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x_tnd, *w.mma, w.fc_b, out)
    with torch.cuda.device(x.device):
        err = lib.lstm2_int8_fwd(*(a.data_ptr() for a in args),
                                 n, steps, d, hidden, out_dim, rows, form, stream)
    if err != 0:
        what = f" (the cluster form, clusters of {form})" if form else ""
        raise RuntimeError(f"lstm2_int8_fwd launch failed{what}: CUDA error {err}")
    LAUNCHES[str(x.device)] += 1
    INT8_SWEEP_FORMS[f"lstm2_int8_fwd {f'cluster{form}' if form else 'tile'}"] += 1
    return out


def _library():
    return nvcc.load("lstm2_int8_fwd", "lstm2_int8_fwd", _ARGTYPES)
