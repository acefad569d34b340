"""Fused 2-layer LSTM forward with the output Linear: wrapper, plain version,
launch count and build of the CUDA kernel csrc/lstm2_fwd.cu.

Replaces the TPU kernel `_make_kernel` launched by `stacked_lstm2`
(fullsubnet_plus_tpu/ops/lstm_pallas.py:98, :210, pallas_call at :277).
Per step t, for every row n of the [N, D, T] fold:

    g1 = x_t W1 + h1 U1 + (b_ih1 + b_hh1)            gate order i, f, g, o
    g2 = [h1 | h2] [W2; U2] + (b_ih2 + b_hh2)
    y_t = h2 W_fc + b_fc                              out [N, T, O]

h and c are carried in float32; h is rounded to the weight dtype before
every product (the TPU kernel's `h.astype(mm)`), products accumulate in
float32, and y is stored in x's dtype. Every product runs on the tensor
cores (mma.sync), reading the weights packed into fragment order with the
gate columns interleaved (`pack_fwd_mma`, once per call). In bfloat16 the
fc reads W_fc rounded to bfloat16, as the TPU kernel's `fcw.astype(mm)`. In
float32 the kernel computes each product as three TF32 products of split
operands (a = big + small, both TF32: small.big + big.small + big.big, float32
sums), which holds the float32 agreement floors; a single TF32 product does not.

`lstm2_fc` takes the plain version for a tensor on the CPU and launches the
kernel for a CUDA tensor, or raises; it never falls back. `lstm2_fc_split`
runs it over the fold's rows split across several cards (`fold_split`, the
counterpart of `_fold_sharded`, lstm_pallas.py:893-945). The kernel is
compiled with nvcc from the package's sources at first use, into
fullsubnet_plus_torch/_build/, and loaded with ctypes (ops/nvcc.py).
"""

from __future__ import annotations

import ctypes
import warnings
from collections import Counter
from typing import NamedTuple

import torch

from fullsubnet_plus_torch.ops import nvcc

# kernel launches through lstm2_fc by card ("cuda:0", ...) since import (or last
# clear); the total is sum(LAUNCHES.values())
LAUNCHES: Counter = Counter()

# The sweep's row tiles by dtype: one or two m16 tiles in bf16; one in float32,
# where two operand buffers of 32 rows do not fit a block (PERF.md: one buffer
# with h held in registers measured slower than R 16 on the H100)
FWD_MMA_ROWS_PER_CTA = {torch.bfloat16: (16, 32), torch.float32: (16,)}
FWD_MMA_PAD_BYTES = 16  # pad of an operand row (operand_pitch in csrc/lstm2_fwd_sweep.cuh)
MAX_HIDDEN = 512  # the kernel's __launch_bounds__: one thread per hidden unit
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


class LSTM2Weights(NamedTuple):
    """Operands of the fused forward (nn/lstm.py LSTM2.packed builds them).

    w1 [D, 4H], u1 [H, 4H], w2 [2H, 4H]: the weight dtype (float32 or
    bfloat16), row-major. b1, b2 [4H], fc_w [H, O], fc_b [O]: float32."""

    w1: torch.Tensor
    u1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    fc_w: torch.Tensor
    fc_b: torch.Tensor


def pack_weights(w_ih0, w_hh0, b_ih0, b_hh0, w_ih1, w_hh1, b_ih1, b_hh1, fc_w,
                 fc_b) -> LSTM2Weights:
    """The kernels' operands from torch.nn.LSTM's eight tensors and the
    output Linear's two: weights transposed to [K, 4H] row-major in their
    own dtype, layer 2's input and recurrent matrices stacked into [W2; U2]
    ([2H, 4H]), b_ih + b_hh summed in the parameters' dtype (as the TPU
    kernel's wrapper does) and then widened to float32 (float64 stays), and
    the Linear as W_fc [H, O] and b_fc [O] in float32."""
    wide = torch.float64 if w_ih0.dtype == torch.float64 else torch.float32

    def t(w):
        return w.t().contiguous()

    return LSTM2Weights(
        w1=t(w_ih0), u1=t(w_hh0), b1=(b_ih0 + b_hh0).to(wide),
        w2=torch.cat([t(w_ih1), t(w_hh1)], dim=0), b2=(b_ih1 + b_hh1).to(wide),
        fc_w=t(fc_w).to(wide), fc_b=fc_b.to(wide))


def pack_mma_b(w: torch.Tensor) -> torch.Tensor:
    """A weight [n, K] whose row c holds the K products' weights of output
    column c (k-contiguous: the "col" B operand of mma.sync m16n8k16) ->
    its fragments [ceil(n / 8), K / 32, 32, 8] in the order the lanes read
    them: n-tile nt, k-pair kp (k-steps 2kp and 2kp + 1 of 16), lane
    4g + t holds, for each of the two k-steps ks, w[8nt + g, 16ks + 2t + {0, 1}]
    and w[8nt + g, 16ks + 8 + 2t + {0, 1}]. So a warp reads 512 contiguous
    bytes a k-pair, 16 a lane. Rows past n are zero."""
    n, k = w.shape
    if k % 32:
        raise ValueError(f"pack_mma_b: K = {k} is not a multiple of 32")
    tiles = -(-n // 8)
    w = torch.nn.functional.pad(w, (0, 0, 0, 8 * tiles - n))
    # (nt, g, kp, ks, half, t, pos) -> (nt, kp, g, t, ks, half, pos)
    return (w.reshape(tiles, 8, k // 32, 2, 2, 4, 2).permute(0, 2, 1, 5, 3, 4, 6)
            .reshape(tiles, k // 32, 32, 8).contiguous())


def unpack_mma_b(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of `pack_mma_b`: [n, K]."""
    tiles, kpairs = packed.shape[:2]
    return (packed.reshape(tiles, kpairs, 8, 4, 2, 2, 2).permute(0, 2, 1, 4, 5, 3, 6)
            .reshape(8 * tiles, 32 * kpairs)[:n])


def pack_tf32_b(w: torch.Tensor) -> torch.Tensor:
    """A float32 weight [n, K] whose row c holds the K products' weights of
    output column c (the "col" B operand of mma.sync m16n8k8) -> its
    fragments [ceil(n / 8), K / 16, 32, 4] in the order the lanes read them:
    n-tile nt, k-chunk kc (k-steps 2kc and 2kc + 1 of 8), lane 4g + t holds,
    for each k-step ks, b0 = w[8nt + g, 16kc + 8ks + t] and b1 = w[8nt + g,
    16kc + 8ks + 4 + t]. So a warp reads 512 contiguous bytes a k-chunk, 16
    a lane. Rows past n are zero."""
    n, k = w.shape
    if k % 16:
        raise ValueError(f"pack_tf32_b: K = {k} is not a multiple of 16")
    tiles = -(-n // 8)
    w = torch.nn.functional.pad(w, (0, 0, 0, 8 * tiles - n))
    # (nt, g, kc, ks, half, t) -> (nt, kc, g, t, ks, half)
    return (w.reshape(tiles, 8, k // 16, 2, 2, 4).permute(0, 2, 1, 5, 3, 4)
            .reshape(tiles, k // 16, 32, 4).contiguous())


def unpack_tf32_b(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of `pack_tf32_b`: [n, K]."""
    tiles, chunks = packed.shape[:2]
    return (packed.reshape(tiles, chunks, 8, 4, 2, 2).permute(0, 2, 1, 4, 5, 3)
            .reshape(8 * tiles, 16 * chunks)[:n])


def interleave_gates(w: torch.Tensor) -> torch.Tensor:
    """[..., 4H] in gate order i, f, g, o (column gate * H + unit) -> the
    sweep's order: column 32u + 8 gate + j holds unit 8u + j, so
    n-tiles 4u .. 4u + 3 hold the four gates of units 8u .. 8u + 7."""
    hidden = w.shape[-1] // 4
    return (w.reshape(*w.shape[:-1], 4, hidden // 8, 8).transpose(-3, -2)
            .reshape(*w.shape[:-1], 4 * hidden))


def deinterleave_gates(w: torch.Tensor) -> torch.Tensor:
    """The inverse of `interleave_gates`."""
    hidden = w.shape[-1] // 4
    return (w.reshape(*w.shape[:-1], hidden // 8, 4, 8).transpose(-3, -2)
            .reshape(*w.shape[:-1], 4 * hidden))


def x_cols(d_in: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """x's columns in the sweep's operand rows: D padded to whole k-chunks of
    the weight dtype (32 bf16 or 16 float32, 64 bytes either way)."""
    chunk = 64 // torch.tensor([], dtype=dtype).element_size()
    return -(-d_in // chunk) * chunk


class FwdMmaWeights(NamedTuple):
    """The forward sweep's operands (`pack_fwd_mma`): w1 = [W1 padded with
    zero rows to x_cols(D, dtype); U1], w2 = [W2; U2] and fc = W_fc^T (O padded to
    n-tiles of 8) as fragments of their transposes in the weight dtype
    (`pack_mma_b` for bf16, `pack_tf32_b` for float32), the gate columns
    interleaved; b1, b2 [4H] float32, interleaved alike."""

    w1: torch.Tensor
    w2: torch.Tensor
    fc: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor


def pack_fwd_mma(w: LSTM2Weights) -> FwdMmaWeights:
    """The sweep's operands from the fused forward's, in the weights' dtype
    (at H 384: 3.7 MB bf16, 7.4 MB float32; at FullSubNet's full-band
    shape, D 257, H 512, O 257: 7.7 MB bf16, 15.4 MB float32; a few device
    copies, once per call). In bf16 fc_w is rounded to bf16, as the TPU kernel's
    `fcw.astype(mm)` (exact for a bf16 module's weights)."""
    d_in, dtype = w.w1.shape[0], w.w1.dtype
    pack = pack_tf32_b if dtype == torch.float32 else pack_mma_b
    w1 = torch.cat([torch.nn.functional.pad(w.w1, (0, 0, 0, x_cols(d_in, dtype) - d_in)),
                    w.u1])

    def fragments(m):  # [K, 4H] -> the fragments of its interleaved transpose
        return pack(interleave_gates(m).t().to(dtype))

    return FwdMmaWeights(fragments(w1), fragments(w.w2), pack(w.fc_w.t().to(dtype)),
                         interleave_gates(w.b1).contiguous(), interleave_gates(w.b2).contiguous())


def lstm_cell(gates: torch.Tensor, c: torch.Tensor):
    """The LSTM cell on [.., 4H] gates in order i, f, g, o -> (h, c)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm2_fc_reference(x: torch.Tensor, w: LSTM2Weights) -> torch.Tensor:
    """The plain version: a Python loop over T with torch.matmul, the same
    cast points and float32 state as the kernel. x [N, D, T] -> [N, T, O]."""
    n, _, steps = x.shape
    hidden = w.u1.shape[0]
    dtype = w.w1.dtype

    def rounded(h):  # h.astype(mm) of the TPU kernel, kept in float32
        return h.to(dtype).float()

    w1, u1, w2 = w.w1.float(), w.u1.float(), w.w2.float()
    h1 = x.new_zeros(n, hidden, dtype=torch.float32)
    c1, h2, c2 = torch.zeros_like(h1), torch.zeros_like(h1), torch.zeros_like(h1)

    out = []
    for t in range(steps):
        h1, c1 = lstm_cell(x[:, :, t].float() @ w1 + h1 @ u1 + w.b1, c1)
        h1 = rounded(h1)
        h2, c2 = lstm_cell(torch.cat([h1, h2], dim=-1) @ w2 + w.b2, c2)
        h2 = rounded(h2)
        out.append(h2 @ w.fc_w + w.fc_b)
    return torch.stack(out, dim=1).to(x.dtype)


def lstm2_fc(x: torch.Tensor, w: LSTM2Weights) -> torch.Tensor:
    """x [N, D, T] (the model's channel-major fold) -> [N, T, O]."""
    if x.device.type == "cpu":
        return lstm2_fc_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"lstm2_fc: unsupported device {x.device}")
    return _launch(x, w)


def to_device(weights, device):
    """A weights NamedTuple (nested ones too) with every tensor on `device`."""
    return type(weights)(*(to_device(v, device) if isinstance(v, tuple) else v.to(device)
                           for v in weights))


def fold_split(fn, x: torch.Tensor, weights, devices) -> torch.Tensor:
    """`fn(x_part, weights[i])` on `devices[i]` over an even split of the
    fold's rows, the outputs gathered in order on x's device.

    The fold's rows are independent sequences, so the split needs no
    communication but the copies in and out; every part is dispatched
    before any is waited on (each launch uses its own card's stream). Where
    the rows do not divide over the cards the whole fold runs on x's card
    with a warning, as the JAX wrapper does (lstm_pallas.py:918-932);
    `weights[0]` must then lie on x's device."""
    parts = len(devices)
    if parts != len(weights) or parts == 0:
        raise ValueError(f"fold_split: {len(weights)} weights for {parts} devices")
    if parts == 1 or x.shape[0] % parts:
        if parts > 1:
            warnings.warn(f"fold of {x.shape[0]} rows does not divide over {parts} cards; "
                          "running the LSTM kernel on one card (the whole fold)",
                          stacklevel=3)
        return fn(x, weights[0])
    rows = x.shape[0] // parts
    # every part is copied out before any kernel is queued: a copy between
    # cards waits for both cards' streams, so a copy queued after the first
    # part's kernel would wait for that kernel
    xs = [x[i * rows:(i + 1) * rows].to(dev, non_blocking=True)
          for i, dev in enumerate(devices)]
    outs = [fn(part, w) for part, w in zip(xs, weights)]
    return torch.cat([o.to(x.device, non_blocking=True) for o in outs])


def lstm2_fc_split(x: torch.Tensor, weights, devices) -> torch.Tensor:
    """`lstm2_fc` over the fold split across `devices` (`fold_split`), with
    `weights[i]` the operands on `devices[i]`."""
    return fold_split(lstm2_fc, x, weights, devices)


def fwd_mma_shared_memory_bytes(rows: int, d_in: int, hidden: int,
                                dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one block of the sweep (shared_bytes_mma in
    lstm2_fwd_sweep.cuh): two operand buffers [R][x | h1 | h2 | pad] in the
    weight dtype (x padded to `x_cols`), the pad 16 bytes, and c1, c2 [R * H]
    float32. Nothing grows with O. At D 257, H 512, R 16: 150,016 bytes in
    bf16 and 231,936 in float32, within a block."""
    size = torch.tensor([], dtype=dtype).element_size()
    pitch = x_cols(d_in, dtype) + 2 * hidden + FWD_MMA_PAD_BYTES // size
    return 2 * size * rows * pitch + 2 * 4 * rows * hidden


def fwd_mma_rows_per_cta(n: int, sm_count: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The sweep's row tile R for x's dtype: the one that sweeps the fold in
    the fewest waves of one CTA per SM, and of two that tie the smaller.
    Each SM pulls every weight fragment from L2 once a step whatever R is,
    and that sets a step's time; R 32 shares each fragment between two
    m-tiles but takes a little longer a step (on the H100, bf16 K2 at N
    2304, T 195: one wave of R 32 17.3-17.7 ms, two waves of R 16 22.0-23.1;
    at N 771, one wave either way, R 16 9.8-10.3 against 13.0-13.5; PERF.md,
    scripts/time_torch_fwd_tiles.py). float32 has R 16 alone."""
    return fewest_waves_tile(n, sm_count, FWD_MMA_ROWS_PER_CTA[dtype])


def fewest_waves_tile(n: int, sm_count: int, tiles) -> int:
    """Of `tiles` (rows per CTA), the one that covers n rows in the fewest
    waves of one CTA per SM, and of two that tie the smaller."""
    def waves(rows):
        return -(-(-(-n // rows)) // sm_count)

    return min(tiles, key=lambda rows: (waves(rows), rows))


def fwd_mma_row_tile(n: int, d_in: int, hidden: int, sm_count: int,
                     dtype: torch.dtype = torch.bfloat16) -> int:
    """`fwd_mma_rows_per_cta`, or 16 where that tile needs more shared memory
    than a block has; raises where 16 does too. K1 and K2 both take it, so
    their y is equal bit for bit."""
    rows = fwd_mma_rows_per_cta(n, sm_count, dtype)
    if fwd_mma_shared_memory_bytes(rows, d_in, hidden, dtype) > SMEM_LIMIT:
        rows = FWD_MMA_ROWS_PER_CTA[dtype][0]
    if fwd_mma_shared_memory_bytes(rows, d_in, hidden, dtype) > SMEM_LIMIT:
        raise ValueError("D and H need more shared memory than a block has")
    return rows


def _check(x: torch.Tensor, w: LSTM2Weights) -> None:
    n, d, _ = x.shape
    hidden = w.u1.shape[0]
    out_dim = w.fc_w.shape[1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"lstm2_fc: x dtype {x.dtype} (float32 or bfloat16)")
    expect = {
        "w1": ((d, 4 * hidden), x.dtype), "u1": ((hidden, 4 * hidden), x.dtype),
        "b1": ((4 * hidden,), torch.float32), "w2": ((2 * hidden, 4 * hidden), x.dtype),
        "b2": ((4 * hidden,), torch.float32), "fc_w": ((hidden, out_dim), torch.float32),
        "fc_b": ((out_dim,), torch.float32),
    }
    for name, (shape, dtype) in expect.items():
        t = getattr(w, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"lstm2_fc: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"lstm2_fc: {name} must be contiguous on {x.device}")
    if hidden % 32 or hidden > MAX_HIDDEN:
        raise ValueError(f"lstm2_fc: hidden {hidden} must be a multiple of 32, <= {MAX_HIDDEN}")
    if n == 0:
        raise ValueError("lstm2_fc: empty fold")


def _launch(x: torch.Tensor, w: LSTM2Weights) -> torch.Tensor:
    _check(x, w)
    n, d, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows = fwd_mma_row_tile(n, d, hidden, sm_count, x.dtype)
    packed = pack_fwd_mma(w)
    x_tnd = x.permute(2, 0, 1).contiguous()  # [T, N, D]: a step's rows are contiguous
    out = torch.empty(n, steps, out_dim, dtype=x.dtype, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x_tnd, *packed, w.fc_b, out)
    with torch.cuda.device(x.device):
        err = lib.lstm2_fwd(
            *(a.data_ptr() for a in args),
            n, steps, d, hidden, out_dim, rows, _DTYPE_CODES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm2_fwd launch failed: CUDA error {err}")
    LAUNCHES[str(x.device)] += 1
    return out


def _library():
    return nvcc.load("lstm2_fwd", "lstm2_fwd", _ARGTYPES)
