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

`lstm2_int8_fc` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor, or raises; it never falls back. The
kernel is built with nvcc at first use (ops/nvcc.py).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from fullsubnet_plus_torch.ops import nvcc
from fullsubnet_plus_torch.ops.lstm2 import SMEM_LIMIT, lstm_cell

H_QUANT_SCALE = 127.0
LAUNCHES = 0  # kernel launches through lstm2_int8_fc since import (or last reset)

ROWS_PER_CTA = 16  # R in csrc/lstm2_int8_fwd.cu
MAX_HIDDEN = 512  # the kernel's __launch_bounds__: one thread per hidden unit
_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


class LSTM2Int8Weights(NamedTuple):
    """Operands of the int8-recurrent forward (nn/lstm.py LSTM2.prepare_int8).

    w1 [D, 4H] bfloat16; u1q [H, 4H] and w2q [2H, 4H] ([W2; U2]) int8 with
    column scales s1, s2 [4H] float32 (1/127 of h included); b1, b2 [4H],
    fc_w [H, O] and fc_b [O] float32 (bf16 values). u1q_packed [H/4, 4H] and
    w2q_packed [H/2, 4H] int32 are u1q and w2q repacked k-quad-major, four
    consecutive k of one column in one word (byte i = row 4q + i), the
    kernel's __dp4a operands; the plain version reads u1q and w2q."""

    w1: torch.Tensor
    u1q: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2q: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    fc_w: torch.Tensor
    fc_b: torch.Tensor
    u1q_packed: torch.Tensor
    w2q_packed: torch.Tensor


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


def pack_k_quads(wq: torch.Tensor) -> torch.Tensor:
    """int8 [K, M] -> int32 [K/4, M]: word (q, m) holds wq[4q + i, m] in
    byte i (little-endian, as __dp4a reads it)."""
    k, m = wq.shape
    quads = wq.reshape(k // 4, 4, m).transpose(1, 2).contiguous()  # [K/4, M, 4]
    return quads.view(torch.int32).reshape(k // 4, m)


def unpack_k_quads(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_k_quads`."""
    q, m = packed.shape
    return packed.contiguous().view(torch.int8).reshape(q, m, 4).transpose(1, 2).reshape(4 * q, m)


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


def shared_memory_bytes(d_in: int, hidden: int, out_dim: int) -> int:
    """Dynamic shared memory of one block (the layout in lstm2_int8_fwd.cu):
    x tile [D][R] float32, h1q and h2q [H/4][R] packed int8, c1 and c2
    [R][H] float32, fc partials [H/32][R][O] float32."""
    return 4 * ROWS_PER_CTA * (d_in + hidden // 2 + 2 * hidden + (hidden // 32) * out_dim)


def _check(x: torch.Tensor, w: LSTM2Int8Weights) -> None:
    n, d, _ = x.shape
    hidden = w.u1q.shape[0]
    out_dim = w.fc_w.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"lstm2_int8_fc: x dtype {x.dtype} (bfloat16)")
    g = 4 * hidden
    expect = {
        "w1": ((d, g), torch.bfloat16), "u1q": ((hidden, g), torch.int8),
        "s1": ((g,), torch.float32), "b1": ((g,), torch.float32),
        "w2q": ((2 * hidden, g), torch.int8), "s2": ((g,), torch.float32),
        "b2": ((g,), torch.float32),
        "fc_w": ((hidden, out_dim), torch.float32), "fc_b": ((out_dim,), torch.float32),
        "u1q_packed": ((hidden // 4, g), torch.int32),
        "w2q_packed": ((hidden // 2, g), torch.int32),
    }
    for name, (shape, dtype) in expect.items():
        t = getattr(w, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"lstm2_int8_fc: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"lstm2_int8_fc: {name} must be contiguous on {x.device}")
    if n == 0:
        raise ValueError("lstm2_int8_fc: empty fold")


def _launch(x: torch.Tensor, w: LSTM2Int8Weights) -> torch.Tensor:
    global LAUNCHES
    _check(x, w)
    n, d, steps = x.shape
    hidden, out_dim = w.u1q.shape[0], w.fc_w.shape[1]
    if hidden % 32 or hidden > MAX_HIDDEN:
        raise ValueError(f"lstm2_int8_fc: hidden {hidden} must be a multiple of 32, "
                         f"<= {MAX_HIDDEN}")
    if shared_memory_bytes(d, hidden, out_dim) > SMEM_LIMIT:
        raise ValueError("lstm2_int8_fc: D, H and O need more shared memory than a block has")
    x_tnd = x.permute(2, 0, 1).contiguous()  # [T, N, D]: a step's rows are contiguous
    out = torch.empty(n, steps, out_dim, dtype=torch.bfloat16, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.lstm2_int8_fwd(
            x_tnd.data_ptr(), w.w1.data_ptr(), w.u1q_packed.data_ptr(), w.s1.data_ptr(),
            w.b1.data_ptr(), w.w2q_packed.data_ptr(), w.s2.data_ptr(), w.b2.data_ptr(),
            w.fc_w.data_ptr(), w.fc_b.data_ptr(), out.data_ptr(),
            n, steps, d, hidden, out_dim, stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm2_int8_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def build() -> Path:
    """Compile csrc/lstm2_int8_fwd.cu for sm_90a into the build directory
    (once per source version) and return the shared library's path."""
    return nvcc.build("lstm2_int8_fwd")


def _library():
    return nvcc.load("lstm2_int8_fwd", "lstm2_int8_fwd", _ARGTYPES)
