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
float32, and y is stored in x's dtype.

`lstm2_fc` takes the plain version for a tensor on the CPU and launches the
kernel for a CUDA tensor, or raises; it never falls back. The kernel is
compiled with nvcc from the package's sources at first use, into
fullsubnet_plus_torch/_build/, and loaded with ctypes (ops/nvcc.py).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from fullsubnet_plus_torch.ops import nvcc

LAUNCHES = 0  # kernel launches through lstm2_fc since import (or last reset)

ROWS_PER_CTA = 16  # R in csrc/lstm2_fwd.cu
MAX_HIDDEN = 512  # the kernel's __launch_bounds__: one thread per hidden unit
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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


def shared_memory_bytes(d_in: int, hidden: int, out_dim: int) -> int:
    """Dynamic shared memory of one block (the layout in lstm2_fwd_sweep.cuh):
    x tile [D][R], h1 and h2 [H][R], c1 and c2 [R][H], fc partials
    [H/32][R][O], all float32."""
    floats = ROWS_PER_CTA * (d_in + 4 * hidden + (hidden // 32) * out_dim)
    return 4 * floats


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
    if shared_memory_bytes(d, hidden, out_dim) > SMEM_LIMIT:
        raise ValueError("lstm2_fc: D, H and O need more shared memory than a block has")
    if n == 0:
        raise ValueError("lstm2_fc: empty fold")


def _launch(x: torch.Tensor, w: LSTM2Weights) -> torch.Tensor:
    global LAUNCHES
    _check(x, w)
    n, d, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    x_tnd = x.permute(2, 0, 1).contiguous()  # [T, N, D]: a step's rows are contiguous
    out = torch.empty(n, steps, out_dim, dtype=x.dtype, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.lstm2_fwd(
            x_tnd.data_ptr(), w.w1.data_ptr(), w.u1.data_ptr(), w.b1.data_ptr(),
            w.w2.data_ptr(), w.b2.data_ptr(), w.fc_w.data_ptr(), w.fc_b.data_ptr(),
            out.data_ptr(), n, steps, d, hidden, out_dim, _DTYPE_CODES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm2_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _library():
    return nvcc.load("lstm2_fwd", "lstm2_fwd", _ARGTYPES)
