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
fullsubnet_plus_torch/_build/, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple

import torch

LAUNCHES = 0  # kernel launches through lstm2_fc since import (or last reset)

ROWS_PER_CTA = 16  # R in csrc/lstm2_fwd.cu
MAX_HIDDEN = 512  # the kernel's __launch_bounds__: one thread per hidden unit
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "lstm2_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_lib_lock = threading.Lock()


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

    def cell(gates, c):
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    out = []
    for t in range(steps):
        h1, c1 = cell(x[:, :, t].float() @ w1 + h1 @ u1 + w.b1, c1)
        h1 = rounded(h1)
        h2, c2 = cell(torch.cat([h1, h2], dim=-1) @ w2 + w.b2, c2)
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
    """Dynamic shared memory of one block (the layout in lstm2_fwd.cu):
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


def build() -> Path:
    """Compile csrc/lstm2_fwd.cu for sm_90a into the build directory (once
    per source version) and return the shared library's path."""
    from torch.utils.cpp_extension import CUDA_HOME

    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    lib_path = _BUILD_DIR / f"lstm2_fwd_{digest}.so"
    if lib_path.exists():
        return lib_path
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        (_BUILD_DIR / f"lstm2_fwd_{digest}.ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.lstm2_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            lib.lstm2_fwd.restype = ctypes.c_int
            _lib = lib
    return _lib
