"""The differentiable fused 2-layer LSTM + output Linear: a
torch.autograd.Function over three CUDA kernels, their plain versions and
their launch counts.

Replaces the jax.custom_vjp `_stacked_lstm2_train`
(fullsubnet_plus_tpu/ops/lstm_pallas.py:610-612, :890) and its three TPU
kernels:

  * `_residual_kernel` (:322, pallas_call at :638) -> csrc/lstm2_train_fwd.cu:
    the forward sweep of ops/lstm2.py (on the tensor cores, from the weights
    `pack_fwd_mma` packs; in float32 as three TF32 products) that also
    stores the activated gates
    [sigma(i), sigma(f), tanh(g), sigma(o)] and c, h of both layers, in x's
    dtype, as [T, N, 4H] and [T, N, H];
  * `_make_bwd_kernel` (:415, pallas_call at :828) -> csrc/lstm2_bwd.cu: the
    reverse sweep that writes dgates1, dgates2 [T, N, 4H] and dx; the weight
    gradients are matrix products outside (`weight_grads`), as in the JAX
    package (:860-879);
  * `_make_bwd_kernel_fused` (:472, pallas_call at :752) ->
    csrc/lstm2_bwd_wgrad.cu: the same sweep with the weight gradients summed
    inside the kernel file, so no [T, N, 4H] array of dgates is written; in
    bfloat16 those products run on the tensor cores too, in tiles that
    `wgrad_tiles` chooses.

`FUSED_WGRAD` chooses between the last two, as the JAX module's switch of
the same name does (:679); left at None, the form follows x's dtype
(`fused_wgrad`), as measured on the H100. Both share the reverse sweep,
whose three products run on the tensor cores (in float32 as three TF32
products of split operands), reading the weights packed into mma.sync
fragment order (`pack_mma_b` in bfloat16, `pack_tf32_b` in float32). Cast
points follow the TPU kernels: residuals and dgates are rounded to x's
dtype where a product or a store reads them, h, c and every carry stay
float32, the bias gradient of the fused form sums the unrounded dgates and
that of the other form the rounded ones.

A tensor on the CPU takes the plain versions; a CUDA tensor launches the
kernels or raises. The plain versions also admit float64 (for gradcheck).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from fullsubnet_plus_torch.ops import nvcc
from fullsubnet_plus_torch.ops.lstm2 import (
    MAX_HIDDEN,
    SMEM_LIMIT,
    LSTM2Weights,
    fwd_mma_row_tile,
    fwd_mma_shared_memory_bytes,
    pack_fwd_mma,
    pack_mma_b,
    pack_tf32_b,
    pack_weights,
)

# The backward form: True the in-kernel weight-gradient accumulation
# (csrc/lstm2_bwd_wgrad.cu), False the dgates-writing sweep (csrc/lstm2_bwd.cu)
# and `weight_grads`, None the form FUSED_WGRAD_BY_DTYPE gives x's dtype.
FUSED_WGRAD: bool | None = None
# Measured on the H100 at the training fold (PERF.md): bf16 K3 55 ms against
# K4 + `weight_grads` 80; float32, with the reverse sweep on the tensor cores
# in both, K3 166 ms against 120, whose FMA weight gradients (67 ms) lose to
# cuBLAS's SGEMM (36 ms). K4 holds the dgates of every step (5.5 GB in
# float32 there), K3 an L2-sized scratch.
FUSED_WGRAD_BY_DTYPE = {torch.float32: False, torch.bfloat16: True}

# wrapper calls that launched their kernel, since import (or last reset)
LAUNCHES = {"lstm2_train_fwd": 0, "lstm2_bwd": 0, "lstm2_bwd_wgrad": 0}

MMA_ROWS_PER_CTA = 16  # the reverse sweep's row tile: one m16 tile (MMA_ROWS in the .cuh)
MMA_PAD_BYTES = 16  # pad of a dgates row in the reverse sweep's shared memory (lstm2_bwd_sweep.cuh)
WGRAD_SCRATCH_BYTES = 32 << 20  # dgates scratch of the fused backward: a few steps, L2-sized
# The bf16 weight-gradient kernel's tiles (csrc/lstm2_bwd_wgrad.cu, `HTile` and
# W1_ROWS x W1_COLS): rows of the gradient x gate columns. dU1, dW2 and dU2
# take one of WGRAD_H_TILES (`wgrad_tiles`); dW1 (D rows) takes WGRAD_W1_TILE.
WGRAD_H_TILES = ((64, 128), (128, 128))
WGRAD_W1_TILE = (48, 64)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_PTR] * 14 + [_INT] * 7 + [_PTR]
_BWD_ARGTYPES = [_PTR] * 12 + [_INT] * 7 + [_PTR]
_WGRAD_ARGTYPES = [_PTR] * 23 + [_INT] * 8 + [_PTR]


class Residuals(NamedTuple):
    """What the forward saves for the backward, in x's dtype: the activated
    gates g1, g2 [T, N, 4H] (order i, f, g, o) and c1, h1, c2, h2 [T, N, H]."""

    g1: torch.Tensor
    c1: torch.Tensor
    h1: torch.Tensor
    g2: torch.Tensor
    c2: torch.Tensor
    h2: torch.Tensor


class SweepGrads(NamedTuple):
    """The reverse sweep's results: dx [N, D, T] and dgates [T, N, 4H] in
    x's dtype; db1, db2 [4H], the sums of the unrounded dgates (None from
    the dgates-writing kernel, whose bias sums `weight_grads` takes)."""

    dx: torch.Tensor
    dg1: torch.Tensor
    dg2: torch.Tensor
    db1: torch.Tensor | None
    db2: torch.Tensor | None


class LSTM2Grads(NamedTuple):
    """dx [N, D, T] in x's dtype; dw1 [D, 4H], du1, dw2, du2 [H, 4H] and
    db1, db2 [4H] in float32 (the kernels' operand layout, [in, 4H])."""

    dx: torch.Tensor
    dw1: torch.Tensor
    du1: torch.Tensor
    dw2: torch.Tensor
    du2: torch.Tensor
    db1: torch.Tensor
    db2: torch.Tensor


def fused_wgrad(dtype: torch.dtype) -> bool:
    """The backward form for x's dtype: FUSED_WGRAD when set, else the
    measured default (the fused form, the JAX package's, for a dtype the
    kernels do not take)."""
    return FUSED_WGRAD if FUSED_WGRAD is not None else FUSED_WGRAD_BY_DTYPE.get(dtype, True)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _cell_fwd(gates: torch.Tensor, c: torch.Tensor):
    """[.., 4H] pre-activations -> (activated gates, h, c)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c = f * c + i * g
    return torch.cat([i, f, g, o], dim=-1), o * torch.tanh(c), c


def lstm2_train_fwd_reference(x: torch.Tensor, w: LSTM2Weights):
    """The plain version of the residual-saving forward: a loop over T with
    the kernel's cast points. x [N, D, T] -> (y [N, T, O], Residuals)."""
    n, _, steps = x.shape
    hidden = w.u1.shape[0]
    acc = _acc_dtype(x.dtype)
    w1, u1, w2 = w.w1.to(acc), w.u1.to(acc), w.w2.to(acc)
    h1 = x.new_zeros(n, hidden, dtype=acc)
    c1, h2, c2 = torch.zeros_like(h1), torch.zeros_like(h1), torch.zeros_like(h1)

    out, saved = [], [[] for _ in Residuals._fields]
    for t in range(steps):
        a1, h1, c1 = _cell_fwd(x[:, :, t].to(acc) @ w1 + h1 @ u1 + w.b1, c1)
        h1 = h1.to(x.dtype).to(acc)  # the products and the residual read the rounded h
        a2, h2, c2 = _cell_fwd(torch.cat([h1, h2], dim=-1) @ w2 + w.b2, c2)
        h2 = h2.to(x.dtype).to(acc)
        out.append(h2 @ w.fc_w + w.fc_b)
        for store, value in zip(saved, (a1, c1, h1, a2, c2, h2)):
            store.append(value.to(x.dtype))
    if not steps:
        raise ValueError("lstm2_train_fwd: no time steps")
    return (torch.stack(out, dim=1).to(x.dtype),
            Residuals(*(torch.stack(s, dim=0) for s in saved)))


def _cell_bwd(dh, gates, c, c_prev, dc_carry):
    """One LSTM cell's backward from the activated gates -> (dgates, dc)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    tanh_c = torch.tanh(c)
    do = dh * tanh_c
    dc = dh * o * (1.0 - tanh_c * tanh_c) + dc_carry
    di, dg, df = dc * g, dc * i, dc * c_prev
    dgates = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f), dg * (1.0 - g * g),
                        do * o * (1.0 - o)], dim=-1)
    return dgates, dc * f


def lstm2_bwd_reference(dy: torch.Tensor, x: torch.Tensor, w: LSTM2Weights,
                        res: Residuals) -> SweepGrads:
    """The plain version of the reverse sweep (both backward kernels run
    it): dy [N, T, O] -> SweepGrads. dy is rounded to x's dtype first, the
    dgates are rounded to it before every product, carries stay float32."""
    n, _, steps = x.shape
    hidden = w.u1.shape[0]
    acc = _acc_dtype(x.dtype)
    w1t, u1t, w2t = w.w1.to(acc).t(), w.u1.to(acc).t(), w.w2.to(acc).t()
    fcwt = w.fc_w.t()
    dy = dy.to(x.dtype).to(acc)
    zeros = x.new_zeros(n, hidden, dtype=acc)
    dh1, dc1, dh2, dc2 = zeros, zeros, zeros, zeros
    db1 = x.new_zeros(4 * hidden, dtype=acc)
    db2 = torch.zeros_like(db1)
    dx, dg1, dg2 = [None] * steps, [None] * steps, [None] * steps
    for t in range(steps - 1, -1, -1):
        c2_prev = res.c2[t - 1].to(acc) if t else zeros
        d2, dc2 = _cell_bwd(dy[:, t] @ fcwt + dh2, res.g2[t].to(acc), res.c2[t].to(acc),
                            c2_prev, dc2)
        dg2[t] = d2.to(x.dtype)
        dinp2 = dg2[t].to(acc) @ w2t  # d[h1_t | h2_{t-1}]
        dh2 = dinp2[:, hidden:]
        c1_prev = res.c1[t - 1].to(acc) if t else zeros
        d1, dc1 = _cell_bwd(dinp2[:, :hidden] + dh1, res.g1[t].to(acc), res.c1[t].to(acc),
                            c1_prev, dc1)
        dg1[t] = d1.to(x.dtype)
        dh1 = dg1[t].to(acc) @ u1t
        dx[t] = (dg1[t].to(acc) @ w1t).to(x.dtype)
        db1 = db1 + d1.sum(dim=0)
        db2 = db2 + d2.sum(dim=0)
    return SweepGrads(torch.stack(dx, dim=2), torch.stack(dg1), torch.stack(dg2), db1, db2)


def weight_grads(x: torch.Tensor, res: Residuals, dg1: torch.Tensor, dg2: torch.Tensor):
    """The weight gradients from the stored dgates, as whole-sequence
    matrix products with float32 sums (the JAX package's einsums outside its
    kernel, lstm_pallas.py:860-879): (dw1, du1, dw2, du2, db1, db2). The
    previous-step h is the saved h shifted by one step, zero at t = 0."""
    acc = _acc_dtype(x.dtype)
    steps, n, gates = dg1.shape
    g1, g2 = dg1.reshape(steps * n, gates).to(acc), dg2.reshape(steps * n, gates).to(acc)

    def flat_t(a):  # [T, N, K] -> [K, T*N]
        return a.reshape(steps * n, -1).to(acc).t()

    def shifted(h):
        return torch.cat([torch.zeros_like(h[:1]), h[:-1]], dim=0)

    x_tnd = x.permute(2, 0, 1)
    return (flat_t(x_tnd) @ g1, flat_t(shifted(res.h1)) @ g1, flat_t(res.h1) @ g2,
            flat_t(shifted(res.h2)) @ g2, g1.sum(dim=0), g2.sum(dim=0))


# ---------------------------------------------------------------------------
# dispatch: the plain version on the CPU, the kernel on the card
# ---------------------------------------------------------------------------

def lstm2_train_fwd(x: torch.Tensor, w: LSTM2Weights):
    """x [N, D, T] -> (y [N, T, O], Residuals)."""
    if x.device.type == "cpu":
        return lstm2_train_fwd_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"lstm2_train_fwd: unsupported device {x.device}")
    return _launch_train_fwd(x, w)


def lstm2_bwd_sweep(dy: torch.Tensor, x: torch.Tensor, w: LSTM2Weights,
                    res: Residuals) -> SweepGrads:
    """The dgates-writing reverse sweep alone: dx and the dgates of every step."""
    if x.device.type == "cpu":
        return lstm2_bwd_reference(dy, x, w, res)
    if x.device.type != "cuda":
        raise ValueError(f"lstm2_bwd_sweep: unsupported device {x.device}")
    return _launch_bwd(dy, x, w, res)


def lstm2_bwd_plain(dy: torch.Tensor, x: torch.Tensor, w: LSTM2Weights, res: Residuals,
                    fused: bool | None = None) -> LSTM2Grads:
    """The plain version of both backward forms: the reverse loop, then the
    weight gradients as matrix products over its dgates; `fused` only
    chooses which bias sums come back (see the module's note)."""
    fused = fused_wgrad(x.dtype) if fused is None else fused
    sweep = lstm2_bwd_reference(dy, x, w, res)
    dw1, du1, dw2, du2, db1, db2 = weight_grads(x, res, sweep.dg1, sweep.dg2)
    if fused:
        db1, db2 = sweep.db1, sweep.db2
    return LSTM2Grads(sweep.dx, dw1, du1, dw2, du2, db1, db2)


def lstm2_bwd(dy: torch.Tensor, x: torch.Tensor, w: LSTM2Weights, res: Residuals,
              fused: bool | None = None) -> LSTM2Grads:
    """The backward of `lstm2_train_fwd` for the cotangent dy [N, T, O]:
    with `fused` (default `fused_wgrad(x.dtype)`) the weight gradients come
    from the sweep itself, else from `weight_grads` over the stored dgates."""
    fused = fused_wgrad(x.dtype) if fused is None else fused
    if x.device.type == "cpu":
        return lstm2_bwd_plain(dy, x, w, res, fused)
    if x.device.type != "cuda":
        raise ValueError(f"lstm2_bwd: unsupported device {x.device}")
    if fused:
        return _launch_bwd_wgrad(dy, x, w, res)
    sweep = lstm2_bwd_sweep(dy, x, w, res)
    return LSTM2Grads(sweep.dx, *weight_grads(x, res, sweep.dg1, sweep.dg2))


class LSTM2TrainFunction(torch.autograd.Function):
    """y = fc(lstm2(x)) with the hand-written backward. Arguments: the fold
    x [N, D, T], then torch.nn.LSTM's eight tensors (weight_ih_l0 [4H, D],
    weight_hh_l0 [4H, H], bias_ih_l0, bias_hh_l0 and the same of layer 1)
    and the Linear's weight [O, H] and bias [O]. Every gradient comes back
    in its tensor's dtype; both biases of a layer receive the same db."""

    @staticmethod
    def forward(ctx, x, *params):
        y, res = lstm2_train_fwd(x, pack_weights(*params))
        ctx.save_for_backward(x, *params, *res)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, *rest = ctx.saved_tensors
        params, res = rest[:10], Residuals(*rest[10:])
        g = lstm2_bwd(dy, x, pack_weights(*params), res)
        # the fc's gradient, outside the kernels (lstm_pallas.py:883-886)
        acc = g.dw1.dtype
        steps, n, hidden = res.h2.shape
        dy_tn = dy.to(x.dtype).to(acc).transpose(0, 1).reshape(steps * n, -1)
        dfc_w = dy_tn.t() @ res.h2.reshape(steps * n, hidden).to(acc)  # [O, H]
        grads = (g.dw1.t(), g.du1.t(), g.db1, g.db1, g.dw2.t(), g.du2.t(), g.db2, g.db2,
                 dfc_w, dy_tn.sum(dim=0))
        return (g.dx, *(d.to(p.dtype) for d, p in zip(grads, params)))


def lstm2_fc_train(x: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
    """Differentiable x [N, D, T] -> [N, T, O]; see LSTM2TrainFunction."""
    return LSTM2TrainFunction.apply(x, *params)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def mma_rows_per_cta(n: int, sm_count: int) -> int:
    """The row tile R of the reverse sweep, whose products run on the
    tensor cores in m-tiles of 16 rows: one m-tile at every fold and in both
    types. Two (R 32: one wave at N 2304 and half the weight reads) measured
    slower in bf16 at N 771 to 2304 on the H100, each step taking twice as
    long, and do not fit a block in float32 (PERF.md)."""
    return MMA_ROWS_PER_CTA


def fwd_shared_memory_bytes(rows: int, d_in: int, hidden: int, out_dim: int,
                            dtype: torch.dtype = torch.float32) -> int:
    """csrc/lstm2_train_fwd.cu: K1's tensor-core sweep's
    (`fwd_mma_shared_memory_bytes`), which does not grow with O."""
    return fwd_mma_shared_memory_bytes(rows, d_in, hidden, dtype)


def _bwd_bytes(rows: int, d_in: int, hidden: int, out_dim: int, dtype: torch.dtype,
               ksplit: bool) -> int:
    size = torch.tensor([], dtype=dtype).element_size()
    partials = (hidden // 32) * (-(-d_in // 8) * 8) if ksplit else 0
    return (size * rows * (4 * hidden + MMA_PAD_BYTES // size)
            + 4 * rows * (2 * hidden + out_dim + partials))


def bwd_dx_ksplit(rows: int, d_in: int, hidden: int, out_dim: int,
                  dtype: torch.dtype = torch.float32) -> bool:
    """The reverse sweep's form of dx (`dx_ksplit` in csrc/lstm2_bwd_sweep.cuh):
    True, each warp sums every dx n-tile over its share of the 4H gate
    columns into a partial of its own, where those partials fit a block (the
    shipped sub-band shape, D 34, H 384); False, each warp owns whole dx
    n-tiles over all 4H and stores them straight from its accumulators
    (FullSubNet's full-band LSTM, D 257, H 512, O 257)."""
    return _bwd_bytes(rows, d_in, hidden, out_dim, dtype, True) <= SMEM_LIMIT


def bwd_shared_memory_bytes(rows: int, d_in: int, hidden: int, out_dim: int,
                            dtype: torch.dtype = torch.float32,
                            ksplit: bool | None = None) -> int:
    """csrc/lstm2_bwd_sweep.cuh: the dgates in x's dtype [R][4H + pad]
    (MMA_PAD_BYTES of pad), then float32 the dh1 and dh2 carries [R][H], the
    dy tile [R][O] and, in the k-split form of dx, a dx partial per warp
    [H / 32][R][ceil(D / 8) * 8]; in the form `bwd_dx_ksplit` takes, or in
    the one `ksplit` names."""
    if ksplit is None:
        ksplit = bwd_dx_ksplit(rows, d_in, hidden, out_dim, dtype)
    return _bwd_bytes(rows, d_in, hidden, out_dim, dtype, ksplit)


def _check(name: str, x: torch.Tensor, w: LSTM2Weights, smem_bytes, row_tile) -> int:
    """Raises on what the kernels do not take; returns the row tile R,
    `row_tile(n, sm_count)`."""
    n, d, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: x dtype {x.dtype} (float32 or bfloat16)")
    expect = {
        "w1": ((d, 4 * hidden), x.dtype), "u1": ((hidden, 4 * hidden), x.dtype),
        "b1": ((4 * hidden,), torch.float32), "w2": ((2 * hidden, 4 * hidden), x.dtype),
        "b2": ((4 * hidden,), torch.float32), "fc_w": ((hidden, out_dim), torch.float32),
        "fc_b": ((out_dim,), torch.float32),
    }
    for field, (shape, dtype) in expect.items():
        t = getattr(w, field)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {field} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {field} must be contiguous on {x.device}")
    if hidden % 32 or hidden > MAX_HIDDEN:
        raise ValueError(f"{name}: hidden {hidden} must be a multiple of 32, <= {MAX_HIDDEN}")
    if d > hidden:
        raise ValueError(f"{name}: input width {d} exceeds hidden {hidden}")
    if n == 0 or steps == 0:
        raise ValueError(f"{name}: empty fold")
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows = row_tile(n, sm_count)
    if smem_bytes(rows, d, hidden, out_dim) > SMEM_LIMIT:
        raise ValueError(f"{name}: D, H and O need more shared memory than a block has")
    return rows


def _check_residuals(name: str, x: torch.Tensor, res: Residuals, hidden: int) -> None:
    n, _, steps = x.shape
    for field, t in zip(res._fields, res):
        width = 4 * hidden if field[0] == "g" else hidden
        if (tuple(t.shape) != (steps, n, width) or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: residual {field} must be a contiguous "
                             f"{(steps, n, width)} {x.dtype} tensor on {x.device}")


def _call(name: str, argtypes: list, x: torch.Tensor, *args) -> None:
    """Launch `name` of csrc/<name>.cu on x's device and current stream,
    raise on a refused launch, and count the launch."""
    lib = nvcc.load(name, name, argtypes)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                                   for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _launch_train_fwd(x: torch.Tensor, w: LSTM2Weights):
    n, d, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    # K1's row tile at this N (`fwd_mma_row_tile`), so y is K1's bit for bit
    rows = _check("lstm2_train_fwd", x, w,
                  functools.partial(fwd_shared_memory_bytes, dtype=x.dtype),
                  lambda n_rows, sm_count: fwd_mma_row_tile(n_rows, d, hidden, sm_count, x.dtype))
    packed = pack_fwd_mma(w)
    x_tnd = x.permute(2, 0, 1).contiguous()  # [T, N, D]: a step's rows are contiguous

    def empty(*shape):
        return torch.empty(*shape, dtype=x.dtype, device=x.device)

    out = empty(n, steps, out_dim)
    res = Residuals(*(empty(steps, n, 4 * hidden if f[0] == "g" else hidden)
                      for f in Residuals._fields))
    _call("lstm2_train_fwd", _FWD_ARGTYPES, x, x_tnd, *packed, w.fc_b, out, *res, n, steps, d,
          hidden, out_dim, rows, _DTYPE_CODES[x.dtype])
    return out, res


def _bwd_operands(name: str, dy: torch.Tensor, x: torch.Tensor, w: LSTM2Weights,
                  res: Residuals):
    """Checks, the row tile, dy [N, T, O] in x's dtype, and the weights as
    the sweep reads them: the packed mma fragments of [W2; U2], U1 and W1
    (`pack_mma_b` in bfloat16, `pack_tf32_b` in float32; once per call:
    3.7 MB and 7.4 MB at H 384)."""
    rows = _check(name, x, w, functools.partial(bwd_shared_memory_bytes, dtype=x.dtype),
                  mma_rows_per_cta)
    n, _, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    _check_residuals(name, x, res, hidden)
    if tuple(dy.shape) != (n, steps, out_dim) or dy.device != x.device:
        raise ValueError(f"{name}: dy is {tuple(dy.shape)} on {dy.device}, expected "
                         f"{(n, steps, out_dim)} on {x.device}")
    dy = dy.to(x.dtype).contiguous()
    pack = pack_mma_b if x.dtype == torch.bfloat16 else pack_tf32_b
    return rows, dy, tuple(pack(m) for m in (w.w2, w.u1, w.w1))


def _launch_bwd(dy: torch.Tensor, x: torch.Tensor, w: LSTM2Weights, res: Residuals) -> SweepGrads:
    rows, dy, weights = _bwd_operands("lstm2_bwd", dy, x, w, res)
    n, d, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    dg1, dg2 = torch.empty_like(res.g1), torch.empty_like(res.g2)
    dx_tnd = torch.empty(steps, n, d, dtype=x.dtype, device=x.device)
    _call("lstm2_bwd", _BWD_ARGTYPES, x, dy, res.g1, res.c1, res.g2, res.c2, *weights,
          w.fc_w, dg1, dg2, dx_tnd, n, steps, d, hidden, out_dim, rows, _DTYPE_CODES[x.dtype])
    # the bias sums of this form come from the rounded dgates (weight_grads)
    return SweepGrads(dx_tnd.permute(1, 2, 0), dg1, dg2, None, None)


def wgrad_chunk_steps(n: int, hidden: int, steps: int, itemsize: int) -> int:
    """Steps of dgates the fused backward keeps in its scratch at a time."""
    return max(1, min(steps, WGRAD_SCRATCH_BYTES // (2 * n * 4 * hidden * itemsize)))


def wgrad_tiles(d_in: int, hidden: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """(dW1's tile, the tile of dU1, dW2 and dU2) of the bf16 weight-gradient
    kernel, each (rows, gate columns); `wgrad_tile` in csrc/lstm2_bwd_wgrad.cu
    mirrors it. 64 x 128 (two CTAs an SM) was the fastest shape at the
    training fold on the H100 in every run, 7-8 % ahead of 128 x 128 and 40 %
    ahead of 128 x 256 (PERF.md); at H 64 it is also the one without padded
    rows. dW1's D rows are padded to m16 tiles of 48, not to a whole tile."""
    return WGRAD_W1_TILE, WGRAD_H_TILES[0]


def force_wgrad_tile(shape: int | None) -> int | None:
    """Make every later bf16 K3 launch take WGRAD_H_TILES[shape] for dU1, dW2
    and dU2 (None: the rule again), to time the candidates on the card;
    returns the previous setting."""
    lib = nvcc.load("lstm2_bwd_wgrad", "lstm2_bwd_wgrad", _WGRAD_ARGTYPES)
    fn = lib.lstm2_bwd_wgrad_force_tile
    fn.argtypes, fn.restype = [_INT], _INT
    before = fn(-1 if shape is None else shape)
    if before < -1:
        raise ValueError(f"force_wgrad_tile: no tile shape {shape}")
    return None if before == -1 else before


def _launch_bwd_wgrad(dy: torch.Tensor, x: torch.Tensor, w: LSTM2Weights,
                      res: Residuals) -> LSTM2Grads:
    rows, dy, weights = _bwd_operands("lstm2_bwd_wgrad", dy, x, w, res)
    n, d, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    tiles = -(-n // rows)
    chunk = wgrad_chunk_steps(n, hidden, steps, x.element_size())
    if x.dtype == torch.bfloat16:  # rows padded to 8 with zeros: 16-byte copies of whole rows
        x_tnd = x.new_zeros(steps, n, -(-d // 8) * 8)
        x_tnd[:, :, :d] = x.permute(2, 0, 1)
    else:
        x_tnd = x.permute(2, 0, 1).contiguous()

    def f32(*shape, zero=False):
        return (torch.zeros if zero else torch.empty)(*shape, dtype=torch.float32,
                                                      device=x.device)

    dx_tnd = torch.empty(steps, n, d, dtype=x.dtype, device=x.device)
    # the sums start from zero; each element is owned by one thread
    dw1, du1, dw2, du2 = (f32(k, 4 * hidden, zero=True) for k in (d, hidden, hidden, hidden))
    db1, db2 = f32(4 * hidden), f32(4 * hidden)
    scratch_dg1 = torch.empty(chunk, n, 4 * hidden, dtype=x.dtype, device=x.device)
    scratch_dg2 = torch.empty_like(scratch_dg1)
    carry = f32(4, tiles * rows, hidden)  # dh1, dc1, dh2, dc2 between chunks
    db_part = f32(tiles, 2, 4 * hidden)  # each row tile's bias sums
    _call("lstm2_bwd_wgrad", _WGRAD_ARGTYPES, x, dy, x_tnd, res.g1, res.c1, res.h1, res.g2,
          res.c2, res.h2, *weights, w.fc_w, dx_tnd, dw1, du1, dw2, du2, db1, db2,
          scratch_dg1, scratch_dg2, carry, db_part, n, steps, d, hidden, out_dim, rows, chunk,
          _DTYPE_CODES[x.dtype])
    return LSTM2Grads(dx_tnd.permute(1, 2, 0), dw1, du1, dw2, du2, db1, db2)

