"""The differentiable fused 2-layer LSTM + output Linear: a
torch.autograd.Function over three CUDA kernels, their plain versions and
their launch counts.

Replaces the jax.custom_vjp `_stacked_lstm2_train`
(fullsubnet_plus_tpu/ops/lstm_pallas.py:610-612, :890) and its three TPU
kernels:

  * `_residual_kernel` (:322, pallas_call at :638) -> csrc/lstm2_train_fwd.cu:
    the forward sweep of ops/lstm2.py (on the tensor cores, from the weights
    `pack_fwd_mma` packs; in float32 as three TF32 products; in the form and
    row tile K1 takes, `fwd_sweep_launch`: at the training fold the wave
    form, its h and c carries between a tile's items in device memory) that
    also
    stores the activated gates
    [sigma(i), sigma(f), tanh(g), sigma(o)] and c, h of both layers, in x's
    dtype, as [T, N, 4H] and [T, N, H];
  * `_make_bwd_kernel` (:415, pallas_call at :828) -> csrc/lstm2_bwd.cu: the
    reverse sweep that writes dgates1, dgates2 [T, N, 4H] and dx; the weight
    gradients are matrix products outside (`weight_grads`), as in the JAX
    package (:860-879);
  * `_make_bwd_kernel_fused` (:472, pallas_call at :752) ->
    csrc/lstm2_bwd_wgrad.cu: the same sweep with the weight gradients summed
    inside the kernel file, so no [T, N, 4H] array of dgates is written;
    those products run on the tensor cores too (in float32 as three TF32
    products), in tiles that `wgrad_tiles` chooses: on Hopper's warpgroup
    products (wgmma) fed by TMA tensor maps, the mma.sync kernels kept as
    forced candidates.

`FUSED_WGRAD` chooses between the last two, as the JAX module's switch of
the same name does (:679); left at None, the form follows x's dtype
(`fused_wgrad`), as measured on the H100. Both share the reverse sweep,
whose three products run on the tensor cores (in float32 as three TF32
products of split operands), reading the weights packed into mma.sync
fragment order (`pack_mma_b` in bfloat16, `pack_tf32_b` in float32) on
mma.sync, in one of three forms that `bwd_sweep_form` chooses: the tile
form (a CTA a row tile for all its steps), the wave form (the same work cut
into items of a row tile and a few steps, in launches of a CTA an SM, so a
fold of more tiles than SMs leaves no SM idle for a second wave) or, at
FullSubNet's full-band folds, the cluster form (a cluster of CTAs a row
tile, each owning a slice of the hidden units). Cast
points follow the TPU kernels: residuals and dgates are rounded to x's
dtype where a product or a store reads them, h, c and every carry stay
float32, the bias gradient of the fused form sums the unrounded dgates and
that of the other form the rounded ones.

`lstm2_fc_train_split` runs the differentiable function over the fold's
rows split across several cards, the counterpart of
`stacked_lstm2_train_sharded` (:948-951): each card runs K2 and K3 / K4 on
its slice, and autograd sums the cards' weight gradients into the
parameters, as shard_map's transpose psums them in the JAX package.

A tensor on the CPU takes the plain versions; a CUDA tensor launches the
kernels or raises. The plain versions also admit float64 (for gradcheck).
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import NamedTuple

import torch

from fullsubnet_plus_torch.ops import lstm2, nvcc
from fullsubnet_plus_torch.ops.lstm2 import (
    MAX_HIDDEN,
    SMEM_LIMIT,
    LSTM2Weights,
    count_form,
    fold_split,
    form_label,
    fwd_carry,
    fwd_mma_shared_memory_bytes,
    fwd_sweep_launch,
    pack_fwd_mma,
    pack_mma_b,
    pack_tf32_b,
    pack_weights,
)

# The backward form: True the in-kernel weight-gradient accumulation
# (csrc/lstm2_bwd_wgrad.cu), False the dgates-writing sweep (csrc/lstm2_bwd.cu)
# and `weight_grads`, None the form FUSED_WGRAD_BY_DTYPE gives x's dtype.
FUSED_WGRAD: bool | None = None
# Measured on the H100 (PERF.md): the fused form in both dtypes, the JAX
# package's default. At the training fold bf16 K3 took 52.2 ms against K4 +
# `weight_grads` 77.2, float32 K3 (its weight gradients as 3xTF32 on the
# tensor cores, 28.5 ms) 107.7 against 112.8; at FullSubNet's sub-band fold
# 107.0 against 111.7, at its full-band fold 8.9 against 8.4, so its step
# as a whole is faster through K3 too. K4 also holds the dgates of every
# step (5.5 GB in float32 at the training fold), K3 a scratch of a few.
FUSED_WGRAD_BY_DTYPE = {torch.float32: True, torch.bfloat16: True}

# wrapper calls that launched their kernel, since import (or last reset), and
# the same by kernel and card ("lstm2_bwd cuda:1") and by the reverse sweep's
# form ("lstm2_bwd cluster16", "lstm2_bwd_wgrad wave"; each cleared apart)
LAUNCHES = {"lstm2_train_fwd": 0, "lstm2_bwd": 0, "lstm2_bwd_wgrad": 0}
LAUNCHES_BY_CARD: Counter = Counter()
SWEEP_FORMS: Counter = Counter()
# K3's launches by the tile of its weight-gradient kernel ("lstm2_bwd_wgrad
# 128x256x64xwgmmax2"; cleared apart)
WGRAD_TILES: Counter = Counter()

# The reverse sweep's form (csrc/lstm2_bwd_sweep.cuh): None the one
# `bwd_sweep_form` chooses, 0 the tile form (`sweep_mma_kernel`: a CTA a
# tile of 16 rows over all the steps), SWEEP_WAVE the wave form (the same
# kernel: a CTA an item of a tile and WAVE_STEPS steps, a launch a wave of
# at most a CTA an SM), SWEEP_CLUSTER the cluster form
# (`sweep_cluster_kernel`: a cluster of 16 CTAs a tile, each owning 32
# hidden units). Set to time the forms; the launch takes the form it is
# given and none falls back.
SWEEP_FORM: int | None = None
SWEEP_WAVE = 1  # WAVE_FORM in the .cuh
# The cluster form's C in both dtypes (CLUSTER_SIZE in the .cuh): at
# FullSubNet's full-band fold on the H100, clusters of 8 (64 units a CTA)
# took longer in bf16 and do not fit a block in float32 (PERF.md).
SWEEP_CLUSTER = 16
CLUSTER_UNITS = 32  # hidden units a CTA of the cluster form owns (CL_UNITS)
CLUSTER_KPARTS = 8  # k-parts of each of its products (CL_KPARTS)
CLUSTER_MAX_O = 288  # its dy tile's widest row (CL_MAX_O)
CLUSTER_BAR_BYTES = 8 * 16  # an 8-byte mbarrier for each of 16 owners (CL_BAR_BYTES)
# The most rows the rule gives the cluster form: the largest fold at which
# it measured faster than the tile form in both dtypes on the H100 (its
# clusters run in waves of 7; in bf16 the tile form was faster at N 2112:
# PERF.md, `scripts/time_torch_fb_train.py --folds`).
CLUSTER_MAX_ROWS = 1536
# 1 makes the cluster form's rank 0 send its dgates only after its own
# products, to test that a CTA rewrites its block only once its copies have
# read it (K4 alone; the results stay bit for bit).
SWEEP_LATE_SENDS = 0

# The wave form: the steps of a work item (a tile's carries go through
# device memory between its items). 4 on the H100 at the training fold: the
# sweep 50.7 / 48.8 / 48.1 / 48.1 ms in float32 at 1 / 2 / 4 / 8 steps, 25.3
# / 23.3 / 22.5 / 22.4 in bf16 (PERF.md)
WAVE_STEPS = 4
# The SMs of the card the rule assumes where it is asked by shape alone (an
# H100 SXM); the wrappers pass the card's own count
SM_COUNT = 132

MMA_ROWS_PER_CTA = 16  # the reverse sweep's row tile: one m16 tile (MMA_ROWS in the .cuh)
MMA_PAD_BYTES = 16  # pad of a dgates row in the reverse sweep's shared memory (lstm2_bwd_sweep.cuh)
# The dgates scratch of the fused backward by x's dtype: the steps it holds
# (`wgrad_chunk_steps`) are swept, then summed into the weight gradients.
# bf16: 32 MiB, L2-sized (2 steps at the training fold N 2304, H 384). float32:
# 432 MiB, 16 steps there: float32 K3 took 126.9 ms at 1 step (195 sweep and
# weight-gradient launches), 117.9 at 2, 113.5 at 4, 109.0 at 8 and 107.6 at
# 16 on the H100 (PERF.md), the dgates past the L2 costing less than the
# launches they save; FullSubNet's full-band fold (N 18, H 512) fits whole.
WGRAD_SCRATCH_BYTES = {torch.float32: 432 << 20, torch.bfloat16: 32 << 20}
# The same where the sweep takes its wave form, which cuts each chunk's sweep
# into items of WAVE_STEPS steps: longer chunks make more items, which fill
# the waves better. 32 steps at the training fold in both dtypes: float32 K3
# 83.2 ms at 16 steps and 78.1 at 32, bf16 50.0 at 2, 34.2 at 16 and 31.6 at
# 32 on the H100 (PERF.md; scripts/time_torch_bwd_forms.py)
WAVE_SCRATCH_BYTES = {torch.float32: 864 << 20, torch.bfloat16: 432 << 20}
# The weight-gradient kernels' tiles (csrc/lstm2_bwd_wgrad.cu): rows of the
# gradient x gate columns. In bf16 (`HTile`) dU1, dW2 and dU2 take one of
# WGRAD_H_TILES; in float32 (`F32Tile`) one of WGRAD_F32_TILES, each with the
# contraction rows of a staged slice and how they are staged (cp.async 16
# bytes a thread, or bulk copies of whole rows by the Tensor Memory
# Accelerator); `wgrad_tiles` chooses. dW1 (D rows) takes WGRAD_W1_TILE
# (W1_ROWS x W1_COLS) in both on mma.sync. The entries named "wgmma" are the
# kernels on Hopper's warpgroup products (`wgrad_wgmma_kernel`,
# `wgrad_wgmma_tf32_kernel`, `WgmmaTile`): (rows, gate columns, contraction
# rows a slice, "wgmma", runs of each step's row slices); dW1 takes the same
# tile there.
WGRAD_H_TILES = ((64, 128), (128, 128), (128, 256, 64, "wgmma", 2))
WGRAD_F32_TILES = ((64, 128, 32, "cp.async"), (64, 128, 64, "cp.async"),
                   (128, 128, 32, "cp.async"), (128, 128, 64, "cp.async"),
                   (128, 128, 64, "bulk"), (64, 128, 64, "bulk"), (128, 128, 32, "wgmma", 1))
WGRAD_W1_TILE = (48, 64)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_PTR] * 15 + [_INT] * 9 + [_PTR]
_BWD_ARGTYPES = [_PTR] * 13 + [_INT] * 10 + [_PTR]
_WGRAD_ARGTYPES = [_PTR] * 24 + [_INT] * 10 + [_PTR]
# what `wgmma::encode_3d` (csrc/lstm2_wgmma.cuh) adds to the CUresult when a
# tensor map fails to encode
_ENCODE_FAILED = 1000


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


def lstm2_fc_train_split(x: torch.Tensor, params, devices) -> torch.Tensor:
    """`lstm2_fc_train` over the fold's rows split evenly across `devices`
    (the first is x's card), the outputs gathered in order on x's card.

    Each slice of x and each card's copy of the ten parameter tensors are
    differentiable copies made before any kernel is queued (`fold_split`),
    so the backward copies each card's dx and weight gradients back and
    autograd sums the weight gradients into `params`. In the backward the
    copies of dy to the other cards come before the first card's own
    sweep: they are the gather's backward, made later in the forward than
    any slice's function, and autograd runs the latest-made ready node of
    a card first. A card named twice runs two slices, each of whose
    gradients is added once. Where the rows do not divide over the cards
    the whole fold runs on x's card with `fold_split`'s warning."""
    parts = len(devices)
    if parts > 1 and x.shape[0] % parts == 0:
        weights = [tuple(p.to(dev, non_blocking=True) for p in params) for dev in devices]
    else:
        weights = [tuple(params)] * parts
    return fold_split(lambda part, w: lstm2_fc_train(part, *w), x, weights, devices)


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
    """csrc/lstm2_bwd_sweep.cuh: `sweep_mma_kernel`'s dgates in x's dtype
    [R][4H + pad] (MMA_PAD_BYTES of pad), then float32 the dh1 and dh2
    carries [R][H], the dy tile [R][O] and, in the k-split form of dx, a dx
    partial per warp [H / 32][R][ceil(D / 8) * 8]; in the form
    `bwd_dx_ksplit` takes, or in the one `ksplit` names."""
    if ksplit is None:
        ksplit = bwd_dx_ksplit(rows, d_in, hidden, out_dim, dtype)
    return _bwd_bytes(rows, d_in, hidden, out_dim, dtype, ksplit)


def _cluster_fc_ld(out_dim: int) -> int:
    """A row of the cluster form's W_fc slice and dy tile (`cl_fc_ld`): O
    rounded up to an odd number of 4-float words."""
    ld = -(-out_dim // 4) * 4
    return ld if (ld // 4) % 2 else ld + 4


def bwd_cluster_shared_memory_bytes(d_in: int, hidden: int, out_dim: int,
                                    dtype: torch.dtype = torch.float32) -> int:
    """csrc/lstm2_bwd_sweep.cuh, the cluster form (`cluster_shared_bytes`): a
    CTA owning U = 32 units holds an mbarrier an owner (128 bytes), the
    tile's dgates in x's dtype as H / U owners' blocks [16][4U + pad], then
    float32 W_fc's rows of its units [U][fc_ld] and the dy tile [16][fc_ld]
    (fc_ld: O rounded up to an odd number of 4-float words), the products'
    k-part partials [8][16][2U + 8] and dy W_fc^T [16][U]. D does not enter:
    dx's columns are spread over the cluster."""
    size = torch.tensor([], dtype=dtype).element_size()
    units, fc_ld = CLUSTER_UNITS, _cluster_fc_ld(out_dim)
    return (CLUSTER_BAR_BYTES
            + size * (hidden // units) * MMA_ROWS_PER_CTA * (4 * units + MMA_PAD_BYTES // size)
            + 4 * ((units + MMA_ROWS_PER_CTA) * fc_ld
                   + CLUSTER_KPARTS * MMA_ROWS_PER_CTA * (2 * units + 8)
                   + MMA_ROWS_PER_CTA * units))


def bwd_sweep_cluster(n: int, d_in: int, hidden: int, out_dim: int, dtype: torch.dtype) -> int:
    """Whether a fold of n rows takes the reverse sweep's cluster form, by
    its shape alone: SWEEP_CLUSTER (a cluster of 16 CTAs a row tile of 16,
    each owning 32 hidden units, the dgates exchanged through distributed
    shared memory; the clusters run in waves where the card holds fewer at
    once) where H = 16 x 32, D <= H, O <= CLUSTER_MAX_O, n <=
    CLUSTER_MAX_ROWS and a CTA's shared memory fits a block; else 0, and
    `bwd_sweep_form` chooses between the tile and wave forms, a CTA a row
    tile (the shipped folds, H 384). The launch takes the form it is given:
    one refused raises, none falls back. (csrc/lstm2_bwd_sweep.cuh's
    `cluster_runs` checks the shape again.)"""
    if dtype not in _DTYPE_CODES or hidden != SWEEP_CLUSTER * CLUSTER_UNITS:
        return 0
    if d_in > hidden or out_dim > CLUSTER_MAX_O or n > CLUSTER_MAX_ROWS:
        return 0
    if bwd_cluster_shared_memory_bytes(d_in, hidden, out_dim, dtype) > SMEM_LIMIT:
        return 0
    return SWEEP_CLUSTER


def bwd_sweep_form(n: int, d_in: int, hidden: int, out_dim: int, dtype: torch.dtype,
                   sm_count: int = SM_COUNT) -> int:
    """The reverse sweep's form for a fold of n rows, by its shape and the
    card's SMs alone: the cluster form where `bwd_sweep_cluster` takes it;
    else SWEEP_WAVE where the fold has more row tiles of 16 than the card
    has SMs (the tile form would leave most SMs idle for a second wave);
    else 0, the tile form."""
    cluster = bwd_sweep_cluster(n, d_in, hidden, out_dim, dtype)
    if cluster:
        return cluster
    return SWEEP_WAVE if -(-n // MMA_ROWS_PER_CTA) > sm_count else 0


def sweep_form_name(form: int) -> str:
    """A form as SWEEP_FORMS names it: "tile", "wave" or "cluster16"."""
    return {0: "tile", SWEEP_WAVE: "wave"}.get(form, f"cluster{form}")


def sweep_form(x: torch.Tensor, w: LSTM2Weights) -> int:
    """The form a reverse sweep of x takes: SWEEP_FORM when set, else
    `bwd_sweep_form`'s on x's card."""
    if SWEEP_FORM is not None:
        return SWEEP_FORM
    n, d, _ = x.shape
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    return bwd_sweep_form(n, d, w.u1.shape[0], w.fc_w.shape[1], x.dtype, sm_count)


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


def _call(name: str, argtypes: list, x: torch.Tensor, *args, form: int | None = None) -> None:
    """Launch `name` of csrc/<name>.cu on x's device and current stream,
    raise on a refused launch, and count the launch and its sweep's `form`
    (the forward's in ops/lstm2.py's FWD_SWEEP_FORMS, a reverse sweep's in
    SWEEP_FORMS)."""
    lib = nvcc.load(name, name, argtypes)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                                   for a in args), stream)
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"{name}: a TMA tensor map failed to encode (CUresult "
                           f"{err - _ENCODE_FAILED})")
    if err != 0:  # the reverse sweep's forms have the forward's numbers (SWEEP_WAVE 1)
        raise RuntimeError(f"{name} launch failed{form_label(form)}: CUDA error {err}")
    LAUNCHES[name] += 1
    LAUNCHES_BY_CARD[f"{name} {x.device}"] += 1
    if name == "lstm2_train_fwd":
        count_form(name, form)
    elif form is not None:
        SWEEP_FORMS[f"{name} {sweep_form_name(form)}"] += 1


def _launch_train_fwd(x: torch.Tensor, w: LSTM2Weights):
    n, d, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    _check("lstm2_train_fwd", x, w, functools.partial(fwd_shared_memory_bytes, dtype=x.dtype),
           lambda *_: 16)
    # K1's form and row tile at this N (`fwd_sweep_launch`), so y is K1's bit for bit
    form, rows = fwd_sweep_launch(x, w)
    packed = pack_fwd_mma(w)
    x_tnd = x.permute(2, 0, 1).contiguous()  # [T, N, D]: a step's rows are contiguous

    def empty(*shape):
        return torch.empty(*shape, dtype=x.dtype, device=x.device)

    out = empty(n, steps, out_dim)
    res = Residuals(*(empty(steps, n, 4 * hidden if f[0] == "g" else hidden)
                      for f in Residuals._fields))
    carry = fwd_carry(x, form, rows, hidden)  # the wave form's carries between a tile's parts
    _call("lstm2_train_fwd", _FWD_ARGTYPES, x, x_tnd, *packed, w.fc_b, out, *res, carry, n, steps,
          d, hidden, out_dim, rows, form, lstm2.FWD_WAVE_STEPS if carry is not None else 0,
          _DTYPE_CODES[x.dtype], form=form)
    return out, res


def _bwd_operands(name: str, dy: torch.Tensor, x: torch.Tensor, w: LSTM2Weights,
                  res: Residuals):
    """Checks, the row tile, the sweep's form (`sweep_form`), dy [N, T, O]
    in x's dtype, and the weights as the sweep reads them: the packed mma
    fragments of [W2; U2], U1 and W1 (`pack_mma_b` in bfloat16, `pack_tf32_b`
    in float32; once per call: 3.7 MB and 7.4 MB at H 384)."""
    rows = _check(name, x, w, functools.partial(bwd_shared_memory_bytes, dtype=x.dtype),
                  mma_rows_per_cta)
    form = sweep_form(x, w)
    n, _, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    _check_residuals(name, x, res, hidden)
    if tuple(dy.shape) != (n, steps, out_dim) or dy.device != x.device:
        raise ValueError(f"{name}: dy is {tuple(dy.shape)} on {dy.device}, expected "
                         f"{(n, steps, out_dim)} on {x.device}")
    dy = dy.to(x.dtype).contiguous()
    pack = pack_mma_b if x.dtype == torch.bfloat16 else pack_tf32_b
    return rows, form, dy, tuple(pack(m) for m in (w.w2, w.u1, w.w1))


def _launch_bwd(dy: torch.Tensor, x: torch.Tensor, w: LSTM2Weights, res: Residuals) -> SweepGrads:
    rows, form, dy, weights = _bwd_operands("lstm2_bwd", dy, x, w, res)
    n, d, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    dg1, dg2 = torch.empty_like(res.g1), torch.empty_like(res.g2)
    dx_tnd = torch.empty(steps, n, d, dtype=x.dtype, device=x.device)
    wave = form == SWEEP_WAVE
    # the wave form's carries between a tile's parts
    carry = (torch.empty(4, -(-n // rows) * rows, hidden, dtype=torch.float32, device=x.device)
             if wave else None)
    _call("lstm2_bwd", _BWD_ARGTYPES, x, dy, res.g1, res.c1, res.g2, res.c2, *weights,
          w.fc_w, dg1, dg2, dx_tnd, carry, n, steps, d, hidden, out_dim, rows, form,
          WAVE_STEPS if wave else 0, SWEEP_LATE_SENDS, _DTYPE_CODES[x.dtype], form=form)
    # the bias sums of this form come from the rounded dgates (weight_grads)
    return SweepGrads(dx_tnd.permute(1, 2, 0), dg1, dg2, None, None)


def wgrad_chunk_steps(n: int, hidden: int, steps: int, dtype: torch.dtype,
                      wave: bool = False) -> int:
    """Steps of dgates the fused backward keeps in its scratch at a time
    (WGRAD_SCRATCH_BYTES[dtype], or WAVE_SCRATCH_BYTES[dtype] where the
    sweep takes its wave form). The weight gradients are the same bits at
    any chunk; the bias sums are grouped by it (each sweep sums its steps
    before adding them to the tile's row)."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    budget = (WAVE_SCRATCH_BYTES if wave else WGRAD_SCRATCH_BYTES)[dtype]
    return max(1, min(steps, budget // (2 * n * 4 * hidden * itemsize)))


def wgrad_tiles(d_in: int, hidden: int, dtype: torch.dtype = torch.bfloat16, n: int = 2304):
    """(dW1's tile, the tile of dU1, dW2 and dU2) of the weight-gradient
    kernel in `dtype` on a fold of n rows: dW1's (rows, gate columns), the
    other as its WGRAD_H_TILES / WGRAD_F32_TILES entry;
    `wgrad_tile` and `wgrad_f32_tile` in csrc/lstm2_bwd_wgrad.cu mirror it.
    On mma.sync dW1's D rows are padded to m16 tiles of 48, not to a whole
    tile; on wgmma dW1 takes the same tile as the others.

    The wgmma kernels at every fold: on the H100 (the weight-gradient kernel
    alone, PERF.md) at the sub-band training folds (N 2304) bf16 128 x 256
    in two runs of row slices took 2.6-2.7 ms against 8.1 for the fastest
    mma.sync shape (64 x 128) (128 x 128 in one run took 3.2), float32 128
    x 128 with 32-row slices 17.7-17.9 against 28.0-28.3 for the fastest
    mma.sync tile (128 x 128, 64-row slices staged by bulk copies); at
    FullSubNet's full-band fold (N 18, where TMA fills a slice's missing rows
    with zeros without reading memory) 0.19 against 0.50 in bf16 and 0.50
    against 1.06 (128 x 128, 32-row cp.async slices) in float32."""
    tile = WGRAD_F32_TILES[6] if dtype == torch.float32 else WGRAD_H_TILES[2]
    return (tile[:2] if wgmma_tile(tile) else WGRAD_W1_TILE), tile


def wgmma_tile(tile: tuple) -> bool:
    """Whether a WGRAD_H_TILES / WGRAD_F32_TILES entry is a wgmma kernel's."""
    return len(tile) == 5 and tile[3] == "wgmma"


def wgrad_launch_tile(n: int, d_in: int, hidden: int, dtype: torch.dtype) -> tuple:
    """The WGRAD_H_TILES / WGRAD_F32_TILES entry that the next K3 launch in
    `dtype` at (n, D, H) takes for dU1, dW2 and dU2: forced
    (`force_wgrad_tile`) or the rule's (`lstm2_bwd_wgrad_tile`, which
    `wgrad_tiles` mirrors)."""
    lib = nvcc.load("lstm2_bwd_wgrad", "lstm2_bwd_wgrad", _WGRAD_ARGTYPES)
    fn = lib.lstm2_bwd_wgrad_tile
    fn.argtypes, fn.restype = [_INT] * 4, _INT
    shape = fn(n, d_in, hidden, _DTYPE_CODES[dtype])
    if shape < 0:
        raise ValueError(f"wgrad_launch_tile: no weight-gradient kernel in {dtype}")
    return (WGRAD_F32_TILES if dtype == torch.float32 else WGRAD_H_TILES)[shape]


def force_wgrad_tile(shape: int | None, dtype: torch.dtype = torch.bfloat16) -> int | None:
    """Make every later K3 launch in `dtype` take WGRAD_H_TILES[shape] (bf16)
    or WGRAD_F32_TILES[shape] (float32) for dU1, dW2 and dU2 (None: the rule
    again), to time the candidates on the card; returns the previous
    setting."""
    lib = nvcc.load("lstm2_bwd_wgrad", "lstm2_bwd_wgrad", _WGRAD_ARGTYPES)
    fn = lib.lstm2_bwd_wgrad_force_tile
    fn.argtypes, fn.restype = [_INT, _INT], _INT
    before = fn(-1 if shape is None else shape, _DTYPE_CODES[dtype])
    if before < -1:
        raise ValueError(f"force_wgrad_tile: no {dtype} tile shape {shape}")
    return None if before == -1 else before


def wgrad_x_cols(d_in: int, dtype: torch.dtype) -> int:
    """The columns of x as the weight-gradient kernels read it (`x_cols` in
    csrc/lstm2_bwd_wgrad.cu): D rounded up to whole 16-byte copies, 4 float32
    or 8 bf16 (34 -> 36 / 40, 257 -> 260 / 264); the pad columns are zero."""
    per_copy = 16 // torch.tensor([], dtype=dtype).element_size()
    return -(-d_in // per_copy) * per_copy


def _launch_bwd_wgrad(dy: torch.Tensor, x: torch.Tensor, w: LSTM2Weights,
                      res: Residuals) -> LSTM2Grads:
    rows, form, dy, weights = _bwd_operands("lstm2_bwd_wgrad", dy, x, w, res)
    n, d, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    tiles = -(-n // rows)
    chunk = wgrad_chunk_steps(n, hidden, steps, x.dtype, wave=form == SWEEP_WAVE)
    # [T, N, D] with zero columns up to whole 16-byte copies of each row
    x_tnd = x.new_zeros(steps, n, wgrad_x_cols(d, x.dtype))
    x_tnd[:, :, :d] = x.permute(2, 0, 1)

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
    # the wgmma kernels' runs past the first sum into partials of their own
    tile = wgrad_launch_tile(n, d, hidden, x.dtype)
    parts = tile[4] - 1 if wgmma_tile(tile) else 0
    wgrad_part = f32(parts, (d + 3 * hidden) * 4 * hidden) if parts else None
    _call("lstm2_bwd_wgrad", _WGRAD_ARGTYPES, x, dy, x_tnd, res.g1, res.c1, res.h1, res.g2,
          res.c2, res.h2, *weights, w.fc_w, dx_tnd, dw1, du1, dw2, du2, db1, db2,
          scratch_dg1, scratch_dg2, carry, db_part, wgrad_part, n, steps, d, hidden, out_dim,
          rows, form, chunk, WAVE_STEPS if form == SWEEP_WAVE else 0, _DTYPE_CODES[x.dtype],
          form=form)
    WGRAD_TILES[f"lstm2_bwd_wgrad {'x'.join(map(str, tile))}"] += 1
    return LSTM2Grads(dx_tnd.permute(1, 2, 0), dw1, du1, dw2, du2, db1, db2)

