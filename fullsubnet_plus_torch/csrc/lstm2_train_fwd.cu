// Residual-saving forward of the fused 2-layer LSTM + output Linear, for
// Hopper (sm_90a): the forward half of the training step.
//
// Replaces the TPU kernel `_residual_kernel` launched by `_train_fwd`
// (fullsubnet_plus_tpu/ops/lstm_pallas.py:322, :615, pallas_call at :638).
// It is the sweep of lstm2_fwd.cu (same products, same sum order, so y is
// the same primal) that also stores, per step and row, what the backward
// reads: the ACTIVATED gates [sigma(i), sigma(f), tanh(g), sigma(o)] of both
// layers as g1, g2 [T, N, 4H] and c1, h1, c2, h2 [T, N, H], all in x's type
// (the carried h and c stay float32; the stored h is the one the products
// read, rounded in bf16).
//
// What bounds it on the H100. At the training fold (N = 2304 rows, D = 34,
// H = 384, O = 2, T = 195) it does 1.64 TFLOP and must write (12H + O)
// elements per row and step: 8.3 GB in float32, 4.1 GB in bf16. In float32
// the operations bound it (9.9 ms as three TF32 products at 494.7 TFLOP/s,
// 24.4 ms as FMAs, against 2.5 ms of bytes); in bf16 the two are close (1.7
// ms at the tensor cores' 989 TFLOP/s against 1.2 ms of bytes). As in K1,
// each SM's pull of the weights from L2 every step sets a step's time. At R
// 16 the fold's 144 tiles would take two waves of 132 SMs, the second of 12
// CTAs costing nearly as much as the first; the wave form runs them in full
// waves instead.
//
// Design: the tensor-core sweep of lstm2_fwd_sweep.cuh with its residual
// stores compiled in, in the form and row tile K1 takes at the same fold
// (so y is K1's bit for bit): in the tile form one CTA per tile of R rows
// sweeps all T steps (R 16 or 32 in bf16, 16 in float32) and a lane stores
// pairs of the (row, unit) pairs its accumulators hold; the wave form runs
// the same kernel over items of a tile and a few steps, in launches of a
// CTA an SM, the carries between a tile's items in device memory (c from
// the float32 words the sweep carries, never from the saved residual c,
// which is rounded in bf16); in the pair form (bf16 at the sub-band folds,
// in one launch or in waves) a cluster of two CTAs sweeps a tile of 32 rows
// and each CTA stores the residuals of its own half of the units; in the
// cluster form (FullSubNet's full-band fold, N 18, D 257, H 512, O 257) a
// cluster of 16 CTAs sweeps a tile of 16 rows and each thread stores the
// residuals of its own cell. The residuals are laid out [T, N, .] so the backward, which
// walks the steps in reverse, reads a step's row tile as contiguous rows.
// Weights stay in global memory (L2).
//
// Launch: grid ceil(N / R) (the wave form: launches of at most that many),
// block H threads, dynamic shared memory as in
// fwd_shared_memory_bytes() of ops/lstm2_train.py. The C entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "lstm2_fwd_sweep.cuh"

// dtype: 0 = float32 (rows 16), 1 = bfloat16 (rows 16 or 32): the type of x,
// out and the six residuals. The weights, the form, carry and part_steps
// come as in lstm2_fwd.
extern "C" int lstm2_train_fwd(const void* x, const void* w1p, const void* w2p, const void* fcp,
                               const void* b1p, const void* b2p, const void* fcb, void* out,
                               void* g1, void* c1, void* h1, void* g2, void* c2, void* h2,
                               void* carry, int n_rows, int steps, int D, int H, int O, int rows,
                               int form, int part_steps, int dtype, void* stream) {
  if (!fwd::valid_shape(n_rows, steps, D, H, O) || steps == 0)
    return (int)cudaErrorInvalidValue;
  void* const res[6] = {g1, c1, h1, g2, c2, h2};
  return fwd::launch_dtype<true>(dtype, x, w1p, w2p, fcp, b1p, b2p, fcb, out, res, carry, n_rows,
                                 steps, D, H, O, rows, form, part_steps,
                                 static_cast<cudaStream_t>(stream));
}
