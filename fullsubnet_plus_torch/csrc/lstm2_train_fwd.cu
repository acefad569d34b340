// Residual-saving forward of the fused 2-layer LSTM + output Linear, for
// Hopper (sm_90a): the forward half of the training step.
//
// Replaces the TPU kernel `_residual_kernel` launched by `_train_fwd`
// (fullsubnet_plus_tpu/ops/lstm_pallas.py:322, :615, pallas_call at :638).
// It is the sweep of lstm2_fwd.cu (same products, same sum order, so y is
// the same primal) that also stores, per step and row, what the backward
// reads: the ACTIVATED gates [sigma(i), sigma(f), tanh(g), sigma(o)] of both
// layers as g1, g2 [T, N, 4H] and c1, h1, c2, h2 [T, N, H], all in x's type
// (the carried h and c stay float32; the stored h is the rounded h that the
// products read).
//
// What bounds it on the H100. At the training fold (N = 2304 rows, D = 34,
// H = 384, O = 2, T = 195) it does 1.64 TFLOP and must write (12H + O)
// elements per row and step: 8.3 GB in float32, 4.1 GB in bf16. In float32
// the FMA rate bounds it (24.4 ms at 67 TFLOP/s against 2.5 ms of bytes); in
// bf16 the two are close (1.7 ms at the tensor cores' 989 TFLOP/s against
// 1.2 ms of bytes). The float32 products are FMAs, far above its bound; the
// bf16 products run on the tensor cores.
//
// Design: the sweeps of lstm2_fwd_sweep.cuh with their residual stores
// compiled in. One CTA per tile of R rows sweeps all T steps. float32
// (`sweep_kernel`): thread j of the H threads owns hidden unit j of both
// layers, so every residual store of a row is H contiguous elements across
// the block; R is 16 or 20, the tile that covers the fold in the fewest waves
// of one CTA per SM. bfloat16 (`sweep_mma_kernel`): mma.sync products, a
// lane stores bf16 pairs of the (row, unit) pairs its accumulators hold; R
// is 16 or 32, the tile K1 takes at the same N, so y is K1's bit for bit.
// The residuals are laid out [T, N, .] so the backward, which walks the
// steps in reverse, reads a step's row tile as contiguous rows. Weights stay
// in global memory (L2).
//
// Launch: grid ceil(N / R), block H threads, dynamic shared memory as in
// fwd_shared_memory_bytes() of ops/lstm2_train.py. The C entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "lstm2_fwd_sweep.cuh"

// dtype: 0 = float32 (x, W1, U1, [W2; U2], out and the six residuals; rows
// 16 or 20), 1 = bfloat16 (x, out and the residuals; the weights as the
// packed fragments w1p, w2p, fcp and the gate-interleaved biases b1p, b2p;
// rows 16 or 32). The other dtype's weight arguments are not read.
extern "C" int lstm2_train_fwd(const void* x, const void* w1, const void* u1, const void* b1,
                               const void* w2, const void* b2, const void* fcw,
                               const void* fcb, const void* w1p, const void* w2p,
                               const void* fcp, const void* b1p, const void* b2p, void* out,
                               void* g1, void* c1, void* h1, void* g2, void* c2, void* h2,
                               int n_rows, int steps, int D, int H, int O, int rows, int dtype,
                               void* stream) {
  if (!fwd::valid_shape(n_rows, steps, D, H, O) || steps == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const fwd::Residuals<float> res{static_cast<float*>(g1), static_cast<float*>(c1),
                                    static_cast<float*>(h1), static_cast<float*>(g2),
                                    static_cast<float*>(c2), static_cast<float*>(h2)};
    if (rows == 16)
      return fwd::launch<float, 16, true>(x, w1, u1, b1, w2, b2, fcw, fcb, out, res, n_rows,
                                          steps, D, H, O, s);
    if (rows == 20 && H <= 384)
      return fwd::launch<float, 20, true>(x, w1, u1, b1, w2, b2, fcw, fcb, out, res, n_rows,
                                          steps, D, H, O, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    const fwd::Residuals<T> res{static_cast<T*>(g1), static_cast<T*>(c1), static_cast<T*>(h1),
                                static_cast<T*>(g2), static_cast<T*>(c2), static_cast<T*>(h2)};
    const fwd::MmaWeights wt{static_cast<const uint4*>(w1p), static_cast<const uint4*>(w2p),
                             static_cast<const uint4*>(fcp), static_cast<const float*>(b1p),
                             static_cast<const float*>(b2p)};
    return fwd::launch_mma<true>(x, wt, fcb, out, res, n_rows, steps, D, H, O, rows, s);
  }
  return (int)cudaErrorInvalidValue;
}
