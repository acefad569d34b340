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
// 1.2 ms of bytes). This kernel's products are float32 FMAs in both types,
// so it stays far above either bound.
//
// Design (a simple kernel that is right): the sweep of lstm2_fwd_sweep.cuh
// with its residual stores compiled in. One CTA per tile of R rows sweeps
// all T steps; thread j of the H threads owns hidden unit j of both layers,
// so every residual store of a row is H contiguous elements across the
// block. The residuals are laid out [T, N, .] so the backward, which walks
// the steps in reverse, reads a step's row tile as contiguous rows. Weights
// stay in global memory (L2). R is 16 or 20: the caller picks the tile that
// covers the fold in the fewest waves of one CTA per SM.
//
// Launch: grid ceil(N / R), block H threads, dynamic shared memory as in
// fwd_shared_memory_bytes() of ops/lstm2_train.py. The C entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "lstm2_fwd_sweep.cuh"

namespace {

template <typename T>
int launch(const void* x, const void* w1, const void* u1, const void* b1, const void* w2,
           const void* b2, const void* fcw, const void* fcb, void* out, void* const* saved,
           int n_rows, int steps, int D, int H, int O, int rows, cudaStream_t stream) {
  const fwd::Residuals<T> res{static_cast<T*>(saved[0]), static_cast<T*>(saved[1]),
                              static_cast<T*>(saved[2]), static_cast<T*>(saved[3]),
                              static_cast<T*>(saved[4]), static_cast<T*>(saved[5])};
  if (rows == 16)
    return fwd::launch<T, 16, true>(x, w1, u1, b1, w2, b2, fcw, fcb, out, res, n_rows, steps,
                                    D, H, O, stream);
  if (rows == 20 && H <= 384)
    return fwd::launch<T, 20, true>(x, w1, u1, b1, w2, b2, fcw, fcb, out, res, n_rows, steps,
                                    D, H, O, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W1, U1, [W2; U2], out and the six
// residuals). rows: the row tile R, 16 or 20.
extern "C" int lstm2_train_fwd(const void* x, const void* w1, const void* u1, const void* b1,
                               const void* w2, const void* b2, const void* fcw,
                               const void* fcb, void* out, void* g1, void* c1, void* h1,
                               void* g2, void* c2, void* h2, int n_rows, int steps, int D,
                               int H, int O, int rows, int dtype, void* stream) {
  if (!fwd::valid_shape(n_rows, steps, D, H, O) || steps == 0)
    return (int)cudaErrorInvalidValue;
  void* const saved[6] = {g1, c1, h1, g2, c2, h2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w1, u1, b1, w2, b2, fcw, fcb, out, saved, n_rows, steps, D, H, O,
                         rows, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w1, u1, b1, w2, b2, fcw, fcb, out, saved, n_rows, steps,
                                 D, H, O, rows, s);
  return (int)cudaErrorInvalidValue;
}
