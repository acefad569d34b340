// Fused 2-layer LSTM forward with the output Linear, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_kernel` launched by `stacked_lstm2`
// (fullsubnet_plus_tpu/ops/lstm_pallas.py:98, :210). Per step t and row n:
//   g1 = x_t W1 + h1 U1 + b1,  g2 = [h1 | h2] [W2; U2] + b2   (gates i,f,g,o)
//   c = f*c + i*g,  h = o*tanh(c),  y_t = h2 W_fc + b_fc
// h and c stay float32; h is rounded to the weight type before every product
// (the TPU kernel's h.astype(mm)); products accumulate in float32.
//
// What bounds it. The shipped sub-band fold at batch 8 x 10 s is N = 2056
// rows, D = 34, H = 384, O = 2, T = 628: 2*N*T*(D + 3H)*4H + 2*N*T*H*O
// = 4.7 TFLOP against about 0.19 GB of inputs, weights and outputs, so the
// work is bound by operations, and by latency: the T steps are sequential
// and each step's products depend on the last step's h.
//
// Design (a simple kernel that is right; wgmma, clusters and persistent
// CTAs are later work): the sweep of lstm2_fwd_sweep.cuh, which the training
// forward (lstm2_train_fwd.cu) shares, with one CTA per tile of R = 16 rows
// for all T steps and one thread per hidden unit, storing y only.
//
// Launch: grid ceil(N / R), block H threads, dynamic shared memory as in
// shared_memory_bytes() of ops/lstm2.py. The C entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include "lstm2_fwd_sweep.cuh"

namespace {

constexpr int R = 16;  // rows per CTA; ROWS_PER_CTA in ops/lstm2.py

template <typename T>
int launch(const void* x, const void* w1, const void* u1, const void* b1, const void* w2,
           const void* b2, const void* fcw, const void* fcb, void* out, int n_rows, int steps,
           int D, int H, int O, cudaStream_t stream) {
  return fwd::launch<T, R, false>(x, w1, u1, b1, w2, b2, fcw, fcb, out, fwd::Residuals<T>{},
                                  n_rows, steps, D, H, O, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W1, U1, [W2; U2] and out).
extern "C" int lstm2_fwd(const void* x, const void* w1, const void* u1, const void* b1,
                         const void* w2, const void* b2, const void* fcw, const void* fcb,
                         void* out, int n_rows, int steps, int D, int H, int O, int dtype,
                         void* stream) {
  if (!fwd::valid_shape(n_rows, steps, D, H, O)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w1, u1, b1, w2, b2, fcw, fcb, out, n_rows, steps, D, H, O, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w1, u1, b1, w2, b2, fcw, fcb, out, n_rows, steps, D, H,
                                 O, s);
  return (int)cudaErrorInvalidValue;
}
