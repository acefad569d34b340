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
// Design: the sweeps of lstm2_fwd_sweep.cuh, which the training forward
// (lstm2_train_fwd.cu) shares, storing y only. One CTA per row tile runs all
// T steps. float32 (`sweep_kernel`): R = 16 rows, one thread per hidden
// unit, float32 FMA products from L2-resident weights. bfloat16
// (`sweep_mma_kernel`): every product on mma.sync bf16 -> f32 from weights
// packed into fragment order once per call, R = 16 or 32 rows (one or two m16
// tiles sharing each weight fragment loaded from L2), chosen by the wrapper.
//
// Launch: grid ceil(N / R), block H threads, dynamic shared memory as in
// shared_memory_bytes() of ops/lstm2.py. The C entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include "lstm2_fwd_sweep.cuh"

// dtype: 0 = float32 (x, W1, U1, [W2; U2] and out; rows 16), 1 = bfloat16
// (x and out; the weights as the packed fragments w1p, w2p, fcp and the
// gate-interleaved biases b1p, b2p; rows 16 or 32). The other dtype's weight
// arguments are not read.
extern "C" int lstm2_fwd(const void* x, const void* w1, const void* u1, const void* b1,
                         const void* w2, const void* b2, const void* fcw, const void* fcb,
                         const void* w1p, const void* w2p, const void* fcp, const void* b1p,
                         const void* b2p, void* out, int n_rows, int steps, int D, int H, int O,
                         int rows, int dtype, void* stream) {
  if (!fwd::valid_shape(n_rows, steps, D, H, O)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && rows == 16)
    return fwd::launch<float, 16, false>(x, w1, u1, b1, w2, b2, fcw, fcb, out,
                                         fwd::Residuals<float>{}, n_rows, steps, D, H, O, s);
  if (dtype == 1) {
    const fwd::MmaWeights wt{static_cast<const uint4*>(w1p), static_cast<const uint4*>(w2p),
                             static_cast<const uint4*>(fcp), static_cast<const float*>(b1p),
                             static_cast<const float*>(b2p)};
    return fwd::launch_mma<false>(x, wt, fcb, out, fwd::Residuals<__nv_bfloat16>{}, n_rows,
                                  steps, D, H, O, rows, s);
  }
  return (int)cudaErrorInvalidValue;
}
