// Reverse-sweep backward of the fused 2-layer LSTM that keeps the dgates,
// for Hopper (sm_90a): the training step's default backward in float32.
//
// Replaces the TPU kernel `_make_bwd_kernel` launched by `_train_bwd` with
// FUSED_WGRAD = False (fullsubnet_plus_tpu/ops/lstm_pallas.py:415, :695,
// pallas_call at :828). One launch sweeps t = T-1 .. 0 for every row tile
// and writes dgates1, dgates2 [T, N, 4H] and dx [T, N, D] in x's type; the
// weight gradients are whole-sequence matrix products outside the kernel
// (`weight_grads` in ops/lstm2_train.py), as in the JAX package.
//
// What bounds it on the H100. At the training fold (N = 2304, D = 34,
// H = 384, O = 2, T = 195) the sweep does 1.64 TFLOP (the transposed
// products contract over all 4H gate columns) and moves the residuals in
// (10H elements per row and step: g and c of both layers; c_{t-1} is the
// same array read again) and both dgates and dx out (8H + D): 12.5 GB in
// float32, 6.3 GB in bf16. In float32 the operations bound it: 9.9 ms as
// three TF32 products a product at 494.7 TFLOP/s (24.4 ms as FMAs at 67
// TFLOP/s) against 3.7 ms of bytes; in bf16 the bytes do (1.9 ms against
// 1.7 ms at the tensor cores' rate).
//
// Design: the sweep of lstm2_bwd_sweep.cuh (one CTA per row tile of 16 for
// all T, the tile's dgates in shared memory; where the fold has more tiles
// than the card has SMs, as at the training fold, its wave form: the same
// kernel over items of a tile and a few steps, a launch a wave of a CTA an
// SM, the carries between a tile's items in `carry`; at folds of a few
// tiles, such as FullSubNet's full-band N 18, its cluster form: a cluster of
// 16 CTAs per tile), run over all steps with the carries starting from zero.
// Its products
// run on the tensor cores (mma.sync, the weights packed into fragment order
// by the wrapper; float32 as three TF32 products of split operands), and
// each CTA's step latency bounds it: the product loops' L2 round trips for
// the weight fragments and the cell backward's loads (the header's note).
// The bf16 sweep has 114 HMMA instructions in each of its two functions, the
// float32 one 342 HMMA.1688.F32.TF32 (cuobjdump -sass of the built library;
// chip_smoke.py phase 1).
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include "lstm2_bwd_sweep.cuh"

namespace {

template <typename T>
int run(const void* dy, const void* g1, const void* c1, const void* g2, const void* c2,
        const void* w2p, const void* u1p, const void* w1p, const void* fcw, void* dg1,
        void* dg2, void* dx, void* carry, int n_rows, int steps, int D, int H, int O, int rows,
        int form, int part_steps, int late_sends, cudaStream_t stream) {
  bwd::SweepArgs<T> a;
  a.dy = static_cast<const T*>(dy);
  a.g1 = static_cast<const T*>(g1);
  a.c1 = static_cast<const T*>(c1);
  a.g2 = static_cast<const T*>(g2);
  a.c2 = static_cast<const T*>(c2);
  a.w2p = static_cast<const uint4*>(w2p);
  a.u1p = static_cast<const uint4*>(u1p);
  a.w1p = static_cast<const uint4*>(w1p);
  a.fcw = static_cast<const float*>(fcw);
  a.dg1 = static_cast<T*>(dg1);
  a.dg2 = static_cast<T*>(dg2);
  a.dx = static_cast<T*>(dx);
  a.carry = static_cast<float*>(carry);
  a.db_part = nullptr;
  a.n_rows = n_rows;
  a.steps = steps;
  a.D = D;
  a.H = H;
  a.O = O;
  a.t_hi = steps - 1;
  a.t_lo = 0;
  a.t_base = 0;
  a.resume = 0;
  a.late_sends = late_sends;
  return bwd::launch_sweep<T>(a, rows, form, part_steps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (dy, the residuals, the weights, dgates
// and dx; fcw is float32). w2p, u1p, w1p: [W2; U2], U1 and W1 packed into
// mma fragments (ops/lstm2.py: pack_tf32_b for float32, pack_mma_b for
// bfloat16); rows is 16. form: the sweep's form (0 the tile form, 1 the wave
// form, 16 the cluster form: clusters of 16). The wave form also takes carry,
// a float32 [4][ceil(N / rows) * rows][H] scratch for the carries between a
// tile's parts, and part_steps, the steps of a part (the other forms: null
// and 0). late_sends: 1 for the cluster form's rank 0 to send its dgates
// after its own products (a test of the exchange), else 0.
extern "C" int lstm2_bwd(const void* dy, const void* g1, const void* c1, const void* g2,
                         const void* c2, const void* w2p, const void* u1p, const void* w1p,
                         const void* fcw, void* dg1, void* dg2, void* dx, void* carry,
                         int n_rows, int steps, int D, int H, int O, int rows, int form,
                         int part_steps, int late_sends, int dtype, void* stream) {
  if (!bwd::valid_shape(n_rows, steps, D, H, O)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(dy, g1, c1, g2, c2, w2p, u1p, w1p, fcw, dg1, dg2, dx, carry, n_rows,
                      steps, D, H, O, rows, form, part_steps, late_sends, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(dy, g1, c1, g2, c2, w2p, u1p, w1p, fcw, dg1, dg2, dx, carry,
                              n_rows, steps, D, H, O, rows, form, part_steps, late_sends, s);
  return (int)cudaErrorInvalidValue;
}
