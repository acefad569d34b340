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
// rows, D = 34, H = 384, O = 2, T = 629: 2*N*T*(D + 3H)*4H + 2*N*T*H*O
// = 4.7 TFLOP against about 0.19 GB of inputs, weights and outputs, so the
// work is bound by operations (float32: 28.6 ms as three TF32 products at the
// tensor cores' 494.7 TFLOP/s, 70.4 ms as FMAs at 67; bf16: 4.8 ms), and by
// latency: the T steps are sequential and each step's products depend on the
// last step's h. In practice each SM's pull of the weights from L2 every step
// (7.5 MB float32, 3.7 MB bf16) sets a step's time.
//
// Design: the tensor-core sweep of lstm2_fwd_sweep.cuh, which the training
// forward (lstm2_train_fwd.cu) shares, storing y only. Every product runs on
// mma.sync from weights packed into fragment order once per call: bf16
// m16n8k16, float32 m16n8k8 as three TF32 products of split operands. In
// the tile form one CTA per row tile runs all T steps, R = 16 or 32 rows in
// bf16 (one or two m16 tiles sharing each weight fragment loaded from L2),
// 16 in float32; where the fold has more row tiles than the card holds at
// once, the wave form runs the same kernel over items of a tile and a few
// steps, a launch a wave, the h and c carries between a tile's items in
// device memory. In bf16 at the sub-band folds the pair form takes the R 32
// tile over a cluster of two CTAs, each owning half the units and pulling
// half the weights a step, h exchanged through distributed shared memory,
// in one launch or in waves. At FullSubNet's full-band fold (N 8, D 257, H 512, O 257:
// one CTA on one SM pulling 15.4 MB of float32 fragments a step) the cluster
// form runs instead: a cluster of 16 CTAs a tile of 16 rows, each owning 32
// units, h1 and h2 all-gathered each step by TMA bulk copies into the
// peers' shared memory. The wrapper chooses the form and R.
//
// Launch: the tile form grid ceil(N / R) (the wave form launches of at most
// that many), block H threads, dynamic shared memory as in
// fwd_mma_shared_memory_bytes() of ops/lstm2.py; the pair form grid 2
// ceil(N / 32) (in waves: launches of at most that many) in clusters of 2,
// block H threads, as in fwd_pair_shared_memory_bytes(); the cluster
// form grid 16 ceil(N / 16) in clusters of 16, block 512 threads, as in
// fwd_cluster_shared_memory_bytes(). The C entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include "lstm2_fwd_sweep.cuh"

// dtype: 0 = float32 (rows 16), 1 = bfloat16 (rows 16 or 32): the type of x
// and out. The weights come as the packed fragments w1p, w2p, fcp and the
// gate-interleaved biases b1p, b2p (ops/lstm2.py::pack_fwd_mma), fcb as b_fc.
// form: the sweep's form (0 the tile form, 1 the wave form, 2 the pair form
// in one launch and 3 in waves: clusters of 2, rows 32, bf16; 16 the
// cluster form: clusters of 16, rows 16). The forms in waves (1, 3) also
// take carry, a [ceil(N / rows)][carry_bytes] scratch for the carries
// between a tile's parts (fwd_carry_bytes in ops/lstm2.py), and part_steps,
// the steps of a part (the other forms: null and 0).
extern "C" int lstm2_fwd(const void* x, const void* w1p, const void* w2p, const void* fcp,
                         const void* b1p, const void* b2p, const void* fcb, void* out,
                         void* carry, int n_rows, int steps, int D, int H, int O, int rows,
                         int form, int part_steps, int dtype, void* stream) {
  if (!fwd::valid_shape(n_rows, steps, D, H, O)) return (int)cudaErrorInvalidValue;
  return fwd::launch_dtype<false>(dtype, x, w1p, w2p, fcp, b1p, b2p, fcb, out, nullptr, carry,
                                  n_rows, steps, D, H, O, rows, form, part_steps,
                                  static_cast<cudaStream_t>(stream));
}

// The clusters of the pair form (bf16) the current card holds at once at D,
// H (cudaOccupancyMaxActiveClusters), into *clusters: what a wave of the
// pair form in waves holds, and what `fwd_sweep_pair` in ops/lstm2.py
// assumes (half the SMs). Returns a CUDA error, or 0.
extern "C" int lstm2_fwd_pair_clusters(int D, int H, int* clusters) {
  return fwd::pair_capacity<false>(D, H, clusters);
}
