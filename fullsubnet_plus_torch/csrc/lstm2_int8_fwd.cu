// int8-recurrent 2-layer LSTM forward with the output Linear, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_quant_kernel` launched by
// `stacked_lstm2_quantized` (fullsubnet_plus_tpu/ops/lstm_pallas.py:1022,
// :1084), the serving default. Per step t and row n (gates i, f, g, o):
//   g1 = (x_t W1)_f32 + (h1q U1q)_i32 * s1 + b1    x, W1 bf16; h1q, U1q int8
//   g2 = ([h1q | h2q] [W2q; U2q])_i32 * s2 + b2    with this step's h1q
//   c = f*c + i*g, h = o*tanh(c) in float32;  hq = clip(rint(127 h), +-127)
//   y_t = bf16(h2) W_fc + b_fc, stored bf16 (h2 before quantization)
// The column scales s1, s2 already hold h's 1/127 (ops/lstm2_int8.py).
//
// What bounds it. At the serving fold (8 slots of 4 s chunks: N = 2056,
// D = 34, H = 384, O = 2, T = 255) the int8 products are 2*N*T*3H*4H = 1.86
// T operations and the bf16 ones 2*N*T*(D*4H + H*O) = 0.056 TFLOP, against
// about 38 MB of inputs, weights and outputs: bound by operations (about
// 0.99 ms at the tensor cores' int8 and bf16 peaks) and by latency: the T
// steps are sequential and each depends on the last h. In practice each
// SM's pull of the weight fragments from L2 every step sets a step's time:
// 1.97 MB at H 384 (U1q 0.59 and [W2q; U2q] 1.18 int8, W1 0.20 bf16).
//
// Two forms, chosen by the fold's shape (`int8_sweep_cluster` in
// ops/lstm2_int8.py), as the forward sweep's (lstm2_fwd_sweep.cuh):
//   * the tile form, `int8_sweep_kernel` (below): one CTA per tile of R
//     rows sweeps all T steps; every CTA pulls every weight fragment from
//     L2 each step (the shipped folds, H 384);
//   * the cluster form, `int8_sweep_cluster_kernel` (after it): a cluster
//     of 16 CTAs per tile of 16 rows, each owning 32 hidden units and
//     pulling only its gate columns' weights, h1q and h2q all-gathered
//     each step through distributed shared memory (FullSubNet's
//     full-band folds of a few tiles, H 512).
//
// The tile form: K1's tensor-core sweep (lstm2_fwd_sweep.cuh) on int8 operands.
// One CTA per tile of R = 16 MT rows (16 or 32, chosen by the wrapper)
// sweeps all T steps; warp w of the H / 32 owns units 32w .. 32w + 31 in 4
// passes of one unit group of 8. Every product runs on mma.sync: the int8
// ones as m16n8k32 s8 x s8 -> s32 (exact integer sums), x W1 and the fc as
// bf16 m16n8k16 with float32 sums. The weights are packed once, when the
// model is prepared (ops/lstm2_int8.py::pack_int8_mma), into B-fragment lane
// order, 16 bytes a lane for a 64-byte chunk of an operand row (two k-steps
// of 32 s8 or of 16 bf16), with the gate columns interleaved: n-tiles 4u ..
// 4u + 3 hold gates i, f, g, o of units 8u .. 8u + 7, so a lane's
// accumulators hold all four gates of its (row, unit) pairs and the cell
// runs straight from them. The s8 A fragment of m16n8k32 has the byte layout
// of bf16's m16n8k16 one, so ldmatrix at the same addresses feeds both.
// Layer 1 runs two products a pass into two accumulator sets, int32 h1q U1q
// and float32 x W1, then gates = facc + float(iacc) * s1 + b1 in the plain
// version's order and roundings (no contraction into FMAs); float(iacc) is
// exact (|sum| <= 2H 127^2 < 2^24). Layer 2 is one s8 product over [h1q |
// h2q] against [W2q; U2q]. The fc is a bf16 product over bf16(h2) against
// W_fc^T (O padded to n-tiles of 8), warps owning n-tiles, so nothing in
// shared memory grows with O. c1 and c2 stay float32 in shared memory, each
// word private to its lane. Each output word has one writer and every sum a
// fixed order: no atomics, the same bits on every run.
//
// Shared memory: two operand buffers that alternate by step parity, each R
// int8 rows [h1q | h2q | 16-byte pad] and R bf16 rows [x (x_cols(D)) |
// bf16(h2) | 16-byte pad]; the pads make each pitch an odd multiple of 16
// bytes, so ldmatrix is free of bank conflicts. Then c1 and c2, R * H float32
// each: 103,424 bytes at D 34, H 384, R 16; 206,848 at R 32; 150,528 at D
// 257, H 512, R 16.
//
// Launch of the tile form: grid ceil(N / R), block H threads, dynamic shared
// memory as in shared_memory_bytes() of ops/lstm2_int8.py. The C entry
// point launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "lstm2_common.cuh"

namespace {

using lstm2::bulk_commit;
using lstm2::bulk_wait_read;
using lstm2::CHUNK_BYTES;
using lstm2::cluster_arrive;
using lstm2::cluster_ctarank;
using lstm2::cluster_idx;
using lstm2::cluster_nctarank;
using lstm2::cluster_wait;
using lstm2::copy_to_peer;
using lstm2::fence_proxy_async;
using lstm2::ldmatrix_x4;
using lstm2::mbar_arrive_expect;
using lstm2::mbar_init;
using lstm2::mbar_wait;
using lstm2::mma_bf16;
using lstm2::peer_address;
using lstm2::sigm;

constexpr int PASSES = 4;     // unit groups of 8 a warp owns: H / 32 warps x 4 x 8 = H
constexpr int PAD_BYTES = 16;  // PAD_BYTES in ops/lstm2_int8.py

// x's columns in a bf16 operand row, zero-padded to whole 64-byte chunks
__host__ __device__ inline int x_cols(int D) { return (D + 31) / 32 * 32; }
// bytes of an int8 operand row [h1q | h2q | pad] and of a bf16 one [x | h2 | pad]
__host__ __device__ inline int q_pitch(int H) { return 2 * H + PAD_BYTES; }
__host__ __device__ inline int x_pitch(int D, int H) { return 2 * (x_cols(D) + H) + PAD_BYTES; }
// two operand buffers of R int8 and R bf16 rows, then c1 and c2 (R * H float32 each)
__host__ __device__ inline size_t shared_bytes(int R, int D, int H) {
  return 2 * (size_t)R * (q_pitch(H) + x_pitch(D, H)) + 2 * sizeof(float) * (size_t)R * H;
}
// 64-byte chunks of a product over K int8 values; the packer pads K with zero
// weights, which meet whatever bytes follow in the row (h2q after h1q)
__host__ __device__ inline int s8_chunks(int K) { return (K + 63) / 64; }

// d += A (16 x 32, row) B (32 x 8, col): s8 products, int32 sums (exact).
// Lane (g, t) = (lane / 4, lane % 4) holds a = {A[g][4t..4t+3], A[g+8][4t..],
// A[g][16+4t..], A[g+8][16+4t..]}, b0 = B[4t..4t+3][g], b1 = B[16+4t..][g];
// d as mma_bf16's.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 64-byte chunk of an m-tile's operand rows as two ldmatrix x4 (lane l
// gives the address of row l % 16, byte 16 (l / 16) of the chunk): two
// k-steps of 32 s8 or of 16 bf16, the same bytes in either type.
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], uint32_t addr) {
  ldmatrix_x4(a[0], addr);
  ldmatrix_x4(a[1], addr + 32);
}

// The chunk's products with one n-tile's 16-byte B word: {b0, b1} of k-step
// 0, then of k-step 1 (pack_s8_b, pack_mma_b)
struct S8Mma {
  using Acc = int;
  static __device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[2][4],
                                             const uint4& b) {
    mma_s8(d, a[0], b.x, b.y);
    mma_s8(d, a[1], b.z, b.w);
  }
};
struct Bf16Mma {
  using Acc = float;
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[2][4],
                                             const uint4& b) {
    mma_bf16(d, a[0], b.x, b.y);
    mma_bf16(d, a[1], b.z, b.w);
  }
};

// acc[mt][i] += (A's m-tile mt) . (B's n-tile i) over all chunks, in k
// order, as K1's mma_pass: a_addr is this lane's ldmatrix address of m-tile
// 0, chunk 0 (m-tiles m_stride bytes apart); B this lane's word of n-tile 0,
// chunk 0 (n-tiles ns words apart). b holds chunk 0 on entry; each chunk's
// products run while the next one's words load, and the last chunk loads
// chunk 0 of B_next (n-tiles ns_next apart) into b for the next product.
template <typename P, int MT>
__device__ __forceinline__ void mma_pass(typename P::Acc (&acc)[MT][4][4], uint32_t a_addr,
                                         uint32_t m_stride, const uint4* __restrict__ B, size_t ns,
                                         int chunks, const uint4* __restrict__ B_next,
                                         size_t ns_next, uint4 (&b)[4]) {
#pragma unroll 2
  for (int kc = 0; kc < chunks; ++kc) {
    const bool last = kc + 1 == chunks;
    const uint4* nxt = last ? B_next : B + (size_t)(kc + 1) * 32;
    const size_t nst = last ? ns_next : ns;
    uint4 nb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) nb[i] = __ldg(nxt + i * nst);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[2][4];
      load_a(a, a_addr + mt * m_stride + kc * lstm2::CHUNK_BYTES);
#pragma unroll
      for (int i = 0; i < 4; ++i) P::mma(acc[mt][i], a, b[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = nb[i];
  }
}

__device__ __forceinline__ signed char quantize(float h) {  // round half to even
  return (signed char)min(127, max(-127, __float2int_rn(h * 127.0f)));
}

// The LSTM cell of one unit group, straight from the gate pre-activations:
// lane (g, q) holds in gates[mt][gate][e] row 16 mt + g + 8 (e / 2), unit
// unit0 + e % 2 (unit0 = 8u + 2q); its c words are lane-private, cs[(4 mt +
// e) * 32 + lane]. store(row, h0, h1) writes the pair of units.
template <int MT, typename Store>
__device__ __forceinline__ void cell(const float (&gates)[MT][4][4], float* __restrict__ cs,
                                     int lane, Store store) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float h[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int e = 2 * half + p;
        const float i = sigm(gates[mt][0][e]), f = sigm(gates[mt][1][e]);
        const float g = tanhf(gates[mt][2][e]), o = sigm(gates[mt][3][e]);
        float& cw = cs[(4 * mt + e) * 32 + lane];
        const float c = f * cw + i * g;
        cw = c;
        h[p] = o * tanhf(c);
      }
      store(16 * mt + (lane >> 2) + 8 * half, h[0], h[1]);
    }
}

// This lane's scale and bias pair of gate n-tile `gate` of unit group ug
__device__ __forceinline__ float2 pair(const float* __restrict__ v, int ug, int gate, int lane) {
  return __ldg(reinterpret_cast<const float2*>(v + 32 * ug + 8 * gate + 2 * (lane & 3)));
}

// y_t = bf16(h2_t) W_fc + b_fc for the tile's rows: warp w computes n-tiles
// w, w + warps, .. of the O columns over all H
template <int MT>
__device__ __forceinline__ void fc_mma(uint32_t a_addr, uint32_t m_stride,
                                       const uint4* __restrict__ fc, int chunks,
                                       const float* __restrict__ fcb,
                                       __nv_bfloat16* __restrict__ out, int n0, int t, int steps,
                                       int O, int rows_here, int warp, int warps, int lane) {
  for (int nt = warp; 8 * nt < O; nt += warps) {
    float acc[MT][4] = {};
    for (int kc = 0; kc < chunks; ++kc) {
      const uint4 bv = __ldg(fc + ((size_t)nt * chunks + kc) * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[2][4];
        load_a(a, a_addr + mt * m_stride + kc * lstm2::CHUNK_BYTES);
        Bf16Mma::mma(acc[mt], a, bv);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + (lane >> 2) + 8 * (e >> 1);
        const int o = 8 * nt + 2 * (lane & 3) + (e & 1);
        if (row < rows_here && o < O)
          out[((size_t)(n0 + row) * steps + t) * O + o] = __float2bfloat16_rn(acc[mt][e] + fcb[o]);
      }
  }
}

// The weights as packed by ops/lstm2_int8.py::pack_int8_mma: fragments
// [n-tile][chunk][lane] of 16 bytes, gate columns interleaved
struct Int8Weights {
  const uint4* u1;   // U1q^T, s8: [4H/8][s8_chunks(H)][32]
  const uint4* w1;   // (W1, zero rows up to x_cols(D))^T, bf16: [4H/8][x_cols(D)/32][32]
  const uint4* w2;   // [W2q; U2q]^T, s8: [4H/8][2H/64][32]
  const uint4* fc;   // W_fc^T, bf16, O zero-padded to n-tiles of 8: [ceil(O/8)][H/32][32]
  const float* s1;   // [4H] each, gate-interleaved
  const float* b1;
  const float* s2;
  const float* b2;
  const float* fcb;  // [O]
};

// The sweep for a tile of R = 16 MT rows. The two operand buffers alternate
// by step parity (bb = t & 1), as K1's:
//   layer 1 reads x_t and h1q_{t-1} from buffer bb and writes h1q_t into
//     buffer bb ^ 1; layer 2 reads [h1q_t | h2q_{t-1}] from buffer bb ^ 1,
//     writes h2q_t and bf16(h2_t) into buffer bb, and x_{t+1} is loaded into
//     buffer bb ^ 1;
//   the fc of step t - 1 reads bf16(h2_{t-1}) from buffer bb ^ 1 at the
//     start of step t.
// So no write lands on a word a warp may still read in the same phase, and a
// step needs two barriers.
template <int MT, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
int8_sweep_kernel(const __nv_bfloat16* __restrict__ x,  // [T, N, D]
                  const Int8Weights wt, __nv_bfloat16* __restrict__ out,  // [N, T, O]
                  int n_rows, int steps, int D, int H, int O) {
  constexpr int R = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xc = x_cols(D), qp = q_pitch(H), xp = x_pitch(D, H), xld = xp / 2;
  signed char* qrows = reinterpret_cast<signed char*>(smem);                       // [2][R][qp]
  __nv_bfloat16* xrows = reinterpret_cast<__nv_bfloat16*>(smem + 2 * R * qp);     // [2][R][xld]
  float* c1s = reinterpret_cast<float*>(smem + 2 * (size_t)R * (qp + xp));        // [R * H]
  float* c2s = c1s + (size_t)R * H;                                               // [R * H]

  const int j = threadIdx.x, warp = j >> 5, lane = j & 31, warps = H >> 5;
  const int n0 = blockIdx.x * R;
  const int rows_here = min(R, n_rows - n0);
  const int kq1 = s8_chunks(H), kq2 = s8_chunks(2 * H), kx = xc / 32, kf = H / 32;
  const size_t ns1 = (size_t)kq1 * 32, nsx = (size_t)kx * 32, ns2 = (size_t)kq2 * 32;
  const uint32_t qm = 16 * qp, xm = 16 * xp;  // bytes between m-tiles
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  uint32_t qa[2], xa[2];  // this lane's ldmatrix address in each buffer, column 0
#pragma unroll
  for (int bb = 0; bb < 2; ++bb) {
    qa[bb] = base + (bb * R + (lane & 15)) * qp + 16 * (lane >> 4);
    xa[bb] = base + 2 * R * qp + (bb * R + (lane & 15)) * xp + 16 * (lane >> 4);
  }
  // the warp's first n-tile (unit group 4 warp, gate i) of each product
  const uint4* u1w = wt.u1 + (size_t)4 * PASSES * warp * ns1 + lane;
  const uint4* w1w = wt.w1 + (size_t)4 * PASSES * warp * nsx + lane;
  const uint4* w2w = wt.w2 + (size_t)4 * PASSES * warp * ns2 + lane;
  const size_t cwarp = (size_t)warp * PASSES * MT * 4 * 32;  // the warp's c words

  auto load_x = [&](int t, __nv_bfloat16* dst) {  // rows past N stay zero
    const __nv_bfloat16* xt = x + ((size_t)t * n_rows + n0) * D;
    for (int idx = j; idx < rows_here * D; idx += blockDim.x) {
      const int r = idx / D;
      dst[(size_t)r * xld + idx - r * D] = xt[idx];
    }
  };

  {  // zero both buffers (pads, h, x's padding columns) and c
    uint32_t* words = reinterpret_cast<uint32_t*>(smem);
    const size_t n_words = shared_bytes(R, D, H) / 4;
    for (size_t i = j; i < n_words; i += blockDim.x) words[i] = 0u;
  }
  __syncthreads();
  if (steps > 0) load_x(0, xrows);
  __syncthreads();

  uint4 b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __ldg(u1w + i * ns1);
  for (int t = 0; t < steps; ++t) {
    const int bb = t & 1;
    signed char* q_cur = qrows + (size_t)bb * R * qp;
    signed char* q_nxt = qrows + (size_t)(bb ^ 1) * R * qp;
    __nv_bfloat16* x_cur = xrows + (size_t)bb * R * xld;
    __nv_bfloat16* x_nxt = xrows + (size_t)(bb ^ 1) * R * xld;
    if (t > 0)
      fc_mma<MT>(xa[bb ^ 1] + 2 * xc, xm, wt.fc + lane, kf, wt.fcb, out, n0, t - 1, steps, O,
                 rows_here, warp, warps, lane);

    // layer 1: (h1q_{t-1} U1q) s1 + x_t W1 + b1 -> h1q_t
#pragma unroll 1
    for (int pass = 0; pass < PASSES; ++pass) {
      const int ug = PASSES * warp + pass, unit0 = 8 * ug + 2 * (lane & 3);
      const bool last = pass + 1 == PASSES;
      int iacc[MT][4][4] = {};
      float gates[MT][4][4] = {};
      mma_pass<S8Mma, MT>(iacc, qa[bb], qm, u1w + 4 * pass * ns1, ns1, kq1,
                          w1w + 4 * pass * nsx, nsx, b);
      mma_pass<Bf16Mma, MT>(gates, xa[bb], xm, w1w + 4 * pass * nsx, nsx, kx,
                            last ? w2w : u1w + 4 * (pass + 1) * ns1, last ? ns2 : ns1, b);
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const float2 s = pair(wt.s1, ug, gate, lane), bias = pair(wt.b1, ug, gate, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float q = __fmul_rn((float)iacc[mt][gate][e], e & 1 ? s.y : s.x);
            const float xw = gates[mt][gate][e];
            gates[mt][gate][e] = __fadd_rn(__fadd_rn(xw, q), e & 1 ? bias.y : bias.x);
          }
      }
      cell<MT>(gates, c1s + cwarp + (size_t)pass * MT * 4 * 32, lane,
               [&](int row, float h0, float h1) {
                 *reinterpret_cast<char2*>(q_nxt + (size_t)row * qp + unit0) =
                     make_char2(quantize(h0), quantize(h1));
               });
    }
    __syncthreads();  // h1q_t is complete

    // layer 2: ([h1q_t | h2q_{t-1}] [W2q; U2q]) s2 + b2 -> h2q_t, bf16(h2_t)
#pragma unroll 1
    for (int pass = 0; pass < PASSES; ++pass) {
      const int ug = PASSES * warp + pass, unit0 = 8 * ug + 2 * (lane & 3);
      const bool last = pass + 1 == PASSES;
      int iacc[MT][4][4] = {};
      mma_pass<S8Mma, MT>(iacc, qa[bb ^ 1], qm, w2w + 4 * pass * ns2, ns2, kq2,
                          last ? u1w : w2w + 4 * (pass + 1) * ns2, last ? ns1 : ns2, b);
      float gates[MT][4][4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const float2 s = pair(wt.s2, ug, gate, lane), bias = pair(wt.b2, ug, gate, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            gates[mt][gate][e] = __fadd_rn(__fmul_rn((float)iacc[mt][gate][e], e & 1 ? s.y : s.x),
                                           e & 1 ? bias.y : bias.x);
      }
      cell<MT>(gates, c2s + cwarp + (size_t)pass * MT * 4 * 32, lane,
               [&](int row, float h0, float h1) {
                 *reinterpret_cast<char2*>(q_cur + (size_t)row * qp + H + unit0) =
                     make_char2(quantize(h0), quantize(h1));
                 *reinterpret_cast<__nv_bfloat162*>(x_cur + (size_t)row * xld + xc + unit0) =
                     __floats2bfloat162_rn(h0, h1);
               });
    }
    if (t + 1 < steps) load_x(t + 1, x_nxt);
    __syncthreads();  // h2q_t, bf16(h2_t) and x_{t+1} are complete
  }
  if (steps > 0)
    fc_mma<MT>(xa[(steps - 1) & 1] + 2 * xc, xm, wt.fc + lane, kf, wt.fcb, out, n0, steps - 1,
               steps, O, rows_here, warp, warps, lane);
}

template <int MT, int MAX_THREADS>
int launch_tile(const void* x, const Int8Weights& wt, void* out, int n_rows, int steps, int D,
                int H, int O, cudaStream_t stream) {
  constexpr int R = 16 * MT;
  const size_t smem = shared_bytes(R, D, H);
  const cudaError_t err = cudaFuncSetAttribute(int8_sweep_kernel<MT, MAX_THREADS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  int8_sweep_kernel<MT, MAX_THREADS><<<(n_rows + R - 1) / R, H, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), wt, static_cast<__nv_bfloat16*>(out), n_rows, steps,
      D, H, O);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The cluster form, `int8_sweep_cluster_kernel`: for folds of a few row tiles
// (FullSubNet's full-band LSTM: N 8 in a batch of 8 and in its daemon, D 257,
// H 512, O 257), where one CTA a tile leaves the card idle and every step
// waits on one SM pulling all the weight fragments from L2 (U1q 1.05 MB,
// [W2q; U2q] 2.10 MB, W1 1.18 MB, the fc 0.27 MB a tile and step). The
// design of the forward's cluster form (lstm2_fwd_sweep.cuh,
// `fwd::sweep_cluster_kernel`) with K5's operands: each tile of 16 rows gets
// a cluster of C = H / 32 CTAs (16 at H 512); CTA rank c owns the 32 hidden
// units [32c, 32c + 32) of both layers, unit groups 4c .. 4c + 3, and reads
// only their 16 gate-interleaved n-tiles of the packed u1, w1 and w2 (264 KB
// a step):
//   * the products on the tensor cores as in the tile form (s8 m16n8k32 with
//     int32 sums, bf16 m16n8k16 with float32 sums), the K of each split over
//     the CTA's warps: warp w runs k-part w % 4 of unit group w / 4 (its four
//     gate n-tiles). Layer 1's k-parts 0 and 1 split x_t W1's chunks (float32
//     partials), k-parts 2 and 3 h1q_{t-1} U1q's (int32 partials), so a warp
//     holds one accumulator set; layer 2's four split [h1q | h2q] [W2q; U2q]
//     (int32). Thread (warp r, lane u) runs the cell of row r, unit 32c + u:
//     xw = the float32 partials in k-part order, iacc = the int32 ones (exact
//     in any order), gates = (xw + float(iacc) s1) + b1 and float(iacc) s2 +
//     b2 in the plain version's order and roundings, c a register;
//   * the exchange: each product contracts over all H units of h1q or h2q,
//     so each CTA keeps the tile's whole h1q and h2q, owner-major: owner o's
//     h1 block is [16][h1q 32 | pad 16] bytes, its h2 block [16][h2q 32 |
//     bf16(h2) 64 | pad 16] (the fc reads h2 before quantization); both
//     pitches are odd multiples of 16 bytes, so ldmatrix is free of bank
//     conflicts. An s8 chunk of 64 bytes spans two owners: its k-step 0 (b.x,
//     b.y) reads owner 2j's block, its k-step 1 (b.z, b.w) owner 2j + 1's, so
//     a warp waits on two owners a chunk. After a cell a CTA writes its block,
//     then one thread copies it whole into every peer's copy with the Tensor
//     Memory Accelerator (cp.async.bulk shared::cta -> shared::cluster, 768
//     and 1,792 bytes), each copy completing its bytes on the peer's mbarrier
//     for that layer, step parity and owner;
//   * the overlap the recurrence leaves: layer 2 at step t reads [h1q_t |
//     h2q_{t-1}], so it runs its chunks over h2q_{t-1} (exchanged during
//     layer 1) first, with the fc of step t - 1 on the same owners' bf16(h2)
//     (CTA c owns the fc n-tiles c, c + C, .., the one of index i taken by the
//     warps of unit group i), and h1q_t's as each owner arrives; layer 1 at t
//     + 1 reads [x_{t+1} | h1q_t], not h2q_t, so h2's exchange runs under it;
//     x_{t+1} is loaded during step t;
//   * the blocks alternate by step parity, with one cluster barrier a step,
//     as in the forward's cluster form: a CTA arrives (release) once it has
//     read the blocks of step t - 1 (after layer 2 of step t) and waits on it
//     (acquire) before it sends h1q_{t+1}; it writes its own block again two
//     steps on, once its copies have read it (thread 0 waits for all but its
//     latest bulk group each step).
// Each output word has one writer and each sum a fixed order; no atomics,
// the same bits on every run. Shared memory at D 257, H 512, C 16: the
// mbarriers (512 bytes), the h1 blocks (24,576) and h2 blocks (57,344) of
// both parities, x [16][x_cols + 8] bf16 (9,472), the partials [4][4][16][40]
// words (40,960) and the fc's [4][4][16][8] (8,192): 141,056 bytes.

constexpr int CL_ROWS = 16;       // the row tile: one m16 tile
constexpr int CL_UNITS = 32;      // hidden units a CTA owns: a lane a unit in the cells
constexpr int CL_THREADS = 512;   // 16 warps: a warp a row in the cells
constexpr int CL_KPARTS = 4;      // k-parts of each product: warps = 4 unit groups x 4 k-parts
constexpr int CL_X_KPARTS = 2;    // layer 1's k-parts that run x W1; the rest run h1q U1q
constexpr int CL_FC_TILES = 4;    // fc n-tiles a CTA may own: one a unit group's warps
constexpr int CL_PART_LD = CL_UNITS + 8;  // a gate partial's row: half-warps' stores 8 banks apart
constexpr int CL_FC_LD = 8;       // a row of an fc partial
constexpr int CLUSTER_SIZE = 16;  // INT8_CLUSTER in ops/lstm2_int8.py: H = 16 x 32
constexpr int CL_Q_PITCH = 48;    // bytes of an h1 block's row: h1q (32) and PAD_BYTES
constexpr int CL_H2_PITCH = 112;  // of an h2 block's row: h2q (32), bf16(h2) (64), PAD_BYTES
constexpr int CL_H2_BF16 = 32;    // bf16(h2)'s byte offset in an h2 block's row

// bf16 elements of a row of the x tile
__host__ __device__ inline int cl_x_pitch(int D) { return x_cols(D) + PAD_BYTES / 2; }

// `int8_cluster_shared_memory_bytes` in ops/lstm2_int8.py: an 8-byte mbarrier
// a layer, step parity and owner; the h1 and h2 blocks [2 parities][C][16]
// [pitch]; the x tile [16][x pitch] bf16; 32-bit words the partials [KP][4
// gates][16][CL_PART_LD] (float32 or int32) and the fc's [CL_FC_TILES][KP][16]
// [CL_FC_LD] (float32)
__host__ __device__ inline size_t cluster_shared_bytes(int D, int H) {
  const int C = H / CL_UNITS;
  return 8 * 4 * (size_t)C + 2 * (size_t)C * CL_ROWS * (CL_Q_PITCH + CL_H2_PITCH) +
         2 * (size_t)CL_ROWS * cl_x_pitch(D) +
         4 * ((size_t)CL_KPARTS * 4 * CL_ROWS * CL_PART_LD +
              (size_t)CL_FC_TILES * CL_KPARTS * CL_ROWS * CL_FC_LD);
}

// Whether the cluster form runs at this shape: H = CLUSTER_SIZE x 32, D <= H
// (x_{t+1} staged at most 16 words a thread), at most CL_FC_TILES fc n-tiles
// a CTA, and a CTA's shared memory fits a block. The caller chooses the form
// (`int8_sweep_cluster` in ops/lstm2_int8.py); a launch of the cluster form
// where this is false returns an error.
inline bool cluster_runs(int D, int H, int O) {
  return H == CLUSTER_SIZE * CL_UNITS && D <= H && (O + 7) / 8 <= CL_FC_TILES * CLUSTER_SIZE &&
         cluster_shared_bytes(D, H) <= lstm2::SMEM_LIMIT;
}

// acc[g] += A . B[n-tile g] (P: S8Mma or Bf16Mma) for a warp's four gate
// n-tiles (ns words apart) over its chunks v = 0 .. n - 1 in order. Chunk v:
// B's k-chunk kc_of(v), A's two k-steps at the shared-memory addresses a_of(v)
// (.x, .y), wait(v) before A is read. With kFc, for v < fc_n also facc +=
// bf16(h2) . F over owners o and o + 1 (o = fc_owner(v)), each owner one bf16
// chunk, its A at fc_a(o) and its B F's chunk o. Each chunk's fragments load
// while the previous chunk's products run (the loop not unrolled: 5-7 %
// faster a step than unrolled twice on the H100, PERF.md). B, F: this lane's
// word of n-tile 0, chunk 0.
template <typename P, bool kFc, typename KcOf, typename AOf, typename FcOwner, typename FcA,
          typename Wait>
__device__ __forceinline__ void cl_products(typename P::Acc (&acc)[4][4], float (&facc)[4],
                                            const uint4* __restrict__ B, size_t ns,
                                            const uint4* __restrict__ F, int fc_n, int n,
                                            KcOf kc_of, AOf a_of, FcOwner fc_owner, FcA fc_a,
                                            Wait wait) {
  uint4 b[4], f[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
  {
    const size_t k = (size_t)kc_of(0) * 32;
#pragma unroll
    for (int g = 0; g < 4; ++g) b[g] = __ldg(B + k + g * ns);
    if (kFc && fc_n > 0) {
      const int o = fc_owner(0);
      f[0] = __ldg(F + (size_t)o * 32);
      f[1] = __ldg(F + (size_t)(o + 1) * 32);
    }
  }
#pragma unroll 1
  for (int v = 0; v < n; ++v) {
    const int vn = min(v + 1, n - 1);
    const size_t kn = (size_t)kc_of(vn) * 32;
    uint4 nb[4], nf[2] = {f[0], f[1]};
#pragma unroll
    for (int g = 0; g < 4; ++g) nb[g] = __ldg(B + kn + g * ns);
    if (kFc && vn < fc_n) {
      const int o = fc_owner(vn);
      nf[0] = __ldg(F + (size_t)o * 32);
      nf[1] = __ldg(F + (size_t)(o + 1) * 32);
    }
    wait(v);
    uint32_t a[2][4];
    const uint2 addr = a_of(v);
    ldmatrix_x4(a[0], addr.x);
    ldmatrix_x4(a[1], addr.y);
#pragma unroll
    for (int g = 0; g < 4; ++g) P::mma(acc[g], a, b[g]);
    if (kFc && v < fc_n) {
      const int o = fc_owner(v);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t fa[2][4];
        load_a(fa, fc_a(o + half));
        Bf16Mma::mma(facc, fa, f[half]);
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) b[g] = nb[g];
    f[0] = nf[0];
    f[1] = nf[1];
  }
}

// A warp's accumulators of one m16n8 tile, as 32-bit words, into a partial of
// row pitch ld: lane (g, q) holds rows g and g + 8, columns 2q and 2q + 1
__device__ __forceinline__ uint32_t word_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t word_of(int v) { return (uint32_t)v; }
template <typename A>
__device__ __forceinline__ void cl_store_tile(const A (&acc)[4], uint32_t* dst, int ld, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
    *reinterpret_cast<uint2*>(dst + ((lane >> 2) + 8 * half) * ld + 2 * (lane & 3)) =
        make_uint2(word_of(acc[2 * half]), word_of(acc[2 * half + 1]));
}

__global__ void __launch_bounds__(CL_THREADS, 1)
int8_sweep_cluster_kernel(const __nv_bfloat16* __restrict__ x,  // [T, N, D]
                          const Int8Weights wt, __nv_bfloat16* __restrict__ out,  // [N, T, O]
                          int n_rows, int steps, int D, int H, int O) {
  constexpr int R = CL_ROWS, KP = CL_KPARTS, KX = CL_X_KPARTS, PLD = CL_PART_LD;
  constexpr int XR = R * 512 / CL_THREADS;  // x words a thread stages: D <= H <= 512
  extern __shared__ __align__(16) unsigned char smem_cl[];
  const int C = (int)cluster_nctarank(), c = (int)cluster_ctarank(), tile = (int)cluster_idx();
  const int xc = x_cols(D), xp = cl_x_pitch(D);
  const uint32_t q_bytes = R * CL_Q_PITCH, h2_bytes = R * CL_H2_PITCH;  // an h1, an h2 block
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem_cl);
  unsigned char* qblk = smem_cl + 8 * 4 * C;                  // [2 parities][C][R][CL_Q_PITCH]
  unsigned char* h2blk = qblk + (size_t)2 * C * q_bytes;      // [2 parities][C][R][CL_H2_PITCH]
  // [R][xp]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(h2blk + (size_t)2 * C * h2_bytes);
  uint32_t* part = reinterpret_cast<uint32_t*>(xs + (size_t)R * xp);  // [KP][4][R][PLD]
  uint32_t* fcpart = part + KP * 4 * R * PLD;  // [CL_FC_TILES][KP][R][CL_FC_LD], float32

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kp = warp % KP, ug = warp / KP;  // products: k-part kp of unit group ug
  const int r = warp;                        // cells: row r, unit 32c + lane
  const int n0 = tile * R;
  const int rows_here = min(R, n_rows - n0);
  const int xch = xc / 32, hq = s8_chunks(H);  // bf16 chunks of x, s8 chunks of h (2 owners each)
  // layer 1: k-parts 0 .. KX - 1 split x's chunks, the others h1q's; chunks l1_0 .. + l1_n
  const bool xpart = kp < KX;
  const int l1_0 = xpart ? kp * xch / KX : (kp - KX) * hq / (KP - KX);
  const int l1_n = (xpart ? (kp + 1) * xch / KX : (kp - KX + 1) * hq / (KP - KX)) - l1_0;
  // layer 2 and the fc: this k-part's s8 chunks q0 .. q0 + nh - 1 of h1q and of h2q
  const int q0 = kp * hq / KP, nh = (kp + 1) * hq / KP - q0;
  const size_t ns1 = (size_t)hq * 32, nsx = (size_t)xch * 32, ns2 = (size_t)2 * hq * 32;
  const int nt0 = 4 * (4 * c + ug);  // the warp's first gate n-tile: unit group 4c + ug, gate i
  const uint4* u1w = wt.u1 + nt0 * ns1 + lane;
  const uint4* w1w = wt.w1 + nt0 * nsx + lane;
  const uint4* w2w = wt.w2 + nt0 * ns2 + lane;
  const int fnt = c + C * ug;  // this warp's fc n-tile, where it exists
  const bool has_fc = ug < CL_FC_TILES && 8 * fnt < O;
  const uint4* fcw = wt.fc + (size_t)(has_fc ? fnt : 0) * (H / 32) * 32 + lane;
  const uint32_t qbase = (uint32_t)__cvta_generic_to_shared(qblk);
  const uint32_t h2base = (uint32_t)__cvta_generic_to_shared(h2blk);
  const uint32_t lane_q = (uint32_t)((lane & 15) * CL_Q_PITCH + 16 * (lane >> 4));
  const uint32_t lane_h2 = (uint32_t)((lane & 15) * CL_H2_PITCH + 16 * (lane >> 4));
  const uint32_t xbase = (uint32_t)__cvta_generic_to_shared(xs) +
                         (uint32_t)((lane & 15) * xp * 2 + 16 * (lane >> 4));
  auto qb = [&](int parity, int o) { return qbase + (uint32_t)(parity * C + o) * q_bytes; };
  auto hb = [&](int parity, int o) { return h2base + (uint32_t)(parity * C + o) * h2_bytes; };
  auto bar = [&](int layer, int parity, int o) {
    return bars + 8u * (uint32_t)((2 * layer + parity) * C + o);
  };
  auto arm = [&](int layer, int parity) {  // thread 0: one block from each peer, next phase
    for (int o = 0; o < C; ++o)
      if (o != c) mbar_arrive_expect(bar(layer, parity, o), layer ? h2_bytes : q_bytes);
  };
  auto send = [&](int layer, int parity) {  // thread 0: this CTA's block to every peer
    const uint32_t src = layer ? hb(parity, c) : qb(parity, c), b = bar(layer, parity, c);
    for (int k = 1; k < C; ++k) {
      const uint32_t peer = (uint32_t)((c + k) % C);
      copy_to_peer(peer_address(src, peer), src, layer ? h2_bytes : q_bytes,
                   peer_address(b, peer));
    }
    bulk_commit();
  };
  auto store_acc = [&](const auto& acc) {  // into k-part kp's partial
#pragma unroll
    for (int g = 0; g < 4; ++g)
      cl_store_tile(acc[g], part + ((size_t)(kp * 4 + g) * R) * PLD + 8 * ug, PLD, lane);
  };
  auto store_fc = [&](const float (&facc)[4]) {
    cl_store_tile(facc, fcpart + ((size_t)(ug * KP + kp) * R) * CL_FC_LD, CL_FC_LD, lane);
  };
  auto fc_out = [&](int ts) {  // y_ts from the fc partials in k-part order: a thread a word
    const float* fp = reinterpret_cast<const float*>(fcpart);
    for (int idx = tid; idx < CL_FC_TILES * R * CL_FC_LD; idx += CL_THREADS) {
      const int i = idx / (R * CL_FC_LD), row = idx / CL_FC_LD % R, col = idx % CL_FC_LD;
      const int o = 8 * (c + C * i) + col;
      if (row < rows_here && o < O) {
        const float* pp = fp + ((size_t)i * KP * R + row) * CL_FC_LD + col;
        float s = pp[0];
#pragma unroll
        for (int k = 1; k < KP; ++k) s += pp[(size_t)k * R * CL_FC_LD];
        out[((size_t)(n0 + row) * steps + ts) * O + o] = __float2bfloat16_rn(s + wt.fcb[o]);
      }
    }
  };
  float scale[2][4], bias[2][4];  // of this thread's unit's gate columns (gate-interleaved)
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int col = 32 * (4 * c + (lane >> 3)) + 8 * g + (lane & 7);
    scale[0][g] = wt.s1[col];
    bias[0][g] = wt.b1[col];
    scale[1][g] = wt.s2[col];
    bias[1][g] = wt.b2[col];
  }
  auto pw = [&](int k, int g) { return part[((size_t)(k * 4 + g) * R + r) * PLD + lane]; };
  // the cell of (row r, unit 32c + lane) from the gate pre-activations -> h
  auto cell = [&](const float (&pre)[4], float& cw) {
    const float i = sigm(pre[0]), f = sigm(pre[1]), g = tanhf(pre[2]), o = sigm(pre[3]);
    cw = f * cw + i * g;
    return o * tanhf(cw);
  };
  const uint4* no_fc = nullptr;
  auto no_owner = [](int) { return 0; };
  auto no_addr = [](int) { return 0u; };

  {  // zero the blocks (h_{-1}, the pads), x (its pad columns and the rows past N) and the partials
    uint32_t* words = reinterpret_cast<uint32_t*>(qblk);
    const size_t n_words = (cluster_shared_bytes(D, H) - 8 * 4 * C) / 4;
    for (size_t i = tid; i < n_words; i += CL_THREADS) words[i] = 0u;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < 4 * C; ++i) mbar_init(bars + 8u * i, 1);
    arm(0, 0);  // h1q_0
    arm(0, 1);  // h1q_1
    arm(1, 0);  // h2_0 (h2_1's at the end of step 0)
  }
  if (steps > 0) {  // x_0
    const __nv_bfloat16* xt = x + (size_t)n0 * D;
    for (int idx = tid; idx < rows_here * D; idx += CL_THREADS) {
      const int rr = idx / D;
      xs[(size_t)rr * xp + idx - rr * D] = xt[idx];
    }
  }
  __syncthreads();
  cluster_arrive();  // pairs with step 0's wait: the peers' mbarriers are set

  float c1 = 0.0f, c2 = 0.0f;
  float nofacc[4] = {};
  for (int t = 0; t < steps; ++t) {
    const int p = t & 1, pq = p ^ 1;  // this step's blocks, the last step's
    if (xpart) {  // layer 1: x_t W1 over this k-part's x chunks, float32 sums
      float acc[4][4] = {};
      cl_products<Bf16Mma, false>(
          acc, nofacc, w1w, nsx, no_fc, 0, l1_n, [&](int v) { return l1_0 + v; },
          [&](int v) {
            const uint32_t a = xbase + (uint32_t)((l1_0 + v) * CHUNK_BYTES);
            return make_uint2(a, a + 32);
          },
          no_owner, no_addr, [](int) {});
      store_acc(acc);
    } else {  // layer 1: h1q_{t-1} U1q over this k-part's s8 chunks, int32 sums, all here
      int acc[4][4] = {};
      cl_products<S8Mma, false>(
          acc, nofacc, u1w, ns1, no_fc, 0, l1_n, [&](int v) { return l1_0 + v; },
          [&](int v) {
            const int j = l1_0 + v;
            return make_uint2(qb(pq, 2 * j) + lane_q, qb(pq, 2 * j + 1) + lane_q);
          },
          no_owner, no_addr, [](int) {});
      store_acc(acc);
    }
    __syncthreads();  // layer 1's partials are in
    __nv_bfloat16 xv[XR];  // x_{t+1}, staged through registers while the cell runs
    const bool more = t + 1 < steps;
    const __nv_bfloat16* xt = x + ((size_t)(t + 1) * n_rows + n0) * D;
    if (more) {
#pragma unroll
      for (int k = 0; k < XR; ++k) {
        const int idx = tid + k * CL_THREADS;
        if (idx < rows_here * D) xv[k] = xt[idx];
      }
      if (t + 2 < steps) {  // x_{t+2} into L2
        const char* nxt = reinterpret_cast<const char*>(xt + (size_t)n_rows * D);
        for (int off = tid * 128; off < rows_here * D * 2; off += CL_THREADS * 128)
          asm volatile("prefetch.L2 [%0];\n" ::"l"(nxt + off));
      }
    }
    {  // the cell of layer 1: gates = (xw + float(iacc) s1) + b1 -> h1q_t into this CTA's block
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float xw = __uint_as_float(pw(0, g));
#pragma unroll
        for (int k = 1; k < KX; ++k) xw = __fadd_rn(xw, __uint_as_float(pw(k, g)));
        int iacc = (int)pw(KX, g);
#pragma unroll
        for (int k = KX + 1; k < KP; ++k) iacc += (int)pw(k, g);
        pre[g] = __fadd_rn(__fadd_rn(xw, __fmul_rn((float)iacc, scale[0][g])), bias[0][g]);
      }
      const float h = cell(pre, c1);
      qblk[(size_t)(p * C + c) * q_bytes + r * CL_Q_PITCH + lane] = quantize(h);
    }
    if (more) {
#pragma unroll
      for (int k = 0; k < XR; ++k) {
        const int idx = tid + k * CL_THREADS;
        if (idx < rows_here * D) {
          const int rr = idx / D;
          xs[(size_t)rr * xp + idx - rr * D] = xv[k];
        }
      }
    }
    fence_proxy_async();  // this CTA's h1q_t block, to the copies
    __syncthreads();      // h1q_t's block and x_{t+1} are in; the partials are read
    cluster_wait();       // every peer has read the blocks of step t - 2 these copies overwrite
    if (tid == 0) send(0, p);
    {  // layer 2: [h1q_t | h2q_{t-1}] [W2q; U2q], h2q_{t-1}'s chunks (and the fc of step
       // t - 1 on the same owners' bf16(h2)) first, then h1q_t's as each owner arrives
      int acc[4][4] = {};
      float facc[4] = {};
      const bool fc_on = has_fc && t > 0;
      cl_products<S8Mma, true>(
          acc, facc, w2w, ns2, fcw, fc_on ? nh : 0, 2 * nh,
          [&](int v) { return v < nh ? hq + q0 + v : q0 + v - nh; },
          [&](int v) {
            const int j = q0 + (v < nh ? v : v - nh);
            return v < nh ? make_uint2(hb(pq, 2 * j) + lane_h2, hb(pq, 2 * j + 1) + lane_h2)
                          : make_uint2(qb(p, 2 * j) + lane_q, qb(p, 2 * j + 1) + lane_q);
          },
          [&](int v) { return 2 * (q0 + v); },
          [&](int o) { return hb(pq, o) + lane_h2 + CL_H2_BF16; },
          [&](int v) {
            const bool h2 = v < nh;
            const int j = q0 + (h2 ? v : v - nh);
#pragma unroll
            for (int o = 2 * j; o < 2 * j + 2; ++o) {
              if (o == c) continue;
              if (!h2)
                mbar_wait(bar(0, p, o), (uint32_t)(t >> 1) & 1u);
              else if (t > 0)
                mbar_wait(bar(1, pq, o), (uint32_t)((t - 1) >> 1) & 1u);
            }
          });
      store_acc(acc);
      if (fc_on) store_fc(facc);
    }
    __syncthreads();  // layer 2's partials are in; every warp has waited for its blocks
    if (tid == 0) {
      arm(0, p);   // h1q_{t+2}
      arm(1, pq);  // h2_{t+1}
    }
    cluster_arrive();  // this CTA has read h1q_{t-1} and h2_{t-1}
    {  // the cell of layer 2: gates = float(iacc) s2 + b2 -> h2q_t, bf16(h2_t) into its block
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        int iacc = (int)pw(0, g);
#pragma unroll
        for (int k = 1; k < KP; ++k) iacc += (int)pw(k, g);
        pre[g] = __fadd_rn(__fmul_rn((float)iacc, scale[1][g]), bias[1][g]);
      }
      const float h = cell(pre, c2);
      unsigned char* row = h2blk + (size_t)(p * C + c) * h2_bytes + r * CL_H2_PITCH;
      row[lane] = (unsigned char)quantize(h);
      reinterpret_cast<__nv_bfloat16*>(row + CL_H2_BF16)[lane] = __float2bfloat16_rn(h);
    }
    if (t > 0) fc_out(t - 1);
    fence_proxy_async();  // this CTA's h2_t block, to the copies
    __syncthreads();      // h2_t's block is in; the partials are read
    if (tid == 0) {
      send(1, p);
      bulk_wait_read<1>();  // the copies of h1q_t (and before) have read their blocks
    }
  }
  if (steps > 0) {  // the fc of the last step, once h2_{T-1} is in from every owner
    const int pl = (steps - 1) & 1;
    for (int o = 2 * q0; o < 2 * (q0 + nh); ++o)
      if (o != c) mbar_wait(bar(1, pl, o), (uint32_t)((steps - 1) >> 1) & 1u);
    if (has_fc) {
      float facc[4] = {};
      for (int o = 2 * q0; o < 2 * (q0 + nh); ++o) {
        const uint4 f = __ldg(fcw + (size_t)o * 32);
        uint32_t fa[2][4];
        load_a(fa, hb(pl, o) + lane_h2 + CL_H2_BF16);
        Bf16Mma::mma(facc, fa, f);
      }
      store_fc(facc);
    }
    __syncthreads();
    fc_out(steps - 1);
  }
  if (tid == 0) bulk_wait_read<0>();  // this CTA's copies have read its blocks
  cluster_wait();  // pairs with the last step's arrive
}

// Launch the cluster form: a cluster of CLUSTER_SIZE CTAs a row tile; the
// clusters share nothing, so a fold of more tiles than the card holds at
// once runs in waves. A shape `cluster_runs` refuses, or a launch the card
// refuses, returns its error.
int launch_cluster(const void* x, const Int8Weights& wt, void* out, int n_rows, int steps, int D,
                   int H, int O, cudaStream_t stream) {
  if (!cluster_runs(D, H, O)) return (int)cudaErrorInvalidValue;
  if (steps == 0) return (int)cudaSuccess;  // nothing to write
  const size_t smem = cluster_shared_bytes(D, H);
  cudaError_t err = cudaFuncSetAttribute(int8_sweep_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // 16 is past the portable 8
    err = cudaFuncSetAttribute(int8_sweep_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER_SIZE;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_rows + CL_ROWS - 1) / CL_ROWS * CLUSTER_SIZE);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_sweep_cluster_kernel, static_cast<const __nv_bfloat16*>(x),
                           wt, static_cast<__nv_bfloat16*>(out), n_rows, steps, D, H, O);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// form: 0 the tile form, with rows its row tile, 16 (any H) or 32 (H <= 384);
// CLUSTER_SIZE the cluster form (rows 16). The weights come as
// pack_int8_mma's fragments (u1p, w1p, w2p, fcp) and gate-interleaved scales
// and biases (s1, b1, s2, b2); fcb is b_fc. Any other form, a shape the
// cluster form does not run, or a refused launch returns an error.
extern "C" int lstm2_int8_fwd(const void* x, const void* u1p, const void* w1p, const void* w2p,
                              const void* fcp, const void* s1, const void* b1, const void* s2,
                              const void* b2, const void* fcb, void* out, int n_rows, int steps,
                              int D, int H, int O, int rows, int form, void* stream) {
  if (H % 32 != 0 || H > 512 || n_rows <= 0 || steps < 0 || D <= 0 || O <= 0)
    return (int)cudaErrorInvalidValue;
  const Int8Weights wt{static_cast<const uint4*>(u1p), static_cast<const uint4*>(w1p),
                       static_cast<const uint4*>(w2p), static_cast<const uint4*>(fcp),
                       static_cast<const float*>(s1),  static_cast<const float*>(b1),
                       static_cast<const float*>(s2),  static_cast<const float*>(b2),
                       static_cast<const float*>(fcb)};
  if (!wt.u1 || !wt.w1 || !wt.w2 || !wt.fc || !wt.s1 || !wt.b1 || !wt.s2 || !wt.b2 || !wt.fcb)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == CLUSTER_SIZE && rows == CL_ROWS)
    return launch_cluster(x, wt, out, n_rows, steps, D, H, O, st);
  if (form != 0) return (int)cudaErrorInvalidValue;
  if (rows == 16)
    return H <= 384 ? launch_tile<1, 384>(x, wt, out, n_rows, steps, D, H, O, st)
                    : launch_tile<1, 512>(x, wt, out, n_rows, steps, D, H, O, st);
  if (rows == 32 && H <= 384) return launch_tile<2, 384>(x, wt, out, n_rows, steps, D, H, O, st);
  return (int)cudaErrorInvalidValue;
}
