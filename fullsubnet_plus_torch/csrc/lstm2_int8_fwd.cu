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
// Design: K1's tensor-core sweep (lstm2_fwd_sweep.cuh) on int8 operands.
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
// Launch: grid ceil(N / R), block H threads, dynamic shared memory as in
// shared_memory_bytes() of ops/lstm2_int8.py. The C entry point launches on
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include "lstm2_common.cuh"

namespace {

using lstm2::ldmatrix_x4;
using lstm2::mma_bf16;
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

}  // namespace

// rows: the row tile, 16 (any H) or 32 (H <= 384). The weights come as
// pack_int8_mma's fragments (u1p, w1p, w2p, fcp) and gate-interleaved
// scales and biases (s1, b1, s2, b2); fcb is b_fc. A refused launch returns
// its error.
extern "C" int lstm2_int8_fwd(const void* x, const void* u1p, const void* w1p, const void* w2p,
                              const void* fcp, const void* s1, const void* b1, const void* s2,
                              const void* b2, const void* fcb, void* out, int n_rows, int steps,
                              int D, int H, int O, int rows, void* stream) {
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
  if (rows == 16)
    return H <= 384 ? launch_tile<1, 384>(x, wt, out, n_rows, steps, D, H, O, st)
                    : launch_tile<1, 512>(x, wt, out, n_rows, steps, D, H, O, st);
  if (rows == 32 && H <= 384) return launch_tile<2, 384>(x, wt, out, n_rows, steps, D, H, O, st);
  return (int)cudaErrorInvalidValue;
}
