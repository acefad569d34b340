// The forward sweep of the fused 2-layer LSTM + output Linear, shared by
// lstm2_fwd.cu (inference: y only) and lstm2_train_fwd.cu (training: y and
// the residuals the backward reads). Per step t and row n:
//   g1 = x_t W1 + h1 U1 + b1,  g2 = [h1 | h2] [W2; U2] + b2   (gates i,f,g,o)
//   c = f*c + i*g,  h = o*tanh(c),  y_t = h2 W_fc + b_fc
// h and c stay float32; h is rounded to the weight type T before every
// product (the TPU kernel's h.astype(mm); no rounding in float32); products
// accumulate in float32. Both kernels run the same products in the same
// order, so their y is equal bit for bit. One CTA per tile of R rows sweeps
// all T steps, so the recurrence never leaves the block. The weights (7.5 MB
// float32, 3.7 MB bf16 at D 34, H 384) do not fit in shared memory; they stay
// in global memory, served from the 50 MB L2.
//
// `sweep_mma_kernel<T, MT, ...>`: every product, the fc's too, runs on the
// tensor cores with float32 sums, with no FMA product left.
//   bf16: mma.sync m16n8k16 on bf16 operands (the TPU kernel's contract,
//     lstm_pallas.py:144-179); R 16 or 32 (one or two m16 tiles).
//   float32: mma.sync m16n8k8 on TF32 operands, each float32 product as
//     three TF32 products of split operands (lstm2_common.cuh, mma_3xtf32),
//     which hold the float32 agreement floors (one TF32 product does not);
//     R 16: two operand buffers of R 32 do not fit a block, and one buffer
//     with h held in registers until a third barrier measured slower (K1
//     147.0 against 90.3 ms on the H100, PERF.md).
// A: the tile's operand rows [x | h1 | h2] of type T in shared memory, read by
// ldmatrix (the same byte addresses give bf16's m16n8k16 fragment and
// float32's m16n8k8 one); layer 1 is one product over [x | h1] against [W1;
// U1] (x zero-padded from D 34 to 64 bf16 or 48 float32 columns), layer 2
// one over [h1 | h2] against [W2; U2]. In float32 each k-step of A is split
// once and serves the four gate n-tiles of a pass. B: the weights packed once per call by
// ops/lstm2.py::pack_fwd_mma into lane order (16 bytes a lane: two k-steps)
// with the gate columns interleaved (n-tiles 4u .. 4u + 3 = gates i, f, g, o
// of units 8u .. 8u + 7), so a lane's accumulators hold all four gates of its
// (row, unit) pairs and the cell runs straight from them: no [R][4H] gate
// array goes through shared memory. The float32 words are split into TF32
// halves in registers after the load, so the L2 traffic stays 4 bytes a
// weight. Warp w of the H / 32 owns units 32w .. 32w + 31, in 4 passes of one
// unit group; each weight fragment it loads from L2 feeds every m-tile of the
// CTA, so R 32 reads the weights half as often per row as R 16. The fc is a
// product over the h2 tile with W_fc^T packed to T and O padded to n-tiles of
// 8; warps own whole n-tiles, so no shared-memory partial grows with O.
// Shared memory at D 34, H 384: 2 R operand rows of 840 bf16 or 820 float32
// and 2 R x 384 float32 c words: 102,912 bytes (bf16) and 154,112 (float32)
// at R 16, 205,824 (bf16) at R 32; at FullSubNet's full-band shape (D 257,
// H 512) 150,016 (bf16) and 231,936 (float32) at R 16. Launch: grid ceil(N / R), block H threads,
// dynamic shared memory shared_bytes_mma<T>(R, D, H).

#pragma once

#include "lstm2_common.cuh"

namespace fwd {

using lstm2::AFrag;
using lstm2::CHUNK_BYTES;
using lstm2::from_f;
using lstm2::k_chunk;
using lstm2::sigm;

// Where the training forward stores what the backward reads, all in the
// weight type: activated gates g1, g2 [T, N, 4H]; c1, h1, c2, h2 [T, N, H].
template <typename T>
struct Residuals {
  T* g1;
  T* c1;
  T* h1;
  T* g2;
  T* c2;
  T* h2;
};

constexpr int MMA_PASSES = 4;  // unit groups of 8 a warp owns: H / 32 warps x 4 x 8 = H

// x's columns in an operand row, zero-padded to whole k-chunks of T (32 bf16,
// 16 float32: 64 bytes either way). At D 257, H 512 the float32 rows then
// take 272 x columns, not 288, and the float32 sweep fits a block at R 16.
template <typename T> __host__ __device__ inline int x_cols(int D) {
  return (D + k_chunk<T>() - 1) / k_chunk<T>() * k_chunk<T>();
}

// elements of an operand row [x | h1 | h2 | pad]; the 16-byte pad (FWD_MMA_PAD
// in ops/lstm2.py) makes the row pitch an odd multiple of 16 bytes, so
// ldmatrix is free of bank conflicts
template <typename T> __host__ __device__ inline int operand_pitch(int D, int H) {
  return x_cols<T>(D) + 2 * H + 16 / (int)sizeof(T);
}

// two operand buffers [R][pitch] of T, then c1 and c2 (R * H float32 each)
template <typename T> __host__ __device__ inline size_t shared_bytes_mma(int R, int D, int H) {
  return sizeof(T) * 2 * (size_t)R * operand_pitch<T>(D, H) + sizeof(float) * 2 * (size_t)R * H;
}

// The sweep's weights, packed once per call by ops/lstm2.py::pack_fwd_mma
// into mma.sync's B-fragment lane order ([n-tile][k-chunk][lane], 16 bytes a
// lane: pack_mma_b for bf16, pack_tf32_b for float32), with the 4H gate
// columns interleaved: n-tiles 4u .. 4u + 3 hold gates i, f, g, o of units
// 8u .. 8u + 7.
struct MmaWeights {
  // [W1 (zero rows up to x_cols<T>(D)); U1]: [4H/8][(x_cols<T>(D) + H)/k_chunk][32]
  const uint4* w1;
  const uint4* w2;  // [W2; U2]: [4H/8][2H/k_chunk][32]
  const uint4* fc;  // W_fc^T, O zero-padded to n-tiles of 8: [ceil(O/8)][H/k_chunk][32]
  const float* b1;  // [4H], gate-interleaved
  const float* b2;
};

// two values of adjacent columns as T (8 or 4 aligned bytes)
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// acc[mt][i] += (A's m-tile mt) . (B's n-tile i) over all k-chunks, in k
// order. a_addr: this lane's ldmatrix address of m-tile 0, k-chunk 0
// (m-tiles m_stride bytes apart); B: this lane's word of n-tile 0, k-chunk 0
// (n-tiles ns words apart). b holds k-chunk 0 on entry; each k-chunk's
// products run while the next one's fragments load, and the last k-chunk
// loads k-chunk 0 of B_next (n-tiles ns_next apart) into b for the next pass.
template <typename T, int MT>
__device__ __forceinline__ void mma_pass(float (&acc)[MT][4][4], uint32_t a_addr,
                                         uint32_t m_stride, const uint4* __restrict__ B,
                                         size_t ns, int chunks, const uint4* __restrict__ B_next,
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
      AFrag<T> a;
      a.load(a_addr + mt * m_stride + kc * CHUNK_BYTES);
#pragma unroll
      for (int i = 0; i < 4; ++i) a.mma(acc[mt][i], b[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = nb[i];
  }
}

// The LSTM cell of one unit group, straight from the accumulators: lane
// (g, q) = (lane / 4, lane % 4) holds in acc[mt][gate][e] the pre-activation
// of row 16 mt + g + 8 (e / 2), unit unit0 + e % 2 (unit0 = 8u + 2q). Its c
// words are lane-private: cs[(4 mt + e) * 32 + lane]. Writes h as T pairs (in
// bf16 the rounded h) into hdst[row * ld + unit0] and, with kSave, the
// residuals of the rows that exist (the activated gates at g_t[row * 4H +
// gate * H + unit], c and h at [row * H + unit]).
template <typename T, int MT, bool kSave>
__device__ __forceinline__ void cell_mma(const float (&acc)[MT][4][4], float* __restrict__ cs,
                                         T* __restrict__ hdst, int ld, int unit0, int lane,
                                         T* __restrict__ g_t, T* __restrict__ c_t,
                                         T* __restrict__ h_t, int rows_here, int H) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * mt + (lane >> 2) + 8 * half;
      float act[4][2], c[2], h[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int e = 2 * half + p;
        act[0][p] = sigm(acc[mt][0][e]);
        act[1][p] = sigm(acc[mt][1][e]);
        act[2][p] = tanhf(acc[mt][2][e]);
        act[3][p] = sigm(acc[mt][3][e]);
        float& cw = cs[(4 * mt + e) * 32 + lane];
        c[p] = act[1][p] * cw + act[0][p] * act[2][p];
        cw = c[p];
        h[p] = act[3][p] * tanhf(c[p]);
      }
      store_pair(hdst + (size_t)row * ld + unit0, h[0], h[1]);
      if (kSave && row < rows_here) {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          store_pair(g_t + (size_t)row * 4 * H + gate * H + unit0, act[gate][0], act[gate][1]);
        store_pair(c_t + (size_t)row * H + unit0, c[0], c[1]);
        store_pair(h_t + (size_t)row * H + unit0, h[0], h[1]);
      }
    }
}

// One layer of warp `warp`'s 32 units (unit groups 4 warp .. 4 warp + 3), in
// passes of one unit group: its four gate n-tiles for every m-tile, then the
// cell. Each B fragment loaded from L2 feeds all MT m-tiles.
template <typename T, int MT, bool kSave>
__device__ __forceinline__ void layer_mma(uint32_t a_addr, uint32_t m_stride,
                                          const uint4* __restrict__ B, size_t ns, int chunks,
                                          const uint4* __restrict__ B_next, size_t ns_next,
                                          uint4 (&b)[4], const float* __restrict__ bias,
                                          float* __restrict__ cs, T* __restrict__ hdst, int ld,
                                          int warp, int lane, T* __restrict__ g_t,
                                          T* __restrict__ c_t, T* __restrict__ h_t,
                                          int rows_here, int H) {
#pragma unroll 1
  for (int pass = 0; pass < MMA_PASSES; ++pass) {
    const int ug = MMA_PASSES * warp + pass, unit0 = 8 * ug + 2 * (lane & 3);
    float acc[MT][4][4];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
      const float2 bv = *reinterpret_cast<const float2*>(bias + 32 * ug + 8 * gate + 2 * (lane & 3));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][gate][0] = acc[mt][gate][2] = bv.x;
        acc[mt][gate][1] = acc[mt][gate][3] = bv.y;
      }
    }
    const bool last = pass + 1 == MMA_PASSES;
    mma_pass<T, MT>(acc, a_addr, m_stride, B + 4 * pass * ns, ns, chunks,
                    last ? B_next : B + 4 * (pass + 1) * ns, last ? ns_next : ns, b);
    cell_mma<T, MT, kSave>(acc, cs + (size_t)pass * MT * 4 * 32, hdst, ld, unit0, lane, g_t, c_t,
                           h_t, rows_here, H);
  }
}

// y_t = h2_t W_fc + b_fc for the tile's rows, from h2 in an operand buffer:
// warp w computes n-tiles w, w + warps, .. of the O columns over all H, so
// nothing grows with O but the number of n-tiles.
template <typename T, int MT>
__device__ __forceinline__ void fc_mma(uint32_t a_addr, uint32_t m_stride,
                                       const uint4* __restrict__ fc, int chunks,
                                       const float* __restrict__ fcb, T* __restrict__ out, int n0,
                                       int t, int steps, int O, int rows_here, int warp, int warps,
                                       int lane) {
  for (int nt = warp; 8 * nt < O; nt += warps) {
    float acc[MT][4] = {};
    for (int kc = 0; kc < chunks; ++kc) {
      const uint4 bv = __ldg(fc + ((size_t)nt * chunks + kc) * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        AFrag<T> a;
        a.load(a_addr + mt * m_stride + kc * CHUNK_BYTES);
        a.mma(acc[mt], bv);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + (lane >> 2) + 8 * (e >> 1);
        const int o = 8 * nt + 2 * (lane & 3) + (e & 1);
        if (row < rows_here && o < O)
          out[((size_t)(n0 + row) * steps + t) * O + o] = from_f<T>(acc[mt][e] + fcb[o]);
      }
  }
}

// The sweep for a tile of R = 16 MT rows. Shared memory holds two operand
// buffers [R][x | h1 | h2 | pad] of T that alternate by step parity
// (b = t & 1):
//   layer 1 reads [x_t | h1_{t-1}] from buffer b and writes h1_t into
//     buffer b ^ 1; layer 2 reads [h1_t | h2_{t-1}] from buffer b ^ 1 and
//     writes h2_t into buffer b, and x_{t+1} is loaded into buffer b ^ 1;
//   the fc of step t - 1 reads h2_{t-1} from buffer b ^ 1 at the start of
//     step t.
// So no write lands on a word a warp may still read in the same phase, and a
// step needs two barriers. c1 and c2 sit in shared memory, each word private
// to its lane. Each output word has one writer and each sum a fixed order:
// no atomics, the same bits on every run and at either R.
template <typename T, int MT, bool kSave, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
sweep_mma_kernel(const T* __restrict__ x,  // [T, N, D]
                 const MmaWeights wt, const float* __restrict__ fcb,
                 T* __restrict__ out,  // [N, T, O]
                 const Residuals<T> res, int n_rows, int steps, int D, int H, int O) {
  constexpr int R = 16 * MT, KC = k_chunk<T>();
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int xc = x_cols<T>(D), ld = operand_pitch<T>(D, H);
  T* ops = reinterpret_cast<T*>(smem_mma);                          // [2][R][ld]
  float* c1s = reinterpret_cast<float*>(ops + 2 * (size_t)R * ld);  // [R * H]
  float* c2s = c1s + (size_t)R * H;                                 // [R * H]

  const int j = threadIdx.x, warp = j >> 5, lane = j & 31, warps = H >> 5;
  const int n0 = blockIdx.x * R;
  const int rows_here = min(R, n_rows - n0);
  const int kc1 = (xc + H) / KC, kc2 = 2 * H / KC, kcf = H / KC;
  const size_t ns1 = (size_t)kc1 * 32, ns2 = (size_t)kc2 * 32;  // words between n-tiles
  const uint32_t m_stride = sizeof(T) * 16 * ld;  // bytes between m-tiles
  uint32_t a_addr[2];  // this lane's ldmatrix address in each buffer, column 0
#pragma unroll
  for (int bb = 0; bb < 2; ++bb)
    a_addr[bb] = (uint32_t)__cvta_generic_to_shared(ops + ((size_t)bb * R + (lane & 15)) * ld) +
                 16 * (lane >> 4);
  // the warp's first n-tile (unit group 4 warp, gate i) of each layer
  const uint4* w1w = wt.w1 + (size_t)4 * MMA_PASSES * warp * ns1 + lane;
  const uint4* w2w = wt.w2 + (size_t)4 * MMA_PASSES * warp * ns2 + lane;
  const size_t cwarp = (size_t)warp * MMA_PASSES * MT * 4 * 32;  // the warp's c words
  const uint32_t h1_col = sizeof(T) * xc, h2_col = sizeof(T) * (xc + H);  // bytes

  auto load_x = [&](int t, T* dst) {  // x_t into dst's x columns; rows past N stay zero
    const T* xt = x + ((size_t)t * n_rows + n0) * D;
    for (int idx = j; idx < rows_here * D; idx += blockDim.x) {
      const int r = idx / D;
      dst[(size_t)r * ld + idx - r * D] = xt[idx];
    }
  };

  {  // zero both buffers (pads, h, c) before the first x tile
    uint32_t* words = reinterpret_cast<uint32_t*>(smem_mma);
    const size_t n_words = shared_bytes_mma<T>(R, D, H) / 4;
    for (size_t i = j; i < n_words; i += blockDim.x) words[i] = 0u;
  }
  __syncthreads();
  if (steps > 0) load_x(0, ops);
  __syncthreads();

  uint4 b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __ldg(w1w + i * ns1);
  for (int t = 0; t < steps; ++t) {
    const int bb = t & 1;
    T* cur = ops + (size_t)bb * R * ld;
    T* nxt = ops + (size_t)(bb ^ 1) * R * ld;
    const size_t row0 = (size_t)t * n_rows + n0;  // this step's first row of the tile
    if (t > 0)
      fc_mma<T, MT>(a_addr[bb ^ 1] + h2_col, m_stride, wt.fc + lane, kcf, fcb, out, n0, t - 1,
                    steps, O, rows_here, warp, warps, lane);
    // layer 1: [x_t | h1_{t-1}] [W1; U1] -> h1_t
    layer_mma<T, MT, kSave>(a_addr[bb], m_stride, w1w, ns1, kc1, w2w, ns2, b, wt.b1, c1s + cwarp,
                            nxt + xc, ld, warp, lane, kSave ? res.g1 + row0 * 4 * H : nullptr,
                            kSave ? res.c1 + row0 * H : nullptr,
                            kSave ? res.h1 + row0 * H : nullptr, rows_here, H);
    __syncthreads();  // h1_t is complete
    // layer 2: [h1_t | h2_{t-1}] [W2; U2] -> h2_t
    layer_mma<T, MT, kSave>(a_addr[bb ^ 1] + h1_col, m_stride, w2w, ns2, kc2, w1w, ns1, b, wt.b2,
                            c2s + cwarp, cur + xc + H, ld, warp, lane,
                            kSave ? res.g2 + row0 * 4 * H : nullptr,
                            kSave ? res.c2 + row0 * H : nullptr,
                            kSave ? res.h2 + row0 * H : nullptr, rows_here, H);
    if (t + 1 < steps) load_x(t + 1, nxt);
    __syncthreads();  // h2_t and x_{t+1} are complete
  }
  if (steps > 0)
    fc_mma<T, MT>(a_addr[(steps - 1) & 1] + h2_col, m_stride, wt.fc + lane, kcf, fcb, out, n0,
                  steps - 1, steps, O, rows_here, warp, warps, lane);
}

template <typename T, int MT, bool kSave, int MAX_THREADS>
int launch_mma_tile(const void* x, const MmaWeights& wt, const void* fcb, void* out,
                    const Residuals<T>& res, int n_rows, int steps, int D, int H, int O,
                    cudaStream_t stream) {
  constexpr int R = 16 * MT;
  const size_t smem = shared_bytes_mma<T>(R, D, H);
  const cudaError_t err = cudaFuncSetAttribute(sweep_mma_kernel<T, MT, kSave, MAX_THREADS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep_mma_kernel<T, MT, kSave, MAX_THREADS><<<(n_rows + R - 1) / R, H, smem, stream>>>(
      static_cast<const T*>(x), wt, static_cast<const float*>(fcb), static_cast<T*>(out), res,
      n_rows, steps, D, H, O);
  return (int)cudaGetLastError();
}

template <typename T, int MT, bool kSave>
int launch_mma_rows(const void* x, const MmaWeights& wt, const void* fcb, void* out,
                    const Residuals<T>& res, int n_rows, int steps, int D, int H, int O,
                    cudaStream_t stream) {
  return H <= 384 ? launch_mma_tile<T, MT, kSave, 384>(x, wt, fcb, out, res, n_rows, steps, D, H,
                                                       O, stream)
                  : launch_mma_tile<T, MT, kSave, 512>(x, wt, fcb, out, res, n_rows, steps, D, H,
                                                       O, stream);
}

// The sweep always takes the tensor-core kernel; rows is its row tile: 16 or
// 32 (one or two m16 tiles) in bf16, 16 in float32. A refused launch returns
// its error.
template <typename T, bool kSave>
int launch_mma(const void* x, const MmaWeights& wt, const void* fcb, void* out,
               const Residuals<T>& res, int n_rows, int steps, int D, int H, int O, int rows,
               cudaStream_t stream) {
  if (wt.w1 == nullptr || wt.w2 == nullptr || wt.fc == nullptr || wt.b1 == nullptr ||
      wt.b2 == nullptr)
    return (int)cudaErrorInvalidValue;
  if (rows == 16)
    return launch_mma_rows<T, 1, kSave>(x, wt, fcb, out, res, n_rows, steps, D, H, O, stream);
  if constexpr (sizeof(T) == 2) {
    if (rows == 32)
      return launch_mma_rows<T, 2, kSave>(x, wt, fcb, out, res, n_rows, steps, D, H, O, stream);
  }
  return (int)cudaErrorInvalidValue;
}

inline bool valid_shape(int n_rows, int steps, int D, int H, int O) {
  return H % 32 == 0 && H <= 512 && n_rows > 0 && steps >= 0 && D > 0 && O > 0;
}

// The six residual pointers (g1, c1, h1, g2, c2, h2) as T, or none
template <typename T> Residuals<T> residuals_of(void* const* res) {
  if (res == nullptr) return Residuals<T>{};
  return Residuals<T>{static_cast<T*>(res[0]), static_cast<T*>(res[1]), static_cast<T*>(res[2]),
                      static_cast<T*>(res[3]), static_cast<T*>(res[4]), static_cast<T*>(res[5])};
}

// The C entry points' dispatch: dtype 0 float32, 1 bfloat16 (x, out and the
// residuals); the weights as the packed fragments w1p, w2p, fcp and the
// gate-interleaved biases b1p, b2p; res null without kSave.
template <bool kSave>
int launch_dtype(int dtype, const void* x, const void* w1p, const void* w2p, const void* fcp,
                 const void* b1p, const void* b2p, const void* fcb, void* out, void* const* res,
                 int n_rows, int steps, int D, int H, int O, int rows, cudaStream_t stream) {
  if (kSave != (res != nullptr)) return (int)cudaErrorInvalidValue;
  const MmaWeights wt{static_cast<const uint4*>(w1p), static_cast<const uint4*>(w2p),
                      static_cast<const uint4*>(fcp), static_cast<const float*>(b1p),
                      static_cast<const float*>(b2p)};
  if (dtype == 0)
    return launch_mma<float, kSave>(x, wt, fcb, out, residuals_of<float>(res), n_rows, steps, D,
                                    H, O, rows, stream);
  if (dtype == 1)
    return launch_mma<__nv_bfloat16, kSave>(x, wt, fcb, out, residuals_of<__nv_bfloat16>(res),
                                            n_rows, steps, D, H, O, rows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace fwd
