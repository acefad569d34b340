// The forward sweep of the fused 2-layer LSTM + output Linear, shared by
// lstm2_fwd.cu (inference: y only) and lstm2_train_fwd.cu (training: y and
// the residuals the backward reads). Per step t and row n:
//   g1 = x_t W1 + h1 U1 + b1,  g2 = [h1 | h2] [W2; U2] + b2   (gates i,f,g,o)
//   c = f*c + i*g,  h = o*tanh(c),  y_t = h2 W_fc + b_fc
// h and c stay float32; h is rounded to the weight type before every product
// (the TPU kernel's h.astype(mm)); products accumulate in float32. Both
// kernels run the same products in the same order, so their y is equal bit
// for bit. One CTA per tile of R rows sweeps all T steps, so the recurrence
// never leaves the block. The weights (7.3 MB float32, 3.7 MB bf16) do not
// fit in shared memory; they stay in global memory, served from the 50 MB L2.
//
// float32 (`sweep_kernel`, FMA products; R 16 or 20). Thread j of the H
// threads owns hidden unit j of both layers: it computes gate columns j,
// H+j, 2H+j, 3H+j for the tile's rows, so a warp's weight loads are 128
// contiguous bytes, and every residual store of a row is H contiguous
// elements across the block. h1, h2 and the x tile sit in shared memory
// k-major ([K][R]) so one float4 load feeds four rows; c1 and c2 sit in
// shared memory [R][H], private to their thread. The fc (O outputs) is a
// warp-shuffle then cross-warp reduction over H. __syncthreads separates
// each layer's read phase from its write phase. Launch: grid ceil(N / R),
// block H threads, dynamic shared memory shared_bytes(R, D, H, O).
//
// bf16 (`sweep_mma_kernel`, tensor-core products; R 16 or 32: one or two m16
// tiles). Every product, the fc's too, runs on mma.sync.m16n8k16 (bf16
// operands, float32 sums: the TPU kernel's contract, lstm_pallas.py:144-179),
// with no FMA product left. A: the tile's operand rows [x | h1 | h2] bf16 in
// shared memory, read by ldmatrix; layer 1 is one product over [x | h1]
// against [W1; U1] (x zero-padded from D 34 to 64 columns), layer 2 one over
// [h1 | h2] against [W2; U2]. B: the weights packed once per call by
// ops/lstm2.py::pack_fwd_mma into lane order with the gate columns
// interleaved (n-tiles 4u .. 4u + 3 = gates i, f, g, o of units 8u .. 8u +
// 7), so a lane's accumulators hold all four gates of its (row, unit) pairs
// and the cell runs straight from them: no [R][4H] gate array goes through
// shared memory. Warp w of the H / 32 owns units 32w .. 32w + 31, in 4
// passes of one unit group; each weight fragment it loads from L2 feeds
// every m-tile of the CTA, so R 32 reads the weights half as often per row
// as R 16. The fc is a product over the h2 tile with W_fc^T packed to bf16 and
// O padded to n-tiles of 8; warps own whole n-tiles, so no shared-memory
// partial grows with O. Shared memory at D 34, H 384: 2 R x 840 bf16 operand
// rows and 2 R x 384 float32 c words, 205,824 bytes at R 32 (102,912 at R 16).
// Launch: grid ceil(N / R), block H threads, dynamic shared memory
// shared_bytes_mma(R, D, H).

#pragma once

#include "lstm2_common.cuh"

namespace fwd {

using lstm2::from_f;
using lstm2::ldmatrix_x4;
using lstm2::mma_bf16;
using lstm2::round_to;
using lstm2::sigm;
using lstm2::to_f;

inline size_t shared_bytes(int R, int D, int H, int O) {
  return sizeof(float) * (size_t)R * (D + 4 * H + (H / 32) * O);
}

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

// acc[g][r] += sum_k src[k][r] * W[k][g*H + j] for k < K
template <typename T, int R>
__device__ __forceinline__ void accumulate(float (&acc)[4][R], const T* __restrict__ W,
                                           const float* __restrict__ src, int K, int H,
                                           int j) {
  const int G = 4 * H;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const T* row = W + (size_t)k * G + j;
    float w[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) w[g] = to_f(row[g * H]);
    const float4* s = reinterpret_cast<const float4*>(src + k * R);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 v = s[q];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        acc[g][4 * q + 0] = fmaf(v.x, w[g], acc[g][4 * q + 0]);
        acc[g][4 * q + 1] = fmaf(v.y, w[g], acc[g][4 * q + 1]);
        acc[g][4 * q + 2] = fmaf(v.z, w[g], acc[g][4 * q + 2]);
        acc[g][4 * q + 3] = fmaf(v.w, w[g], acc[g][4 * q + 3]);
      }
    }
  }
}

template <int R>
__device__ __forceinline__ void init_acc(float (&acc)[4][R], const float* __restrict__ b,
                                         int H, int j) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float bg = b[g * H + j];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[g][r] = bg;
  }
}

// LSTM cell for unit j of every row: updates c[r][j] and writes the rounded
// h into hs[j][r] and h_out[r]. With kSave it also stores the step's
// residuals of the rows that exist: the ACTIVATED gates at
// g_t[r * 4H + gate * H + j], c and the rounded h at [r * H + j].
template <typename T, int R, bool kSave>
__device__ __forceinline__ void cell(const float (&acc)[4][R], float* __restrict__ cs,
                                     float* __restrict__ hs, float (&h_out)[R],
                                     T* __restrict__ g_t, T* __restrict__ c_t,
                                     T* __restrict__ h_t, int rows_here, int H, int j) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float i = sigm(acc[0][r]);
    const float f = sigm(acc[1][r]);
    const float g = tanhf(acc[2][r]);
    const float o = sigm(acc[3][r]);
    const float c = f * cs[r * H + j] + i * g;
    cs[r * H + j] = c;
    h_out[r] = round_to<T>(o * tanhf(c));
    if (kSave && r < rows_here) {
      T* gr = g_t + (size_t)r * 4 * H + j;
      gr[0] = from_f<T>(i);
      gr[H] = from_f<T>(f);
      gr[2 * H] = from_f<T>(g);
      gr[3 * H] = from_f<T>(o);
      c_t[(size_t)r * H + j] = from_f<T>(c);
      h_t[(size_t)r * H + j] = from_f<T>(h_out[r]);
    }
  }
  float4* dst = reinterpret_cast<float4*>(hs + j * R);
#pragma unroll
  for (int q = 0; q < R / 4; ++q)
    dst[q] = make_float4(h_out[4 * q], h_out[4 * q + 1], h_out[4 * q + 2], h_out[4 * q + 3]);
}

// R = 16 leaves 128 registers a thread for up to 512 units; R = 20 needs
// more accumulators and is built for up to 384 units (168 registers).
template <typename T, int R, bool kSave>
__global__ void __launch_bounds__(R == 16 ? 512 : 384, 1)
sweep_kernel(const T* __restrict__ x,        // [T, N, D]
             const T* __restrict__ w1,       // [D, 4H]
             const T* __restrict__ u1,       // [H, 4H]
             const float* __restrict__ b1,   // [4H]
             const T* __restrict__ w2,       // [2H, 4H]
             const float* __restrict__ b2,   // [4H]
             const float* __restrict__ fcw,  // [H, O]
             const float* __restrict__ fcb,  // [O]
             T* __restrict__ out,            // [N, T, O]
             const Residuals<T> res,         // read only with kSave
             int n_rows, int steps, int D, int H, int O) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;           // [D][R]
  float* h1s = xs + D * R;    // [H][R]
  float* h2s = h1s + H * R;   // [H][R]
  float* c1s = h2s + H * R;   // [R][H]
  float* c2s = c1s + R * H;   // [R][H]
  float* red = c2s + R * H;   // [H/32][R][O]

  const int j = threadIdx.x;  // hidden unit
  const int lane = j & 31, warp = j >> 5, n_warps = H >> 5;
  const int n0 = blockIdx.x * R;
  const int rows_here = min(R, n_rows - n0);

  for (int idx = j; idx < 4 * H * R; idx += H) h1s[idx] = 0.0f;  // h1, h2, c1, c2
  __syncthreads();

  float acc[4][R];
  float h[R];
  for (int t = 0; t < steps; ++t) {
    const size_t row0 = (size_t)t * n_rows + n0;  // this step's first row of the tile
    // x tile of this step, transposed to [D][R]; rows past N read as zero
    const T* xt = x + row0 * D;
    for (int idx = j; idx < R * D; idx += H) {
      const int r = idx / D, k = idx - r * D;
      xs[k * R + r] = (r < rows_here) ? to_f(xt[idx]) : 0.0f;
    }
    __syncthreads();

    // layer 1
    init_acc<R>(acc, b1, H, j);
    accumulate<T, R>(acc, w1, xs, D, H, j);
    accumulate<T, R>(acc, u1, h1s, H, H, j);
    __syncthreads();  // every thread has read the old h1
    cell<T, R, kSave>(acc, c1s, h1s, h, kSave ? res.g1 + row0 * 4 * H : nullptr,
                      kSave ? res.c1 + row0 * H : nullptr, kSave ? res.h1 + row0 * H : nullptr,
                      rows_here, H, j);
    __syncthreads();  // the new h1 is complete

    // layer 2: [h1 | h2] [W2; U2]
    init_acc<R>(acc, b2, H, j);
    accumulate<T, R>(acc, w2, h1s, H, H, j);
    accumulate<T, R>(acc, w2 + (size_t)H * 4 * H, h2s, H, H, j);
    __syncthreads();  // every thread has read the old h2
    cell<T, R, kSave>(acc, c2s, h2s, h, kSave ? res.g2 + row0 * 4 * H : nullptr,
                      kSave ? res.c2 + row0 * H : nullptr, kSave ? res.h2 + row0 * H : nullptr,
                      rows_here, H, j);

    // fused fc: y[r][o] = sum_j h2[r][j] fcw[j][o] + fcb[o]
    for (int o = 0; o < O; ++o) {
      const float wj = fcw[j * O + o];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float p = h[r] * wj;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) red[(warp * R + r) * O + o] = p;
      }
    }
    __syncthreads();
    for (int idx = j; idx < R * O; idx += H) {
      const int r = idx / O, o = idx - r * O;
      float s = fcb[o];
      for (int w = 0; w < n_warps; ++w) s += red[(w * R + r) * O + o];
      if (r < rows_here) out[((size_t)(n0 + r) * steps + t) * O + o] = from_f<T>(s);
    }
    // the next step's first __syncthreads orders these reads of red before
    // its rewrite, and the x tile is not read again in this step
  }
}

// Launch on `stream`; returns cudaGetLastError().
template <typename T, int R, bool kSave>
int launch(const void* x, const void* w1, const void* u1, const void* b1, const void* w2,
           const void* b2, const void* fcw, const void* fcb, void* out,
           const Residuals<T>& res, int n_rows, int steps, int D, int H, int O,
           cudaStream_t stream) {
  const size_t smem = shared_bytes(R, D, H, O);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<T, R, kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + R - 1) / R);
  sweep_kernel<T, R, kSave><<<grid, H, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(u1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(fcw),
      static_cast<const float*>(fcb), static_cast<T*>(out), res, n_rows, steps, D, H, O);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_PAD = 8;  // bf16 pad of an operand row (FWD_MMA_PAD in ops/lstm2.py)
constexpr int MMA_PASSES = 4;  // unit groups of 8 a warp owns: H / 32 warps x 4 x 8 = H

// x's columns in an operand row, zero-padded to whole k-pairs of 32
__host__ __device__ inline int x_cols(int D) { return (D + 31) / 32 * 32; }

// bf16 elements of an operand row [x | h1 | h2 | pad]; the pad makes the
// row pitch an odd multiple of 16 bytes, so ldmatrix is free of bank conflicts
__host__ __device__ inline int operand_pitch(int D, int H) {
  return x_cols(D) + 2 * H + MMA_PAD;
}

// two operand buffers [R][pitch] bf16, then c1 and c2 (R * H float32 each)
__host__ __device__ inline size_t shared_bytes_mma(int R, int D, int H) {
  return sizeof(__nv_bfloat16) * 2 * (size_t)R * operand_pitch(D, H) +
         sizeof(float) * 2 * (size_t)R * H;
}

// The bf16 sweep's weights, packed once per call by ops/lstm2.py::pack_fwd_mma
// into mma.sync's B-fragment lane order (pack_mma_b: [n-tile][k-pair][lane],
// 16 bytes a lane), with the 4H gate columns interleaved: n-tiles 4u .. 4u + 3
// hold gates i, f, g, o of units 8u .. 8u + 7.
struct MmaWeights {
  const uint4* w1;  // [W1 (zero rows up to x_cols(D)); U1]: [4H/8][(x_cols(D) + H)/32][32]
  const uint4* w2;  // [W2; U2]: [4H/8][2H/32][32]
  const uint4* fc;  // W_fc^T, O zero-padded to n-tiles of 8: [ceil(O/8)][H/32][32]
  const float* b1;  // [4H], gate-interleaved
  const float* b2;
};

// acc[mt][i] += (A's m-tile mt) . (B's n-tile i) over all k-pairs, in k order.
// a_addr: this lane's ldmatrix address of m-tile 0, k-pair 0 (m-tiles m_stride
// bytes apart); B: this lane's word of n-tile 0, k-pair 0 (n-tiles ns words
// apart). b holds k-pair 0 on entry; each k-pair's products run while the
// next one's fragments load, and the last k-pair loads k-pair 0 of B_next
// (n-tiles ns_next apart) into b for the next pass.
template <int MT>
__device__ __forceinline__ void mma_pass(float (&acc)[MT][4][4], uint32_t a_addr,
                                         uint32_t m_stride, const uint4* __restrict__ B,
                                         size_t ns, int kpairs, const uint4* __restrict__ B_next,
                                         size_t ns_next, uint4 (&b)[4]) {
#pragma unroll 2
  for (int kp = 0; kp < kpairs; ++kp) {
    const bool last = kp + 1 == kpairs;
    const uint4* nxt = last ? B_next : B + (size_t)(kp + 1) * 32;
    const size_t nst = last ? ns_next : ns;
    uint4 nb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) nb[i] = __ldg(nxt + i * nst);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a0[4], a1[4];  // k-steps 2kp and 2kp + 1: 32 bytes each
      ldmatrix_x4(a0, a_addr + mt * m_stride + kp * 64);
      ldmatrix_x4(a1, a_addr + mt * m_stride + kp * 64 + 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mma_bf16(acc[mt][i], a0, b[i].x, b[i].y);
        mma_bf16(acc[mt][i], a1, b[i].z, b[i].w);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = nb[i];
  }
}

// The LSTM cell of one unit group, straight from the accumulators: lane
// (g, q) = (lane / 4, lane % 4) holds in acc[mt][gate][e] the pre-activation
// of row 16 mt + g + 8 (e / 2), unit unit0 + e % 2 (unit0 = 8u + 2q). Its c
// words are lane-private: cs[(4 mt + e) * 32 + lane]. Writes the rounded h as
// bf16 pairs into hdst[row * ld + unit0] and, with kSave, the residuals of
// the rows that exist (the activated gates at g_t[row * 4H + gate * H +
// unit], c and h at [row * H + unit]).
template <int MT, bool kSave>
__device__ __forceinline__ void cell_mma(const float (&acc)[MT][4][4], float* __restrict__ cs,
                                         __nv_bfloat16* __restrict__ hdst, int ld, int unit0,
                                         int lane, __nv_bfloat16* __restrict__ g_t,
                                         __nv_bfloat16* __restrict__ c_t,
                                         __nv_bfloat16* __restrict__ h_t, int rows_here,
                                         int H) {
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
      const __nv_bfloat162 hb = __floats2bfloat162_rn(h[0], h[1]);
      *reinterpret_cast<__nv_bfloat162*>(hdst + (size_t)row * ld + unit0) = hb;
      if (kSave && row < rows_here) {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          *reinterpret_cast<__nv_bfloat162*>(g_t + (size_t)row * 4 * H + gate * H + unit0) =
              __floats2bfloat162_rn(act[gate][0], act[gate][1]);
        *reinterpret_cast<__nv_bfloat162*>(c_t + (size_t)row * H + unit0) =
            __floats2bfloat162_rn(c[0], c[1]);
        *reinterpret_cast<__nv_bfloat162*>(h_t + (size_t)row * H + unit0) = hb;
      }
    }
}

// One layer of warp `warp`'s 32 units (unit groups 4 warp .. 4 warp + 3), in
// passes of one unit group: its four gate n-tiles for every m-tile, then the
// cell. Each B fragment loaded from L2 feeds all MT m-tiles.
template <int MT, bool kSave>
__device__ __forceinline__ void layer_mma(uint32_t a_addr, uint32_t m_stride,
                                          const uint4* __restrict__ B, size_t ns, int kpairs,
                                          const uint4* __restrict__ B_next, size_t ns_next,
                                          uint4 (&b)[4], const float* __restrict__ bias,
                                          float* __restrict__ cs, __nv_bfloat16* __restrict__ hdst,
                                          int ld, int warp, int lane,
                                          __nv_bfloat16* __restrict__ g_t,
                                          __nv_bfloat16* __restrict__ c_t,
                                          __nv_bfloat16* __restrict__ h_t, int rows_here, int H) {
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
    mma_pass<MT>(acc, a_addr, m_stride, B + 4 * pass * ns, ns, kpairs,
                 last ? B_next : B + 4 * (pass + 1) * ns, last ? ns_next : ns, b);
    cell_mma<MT, kSave>(acc, cs + (size_t)pass * MT * 4 * 32, hdst, ld, unit0, lane, g_t, c_t, h_t,
                        rows_here, H);
  }
}

// y_t = h2_t W_fc + b_fc for the tile's rows, from the rounded h2 in an
// operand buffer: warp w computes n-tiles w, w + warps, .. of the O columns
// over all H, so nothing grows with O but the number of n-tiles.
template <int MT>
__device__ __forceinline__ void fc_mma(uint32_t a_addr, uint32_t m_stride,
                                       const uint4* __restrict__ fc, int kpairs,
                                       const float* __restrict__ fcb,
                                       __nv_bfloat16* __restrict__ out, int n0, int t, int steps,
                                       int O, int rows_here, int warp, int warps, int lane) {
  for (int nt = warp; 8 * nt < O; nt += warps) {
    float acc[MT][4] = {};
    for (int kp = 0; kp < kpairs; ++kp) {
      const uint4 bv = __ldg(fc + ((size_t)nt * kpairs + kp) * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, a_addr + mt * m_stride + kp * 64);
        ldmatrix_x4(a1, a_addr + mt * m_stride + kp * 64 + 32);
        mma_bf16(acc[mt], a0, bv.x, bv.y);
        mma_bf16(acc[mt], a1, bv.z, bv.w);
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

// The bf16 sweep: the steps, cell and cast points of sweep_kernel for a tile
// of R = 16 MT rows, with every product on mma.sync m16n8k16 (bf16 operands,
// float32 sums). Shared memory holds two operand buffers [R][x | h1 | h2 |
// pad] bf16 that alternate by step parity (b = t & 1):
//   layer 1 reads [x_t | h1_{t-1}] from buffer b and writes h1_t into
//     buffer b ^ 1; layer 2 reads [h1_t | h2_{t-1}] from buffer b ^ 1 and
//     writes h2_t into buffer b, and x_{t+1} is loaded into buffer b ^ 1;
//   the fc of step t - 1 reads h2_{t-1} from buffer b ^ 1 at the start of
//     step t.
// So no write lands on a word a warp may still read in the same phase, and a
// step needs two barriers. c1 and c2 sit in shared memory, each word private
// to its lane. Each output word has one writer and each sum a fixed order:
// no atomics, the same bits on every run and at either R.
template <int MT, bool kSave, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
sweep_mma_kernel(const __nv_bfloat16* __restrict__ x,  // [T, N, D]
                 const MmaWeights wt, const float* __restrict__ fcb,
                 __nv_bfloat16* __restrict__ out,  // [N, T, O]
                 const Residuals<__nv_bfloat16> res, int n_rows, int steps, int D, int H, int O) {
  using T = __nv_bfloat16;
  constexpr int R = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int xc = x_cols(D), ld = operand_pitch(D, H);
  T* ops = reinterpret_cast<T*>(smem_mma);                          // [2][R][ld]
  float* c1s = reinterpret_cast<float*>(ops + 2 * (size_t)R * ld);  // [R * H]
  float* c2s = c1s + (size_t)R * H;                                 // [R * H]

  const int j = threadIdx.x, warp = j >> 5, lane = j & 31, warps = H >> 5;
  const int n0 = blockIdx.x * R;
  const int rows_here = min(R, n_rows - n0);
  const int kp1 = (xc + H) / 32, kp2 = 2 * H / 32, kpf = H / 32;
  const size_t ns1 = (size_t)kp1 * 32, ns2 = (size_t)kp2 * 32;  // words between n-tiles
  const uint32_t m_stride = 2 * 16 * ld;  // bytes between m-tiles
  uint32_t a_addr[2];  // this lane's ldmatrix address in each buffer, column 0
#pragma unroll
  for (int bb = 0; bb < 2; ++bb)
    a_addr[bb] = (uint32_t)__cvta_generic_to_shared(ops + ((size_t)bb * R + (lane & 15)) * ld +
                                                    8 * (lane >> 4));
  // the warp's first n-tile (unit group 4 warp, gate i) of each layer
  const uint4* w1w = wt.w1 + (size_t)4 * MMA_PASSES * warp * ns1 + lane;
  const uint4* w2w = wt.w2 + (size_t)4 * MMA_PASSES * warp * ns2 + lane;
  const size_t cwarp = (size_t)warp * MMA_PASSES * MT * 4 * 32;  // the warp's c words

  auto load_x = [&](int t, T* dst) {  // x_t into dst's x columns; rows past N stay zero
    const T* xt = x + ((size_t)t * n_rows + n0) * D;
    for (int idx = j; idx < rows_here * D; idx += blockDim.x) {
      const int r = idx / D;
      dst[(size_t)r * ld + idx - r * D] = xt[idx];
    }
  };

  {  // zero both buffers (pads, h, c) before the first x tile
    uint32_t* words = reinterpret_cast<uint32_t*>(smem_mma);
    const size_t n_words = shared_bytes_mma(R, D, H) / 4;
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
      fc_mma<MT>(a_addr[bb ^ 1] + 2 * (xc + H), m_stride, wt.fc + lane, kpf, fcb, out,
                 n0, t - 1, steps, O, rows_here, warp, warps, lane);
    // layer 1: [x_t | h1_{t-1}] [W1; U1] -> h1_t
    layer_mma<MT, kSave>(a_addr[bb], m_stride, w1w, ns1, kp1, w2w, ns2, b, wt.b1, c1s + cwarp,
                         nxt + xc, ld, warp, lane, kSave ? res.g1 + row0 * 4 * H : nullptr,
                         kSave ? res.c1 + row0 * H : nullptr, kSave ? res.h1 + row0 * H : nullptr,
                         rows_here, H);
    __syncthreads();  // h1_t is complete
    // layer 2: [h1_t | h2_{t-1}] [W2; U2] -> h2_t
    layer_mma<MT, kSave>(a_addr[bb ^ 1] + 2 * xc, m_stride, w2w, ns2, kp2, w1w, ns1, b,
                         wt.b2, c2s + cwarp, cur + xc + H, ld, warp, lane,
                         kSave ? res.g2 + row0 * 4 * H : nullptr,
                         kSave ? res.c2 + row0 * H : nullptr, kSave ? res.h2 + row0 * H : nullptr,
                         rows_here, H);
    if (t + 1 < steps) load_x(t + 1, nxt);
    __syncthreads();  // h2_t and x_{t+1} are complete
  }
  if (steps > 0)
    fc_mma<MT>(a_addr[(steps - 1) & 1] + 2 * (xc + H), m_stride, wt.fc + lane, kpf, fcb,
               out, n0, steps - 1, steps, O, rows_here, warp, warps, lane);
}

template <int MT, bool kSave, int MAX_THREADS>
int launch_mma_tile(const void* x, const MmaWeights& wt, const void* fcb, void* out,
                    const Residuals<__nv_bfloat16>& res, int n_rows, int steps, int D, int H,
                    int O, cudaStream_t stream) {
  constexpr int R = 16 * MT;
  const size_t smem = shared_bytes_mma(R, D, H);
  const cudaError_t err = cudaFuncSetAttribute(sweep_mma_kernel<MT, kSave, MAX_THREADS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep_mma_kernel<MT, kSave, MAX_THREADS><<<(n_rows + R - 1) / R, H, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), wt, static_cast<const float*>(fcb),
      static_cast<__nv_bfloat16*>(out), res, n_rows, steps, D, H, O);
  return (int)cudaGetLastError();
}

// The bf16 sweep always takes the tensor-core kernel; rows is its row tile,
// 16 or 32 (one or two m16 tiles). A refused launch returns its error.
template <bool kSave>
int launch_mma(const void* x, const MmaWeights& wt, const void* fcb, void* out,
               const Residuals<__nv_bfloat16>& res, int n_rows, int steps, int D, int H, int O,
               int rows, cudaStream_t stream) {
  if (wt.w1 == nullptr || wt.w2 == nullptr || wt.fc == nullptr || wt.b1 == nullptr ||
      wt.b2 == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool narrow = H <= 384;
  if (rows == 16)
    return narrow ? launch_mma_tile<1, kSave, 384>(x, wt, fcb, out, res, n_rows, steps, D, H, O,
                                                   stream)
                  : launch_mma_tile<1, kSave, 512>(x, wt, fcb, out, res, n_rows, steps, D, H, O,
                                                   stream);
  if (rows == 32)
    return narrow ? launch_mma_tile<2, kSave, 384>(x, wt, fcb, out, res, n_rows, steps, D, H, O,
                                                   stream)
                  : launch_mma_tile<2, kSave, 512>(x, wt, fcb, out, res, n_rows, steps, D, H, O,
                                                   stream);
  return (int)cudaErrorInvalidValue;
}

inline bool valid_shape(int n_rows, int steps, int D, int H, int O) {
  return H % 32 == 0 && H <= 512 && n_rows > 0 && steps >= 0 && D > 0 && O > 0;
}

}  // namespace fwd
