// The forward sweep of the fused 2-layer LSTM + output Linear, shared by
// lstm2_fwd.cu (inference: y only) and lstm2_train_fwd.cu (training: y and
// the residuals the backward reads). Per step t and row n:
//   g1 = x_t W1 + h1 U1 + b1,  g2 = [h1 | h2] [W2; U2] + b2   (gates i,f,g,o)
//   c = f*c + i*g,  h = o*tanh(c),  y_t = h2 W_fc + b_fc
// h and c stay float32; h is rounded to the weight type T before every
// product (the TPU kernel's h.astype(mm); no rounding in float32); products
// accumulate in float32. Both kernels run the same products in the same
// order, so their y is equal bit for bit. The weights (7.5 MB float32, 3.7 MB
// bf16 at D 34, H 384) do not fit in shared memory; they stay in global
// memory, served from the 50 MB L2. Four forms, chosen by the fold's shape,
// dtype and the card's SM count (`fwd_sweep_plan` in ops/lstm2.py, the same
// for K1 and K2):
//   * the tile form, `sweep_mma_kernel`: one CTA per tile of R rows sweeps
//     all T steps, so the recurrence never leaves the block; every CTA pulls
//     every weight fragment from L2 each step (the folds whose row tiles
//     the card holds at once);
//   * the wave form: the same kernel over the same work cut into items of
//     (row tile, part of part_steps steps). Item k is tile k mod tiles over
//     part k div tiles, oldest steps first, and each launch runs the next
//     min(tiles, the CTAs the card holds at once) items (`launch_mma_tile`).
//     An item starts from the carries its tile's previous part left in
//     device memory (`carry`: h1 and h2 as the operand buffers hold them, in
//     T, and the c words of c1s and c2s, float32), which an earlier launch
//     wrote, so stream order is all the synchronisation there is; it runs
//     the fc of its own last step before it stores them, so each y word
//     keeps one writer. Each item runs the tile form's arithmetic in its
//     order: the same y and residuals bit for bit. At the training fold (N
//     2304, 144 tiles of 16 on 132 SMs) the tile form's second wave of 12
//     CTAs costs nearly a full one; the wave form keeps every SM busy but
//     for the last launch;
//   * the pair form, `sweep_pair_kernel` (bf16; below): the tile form's R 32
//     sweep split over a cluster of two CTAs, each owning half the hidden
//     units and pulling only their weights, h exchanged through distributed
//     shared memory, in one launch or in waves as the wave form (the
//     sub-band folds: twice the SMs of R 32 at R 32's L2 traffic, half R
//     16's);
//   * the cluster form, `sweep_cluster_kernel` (below): a cluster of 16 CTAs
//     per tile of 16 rows, each owning 32 hidden units and pulling only its
//     gate columns' weights, h1 and h2 all-gathered each step through
//     distributed shared memory (FullSubNet's full-band folds of a few
//     tiles, where one CTA a tile would leave the card idle).
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
// H 512) 150,016 (bf16) and 231,936 (float32) at R 16. Launch: grid ceil(N / R) (the wave
// form: launches of at most that many), block H threads, dynamic shared memory
// shared_bytes_mma<T>(R, D, H).

#pragma once

#include <algorithm>

#include "lstm2_common.cuh"

namespace fwd {

using lstm2::AFrag;
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
using lstm2::from_f;
using lstm2::k_chunk;
using lstm2::mbar_arrive_expect;
using lstm2::mbar_init;
using lstm2::mbar_wait;
using lstm2::peer_address;
using lstm2::sigm;
using lstm2::SMEM_LIMIT;

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

// The wave form's carries of one row tile between its parts (`fwd_carry_bytes`
// in ops/lstm2.py): h1 and h2 [R][H] of T, then c1s and c2s [R * H] float32
template <typename T> __host__ __device__ inline size_t carry_bytes(int R, int H) {
  return (size_t)2 * R * H * (sizeof(T) + sizeof(float));
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

// the same bf16 pair at shared::cluster address `peer` (a word of a peer
// CTA's shared memory, mapa)
__device__ __forceinline__ void store_pair_peer(uint32_t peer, float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  asm volatile("st.shared::cluster.b32 [%0], %1;\n" ::"r"(peer),
               "r"(*reinterpret_cast<const uint32_t*>(&v)) : "memory");
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
// bf16 the rounded h) into hdst[row * ld + unit0], with kPeer also into the
// peer CTA's copy of that word (its shared::cluster address: this one's
// plus to_peer), and, with kSave, the residuals of the rows that exist (the
// activated gates at g_t[row * 4H + gate * H + unit], c and h at [row * H +
// unit]).
template <typename T, int MT, bool kSave, bool kPeer>
__device__ __forceinline__ void cell_mma(const float (&acc)[MT][4][4], float* __restrict__ cs,
                                         T* __restrict__ hdst, int ld, int unit0, int lane,
                                         T* __restrict__ g_t, T* __restrict__ c_t,
                                         T* __restrict__ h_t, int rows_here, int H,
                                         uint32_t to_peer) {
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
      T* hw = hdst + (size_t)row * ld + unit0;
      store_pair(hw, h[0], h[1]);
      if constexpr (kPeer)
        store_pair_peer((uint32_t)__cvta_generic_to_shared(hw) + to_peer, h[0], h[1]);
      if (kSave && row < rows_here) {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          store_pair(g_t + (size_t)row * 4 * H + gate * H + unit0, act[gate][0], act[gate][1]);
        store_pair(c_t + (size_t)row * H + unit0, c[0], c[1]);
        store_pair(h_t + (size_t)row * H + unit0, h[0], h[1]);
      }
    }
}

// One layer of a warp's PASSES unit groups ug0 .. ug0 + PASSES - 1 (the tile
// form: MMA_PASSES of them, units 32 warp .. 32 warp + 31), in passes of one
// unit group: its four gate n-tiles for every m-tile (B: the first one's
// word), then the cell. Each B fragment loaded from L2 feeds all MT m-tiles.
template <typename T, int MT, int PASSES, bool kSave, bool kPeer>
__device__ __forceinline__ void layer_mma(uint32_t a_addr, uint32_t m_stride,
                                          const uint4* __restrict__ B, size_t ns, int chunks,
                                          const uint4* __restrict__ B_next, size_t ns_next,
                                          uint4 (&b)[4], const float* __restrict__ bias,
                                          float* __restrict__ cs, T* __restrict__ hdst, int ld,
                                          int ug0, int lane, T* __restrict__ g_t,
                                          T* __restrict__ c_t, T* __restrict__ h_t,
                                          int rows_here, int H, uint32_t to_peer) {
#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    const int ug = ug0 + pass, unit0 = 8 * ug + 2 * (lane & 3);
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
    const bool last = pass + 1 == PASSES;
    mma_pass<T, MT>(acc, a_addr, m_stride, B + 4 * pass * ns, ns, chunks,
                    last ? B_next : B + 4 * (pass + 1) * ns, last ? ns_next : ns, b);
    cell_mma<T, MT, kSave, kPeer>(acc, cs + (size_t)pass * MT * 4 * 32, hdst, ld, unit0, lane,
                                  g_t, c_t, h_t, rows_here, H, to_peer);
  }
}

// y_t = h2_t W_fc + b_fc for the tile's rows, from h2 in an operand buffer:
// this warp computes n-tiles nt0, nt0 + stride, .. of the O columns over all
// H (the tile form: warp w, stride the warps), so nothing grows with O but
// the number of n-tiles.
template <typename T, int MT>
__device__ __forceinline__ void fc_mma(uint32_t a_addr, uint32_t m_stride,
                                       const uint4* __restrict__ fc, int chunks,
                                       const float* __restrict__ fcb, T* __restrict__ out, int n0,
                                       int t, int steps, int O, int rows_here, int nt0, int stride,
                                       int lane) {
  for (int nt = nt0; 8 * nt < O; nt += stride) {
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

// The sweep for a tile of R = 16 MT rows over the steps [t_lo, t_hi] of its
// work item (the tile form: one item of all the steps). Shared memory holds
// two operand buffers [R][x | h1 | h2 | pad] of T that alternate by step
// parity (b = t & 1):
//   layer 1 reads [x_t | h1_{t-1}] from buffer b and writes h1_t into
//     buffer b ^ 1; layer 2 reads [h1_t | h2_{t-1}] from buffer b ^ 1 and
//     writes h2_t into buffer b, and x_{t+1} is loaded into buffer b ^ 1;
//   the fc of step t - 1 reads h2_{t-1} from buffer b ^ 1 at the start of
//     step t.
// So no write lands on a word a warp may still read in the same phase, and a
// step needs two barriers. c1 and c2 sit in shared memory, each word private
// to its lane. After step t, h1_t lies in buffer (t + 1) & 1 and h2_t in
// buffer t & 1: what an item of the wave form stores into its tile's carry
// and the next part loads back before its first step. Each output word has
// one writer and each sum a fixed order: no atomics, the same bits on every
// run, at either R and in either form.
template <typename T, int MT, bool kSave, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
sweep_mma_kernel(const T* __restrict__ x,  // [T, N, D]
                 const MmaWeights wt, const float* __restrict__ fcb,
                 T* __restrict__ out,  // [N, T, O]
                 const Residuals<T> res,
                 unsigned char* __restrict__ carry,  // the wave form: [tiles][carry_bytes]
                 int n_rows, int steps, int D, int H, int O, int item0, int part_steps) {
  constexpr int R = 16 * MT, KC = k_chunk<T>();
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int xc = x_cols<T>(D), ld = operand_pitch<T>(D, H);
  T* ops = reinterpret_cast<T*>(smem_mma);                          // [2][R][ld]
  float* c1s = reinterpret_cast<float*>(ops + 2 * (size_t)R * ld);  // [R * H]
  float* c2s = c1s + (size_t)R * H;                                 // [R * H]

  const int j = threadIdx.x, warp = j >> 5, lane = j & 31, warps = H >> 5;
  // the work item: row tile `tile` over part `part` of part_steps steps
  const int tiles = (n_rows + R - 1) / R, item = item0 + blockIdx.x;
  const int part = item / tiles, tile = item - part * tiles;
  const int t_lo = part * part_steps, t_hi = min(steps, t_lo + part_steps) - 1;
  const int n0 = tile * R;
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
  // h1_t, h2_t (rows in buffers (t + 1) & 1 and t & 1) and the c words
  // between shared memory and the tile's carry, in 16-byte words (a row of
  // h, the operand pitch and the columns xc and xc + H are whole 16-byte
  // multiples)
  auto carries = [&](int t, bool store) {
    uint4* cw = reinterpret_cast<uint4*>(carry + (size_t)tile * carry_bytes<T>(R, H));
    const int hw = H * (int)sizeof(T) / 16;  // 16-byte words of a row of h
    for (int idx = j; idx < 2 * R * hw; idx += blockDim.x) {
      const int layer = idx / (R * hw), r = idx / hw % R;
      uint4* s = reinterpret_cast<uint4*>(ops + ((size_t)((t + 1 + layer) & 1) * R + r) * ld +
                                          xc + layer * H) + idx % hw;
      if (store) cw[idx] = *s; else *s = cw[idx];
    }
    uint4* cs = reinterpret_cast<uint4*>(c1s);
    cw += 2 * R * hw;
    for (int idx = j; idx < R * H / 2; idx += blockDim.x) {  // c1s and c2s: 2 R H words
      if (store) cw[idx] = cs[idx]; else cs[idx] = cw[idx];
    }
  };

  {  // zero both buffers (pads, h, c) before the first x tile
    uint32_t* words = reinterpret_cast<uint32_t*>(smem_mma);
    const size_t n_words = shared_bytes_mma<T>(R, D, H) / 4;
    for (size_t i = j; i < n_words; i += blockDim.x) words[i] = 0u;
  }
  __syncthreads();
  if (t_lo > 0) carries(t_lo - 1, false);  // a later part resumes from the earlier's carries
  if (t_lo <= t_hi) load_x(t_lo, ops + (size_t)(t_lo & 1) * R * ld);
  __syncthreads();

  uint4 b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __ldg(w1w + i * ns1);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int bb = t & 1;
    T* cur = ops + (size_t)bb * R * ld;
    T* nxt = ops + (size_t)(bb ^ 1) * R * ld;
    const size_t row0 = (size_t)t * n_rows + n0;  // this step's first row of the tile
    if (t > t_lo)  // the fc of step t_lo - 1 ran in the item before
      fc_mma<T, MT>(a_addr[bb ^ 1] + h2_col, m_stride, wt.fc + lane, kcf, fcb, out, n0, t - 1,
                    steps, O, rows_here, warp, warps, lane);
    // layer 1: [x_t | h1_{t-1}] [W1; U1] -> h1_t
    layer_mma<T, MT, MMA_PASSES, kSave, false>(
        a_addr[bb], m_stride, w1w, ns1, kc1, w2w, ns2, b, wt.b1, c1s + cwarp, nxt + xc, ld,
        MMA_PASSES * warp, lane, kSave ? res.g1 + row0 * 4 * H : nullptr,
        kSave ? res.c1 + row0 * H : nullptr, kSave ? res.h1 + row0 * H : nullptr, rows_here, H, 0);
    __syncthreads();  // h1_t is complete
    // layer 2: [h1_t | h2_{t-1}] [W2; U2] -> h2_t
    layer_mma<T, MT, MMA_PASSES, kSave, false>(
        a_addr[bb ^ 1] + h1_col, m_stride, w2w, ns2, kc2, w1w, ns1, b, wt.b2, c2s + cwarp,
        cur + xc + H, ld, MMA_PASSES * warp, lane, kSave ? res.g2 + row0 * 4 * H : nullptr,
        kSave ? res.c2 + row0 * H : nullptr, kSave ? res.h2 + row0 * H : nullptr, rows_here, H, 0);
    if (t < t_hi) load_x(t + 1, nxt);
    __syncthreads();  // h2_t and x_{t+1} are complete
  }
  if (t_lo <= t_hi) {
    fc_mma<T, MT>(a_addr[t_hi & 1] + h2_col, m_stride, wt.fc + lane, kcf, fcb, out, n0, t_hi,
                  steps, O, rows_here, warp, warps, lane);
    if (t_hi + 1 < steps) carries(t_hi, true);  // for the tile's next part
  }
}

// The tile form (part_steps 0): one launch, a CTA a row tile over all the
// steps. The wave form (part_steps > 0; the note at the top): the tiles x
// parts of part_steps steps as work items, part-major, in launches of as
// many CTAs as the card holds at once, but no more than the tiles, so every
// item's previous part ran in an earlier launch. carry: the wave form's
// [tiles][carry_bytes<T>(R, H)] scratch. A shape that needs more shared
// memory than a block has is refused.
template <typename T, int MT, bool kSave, int MAX_THREADS>
int launch_mma_tile(const void* x, const MmaWeights& wt, const void* fcb, void* out,
                    const Residuals<T>& res, void* carry, int n_rows, int steps, int D, int H,
                    int O, int part_steps, cudaStream_t stream) {
  constexpr int R = 16 * MT;
  const size_t smem = shared_bytes_mma<T>(R, D, H);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = sweep_mma_kernel<T, MT, kSave, MAX_THREADS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const T* xt = static_cast<const T*>(x);
  const float* fb = static_cast<const float*>(fcb);
  T* y = static_cast<T*>(out);
  unsigned char* cw = static_cast<unsigned char*>(carry);
  const int tiles = (n_rows + R - 1) / R;
  if (part_steps <= 0) {
    kernel<<<tiles, H, smem, stream>>>(xt, wt, fb, y, res, nullptr, n_rows, steps, D, H, O, 0,
                                       std::max(steps, 1));
    return (int)cudaGetLastError();
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, H, smem)) !=
          cudaSuccess)
    return (int)err;
  // a wave holds no more items than tiles, so an item's previous part (tiles
  // items back) ran in an earlier launch
  const int wave = std::min(sms * per_sm, tiles);
  const int items = tiles * ((steps + part_steps - 1) / part_steps);
  if (wave < 1) return (int)cudaErrorInvalidConfiguration;
  for (int item0 = 0; item0 < items; item0 += wave) {
    kernel<<<std::min(wave, items - item0), H, smem, stream>>>(xt, wt, fb, y, res, cw, n_rows,
                                                                steps, D, H, O, item0, part_steps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, int MT, bool kSave>
int launch_mma_rows(const void* x, const MmaWeights& wt, const void* fcb, void* out,
                    const Residuals<T>& res, void* carry, int n_rows, int steps, int D, int H,
                    int O, int part_steps, cudaStream_t stream) {
  return H <= 384 ? launch_mma_tile<T, MT, kSave, 384>(x, wt, fcb, out, res, carry, n_rows, steps,
                                                       D, H, O, part_steps, stream)
                  : launch_mma_tile<T, MT, kSave, 512>(x, wt, fcb, out, res, carry, n_rows, steps,
                                                       D, H, O, part_steps, stream);
}

// The sweep always takes the tensor-core kernel; rows is its row tile: 16 or
// 32 (one or two m16 tiles) in bf16, 16 in float32; part_steps 0 for the tile
// form, the steps of a work item for the wave form. A refused launch returns
// its error.
template <typename T, bool kSave>
int launch_mma(const void* x, const MmaWeights& wt, const void* fcb, void* out,
               const Residuals<T>& res, void* carry, int n_rows, int steps, int D, int H, int O,
               int rows, int part_steps, cudaStream_t stream) {
  if (wt.w1 == nullptr || wt.w2 == nullptr || wt.fc == nullptr || wt.b1 == nullptr ||
      wt.b2 == nullptr)
    return (int)cudaErrorInvalidValue;
  if (rows == 16)
    return launch_mma_rows<T, 1, kSave>(x, wt, fcb, out, res, carry, n_rows, steps, D, H, O,
                                        part_steps, stream);
  if constexpr (sizeof(T) == 2) {
    if (rows == 32)
      return launch_mma_rows<T, 2, kSave>(x, wt, fcb, out, res, carry, n_rows, steps, D, H, O,
                                          part_steps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The pair form, `sweep_pair_kernel<T, kSave, MAX_THREADS>` (bf16): the tile
// form's R 32 sweep (two m-tiles) split over a cluster of two CTAs, so each
// pulls half the weights from L2 a step and a fold fills twice the SMs of
// R 32 at the L2 traffic of R 32. CTA rank c owns the H / 2 hidden units
// 8u .. 8u + 7 of unit groups u = (H / 16) c .. (H / 16)(c + 1) - 1 of both
// layers, all four gates of each (their gate-interleaved n-tiles of the
// packed w1 and w2, nothing else of them); warp w of the H / 32 owns unit
// groups (H / 16) c + 2w and + 1, in PAIR_PASSES passes of the tile form's
// `layer_mma`. So each warp issues as many mma.sync a step as a warp of R 16
// (two m-tiles in two passes, not one in four) and loads half its weight
// fragments.
//   * Both CTAs keep the tile's whole operand rows [x | h1 | h2] in the
//     tile form's two parity buffers (each product contracts over all H
//     units), and c1 and c2 of their own units. After a layer's cells each
//     lane writes its h pairs into its own buffer and into the peer's
//     (st.shared::cluster, 12 KB a layer and step at H 384), and a cluster
//     barrier (release / acquire) takes the place of each of the tile form's
//     two __syncthreads: the two CTAs run in lockstep phases, so the
//     tile form's buffer discipline holds across the pair. Each CTA loads
//     x_{t+1} into its own buffer.
//   * Every (row, unit) gate sum runs the R 32 tile form's mma.sync chain in
//     its k order, and the fc's n-tile nt runs on rank nt % 2 (warp nt / 2
//     mod the warps) with the tile form's chain, so y and every residual are
//     the R 32 tile form's bit for bit; each CTA stores only its own units'
//     residuals and its own fc columns, so each word has one writer.
//   * The wave form (PAIR_WAVE_FORM): the same kernel over items of (row
//     tile, part of part_steps steps) as `launch_mma_tile` orders them, a
//     cluster an item, in launches of as many clusters as the card holds at
//     once (cudaOccupancyMaxActiveClusters; the GPCs may hold fewer pairs
//     than half the SMs) but no more than the tiles. The tile's carry is the
//     tile form's (`carry_bytes`): each CTA stores its own half of each h
//     row and its own c words (rank c's at [2 R H (T)] + c R H floats) and
//     loads whole h rows back.
// Shared memory at D 34, H 384: two operand buffers [32][840] bf16 and c1,
// c2 [32][192] float32, 156,672 bytes (D 32: 152,576). Launch: grid 2 x the
// tiles (the wave form: 2 x at most that many), clusters of 2, block H
// threads, dynamic shared memory pair_shared_bytes<T>(D, H).

constexpr int PAIR_CTAS = 2;    // FWD_PAIR_CTAS in ops/lstm2.py: CTAs of a cluster
constexpr int PAIR_MT = 2;      // m-tiles of a pair's row tile: FWD_PAIR_ROWS = 32 rows
constexpr int PAIR_PASSES = 2;  // unit groups of 8 a warp owns: H / 32 warps x 2 x 8 = H / 2

// `fwd_pair_shared_memory_bytes` in ops/lstm2.py: the tile form's two
// operand buffers at R 32, and c1, c2 of a CTA's H / 2 units
template <typename T> __host__ __device__ inline size_t pair_shared_bytes(int D, int H) {
  constexpr int R = 16 * PAIR_MT;
  return sizeof(T) * 2 * (size_t)R * operand_pitch<T>(D, H) +
         sizeof(float) * 2 * (size_t)R * (H / PAIR_CTAS);
}

// Whether the pair form runs at this shape: bf16, H a multiple of 32 (H / 2
// whole unit groups for whole warps) up to 512, and a CTA's shared memory
// fits a block. The caller chooses the form (`fwd_sweep_pair` in
// ops/lstm2.py); a launch of the pair form where this is false returns an
// error.
template <typename T> inline bool pair_runs(int D, int H) {
  return sizeof(T) == 2 && H % 32 == 0 && H <= 512 && pair_shared_bytes<T>(D, H) <= SMEM_LIMIT;
}

// the cluster barrier whole: this thread's earlier writes (its stores into
// the peer's shared memory too) are seen by every thread of the cluster
// after it
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

template <typename T, bool kSave, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
sweep_pair_kernel(const T* __restrict__ x,  // [T, N, D]
                  const MmaWeights wt, const float* __restrict__ fcb,
                  T* __restrict__ out,  // [N, T, O]
                  const Residuals<T> res,
                  unsigned char* __restrict__ carry,  // the wave form: [tiles][carry_bytes]
                  int n_rows, int steps, int D, int H, int O, int item0, int part_steps) {
  constexpr int MT = PAIR_MT, R = 16 * MT, KC = k_chunk<T>();
  extern __shared__ __align__(16) unsigned char smem_pair[];
  const int xc = x_cols<T>(D), ld = operand_pitch<T>(D, H), HU = H / PAIR_CTAS;
  T* ops = reinterpret_cast<T*>(smem_pair);                          // [2][R][ld]
  float* c1s = reinterpret_cast<float*>(ops + 2 * (size_t)R * ld);  // [R * HU]
  float* c2s = c1s + (size_t)R * HU;                                // [R * HU]

  const int c = (int)cluster_ctarank();
  const int j = threadIdx.x, warp = j >> 5, lane = j & 31, warps = H >> 5;
  // the work item: row tile `tile` over part `part` of part_steps steps
  const int tiles = (n_rows + R - 1) / R, item = item0 + (int)cluster_idx();
  const int part = item / tiles, tile = item - part * tiles;
  const int t_lo = part * part_steps, t_hi = min(steps, t_lo + part_steps) - 1;
  const int n0 = tile * R;
  const int rows_here = min(R, n_rows - n0);
  const int kc1 = (xc + H) / KC, kc2 = 2 * H / KC, kcf = H / KC;
  const size_t ns1 = (size_t)kc1 * 32, ns2 = (size_t)kc2 * 32;  // words between n-tiles
  const uint32_t m_stride = sizeof(T) * 16 * ld;  // bytes between m-tiles
  uint32_t a_addr[2];  // this lane's ldmatrix address in each buffer, column 0
#pragma unroll
  for (int bb = 0; bb < 2; ++bb)
    a_addr[bb] = (uint32_t)__cvta_generic_to_shared(ops + ((size_t)bb * R + (lane & 15)) * ld) +
                 16 * (lane >> 4);
  // the warp's unit groups and first n-tile (its first unit group, gate i) of each layer
  const int ug0 = (H / 16) * c + PAIR_PASSES * warp;
  const uint4* w1w = wt.w1 + (size_t)4 * ug0 * ns1 + lane;
  const uint4* w2w = wt.w2 + (size_t)4 * ug0 * ns2 + lane;
  const size_t cwarp = (size_t)warp * PAIR_PASSES * MT * 4 * 32;  // the warp's c words
  const uint32_t h1_col = sizeof(T) * xc, h2_col = sizeof(T) * (xc + H);  // bytes
  // a word of the operand buffers in the peer's shared memory: its address
  // here plus to_peer
  const uint32_t ops_here = (uint32_t)__cvta_generic_to_shared(ops);
  const uint32_t to_peer = peer_address(ops_here, (uint32_t)(c ^ 1)) - ops_here;

  auto load_x = [&](int t, T* dst) {  // x_t into dst's x columns; rows past N stay zero
    const T* xt = x + ((size_t)t * n_rows + n0) * D;
    for (int idx = j; idx < rows_here * D; idx += blockDim.x) {
      const int r = idx / D;
      dst[(size_t)r * ld + idx - r * D] = xt[idx];
    }
  };
  // h1_t, h2_t (rows in buffers (t + 1) & 1 and t & 1) and this CTA's c
  // words between shared memory and the tile's carry, in 16-byte words: a
  // store writes this CTA's half of each h row, a load reads whole rows
  auto carries = [&](int t, bool store) {
    uint4* cw = reinterpret_cast<uint4*>(carry + (size_t)tile * carry_bytes<T>(R, H));
    const int hw = H * (int)sizeof(T) / 16;  // 16-byte words of a row of h
    const int span = store ? hw / PAIR_CTAS : hw, first = store ? c * span : 0;
    for (int idx = j; idx < 2 * R * span; idx += blockDim.x) {
      const int layer = idx / (R * span), r = idx / span % R, word = first + idx % span;
      uint4* s = reinterpret_cast<uint4*>(ops + ((size_t)((t + 1 + layer) & 1) * R + r) * ld +
                                          xc + layer * H) + word;
      uint4* g = cw + (size_t)(layer * R + r) * hw + word;
      if (store) *g = *s; else *s = *g;
    }
    uint4* cs = reinterpret_cast<uint4*>(c1s);
    cw += 2 * R * hw + (size_t)c * R * HU / 2;  // this CTA's c1s and c2s: 2 R HU floats
    for (int idx = j; idx < R * HU / 2; idx += blockDim.x) {
      if (store) cw[idx] = cs[idx]; else cs[idx] = cw[idx];
    }
  };

  {  // zero both buffers (pads, h, c) before the first x tile
    uint32_t* words = reinterpret_cast<uint32_t*>(smem_pair);
    const size_t n_words = pair_shared_bytes<T>(D, H) / 4;
    for (size_t i = j; i < n_words; i += blockDim.x) words[i] = 0u;
  }
  __syncthreads();
  if (t_lo > 0) carries(t_lo - 1, false);  // a later part resumes from the earlier's carries
  if (t_lo <= t_hi) load_x(t_lo, ops + (size_t)(t_lo & 1) * R * ld);
  cluster_sync();  // both CTAs run and have set their buffers before any h crosses

  uint4 b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __ldg(w1w + i * ns1);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int bb = t & 1;
    T* cur = ops + (size_t)bb * R * ld;
    T* nxt = ops + (size_t)(bb ^ 1) * R * ld;
    const size_t row0 = (size_t)t * n_rows + n0;  // this step's first row of the tile
    if (t > t_lo)  // the fc of step t_lo - 1 ran in the item before
      fc_mma<T, MT>(a_addr[bb ^ 1] + h2_col, m_stride, wt.fc + lane, kcf, fcb, out, n0, t - 1,
                    steps, O, rows_here, PAIR_CTAS * warp + c, PAIR_CTAS * warps, lane);
    // layer 1: [x_t | h1_{t-1}] [W1; U1] -> this CTA's units of h1_t, in both CTAs
    layer_mma<T, MT, PAIR_PASSES, kSave, true>(
        a_addr[bb], m_stride, w1w, ns1, kc1, w2w, ns2, b, wt.b1, c1s + cwarp, nxt + xc, ld, ug0,
        lane, kSave ? res.g1 + row0 * 4 * H : nullptr, kSave ? res.c1 + row0 * H : nullptr,
        kSave ? res.h1 + row0 * H : nullptr, rows_here, H, to_peer);
    cluster_sync();  // h1_t is complete in both CTAs
    // layer 2: [h1_t | h2_{t-1}] [W2; U2] -> this CTA's units of h2_t, in both CTAs
    layer_mma<T, MT, PAIR_PASSES, kSave, true>(
        a_addr[bb ^ 1] + h1_col, m_stride, w2w, ns2, kc2, w1w, ns1, b, wt.b2, c2s + cwarp,
        cur + xc + H, ld, ug0, lane, kSave ? res.g2 + row0 * 4 * H : nullptr,
        kSave ? res.c2 + row0 * H : nullptr, kSave ? res.h2 + row0 * H : nullptr, rows_here, H,
        to_peer);
    if (t < t_hi) load_x(t + 1, nxt);
    cluster_sync();  // h2_t (in both CTAs) and x_{t+1} are complete
  }
  if (t_lo <= t_hi) {  // nothing crosses any more: the rest is this CTA's own
    fc_mma<T, MT>(a_addr[t_hi & 1] + h2_col, m_stride, wt.fc + lane, kcf, fcb, out, n0, t_hi,
                  steps, O, rows_here, PAIR_CTAS * warp + c, PAIR_CTAS * warps, lane);
    if (t_hi + 1 < steps) carries(t_hi, true);  // for the tile's next part
  }
}

// The pair form in one launch (part_steps 0: a cluster a row tile over all
// the steps) or in waves (part_steps > 0, carry the [tiles][carry_bytes<T>(32,
// H)] scratch: items part-major in launches of min(the clusters the card
// holds at once, tiles) clusters). A shape `pair_runs` refuses, or a launch
// the card refuses, returns its error.
template <typename T, bool kSave, int MAX_THREADS>
struct PairLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = {};
  cudaError_t err;
  // the kernel's shared memory set, and a launch of `tiles` clusters of
  // PAIR_CTAS CTAs of H threads
  PairLaunch(int D, int H, int tiles, cudaStream_t stream) {
    const size_t smem = pair_shared_bytes<T>(D, H);
    err = cudaFuncSetAttribute(sweep_pair_kernel<T, kSave, MAX_THREADS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = PAIR_CTAS;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(PAIR_CTAS * tiles);
    cfg.blockDim = dim3(H);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  // the clusters of this launch the card holds at once
  cudaError_t capacity(int* clusters) const {
    return err != cudaSuccess ? err
                              : cudaOccupancyMaxActiveClusters(
                                    clusters, sweep_pair_kernel<T, kSave, MAX_THREADS>, &cfg);
  }
};

template <typename T, bool kSave, int MAX_THREADS>
int launch_pair_threads(const void* x, const MmaWeights& wt, const void* fcb, void* out,
                        const Residuals<T>& res, void* carry, int n_rows, int steps, int D,
                        int H, int O, int part_steps, cudaStream_t stream) {
  auto kernel = sweep_pair_kernel<T, kSave, MAX_THREADS>;
  const int tiles = (n_rows + 16 * PAIR_MT - 1) / (16 * PAIR_MT);
  PairLaunch<T, kSave, MAX_THREADS> launch(D, H, tiles, stream);
  cudaLaunchConfig_t& cfg = launch.cfg;
  cudaError_t err = launch.err;
  if (err != cudaSuccess) return (int)err;
  const T* xt = static_cast<const T*>(x);
  const float* fb = static_cast<const float*>(fcb);
  T* y = static_cast<T*>(out);
  unsigned char* cw = static_cast<unsigned char*>(carry);
  if (part_steps <= 0) {
    err = cudaLaunchKernelEx(&cfg, kernel, xt, wt, fb, y, res, static_cast<unsigned char*>(nullptr),
                             n_rows, steps, D, H, O, 0, std::max(steps, 1));
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
  int clusters = 0;
  if ((err = launch.capacity(&clusters)) != cudaSuccess) return (int)err;
  // a wave holds no more items than tiles, so an item's previous part (tiles
  // items back) ran in an earlier launch
  const int wave = std::min(clusters, tiles);
  const int items = tiles * ((steps + part_steps - 1) / part_steps);
  if (wave < 1) return (int)cudaErrorInvalidConfiguration;
  for (int item0 = 0; item0 < items; item0 += wave) {
    cfg.gridDim = dim3(PAIR_CTAS * std::min(wave, items - item0));
    if ((err = cudaLaunchKernelEx(&cfg, kernel, xt, wt, fb, y, res, cw, n_rows, steps, D, H, O,
                                  item0, part_steps)) != cudaSuccess)
      return (int)err;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// The clusters of the pair form (bf16, the kernel with or without kSave)
// the card holds at once at this shape, into *clusters; a shape `pair_runs`
// refuses returns an error.
template <bool kSave> int pair_capacity(int D, int H, int* clusters) {
  using T = __nv_bfloat16;
  if (!pair_runs<T>(D, H)) return (int)cudaErrorInvalidValue;
  return H <= 384 ? (int)PairLaunch<T, kSave, 384>(D, H, 1, nullptr).capacity(clusters)
                  : (int)PairLaunch<T, kSave, 512>(D, H, 1, nullptr).capacity(clusters);
}

template <typename T, bool kSave>
int launch_pair(const void* x, const MmaWeights& wt, const void* fcb, void* out,
                const Residuals<T>& res, void* carry, int n_rows, int steps, int D, int H, int O,
                int part_steps, cudaStream_t stream) {
  if (!pair_runs<T>(D, H)) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2)
    return H <= 384 ? launch_pair_threads<T, kSave, 384>(x, wt, fcb, out, res, carry, n_rows,
                                                         steps, D, H, O, part_steps, stream)
                    : launch_pair_threads<T, kSave, 512>(x, wt, fcb, out, res, carry, n_rows,
                                                         steps, D, H, O, part_steps, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The cluster form, `sweep_cluster_kernel<T, kSave>`: for folds of a few row
// tiles (FullSubNet's full-band LSTM: N 8 in a batch of 8, N 18 in training,
// at D 257, H 512, O 257), where one CTA a tile leaves the card idle and
// every step waits on one SM pulling all the weight fragments from L2 ([W1;
// U1] and [W2; U2]: 15.4 MB in float32, 7.7 in bf16, a tile and step). Each
// tile of 16 rows gets a cluster of C = H / 32 CTAs (16 at H 512); CTA rank c
// owns the U = 32 hidden units [cU, (c + 1) U) of both layers, unit groups 4c
// .. 4c + 3 (what warp c owns in the tile form), and reads only their 16
// gate-interleaved n-tiles of the packed w1 and w2 (0.93 MB a step in
// float32, 0.47 in bf16):
//   * the products on the tensor cores as in the tile form (mma.sync,
//     AFrag<T>), the K of each split over the CTA's warps: warp w runs
//     k-part w % KP of unit group w / KP (its four gate n-tiles), the k-parts
//     add their partials [KP][4][16][U + 8] in k-part order onto the bias,
//     and thread (warp r, lane u) runs the cell of row r, unit cU + u from
//     the sums, with its c carry in a register;
//   * the exchange: each product contracts over all H units of h1 or h2, so
//     each CTA keeps the tile's whole h1 and h2, owner-major: block o (the
//     units of CTA o) is [16][U + pad] of T (the pad of 16 bytes keeps the
//     row pitch an odd multiple of 16 bytes, so ldmatrix is free of bank
//     conflicts; a k-chunk of 64 bytes lies in one block). After a cell a
//     CTA writes its block, then one thread copies it whole into every
//     peer's copy with the Tensor Memory Accelerator (cp.async.bulk
//     shared::cta -> shared::cluster, 2,304 bytes in float32, 1,280 in
//     bf16), each copy completing its bytes on the peer's mbarrier for that
//     layer, step parity and owner. A k-part's h chunks run owner-major, and
//     the warp waits for an owner's mbarrier only when its chunks reach that
//     block;
//   * the overlap the recurrence leaves: layer 2 at step t reads [h1_t |
//     h2_{t-1}], so it runs its chunks over h2_{t-1} (exchanged during layer
//     1) first and h1_t's as each owner arrives; layer 1 at t + 1 reads
//     [x_{t+1} | h1_t], not h2_t, so h2_t's exchange runs under it; the fc of
//     step t - 1 rides on layer 2's chunks over h2_{t-1} (the same A
//     fragments, one more n-tile: CTA c owns the fc n-tiles c, c + C, ..,
//     the one of index i taken by the warps of unit group i); x_{t+1} is
//     loaded during step t (one x buffer: layer 1 has read x_t by then);
//   * the blocks alternate by step parity, so a copy overwrites the block of
//     step t - 2: a CTA arrives on the cluster barrier (release) once it has
//     read h1_{t-1} and h2_{t-1} (after layer 2 of step t) and waits on it
//     (acquire) before it sends h1_{t+1}, half a step later. A CTA writes its
//     own block again two steps on, once its copies have read it (thread 0
//     waits for all but its latest bulk group each step).
// Each output word has one writer and each sum a fixed order; no atomics,
// the same bits on every run. K1 and K2 run the same code, so their y is
// equal bit for bit. Shared memory at D 257, H 512, C 16: the mbarriers
// (512 bytes), the h blocks (147,456 bytes in float32, 81,920 in bf16), x
// [16][x_cols + pad] (17,664 / 9,472), the partials (40,960) and the fc's
// [4][KP][16][8] (8,192): 214,784 / 141,056 bytes.

constexpr int CL_ROWS = 16;       // the row tile: one m16 tile
constexpr int CL_UNITS = 32;      // hidden units a CTA owns: a lane a unit in the cells
constexpr int CL_THREADS = 512;   // 16 warps: a warp a row in the cells
constexpr int CL_KPARTS = 4;      // k-parts of each product: warps = 4 unit groups x 4 k-parts
constexpr int CL_FC_TILES = 4;    // fc n-tiles a CTA may own: one a unit group's warps
constexpr int CL_PAD_BYTES = 16;  // pad of an h block's or x's row
constexpr int CL_PART_LD = CL_UNITS + 8;  // a gate partial's row: half-warps' stores 8 banks apart
constexpr int CL_FC_LD = 8;       // a row of an fc partial
constexpr int CLUSTER_SIZE = 16;  // FWD_CLUSTER in ops/lstm2.py: CTAs of a cluster, H = 16 x 32

// elements of a row of an owner's h block, and of the x tile
template <typename T> __host__ __device__ constexpr int cl_block_pitch() {
  return CL_UNITS + CL_PAD_BYTES / (int)sizeof(T);
}
template <typename T> __host__ __device__ inline int cl_x_pitch(int D) {
  return x_cols<T>(D) + CL_PAD_BYTES / (int)sizeof(T);
}

// `fwd_cluster_shared_memory_bytes` in ops/lstm2.py: an 8-byte mbarrier a
// layer, step parity and owner; the h blocks [2 layers][2 parities][C][16]
// [block pitch] of T; the x tile [16][x pitch] of T; float32 the partials
// [KP][4 gates][16][CL_PART_LD] and the fc's [CL_FC_TILES][KP][16][CL_FC_LD]
template <typename T> __host__ __device__ inline size_t cluster_shared_bytes(int D, int H) {
  const int C = H / CL_UNITS;
  return 8 * 4 * (size_t)C +
         sizeof(T) * ((size_t)4 * C * CL_ROWS * cl_block_pitch<T>() +
                      (size_t)CL_ROWS * cl_x_pitch<T>(D)) +
         sizeof(float) * ((size_t)CL_KPARTS * 4 * CL_ROWS * CL_PART_LD +
                          (size_t)CL_FC_TILES * CL_KPARTS * CL_ROWS * CL_FC_LD);
}

// Whether the cluster form runs at this shape: H = CLUSTER_SIZE x 32, D <= H
// (x_{t+1} staged at most 16 words a thread), at most CL_FC_TILES fc n-tiles
// a CTA, and a CTA's shared memory fits a block. The caller chooses the form
// (`fwd_sweep_cluster` in ops/lstm2.py); a launch of the cluster form where
// this is false returns an error.
template <typename T> inline bool cluster_runs(int D, int H, int O) {
  return H == CLUSTER_SIZE * CL_UNITS && D <= H && (O + 7) / 8 <= CL_FC_TILES * CLUSTER_SIZE &&
         cluster_shared_bytes<T>(D, H) <= SMEM_LIMIT;
}

// acc[g] += A . B[n-tile g] for a warp's four gate n-tiles (ns words apart)
// over its chunks v = 0 .. n - 1 in order, and, with kFc, facc += A . F for v
// < fc_chunks (the same A fragments). Chunk v: B's and F's k-chunk kc_of(v)
// (F's chunk v), A at a_of(v), wait(v) before A is read. Each chunk's
// fragments load while the previous chunk's products run. B, F: this lane's
// word of n-tile 0, k-chunk 0.
template <typename T, bool kFc, typename KcOf, typename AOf, typename Wait>
__device__ __forceinline__ void cl_products(float (&acc)[4][4], float (&facc)[4],
                                            const uint4* __restrict__ B, size_t ns,
                                            const uint4* __restrict__ F, int fc_chunks, int n,
                                            KcOf kc_of, AOf a_of, Wait wait) {
  uint4 b[4], f = make_uint4(0u, 0u, 0u, 0u);
  {
    const size_t k = (size_t)kc_of(0) * 32;
#pragma unroll
    for (int g = 0; g < 4; ++g) b[g] = __ldg(B + k + g * ns);
    if (kFc && fc_chunks > 0) f = __ldg(F);
  }
#pragma unroll 2
  for (int v = 0; v < n; ++v) {
    const int vn = min(v + 1, n - 1);
    const size_t kn = (size_t)kc_of(vn) * 32;
    uint4 nb[4], nf = f;
#pragma unroll
    for (int g = 0; g < 4; ++g) nb[g] = __ldg(B + kn + g * ns);
    if (kFc && vn < fc_chunks) nf = __ldg(F + (size_t)vn * 32);
    wait(v);
    AFrag<T> a;
    a.load(a_of(v));
#pragma unroll
    for (int g = 0; g < 4; ++g) a.mma(acc[g], b[g]);
    if (kFc && v < fc_chunks) a.mma(facc, f);
#pragma unroll
    for (int g = 0; g < 4; ++g) b[g] = nb[g];
    f = nf;
  }
}

// A warp's accumulators of one m16n8 tile into a partial of row pitch ld:
// lane (g, q) holds rows g and g + 8, columns 2q and 2q + 1
__device__ __forceinline__ void cl_store_tile(const float (&acc)[4], float* dst, int ld,
                                              int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
    *reinterpret_cast<float2*>(dst + ((lane >> 2) + 8 * half) * ld + 2 * (lane & 3)) =
        make_float2(acc[2 * half], acc[2 * half + 1]);
}

template <typename T, bool kSave>
__global__ void __launch_bounds__(CL_THREADS, 1)
sweep_cluster_kernel(const T* __restrict__ x,  // [T, N, D]
                     const MmaWeights wt, const float* __restrict__ fcb,
                     T* __restrict__ out,  // [N, T, O]
                     const Residuals<T> res, int n_rows, int steps, int D, int H, int O) {
  constexpr int R = CL_ROWS, U = CL_UNITS, KP = CL_KPARTS, KC = k_chunk<T>();
  constexpr int S = U / KC;  // k-chunks of a block row: 2 in float32, 1 in bf16
  constexpr int BP = cl_block_pitch<T>(), PLD = CL_PART_LD;
  constexpr int XR = R * 512 / CL_THREADS;  // x words a thread stages: D <= H <= 512
  extern __shared__ __align__(16) unsigned char smem_cl[];
  const int C = (int)cluster_nctarank(), c = (int)cluster_ctarank(), tile = (int)cluster_idx();
  const int xc = x_cols<T>(D), xp = cl_x_pitch<T>(D), G = 4 * H;
  const uint32_t block_bytes = (uint32_t)(sizeof(T) * R * BP);
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem_cl);
  T* hblk = reinterpret_cast<T*>(smem_cl + 8 * 4 * C);  // [2 layers][2 parities][C][R][BP]
  T* xs = hblk + (size_t)4 * C * R * BP;                // [R][xp]
  float* part = reinterpret_cast<float*>(xs + (size_t)R * xp);  // [KP][4][R][PLD]
  float* fcpart = part + KP * 4 * R * PLD;                       // [CL_FC_TILES][KP][R][CL_FC_LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kp = warp % KP, ug = warp / KP;  // products: k-part kp of unit group ug
  const int r = warp, unit = c * U + lane;   // cells: row r, unit cU + lane
  const int n0 = tile * R;
  const int rows_here = min(R, n_rows - n0);
  const bool live = r < rows_here;
  const int xch = xc / KC, hch = H / KC;         // k-chunks of x and of h
  const int kc1 = xch + hch, kc2 = 2 * hch;      // of [W1; U1] and [W2; U2]
  const int x0 = kp * xch / KP, nx = (kp + 1) * xch / KP - x0;  // this k-part's x chunks
  const int q0 = kp * hch / KP, nh = (kp + 1) * hch / KP - q0;  // its h chunks, owner q / S
  const size_t ns1 = (size_t)kc1 * 32, ns2 = (size_t)kc2 * 32;
  const int nt0 = 4 * (4 * c + ug);  // the warp's first gate n-tile: unit group 4c + ug, gate i
  const uint4* w1w = wt.w1 + nt0 * ns1 + lane;
  const uint4* w2w = wt.w2 + nt0 * ns2 + lane;
  const int fnt = c + C * ug;  // this warp's fc n-tile, where it exists
  const bool has_fc = ug < CL_FC_TILES && 8 * fnt < O;
  const uint4* fcw = wt.fc + (size_t)(has_fc ? fnt : 0) * hch * 32 + lane;
  const uint32_t hbase = (uint32_t)__cvta_generic_to_shared(hblk);
  const uint32_t lane_blk = (uint32_t)(((lane & 15) * BP) * (int)sizeof(T) + 16 * (lane >> 4));
  const uint32_t xbase = (uint32_t)__cvta_generic_to_shared(xs) +
                         (uint32_t)(((lane & 15) * xp) * (int)sizeof(T) + 16 * (lane >> 4));
  auto blk = [&](int layer, int parity, int o) {  // bytes from hblk to a block
    return (uint32_t)(((2 * layer + parity) * C + o) * block_bytes);
  };
  auto bar = [&](int layer, int parity, int o) {
    return bars + 8u * (uint32_t)((2 * layer + parity) * C + o);
  };
  auto arm = [&](int layer, int parity) {  // thread 0: one block from each peer, next phase
    for (int o = 0; o < C; ++o)
      if (o != c) mbar_arrive_expect(bar(layer, parity, o), block_bytes);
  };
  auto send = [&](int layer, int parity) {  // thread 0: this CTA's block to every peer
    const uint32_t src = hbase + blk(layer, parity, c), b = bar(layer, parity, c);
    for (int k = 1; k < C; ++k) {
      const uint32_t peer = (uint32_t)((c + k) % C);
      copy_to_peer(peer_address(src, peer), src, block_bytes, peer_address(b, peer));
    }
    bulk_commit();
  };
  auto store_acc = [&](const float (&acc)[4][4]) {  // into k-part kp's partial
#pragma unroll
    for (int g = 0; g < 4; ++g)
      cl_store_tile(acc[g], part + ((size_t)(kp * 4 + g) * R) * PLD + 8 * ug, PLD, lane);
  };
  auto store_fc = [&](const float (&facc)[4]) {
    cl_store_tile(facc, fcpart + ((size_t)(ug * KP + kp) * R) * CL_FC_LD, CL_FC_LD, lane);
  };
  auto fc_out = [&](int ts) {  // y_ts from the fc partials: a thread a word
    for (int idx = tid; idx < CL_FC_TILES * R * CL_FC_LD; idx += CL_THREADS) {
      const int i = idx / (R * CL_FC_LD), row = idx / CL_FC_LD % R, col = idx % CL_FC_LD;
      const int o = 8 * (c + C * i) + col;
      if (row < rows_here && o < O) {
        const float* pp = fcpart + ((size_t)i * KP * R + row) * CL_FC_LD + col;
        float s = pp[0];
#pragma unroll
        for (int k = 1; k < KP; ++k) s += pp[(size_t)k * R * CL_FC_LD];
        out[((size_t)(n0 + row) * steps + ts) * O + o] = from_f<T>(s + fcb[o]);
      }
    }
  };
  // the cell of (row r, unit) from the partials: h into this CTA's block of
  // (layer, parity), the residuals of a row that exists
  float bias[2][4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int col = 32 * (4 * c + (lane >> 3)) + 8 * g + (lane & 7);  // gate-interleaved
    bias[0][g] = wt.b1[col];
    bias[1][g] = wt.b2[col];
  }
  auto cell = [&](int layer, int parity, float& cw, size_t row0, T* g_t, T* c_t, T* h_t) {
    float act[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float s = bias[layer][g];
#pragma unroll
      for (int k = 0; k < KP; ++k) s += part[((size_t)(k * 4 + g) * R + r) * PLD + lane];
      act[g] = g == 2 ? tanhf(s) : sigm(s);
    }
    cw = act[1] * cw + act[0] * act[2];
    const float h = act[3] * tanhf(cw);
    hblk[(size_t)((2 * layer + parity) * C + c) * R * BP + r * BP + lane] = from_f<T>(h);
    if (kSave && live) {
      const size_t row = row0 + r;
#pragma unroll
      for (int g = 0; g < 4; ++g) g_t[row * G + g * H + unit] = from_f<T>(act[g]);
      c_t[row * H + unit] = from_f<T>(cw);
      h_t[row * H + unit] = from_f<T>(h);
    }
  };

  {  // zero the blocks (h_{-1}, the pads), x (its pad columns and the rows past N) and the partials
    uint32_t* words = reinterpret_cast<uint32_t*>(smem_cl + 8 * 4 * C);
    const size_t n_words = (cluster_shared_bytes<T>(D, H) - 8 * 4 * C) / 4;
    for (size_t i = tid; i < n_words; i += CL_THREADS) words[i] = 0u;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < 4 * C; ++i) mbar_init(bars + 8u * i, 1);
    arm(0, 0);  // h1_0
    arm(0, 1);  // h1_1
    arm(1, 0);  // h2_0 (h2_1's at the end of step 0)
  }
  if (steps > 0) {  // x_0
    const T* xt = x + (size_t)n0 * D;
    for (int idx = tid; idx < rows_here * D; idx += CL_THREADS) {
      const int rr = idx / D;
      xs[(size_t)rr * xp + idx - rr * D] = xt[idx];
    }
  }
  __syncthreads();
  cluster_arrive();  // pairs with step 0's wait: the peers' mbarriers are set

  float c1 = 0.0f, c2 = 0.0f;
  for (int t = 0; t < steps; ++t) {
    const int p = t & 1, pq = p ^ 1;  // this step's blocks, the last step's
    const size_t row0 = (size_t)t * n_rows + n0;
    {  // layer 1: [x_t | h1_{t-1}] [W1; U1], x chunks then h1 chunks, all here
      float acc[4][4] = {}, facc[4] = {};
      cl_products<T, false>(
          acc, facc, w1w, ns1, nullptr, 0, nx + nh,
          [&](int v) { return v < nx ? x0 + v : xch + q0 + v - nx; },
          [&](int v) {
            const int q = q0 + v - nx;
            return v < nx ? xbase + (uint32_t)((x0 + v) * CHUNK_BYTES)
                          : hbase + blk(0, pq, q / S) + lane_blk +
                                (uint32_t)((q % S) * CHUNK_BYTES);
          },
          [](int) {});
      store_acc(acc);
    }
    __syncthreads();  // layer 1's partials are in
    T xv[XR];         // x_{t+1}, staged through registers while the cell runs
    const bool more = t + 1 < steps;
    const T* xt = x + ((size_t)(t + 1) * n_rows + n0) * D;
    if (more) {
#pragma unroll
      for (int k = 0; k < XR; ++k) {
        const int idx = tid + k * CL_THREADS;
        if (idx < rows_here * D) xv[k] = xt[idx];
      }
      if (t + 2 < steps) {  // x_{t+2} into L2
        const char* nxt = reinterpret_cast<const char*>(xt + (size_t)n_rows * D);
        for (int off = tid * 128; off < rows_here * D * (int)sizeof(T); off += CL_THREADS * 128)
          asm volatile("prefetch.L2 [%0];\n" ::"l"(nxt + off));
      }
    }
    cell(0, p, c1, row0, kSave ? res.g1 : nullptr, kSave ? res.c1 : nullptr,
         kSave ? res.h1 : nullptr);
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
    fence_proxy_async();  // this CTA's h1_t block, to the copies
    __syncthreads();      // h1_t's block and x_{t+1} are in; the partials are read
    cluster_wait();       // every peer has read the blocks of step t - 2 these copies overwrite
    if (tid == 0) send(0, p);
    {  // layer 2: [h1_t | h2_{t-1}] [W2; U2], h2_{t-1}'s chunks (and the fc of step
       // t - 1) first, then h1_t's as each owner's block arrives
      float acc[4][4] = {}, facc[4] = {};
      const bool fc_on = has_fc && t > 0;
      cl_products<T, true>(
          acc, facc, w2w, ns2, fcw + (size_t)q0 * 32, fc_on ? nh : 0, 2 * nh,
          [&](int v) { return v < nh ? hch + q0 + v : q0 + v - nh; },
          [&](int v) {
            const bool h2 = v < nh;
            const int q = q0 + (h2 ? v : v - nh);
            return hbase + (h2 ? blk(1, pq, q / S) : blk(0, p, q / S)) + lane_blk +
                   (uint32_t)((q % S) * CHUNK_BYTES);
          },
          [&](int v) {
            const bool h2 = v < nh;
            const int q = q0 + (h2 ? v : v - nh), o = q / S;
            if (q % S != 0 || o == c) return;
            if (!h2)
              mbar_wait(bar(0, p, o), (uint32_t)(t >> 1) & 1u);
            else if (t > 0)
              mbar_wait(bar(1, pq, o), (uint32_t)((t - 1) >> 1) & 1u);
          });
      store_acc(acc);
      if (fc_on) store_fc(facc);
    }
    __syncthreads();  // layer 2's partials are in; every warp has waited for its blocks
    if (tid == 0) {
      arm(0, p);   // h1_{t+2}
      arm(1, pq);  // h2_{t+1}
    }
    cluster_arrive();  // this CTA has read h1_{t-1} and h2_{t-1}
    cell(1, p, c2, row0, kSave ? res.g2 : nullptr, kSave ? res.c2 : nullptr,
         kSave ? res.h2 : nullptr);
    if (t > 0) fc_out(t - 1);
    fence_proxy_async();  // this CTA's h2_t block, to the copies
    __syncthreads();      // h2_t's block is in; the partials are read
    if (tid == 0) {
      send(1, p);
      bulk_wait_read<1>();  // the copies of h1_t (and before) have read their blocks
    }
  }
  if (steps > 0) {  // the fc of the last step, once h2_{T-1} is in from every owner
    const int pl = (steps - 1) & 1;
    for (int q = q0; q < q0 + nh; q += S)
      if (q / S != c) mbar_wait(bar(1, pl, q / S), (uint32_t)((steps - 1) >> 1) & 1u);
    if (has_fc) {
      float facc[4] = {};
      for (int q = q0; q < q0 + nh; ++q) {
        const uint4 f = __ldg(fcw + (size_t)q * 32);
        AFrag<T> a;
        a.load(hbase + blk(1, pl, q / S) + lane_blk + (uint32_t)((q % S) * CHUNK_BYTES));
        a.mma(facc, f);
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
template <typename T, bool kSave>
int launch_cluster(const void* x, const MmaWeights& wt, const void* fcb, void* out,
                   const Residuals<T>& res, int n_rows, int steps, int D, int H, int O,
                   cudaStream_t stream) {
  if (!cluster_runs<T>(D, H, O)) return (int)cudaErrorInvalidValue;
  if (steps == 0) return (int)cudaSuccess;  // nothing to write
  const size_t smem = cluster_shared_bytes<T>(D, H);
  cudaError_t err = cudaFuncSetAttribute(sweep_cluster_kernel<T, kSave>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // 16 is past the portable 8
    err = cudaFuncSetAttribute(sweep_cluster_kernel<T, kSave>,
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
  err = cudaLaunchKernelEx(&cfg, sweep_cluster_kernel<T, kSave>, static_cast<const T*>(x), wt,
                           static_cast<const float*>(fcb), static_cast<T*>(out), res, n_rows,
                           steps, D, H, O);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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

// The forms' `form` values (ops/lstm2.py): FWD_SWEEP_WAVE, FWD_PAIR and
// FWD_PAIR_WAVE (0 is the tile form, CLUSTER_SIZE the cluster form)
constexpr int WAVE_FORM = 1;
constexpr int PAIR_FORM = 2;
constexpr int PAIR_WAVE_FORM = 3;

// Launch the sweep in the form `form` gives: 0 the tile form (row tile
// `rows`), WAVE_FORM the wave form (row tile `rows`, items of part_steps
// steps, their carries in `carry`), PAIR_FORM the pair form (rows 32) in
// one launch, PAIR_WAVE_FORM the pair form in waves (rows 32, part_steps
// and carry as the wave form's), CLUSTER_SIZE the cluster form (rows 16);
// any other value, a form in one launch given part_steps or a carry, a form
// in waves without them, or a shape the form does not run, is refused with
// an error.
template <typename T, bool kSave>
int launch_form(const void* x, const MmaWeights& wt, const void* fcb, void* out,
                const Residuals<T>& res, void* carry, int n_rows, int steps, int D, int H, int O,
                int rows, int form, int part_steps, cudaStream_t stream) {
  const bool waves = form == WAVE_FORM || form == PAIR_WAVE_FORM;
  if (waves != (part_steps > 0) || waves != (carry != nullptr)) return (int)cudaErrorInvalidValue;
  if (form == 0 || form == WAVE_FORM)
    return launch_mma<T, kSave>(x, wt, fcb, out, res, carry, n_rows, steps, D, H, O, rows,
                                part_steps, stream);
  if ((form == PAIR_FORM || form == PAIR_WAVE_FORM) && rows == 16 * PAIR_MT &&
      wt.w1 != nullptr && wt.w2 != nullptr && wt.fc != nullptr && wt.b1 != nullptr &&
      wt.b2 != nullptr)
    return launch_pair<T, kSave>(x, wt, fcb, out, res, carry, n_rows, steps, D, H, O, part_steps,
                                 stream);
  if (form == CLUSTER_SIZE && rows == CL_ROWS && wt.w1 != nullptr && wt.w2 != nullptr &&
      wt.fc != nullptr && wt.b1 != nullptr && wt.b2 != nullptr)
    return launch_cluster<T, kSave>(x, wt, fcb, out, res, n_rows, steps, D, H, O, stream);
  return (int)cudaErrorInvalidValue;
}

// The C entry points' dispatch: dtype 0 float32, 1 bfloat16 (x, out and the
// residuals); the weights as the packed fragments w1p, w2p, fcp and the
// gate-interleaved biases b1p, b2p; res null without kSave; carry, form and
// part_steps as in `launch_form`.
template <bool kSave>
int launch_dtype(int dtype, const void* x, const void* w1p, const void* w2p, const void* fcp,
                 const void* b1p, const void* b2p, const void* fcb, void* out, void* const* res,
                 void* carry, int n_rows, int steps, int D, int H, int O, int rows, int form,
                 int part_steps, cudaStream_t stream) {
  if (kSave != (res != nullptr)) return (int)cudaErrorInvalidValue;
  const MmaWeights wt{static_cast<const uint4*>(w1p), static_cast<const uint4*>(w2p),
                      static_cast<const uint4*>(fcp), static_cast<const float*>(b1p),
                      static_cast<const float*>(b2p)};
  if (dtype == 0)
    return launch_form<float, kSave>(x, wt, fcb, out, residuals_of<float>(res), carry, n_rows,
                                     steps, D, H, O, rows, form, part_steps, stream);
  if (dtype == 1)
    return launch_form<__nv_bfloat16, kSave>(x, wt, fcb, out, residuals_of<__nv_bfloat16>(res),
                                             carry, n_rows, steps, D, H, O, rows, form,
                                             part_steps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace fwd
