// The reverse sweep of the fused 2-layer LSTM's backward, shared by
// lstm2_bwd.cu (which keeps the dgates of every step) and
// lstm2_bwd_wgrad.cu (which sweeps a few steps at a time and sums the
// weight gradients itself).
//
// Per step t = t_hi .. t_lo, for the R rows of the CTA's tile
// (fullsubnet_plus_tpu/ops/lstm_pallas.py:433-467, cell backward :392-412):
//   dh2   = dy_t W_fc^T + dh2_carry
//   dgates2, dc2 = cell_bwd(dh2, g2_t, c2_t, c2_{t-1}, dc2)     c_{-1} = 0
//   [dh1' | dh2_carry] = round(dgates2) [W2; U2]^T
//   dgates1, dc1 = cell_bwd(dh1' + dh1_carry, g1_t, c1_t, c1_{t-1}, dc1)
//   dh1_carry = round(dgates1) U1^T,   dx_t = round(dgates1) W1^T
// round() is the cast to the weight type T (none in float32); the carries
// stay float32.
//
// `sweep_mma_kernel<T>`: one CTA per tile of R = 16 rows (one m16 tile) for
// all its steps, H threads. Thread j runs the cell backward of unit j for
// every row of the tile, so both dc carries stay in its registers; the dh
// carries live in shared memory [R][H] float32. The three products, which
// contract over the 4H gate columns, run on the tensor cores with float32
// sums, with no FMA product left:
//   bf16: mma.sync.m16n8k16 on bf16 operands (the TPU kernel's contract,
//     lstm_pallas.py:548-575);
//   float32: mma.sync.m16n8k8 on TF32 operands, each product as three TF32
//     products of split operands (lstm2_common.cuh, AFrag<float>): the
//     integer split of lstm2::split_tf32, each k-step of A split once for
//     the n-tiles of a pass, each k-chunk's products summed into a zeroed
//     partial that one FADD adds to the float32 sum (the tensor core
//     truncates its accumulation; PERF.md).
// A: the step's dgates, row-major [16][4H + pad] of T in shared memory (the
// 16-byte pad keeps the row pitch an odd multiple of 16 bytes, so ldmatrix
// is free of bank conflicts), read with ldmatrix (the same byte addresses
// give bf16's m16n8k16 fragment and float32's m16n8k8 one). B: the weights
// [W2; U2] [2H, 4H], U1 [H, 4H] and W1 [D, 4H] (row c: the weights of output
// column c, k-contiguous, the "col" layout), packed once per backward call
// into lane order (ops/lstm2.py: pack_mma_b for bf16, pack_tf32_b for
// float32): [n-tile of 8 columns][k-chunk of 64 bytes][lane][16 bytes] (W1
// zero-padded from D = 34 to 40 rows), read from L2 16 bytes a lane, so a
// warp reads 512 contiguous bytes a k-chunk; a float32 word is split in
// registers after its load, so L2 traffic stays 4 bytes a weight. Warp w
// takes n-tiles 8w .. 8w + 7 of [dh1' | dh2_carry] and 4w .. 4w + 3 of U1^T
// over all k, in passes of 4 n-tiles (float32 accumulators in registers),
// and every n-tile of dx over its own 1 / (H / 32) of the k-chunks (its
// k-part: 128 of the 4H gate columns), into a partial that the
// threads add in warp order. The epilogues add into or overwrite dh1s /
// dh2s (each word one writer) between barriers; no atomics, so the result
// is the same bit for bit on every run. Shared memory at H 384, D 34, O 2:
// 129,408 bytes in bf16 and 178,560 in float32 (dgates 49.4 / 98.6 KB, dh1
// and dh2 24.6 KB each, dx partials [12][16][40] 30.7 KB).
// cuobjdump -sass: 54 HMMA instructions in each of the two bf16 functions
// (H <= 384 and <= 512), 162 HMMA.1688.F32.TF32 in each float32 one
// (chip_smoke.py phase 1).
//
// What bounds the bf16 sweep (H100 measurements, PERF.md). At the training
// fold (N 2304, T 195: 144 CTAs, two waves on 132 SMs) it runs 1.64 TFLOP
// in about 39 ms, 4 % of the bf16 tensor-core rate, and reads 103 GB of
// weight fragments from L2 (3.66 MB per CTA and step). A step takes about
// 127 us in a full wave, and 84 us for 12 CTAs alone, which is what the
// second wave costs. In a full wave, taking the products out saves 81 us
// (the weight loads alone 43 us) and taking the two cell backwards out
// saves 65 us: the phases overlap only in part
// (scripts/profile_torch_bwd_sweep.py). So each CTA's step latency bounds
// it (the product loops' L2 round trips and the cell backward's loads of
// the residuals), not the L2 bandwidth: R 32, with half the weight bytes,
// made each step about twice as long.
//
// The float32 sweep, alike: 1.64 TFLOP (three times that in TF32 products)
// in about 88 ms, 7.3 MB of weight words per CTA and step. A step takes
// about 256 us in a full wave and 197 us for the 12 CTAs of the second
// wave, 44 % of the time. In a full wave, taking the products out saves
// 217 us (the weight loads alone 69 us, the TF32 splits 61, two of the three
// HMMAs 73) and the cell backwards 98; the k-chunk loop unrolled once or
// four times instead of twice took 283 and 327 us
// (scripts/profile_torch_bwd_sweep.py).

#pragma once

#include "lstm2_common.cuh"

namespace bwd {

using lstm2::AFrag;
using lstm2::CHUNK_BYTES;
using lstm2::from_f;
using lstm2::k_chunk;
using lstm2::to_f;

constexpr int MMA_ROWS = 16;       // the row tile: one m16 tile (MMA_ROWS_PER_CTA)
constexpr int MMA_PAD_BYTES = 16;  // pad of a dgates row in shared memory (MMA_PAD_BYTES)

// W1's rows (the dx columns), zero-padded to n-tiles of 8
__host__ __device__ inline int dx_cols(int D) { return (D + 7) / 8 * 8; }

// elements of a dgates row in shared memory: the 4H gate columns and the pad
template <typename T> __host__ __device__ inline int dgates_pitch(int H) {
  return 4 * H + MMA_PAD_BYTES / (int)sizeof(T);
}

// the dgates [16][pitch] of T, then float32 the dh1 and dh2 carries [16][H],
// the dy tile [16][O] and a dx partial per warp [H / 32][16][dx_cols(D)]
template <typename T> inline size_t shared_bytes(int D, int H, int O) {
  return sizeof(T) * (size_t)MMA_ROWS * dgates_pitch<T>(H) +
         sizeof(float) * (size_t)MMA_ROWS * (2 * H + O + (H / 32) * dx_cols(D));
}

template <typename T>
struct SweepArgs {
  const T* dy;     // [N, T, O]
  const T* g1;     // [T, N, 4H] activated gates, layer 1
  const T* c1;     // [T, N, H]
  const T* g2;
  const T* c2;
  const uint4* w2p;  // [W2; U2], U1, W1 as packed mma fragments (see above)
  const uint4* u1p;
  const uint4* w1p;
  const float* fcw;  // [H, O]
  T* dg1;          // [t_hi - t_base + 1, N, 4H]: step t at index t - t_base
  T* dg2;
  T* dx;           // [T, N, D]
  float* carry;    // [4][tiles * R][H]: dh1, dc1, dh2, dc2 between sweeps, or null
  float* db_part;  // [tiles][2][4H]: this tile's sums of the unrounded dgates, or null
  int n_rows, steps, D, H, O;
  int t_hi, t_lo, t_base;
  int resume;      // 0: carries and bias sums start from zero; 1: read them
};

// The cell backward of unit j for the tile's rows: rounds the dgates to T,
// stores them in the shared dgates (row-major, pitch ld) and (rows that
// exist) in dg_t, updates dc and adds the unrounded dgates to db.
// (Issuing a quad's 24 loads together from raw bits, without the row
// branch, was tried and ran a third slower: it costs registers.)
template <typename T, int R>
__device__ __forceinline__ void cell_bwd(const float (&dh)[R], float (&dc)[R], float (&db)[4],
                                         const T* __restrict__ g_t, const T* __restrict__ c_t,
                                         const T* __restrict__ c_prev_t,
                                         T* __restrict__ dg_t, T* __restrict__ dgs,
                                         int rows_here, int H, int j, int ld) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float gi = 0.f, gf = 0.f, gg = 0.f, go = 0.f, c = 0.f, c_prev = 0.f;
    if (r < rows_here) {
      const T* gr = g_t + (size_t)r * 4 * H + j;
      gi = to_f(gr[0]);
      gf = to_f(gr[H]);
      gg = to_f(gr[2 * H]);
      go = to_f(gr[3 * H]);
      c = to_f(c_t[(size_t)r * H + j]);
      if (c_prev_t != nullptr) c_prev = to_f(c_prev_t[(size_t)r * H + j]);
    }
    const float tanh_c = tanhf(c);
    const float d_o = dh[r] * tanh_c;
    const float d_c = dh[r] * go * (1.0f - tanh_c * tanh_c) + dc[r];
    const float di = d_c * gg, dg = d_c * gi, df = d_c * c_prev;
    dc[r] = d_c * gf;
    const float d[4] = {di * gi * (1.0f - gi), df * gf * (1.0f - gf), dg * (1.0f - gg * gg),
                        d_o * go * (1.0f - go)};
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      db[g] += d[g];  // a row past N has zero gates, carries and dy: adds 0
      const T rounded = from_f<T>(d[g]);
      if (r < rows_here) dg_t[(size_t)r * 4 * H + g * H + j] = rounded;
      dgs[(size_t)r * ld + g * H + j] = rounded;
    }
  }
}

// acc[i] += dgates . B[n-tile i] over the k-chunks [kc0, kc1) (64 bytes of
// a dgates row each, two k-steps), in k order. a_addr: this lane's ldmatrix
// address in the dgates; B: this lane's 16 bytes of n-tile 0 and k-chunk 0;
// n-tile i, k-chunk kc are at B[(i * chunks + kc) * 32].
template <typename T, int NT>
__device__ __forceinline__ void mma_tiles(float (&acc)[NT][4], uint32_t a_addr,
                                          const uint4* __restrict__ B, int chunks, int kc0,
                                          int kc1) {
#pragma unroll 2
  for (int kc = kc0; kc < kc1; ++kc) {
    uint4 b[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) b[i] = __ldg(B + ((size_t)i * chunks + kc) * 32);
    AFrag<T> a;
    a.load(a_addr + kc * CHUNK_BYTES);
#pragma unroll
    for (int i = 0; i < NT; ++i) a.mma(acc[i], b[i]);
  }
}

// This lane's accumulator words into out[row][8i + column] (row pitch
// ld_out), added to what is there when `add`.
template <int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4], float* out, int ld_out,
                                          int lane, bool add) {
  const int fr = lane >> 2, fc = 2 * (lane & 3);  // rows fr, fr + 8; columns fc, fc + 1
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float* word = out + (fr + 8 * (e >> 1)) * ld_out + 8 * i + fc + (e & 1);
      *word = add ? acc[i][e] + *word : acc[i][e];
    }
}

// The sweep for a tile of 16 rows. The tile's dgates sit in shared memory
// as T [16][4H + pad], and warp w of the H / 32 computes, in passes of 4
// n-tiles of 8 columns:
//   [dh1' | dh2_carry]: n-tiles 8w .. 8w + 7 of the 2H columns over all k,
//     the first H columns added into dh1s, the last H written to dh2s;
//   dh1_carry: n-tiles 4w .. 4w + 3 of the H columns over all k, into dh1s;
//   dx: every n-tile of the D columns over its own share of the k-chunks
//     (its k-part), into its own partial, which 16 x D threads then add in
//     warp order.
// Each output word has one writer and each sum a fixed order.
template <typename T, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
sweep_mma_kernel(const SweepArgs<T> a) {
  constexpr int R = MMA_ROWS;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int D = a.D, H = a.H, O = a.O, G = 4 * a.H, ld = dgates_pitch<T>(H);
  const int warps = H / 32, chunks = G / k_chunk<T>(), dxc = dx_cols(D);
  T* dgs = reinterpret_cast<T*>(smem_mma);                         // [R][ld]
  float* dh1s = reinterpret_cast<float*>(dgs + (size_t)R * ld);  // [R][H]
  float* dh2s = dh1s + R * H;                                    // [R][H]
  float* dys = dh2s + R * H;                                     // [R][O]
  float* dxp = dys + R * O;                                      // [warps][R][dxc]

  const int j = threadIdx.x, warp = j >> 5, lane = j & 31;
  const int n0 = blockIdx.x * R;
  const int rows_here = min(R, a.n_rows - n0);
  const size_t n_pad = (size_t)gridDim.x * R;
  const uint32_t a_addr =
      (uint32_t)__cvta_generic_to_shared(dgs + (size_t)(lane & 15) * ld) + 16 * (lane >> 4);

  float dc1[R], dc2[R];
  float db[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (a.resume) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = a.carry[((size_t)c * n_pad + n0 + r) * H + j];
    }
    dh1s[r * H + j] = v[0];
    dc1[r] = v[1];
    dh2s[r * H + j] = v[2];
    dc2[r] = v[3];
  }

  for (int t = a.t_hi; t >= a.t_lo; --t) {
    const size_t row0 = (size_t)t * a.n_rows + n0;
    const size_t prev0 = row0 - a.n_rows;  // used only when t > 0
    const size_t dg0 = ((size_t)(t - a.t_base) * a.n_rows + n0) * G;
    for (int idx = j; idx < R * O; idx += H) {
      const int r = idx / O, o = idx - r * O;
      dys[idx] = (r < rows_here) ? to_f(a.dy[((size_t)(n0 + r) * a.steps + t) * O + o]) : 0.0f;
    }
    __syncthreads();  // dy tile ready; the last step's reads of dgs and dxp are done

    // layer 2
    float dh[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.0f;
      for (int o = 0; o < O; ++o) s = fmaf(dys[r * O + o], a.fcw[j * O + o], s);
      dh[r] = s + dh2s[r * H + j];
    }
    cell_bwd<T, R>(dh, dc2, db[1], a.g2 + row0 * G, a.c2 + row0 * H,
                   t > 0 ? a.c2 + prev0 * H : nullptr, a.dg2 + dg0, dgs, rows_here, H, j, ld);
    __syncthreads();  // dgates2 complete

#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int col0 = (8 * warp + 4 * pass) * 8;  // a pass lies in dh1' or in the dh2 carry
      float acc[4][4] = {};
      mma_tiles<T, 4>(acc, a_addr, a.w2p + (size_t)col0 * chunks * 4 + lane, chunks, 0, chunks);
      if (col0 < H)
        store_acc(acc, dh1s + col0, H, lane, true);  // d h1_t = d h1' + the carry
      else
        store_acc(acc, dh2s + col0 - H, H, lane, false);  // d h2_{t-1}
    }
    __syncthreads();  // dgates2 read, dh1s holds d h1_t

    // layer 1
#pragma unroll
    for (int r = 0; r < R; ++r) dh[r] = dh1s[r * H + j];
    cell_bwd<T, R>(dh, dc1, db[0], a.g1 + row0 * G, a.c1 + row0 * H,
                   t > 0 ? a.c1 + prev0 * H : nullptr, a.dg1 + dg0, dgs, rows_here, H, j, ld);
    __syncthreads();  // dgates1 complete; every thread has read its d h1_t

    {
      float acc[4][4] = {};
      mma_tiles<T, 4>(acc, a_addr, a.u1p + (size_t)warp * 32 * chunks * 4 + lane, chunks, 0,
                      chunks);
      store_acc(acc, dh1s + warp * 32, H, lane, false);  // d h1_{t-1}
    }
    for (int nt = 0; nt < dxc / 8; ++nt) {
      float acc[1][4] = {};
      mma_tiles<T, 1>(acc, a_addr, a.w1p + (size_t)nt * chunks * 32 + lane, chunks,
                      warp * chunks / warps, (warp + 1) * chunks / warps);
      store_acc(acc, dxp + (size_t)warp * R * dxc + 8 * nt, dxc, lane, false);
    }
    __syncthreads();  // dx partials complete
    for (int idx = j; idx < R * D; idx += H) {
      const int r = idx / D, d = idx - r * D;
      float s = 0.0f;
      for (int p = 0; p < warps; ++p) s += dxp[((size_t)p * R + r) * dxc + d];
      if (r < rows_here) a.dx[row0 * D + idx] = from_f<T>(s);
    }
  }

  if (a.carry != nullptr) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v[4] = {dh1s[r * H + j], dc1[r], dh2s[r * H + j], dc2[r]};
#pragma unroll
      for (int c = 0; c < 4; ++c) a.carry[((size_t)c * n_pad + n0 + r) * H + j] = v[c];
    }
  }
  if (a.db_part != nullptr) {
#pragma unroll
    for (int l = 0; l < 2; ++l)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float* dst = a.db_part + ((size_t)blockIdx.x * 2 + l) * G + g * H + j;
        *dst = a.resume ? *dst + db[l][g] : db[l][g];
      }
  }
}

template <typename T, int MAX_THREADS>
int launch_mma(const SweepArgs<T>& a, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(a.D, a.H, a.O);
  const cudaError_t err = cudaFuncSetAttribute(
      sweep_mma_kernel<T, MAX_THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep_mma_kernel<T, MAX_THREADS><<<(a.n_rows + MMA_ROWS - 1) / MMA_ROWS, a.H, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Launch one sweep over [t_lo, t_hi]. The sweep always takes the
// tensor-core kernel, in both types; rows is its row tile, 16.
template <typename T>
int launch_sweep(const SweepArgs<T>& a, int rows, cudaStream_t stream) {
  if (rows != MMA_ROWS || a.w2p == nullptr || a.u1p == nullptr || a.w1p == nullptr)
    return (int)cudaErrorInvalidValue;
  return a.H <= 384 ? launch_mma<T, 384>(a, stream) : launch_mma<T, 512>(a, stream);
}

inline bool valid_shape(int n_rows, int steps, int D, int H, int O) {
  return H % 32 == 0 && H <= 512 && n_rows > 0 && steps > 0 && D > 0 && D <= H && O > 0;
}

}  // namespace bwd
