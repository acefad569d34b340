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
// round() is the cast to the weight type T; the carries stay float32.
//
// Both types: one CTA per row tile for all its steps, H threads. Thread j
// runs the cell backward of unit j for every row of the tile, so both dc
// carries stay in its registers; the dh carries live in shared memory
// [R][H] float32, and the rounded dgates of the step go to shared memory
// for the three products, which contract over the 4H gate columns.
//
// float32 (`sweep_kernel`, FMA products; R 16 or 20): the dgates sit k-major
// ([4H][R] float32, one buffer that layer 2 fills, then layer 1) and thread
// j owns output column j of each transposed weight matrix: columns j and
// H + j of [W2; U2]^T, column j of U1^T, so dh1' and both dh carries never
// leave the thread. A warp's weight loads from L2 are contiguous; the
// shared-memory loads are broadcasts. dx: D x `parts` threads each sum a
// slice of the 4H gate columns, and R x D threads add the slices in a
// fixed order. Shared memory: dgates, dh1 and dh2, the dy tile [R][O], dx
// partials [parts][R][D], all float32.
//
// bf16 (`sweep_mma_kernel`, tensor-core products; R 16, one m16 tile): the
// three products run on mma.sync.m16n8k16 (bf16 operands, float32 sums:
// the TPU kernel's contract, lstm_pallas.py:548-575), with no FMA product
// left. A: the tile's dgates, bf16 row-major [16][4H + 8] in shared memory
// (the pad of 8 keeps ldmatrix free of bank conflicts), read with
// ldmatrix. B: the weights [W2; U2] [2H, 4H], U1 [H, 4H] and W1 [D, 4H]
// (row c: the weights of output column c, k-contiguous, the "col" layout),
// packed by ops/lstm2_train.py::pack_mma_b once per backward call into
// lane order, [n-tile of 8 columns][k-pair of 32][lane][8 bf16] (W1
// zero-padded from D = 34 to 40 rows), and read from L2 16 bytes a lane, so
// a warp reads 512 contiguous bytes a k-pair. Warp w takes n-tiles 8w ..
// 8w + 7 of [dh1' | dh2_carry] and 4w .. 4w + 3 of U1^T over all k, in
// passes of 4 n-tiles (float32 accumulators in registers), and every
// n-tile of dx over its own 4 k-pairs (128 of the 4H gate columns), into a
// partial that the threads add in warp order. The epilogues add into or
// overwrite dh1s / dh2s (each word one writer) between the same barriers
// as the float32 sweep; no atomics, so the result is the same bit for bit
// on every run. Shared memory at H 384, D 34, O 2: 129,408 bytes (dgates bf16
// 49.4 KB, dh1 and dh2 24.6 KB each, dx partials [12][16][40] 30.7 KB).
// cuobjdump -sass: 54 HMMA instructions in each of the two bf16 functions
// (H <= 384 and <= 512), none in the float32 ones (chip_smoke.py phase 1).
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

#pragma once

#include <type_traits>

#include "lstm2_common.cuh"

namespace bwd {

using lstm2::from_f;
using lstm2::ldmatrix_x4;
using lstm2::mma_bf16;
using lstm2::to_f;

constexpr int DX_PARTS_MAX = 12;  // DX_PARTS_MAX in ops/lstm2_train.py

__host__ __device__ inline int dx_parts(int D, int H) {
  const int p = H / D;
  return p < DX_PARTS_MAX ? p : DX_PARTS_MAX;
}

inline size_t shared_bytes(int R, int D, int H, int O) {
  return sizeof(float) * (size_t)R * (4 * H + 2 * H + O + dx_parts(D, H) * D);
}

template <typename T>
struct SweepArgs {
  const T* dy;     // [N, T, O]
  const T* g1;     // [T, N, 4H] activated gates, layer 1
  const T* c1;     // [T, N, H]
  const T* g2;
  const T* c2;
  const T* w2t;    // [4H, 2H] = [W2; U2]^T (float32 sweep)
  const T* u1t;    // [4H, H]
  const T* w1t;    // [4H, D]
  const uint4* w2p;  // [W2; U2], U1, W1 as packed mma fragments (bf16 sweep; see below)
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

// The cell backward of unit j for the tile's rows, four rows at a time:
// rounds the dgates to T, stores them in shared memory and (rows that
// exist) in dg_t, updates dc and adds the unrounded dgates to db. The
// shared copy is float32 k-major [4H][R] for the FMA sweep (S = float) and
// bf16 row-major [R][ld] for the tensor-core sweep (S = __nv_bfloat16).
// (Issuing a quad's 24 loads together from raw bits, without the row
// branch, was tried and ran a third slower: it costs registers.)
template <typename T, int R, typename S>
__device__ __forceinline__ void cell_bwd(const float (&dh)[R], float (&dc)[R], float (&db)[4],
                                         const T* __restrict__ g_t, const T* __restrict__ c_t,
                                         const T* __restrict__ c_prev_t,
                                         T* __restrict__ dg_t, S* __restrict__ dgs,
                                         int rows_here, int H, int j, int ld = 0) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    float d[4][4];  // [gate][row of the quad]
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 4 * q + e;
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
      d[0][e] = di * gi * (1.0f - gi);
      d[1][e] = df * gf * (1.0f - gf);
      d[2][e] = dg * (1.0f - gg * gg);
      d[3][e] = d_o * go * (1.0f - go);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        db[g] += d[g][e];  // a row past N has zero gates, carries and dy: adds 0
        const T rounded = from_f<T>(d[g][e]);
        d[g][e] = to_f(rounded);
        if (r < rows_here) dg_t[(size_t)r * 4 * H + g * H + j] = rounded;
        if constexpr (!std::is_same_v<S, float>) dgs[(size_t)r * ld + g * H + j] = rounded;
      }
    }
    if constexpr (std::is_same_v<S, float>) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        *reinterpret_cast<float4*>(dgs + (size_t)(g * H + j) * R + 4 * q) =
            make_float4(d[g][0], d[g][1], d[g][2], d[g][3]);
    }
  }
}

// acc[c][r] += sum_k dgs[k][r] * W[k * ld + col0 + c * col_stride] over k in [k0, k1)
template <typename T, int R, int C>
__device__ __forceinline__ void contract(float (&acc)[C][R], const T* __restrict__ W, int ld,
                                         int col0, int col_stride,
                                         const float* __restrict__ dgs, int k0, int k1) {
#pragma unroll 2
  for (int k = k0; k < k1; ++k) {
    float w[C];
#pragma unroll
    for (int c = 0; c < C; ++c) w[c] = to_f(W[(size_t)k * ld + col0 + c * col_stride]);
    const float4* s = reinterpret_cast<const float4*>(dgs + (size_t)k * R);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 v = s[q];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c][4 * q + 0] = fmaf(v.x, w[c], acc[c][4 * q + 0]);
        acc[c][4 * q + 1] = fmaf(v.y, w[c], acc[c][4 * q + 1]);
        acc[c][4 * q + 2] = fmaf(v.z, w[c], acc[c][4 * q + 2]);
        acc[c][4 * q + 3] = fmaf(v.w, w[c], acc[c][4 * q + 3]);
      }
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(R == 16 ? 512 : 384, 1)
sweep_kernel(const SweepArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, H = a.H, O = a.O, G = 4 * a.H;
  const int parts = dx_parts(D, H);
  float* dgs = smem;              // [4H][R]
  float* dh1s = dgs + G * R;      // [R][H] carry, word [r][j] owned by thread j
  float* dh2s = dh1s + R * H;     // [R][H]
  float* dys = dh2s + R * H;      // [R][O]
  float* dxp = dys + R * O;       // [parts][R][D]

  const int j = threadIdx.x;
  const int n0 = blockIdx.x * R;
  const int rows_here = min(R, a.n_rows - n0);
  const size_t n_pad = (size_t)gridDim.x * R;  // rows of the carry arrays

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
  // the dx slice of this thread: column dx_d, gate columns [dx_k0, dx_k1)
  const int dx_part = j / D, dx_d = j - dx_part * D;
  const int slice = (G + parts - 1) / parts;
  const int dx_k0 = min(G, dx_part * slice), dx_k1 = min(G, dx_k0 + slice);

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
                   t > 0 ? a.c2 + prev0 * H : nullptr, a.dg2 + dg0, dgs, rows_here, H, j);
    __syncthreads();  // dgates2 complete

    {
      float acc[2][R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[0][r] = acc[1][r] = 0.0f;
      contract<T, R, 2>(acc, a.w2t, 2 * H, j, H, dgs, 0, G);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dh[r] = acc[0][r] + dh1s[r * H + j];  // d h1_t
        dh2s[r * H + j] = acc[1][r];          // d h2_{t-1}
      }
    }
    __syncthreads();  // every thread has read dgates2

    // layer 1
    cell_bwd<T, R>(dh, dc1, db[0], a.g1 + row0 * G, a.c1 + row0 * H,
                   t > 0 ? a.c1 + prev0 * H : nullptr, a.dg1 + dg0, dgs, rows_here, H, j);
    __syncthreads();  // dgates1 complete

    {
      float acc[1][R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[0][r] = 0.0f;
      contract<T, R, 1>(acc, a.u1t, H, j, 0, dgs, 0, G);
#pragma unroll
      for (int r = 0; r < R; ++r) dh1s[r * H + j] = acc[0][r];  // d h1_{t-1}
    }
    if (dx_part < parts) {
      float acc[1][R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[0][r] = 0.0f;
      contract<T, R, 1>(acc, a.w1t, D, dx_d, 0, dgs, dx_k0, dx_k1);
#pragma unroll
      for (int r = 0; r < R; ++r) dxp[((size_t)dx_part * R + r) * D + dx_d] = acc[0][r];
    }
    __syncthreads();  // dx partials complete
    for (int idx = j; idx < R * D; idx += H) {
      const int r = idx / D;
      float s = 0.0f;
      for (int p = 0; p < parts; ++p) s += dxp[(size_t)p * R * D + idx];
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

// Launch one sweep over [t_lo, t_hi]; rows is the row tile R (16 or 20).
template <typename T>
int launch_sweep(const SweepArgs<T>& a, int rows, cudaStream_t stream) {
  const size_t smem = shared_bytes(rows, a.D, a.H, a.O);
  const dim3 grid((a.n_rows + rows - 1) / rows);
  cudaError_t err;
  if (rows == 16) {
    err = cudaFuncSetAttribute(sweep_kernel<T, 16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sweep_kernel<T, 16><<<grid, a.H, smem, stream>>>(a);
  } else if (rows == 20 && a.H <= 384) {
    err = cudaFuncSetAttribute(sweep_kernel<T, 20>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sweep_kernel<T, 20><<<grid, a.H, smem, stream>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the three products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_ROWS = 16;  // the bf16 sweep's row tile: one m16 tile (MMA_ROWS_PER_CTA)
constexpr int MMA_PAD = 8;    // bf16 pad of a dgates row in shared memory (MMA_PAD)

// W1's rows (the dx columns), zero-padded to n-tiles of 8
__host__ __device__ inline int dx_cols(int D) { return (D + 7) / 8 * 8; }

inline size_t shared_bytes_mma(int D, int H, int O) {
  return sizeof(__nv_bfloat16) * (size_t)MMA_ROWS * (4 * H + MMA_PAD) +
         sizeof(float) * (size_t)MMA_ROWS * (2 * H + O + (H / 32) * dx_cols(D));
}

// acc[i] += dgates . B[n-tile i] over the k-pairs [kp0, kp1) (32 gate
// columns each, two k-steps of 16), in k order. a_addr: this lane's
// ldmatrix address in the dgates; B: this lane's 16 bytes of n-tile 0 and
// k-pair 0; n-tile i, k-pair kp are at B[(i * kpairs + kp) * 32].
template <int NT>
__device__ __forceinline__ void mma_tiles(float (&acc)[NT][4], uint32_t a_addr,
                                          const uint4* __restrict__ B, int kpairs, int kp0,
                                          int kp1) {
#pragma unroll 2
  for (int kp = kp0; kp < kp1; ++kp) {
    uint4 b[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) b[i] = __ldg(B + ((size_t)i * kpairs + kp) * 32);
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, a_addr + kp * 64);  // k-steps 2kp and 2kp + 1: 32 bytes each
    ldmatrix_x4(a1, a_addr + kp * 64 + 32);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      mma_bf16(acc[i], a0, b[i].x, b[i].y);
      mma_bf16(acc[i], a1, b[i].z, b[i].w);
    }
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

// The bf16 sweep: the same steps, cell backward and carries as
// sweep_kernel, for a tile of 16 rows. The tile's dgates sit in shared
// memory as bf16 [16][4H + 8], and warp w of the H / 32 computes with
// mma.sync m16n8k16, in passes of 4 n-tiles of 8 columns:
//   [dh1' | dh2_carry]: n-tiles 8w .. 8w + 7 of the 2H columns over all k,
//     the first H columns added into dh1s, the last H written to dh2s;
//   dh1_carry: n-tiles 4w .. 4w + 3 of the H columns over all k, into dh1s;
//   dx: every n-tile of the D columns over k-pairs w * 4 .. w * 4 + 3 (its
//     k-part), into its own partial, which 16 x D threads then add in warp
//     order.
// Each output word has one writer and each sum a fixed order.
template <int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
sweep_mma_kernel(const SweepArgs<__nv_bfloat16> a) {
  using T = __nv_bfloat16;
  constexpr int R = MMA_ROWS;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int D = a.D, H = a.H, O = a.O, G = 4 * a.H, ld = G + MMA_PAD;
  const int warps = H / 32, kpairs = G / 32, dxc = dx_cols(D);
  T* dgs = reinterpret_cast<T*>(smem_mma);                         // [R][4H + 8]
  float* dh1s = reinterpret_cast<float*>(dgs + (size_t)R * ld);  // [R][H]
  float* dh2s = dh1s + R * H;                                    // [R][H]
  float* dys = dh2s + R * H;                                     // [R][O]
  float* dxp = dys + R * O;                                      // [warps][R][dxc]

  const int j = threadIdx.x, warp = j >> 5, lane = j & 31;
  const int n0 = blockIdx.x * R;
  const int rows_here = min(R, a.n_rows - n0);
  const size_t n_pad = (size_t)gridDim.x * R;
  const uint32_t a_addr =
      (uint32_t)__cvta_generic_to_shared(dgs + (size_t)(lane & 15) * ld + 8 * (lane >> 4));

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
      mma_tiles<4>(acc, a_addr, a.w2p + (size_t)col0 * kpairs * 4 + lane, kpairs, 0, kpairs);
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
      mma_tiles<4>(acc, a_addr, a.u1p + (size_t)warp * 32 * kpairs * 4 + lane, kpairs, 0, kpairs);
      store_acc(acc, dh1s + warp * 32, H, lane, false);  // d h1_{t-1}
    }
    for (int nt = 0; nt < dxc / 8; ++nt) {
      float acc[1][4] = {};
      mma_tiles<1>(acc, a_addr, a.w1p + (size_t)nt * kpairs * 32 + lane, kpairs,
                   warp * kpairs / warps, (warp + 1) * kpairs / warps);
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

template <int MAX_THREADS>
int launch_mma(const SweepArgs<__nv_bfloat16>& a, cudaStream_t stream) {
  const size_t smem = shared_bytes_mma(a.D, a.H, a.O);
  const cudaError_t err = cudaFuncSetAttribute(
      sweep_mma_kernel<MAX_THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep_mma_kernel<MAX_THREADS><<<(a.n_rows + MMA_ROWS - 1) / MMA_ROWS, a.H, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The bf16 sweep always takes the tensor-core kernel, whose row tile is 16.
template <>
inline int launch_sweep<__nv_bfloat16>(const SweepArgs<__nv_bfloat16>& a, int rows,
                                       cudaStream_t stream) {
  if (rows != MMA_ROWS || a.w2p == nullptr || a.u1p == nullptr || a.w1p == nullptr)
    return (int)cudaErrorInvalidValue;
  return a.H <= 384 ? launch_mma<384>(a, stream) : launch_mma<512>(a, stream);
}

inline bool valid_shape(int n_rows, int steps, int D, int H, int O) {
  return H % 32 == 0 && H <= 512 && n_rows > 0 && steps > 0 && D > 0 && D <= H && O > 0;
}

}  // namespace bwd
