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
// The products contract over the 4H gate columns, so the forward's split
// (a thread per hidden unit, contracting over K <= 2H) is turned round:
// the tile's rounded dgates sit in shared memory k-major ([4H][R], one
// buffer that layer 2 fills, then layer 1) and thread j of the H threads
// owns output column j of each transposed weight matrix: columns j and
// H + j of [W2; U2]^T, column j of U1^T. Those are also the columns whose
// cell backward the thread runs next, so dh1', both dh carries and both dc
// carries never leave the thread (dc in registers, dh in shared memory
// words that only their owner touches). A warp's weight loads are
// contiguous; every thread reads the same dgates, so the shared-memory
// loads are broadcasts. dx has only D columns: D x `parts` threads each sum
// a slice of the 4H gate columns, and R x D threads add the slices in a
// fixed order.
//
// Shared memory (float32): dgates [4H][R], dh1 and dh2 carries [R][H], the
// dy tile [R][O], dx partials [parts][R][D]; bwd_shared_memory_bytes() of
// ops/lstm2_train.py. One CTA per row tile, H threads.

#pragma once

#include "lstm2_common.cuh"

namespace bwd {

using lstm2::from_f;
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
  const T* w2t;    // [4H, 2H] = [W2; U2]^T
  const T* u1t;    // [4H, H]
  const T* w1t;    // [4H, D]
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
// rounds the dgates to T, stores them k-major in shared memory and (rows
// that exist) in dg_t, updates dc and adds the unrounded dgates to db.
// (Issuing a quad's 24 loads together from raw bits, without the row
// branch, was tried and ran a third slower: it costs registers.)
template <typename T, int R>
__device__ __forceinline__ void cell_bwd(const float (&dh)[R], float (&dc)[R], float (&db)[4],
                                         const T* __restrict__ g_t, const T* __restrict__ c_t,
                                         const T* __restrict__ c_prev_t,
                                         T* __restrict__ dg_t, float* __restrict__ dgs,
                                         int rows_here, int H, int j) {
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
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
      *reinterpret_cast<float4*>(dgs + (size_t)(g * H + j) * R + 4 * q) =
          make_float4(d[g][0], d[g][1], d[g][2], d[g][3]);
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

inline bool valid_shape(int n_rows, int steps, int D, int H, int O) {
  return H % 32 == 0 && H <= 512 && n_rows > 0 && steps > 0 && D > 0 && D <= H && O > 0;
}

}  // namespace bwd
