// The forward sweep of the fused 2-layer LSTM + output Linear, shared by
// lstm2_fwd.cu (inference: y only) and lstm2_train_fwd.cu (training: y and
// the residuals the backward reads). Per step t and row n:
//   g1 = x_t W1 + h1 U1 + b1,  g2 = [h1 | h2] [W2; U2] + b2   (gates i,f,g,o)
//   c = f*c + i*g,  h = o*tanh(c),  y_t = h2 W_fc + b_fc
// h and c stay float32; h is rounded to the weight type before every product
// (the TPU kernel's h.astype(mm)); products accumulate in float32. Both
// kernels run the same products in the same order, so their y is equal bit
// for bit.
//
// One CTA per tile of R rows sweeps all T steps, so the recurrence never
// leaves the block. Thread j of the H threads owns hidden unit j of both
// layers: it computes gate columns j, H+j, 2H+j, 3H+j for the tile's rows, so
// a warp's weight loads are 128 contiguous bytes, and every residual store
// of a row is H contiguous elements across the block. The weights (7.3 MB
// float32, 3.7 MB bf16) do not fit in shared memory; they stay in global
// memory, served from the 50 MB L2. h1, h2 and the x tile sit in shared
// memory k-major ([K][R]) so one float4 load feeds four rows; c1 and c2 sit
// in shared memory [R][H], private to their thread. The fc (O outputs) is a
// warp-shuffle then cross-warp reduction over H. __syncthreads separates
// each layer's read phase from its write phase.
//
// Launch: grid ceil(N / R), block H threads, dynamic shared memory
// shared_bytes(R, D, H, O).

#pragma once

#include "lstm2_common.cuh"

namespace fwd {

using lstm2::from_f;
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

inline bool valid_shape(int n_rows, int steps, int D, int H, int O) {
  return H % 32 == 0 && H <= 512 && n_rows > 0 && steps >= 0 && D > 0 && O > 0;
}

}  // namespace fwd
