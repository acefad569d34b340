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
// rows, D = 34, H = 384, O = 2, T = 628: 2*N*T*(D + 3H)*4H + 2*N*T*H*O
// = 4.7 TFLOP against about 0.19 GB of inputs, weights and outputs, so the
// work is bound by operations, and by latency: the T steps are sequential
// and each step's products depend on the last step's h.
//
// Design (a simple kernel that is right; wgmma, clusters and persistent
// CTAs are later work). One CTA per tile of R = 16 rows sweeps all T steps,
// so the recurrence never leaves the block. Thread j of the H threads owns
// hidden unit j of both layers: it computes gate columns j, H+j, 2H+j, 3H+j
// for the tile's rows, so a warp's weight loads are 128 contiguous bytes.
// The weights (7.3 MB float32, 3.7 MB bf16) do not fit in shared memory;
// they stay in global memory, served from the 50 MB L2. h1, h2 and the x
// tile sit in shared memory k-major ([K][R]) so one float4 load feeds four
// rows; c1 and c2 sit in shared memory [R][H], private to their thread.
// The fc (O outputs) is a warp-shuffle then cross-warp reduction over H.
// __syncthreads separates each layer's read phase from its write phase.
//
// Launch: grid ceil(N / R), block H threads, dynamic shared memory as in
// shared_memory_bytes() of ops/lstm2.py. The C entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 16;  // rows per CTA; ROWS_PER_CTA in ops/lstm2.py

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// h.astype(weight dtype), kept as a float
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

// acc[g][r] += sum_k src[k][r] * W[k][g*H + j] for k < K
template <typename T>
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
// h into hs[j][r] and h_out[r].
template <typename T>
__device__ __forceinline__ void cell(const float (&acc)[4][R], float* __restrict__ cs,
                                     float* __restrict__ hs, float (&h_out)[R], int H,
                                     int j) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float i = sigm(acc[0][r]);
    const float f = sigm(acc[1][r]);
    const float g = tanhf(acc[2][r]);
    const float o = sigm(acc[3][r]);
    const float c = f * cs[r * H + j] + i * g;
    cs[r * H + j] = c;
    h_out[r] = round_to<T>(o * tanhf(c));
  }
  float4* dst = reinterpret_cast<float4*>(hs + j * R);
#pragma unroll
  for (int q = 0; q < R / 4; ++q)
    dst[q] = make_float4(h_out[4 * q], h_out[4 * q + 1], h_out[4 * q + 2], h_out[4 * q + 3]);
}

template <typename T>
__global__ void __launch_bounds__(512, 1)
lstm2_fwd_kernel(const T* __restrict__ x,        // [T, N, D]
                 const T* __restrict__ w1,       // [D, 4H]
                 const T* __restrict__ u1,       // [H, 4H]
                 const float* __restrict__ b1,   // [4H]
                 const T* __restrict__ w2,       // [2H, 4H]
                 const float* __restrict__ b2,   // [4H]
                 const float* __restrict__ fcw,  // [H, O]
                 const float* __restrict__ fcb,  // [O]
                 T* __restrict__ out,            // [N, T, O]
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

  for (int idx = j; idx < 4 * H * R; idx += H) h1s[idx] = 0.0f;  // h1, h2, c1, c2
  __syncthreads();

  float acc[4][R];
  float h[R];
  for (int t = 0; t < steps; ++t) {
    // x tile of this step, transposed to [D][R]; rows past N read as zero
    const T* xt = x + ((size_t)t * n_rows + n0) * D;
    for (int idx = j; idx < R * D; idx += H) {
      const int r = idx / D, k = idx - r * D;
      xs[k * R + r] = (n0 + r < n_rows) ? to_f(xt[idx]) : 0.0f;
    }
    __syncthreads();

    // layer 1
    init_acc(acc, b1, H, j);
    accumulate<T>(acc, w1, xs, D, H, j);
    accumulate<T>(acc, u1, h1s, H, H, j);
    __syncthreads();  // every thread has read the old h1
    cell<T>(acc, c1s, h1s, h, H, j);
    __syncthreads();  // the new h1 is complete

    // layer 2: [h1 | h2] [W2; U2]
    init_acc(acc, b2, H, j);
    accumulate<T>(acc, w2, h1s, H, H, j);
    accumulate<T>(acc, w2 + (size_t)H * 4 * H, h2s, H, H, j);
    __syncthreads();  // every thread has read the old h2
    cell<T>(acc, c2s, h2s, h, H, j);

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
      if (n0 + r < n_rows) out[((size_t)(n0 + r) * steps + t) * O + o] = from_f<T>(s);
    }
    // the next step's first __syncthreads orders these reads of red before
    // its rewrite, and the x tile is not read again in this step
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* u1, const void* b1, const void* w2,
           const void* b2, const void* fcw, const void* fcb, void* out, int n_rows, int steps,
           int D, int H, int O, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)R * (D + 4 * H + (H / 32) * O);
  cudaError_t err = cudaFuncSetAttribute(
      lstm2_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + R - 1) / R);
  lstm2_fwd_kernel<T><<<grid, H, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(u1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(fcw),
      static_cast<const float*>(fcb), static_cast<T*>(out), n_rows, steps, D, H, O);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W1, U1, [W2; U2] and out).
extern "C" int lstm2_fwd(const void* x, const void* w1, const void* u1, const void* b1,
                         const void* w2, const void* b2, const void* fcw, const void* fcb,
                         void* out, int n_rows, int steps, int D, int H, int O, int dtype,
                         void* stream) {
  if (H % 32 != 0 || H > 512 || n_rows <= 0 || steps < 0 || D <= 0 || O <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w1, u1, b1, w2, b2, fcw, fcb, out, n_rows, steps, D, H, O, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w1, u1, b1, w2, b2, fcw, fcb, out, n_rows, steps, D, H,
                                 O, s);
  return (int)cudaErrorInvalidValue;
}
