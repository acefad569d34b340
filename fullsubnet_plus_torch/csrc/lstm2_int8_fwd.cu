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
// 0.99 ms at the tensor cores' int8 and bf16 peaks) and, as in K1, by
// latency: the T steps are sequential and each depends on the last h.
//
// Design (a simple kernel that is right; s8 tensor-core products, clusters
// and persistent CTAs are later work). K1's decomposition: one CTA per tile
// of R = 16 rows sweeps all T steps; thread j of the H threads owns hidden
// unit j of both layers, gate columns j, H+j, 2H+j, 3H+j. h1q and h2q sit in
// shared memory as int8 packed [H/4][R]: one 32-bit word holds four k values
// of one row, and one int4 load feeds four rows. The int8 weights arrive
// repacked k-quad-major ([K/4][4H] words, pack_k_quads in ops/lstm2_int8.py),
// so each __dp4a weight operand is one coalesced 32-bit load; they (1.8 MB)
// stay in global memory, served from L2. Each layer's integer product is a
// chain of signed __dp4a into int32, exact, then one float multiply by the
// column scale. x W1 is float32 FMAs on bf16 values, as in K1. c1 and c2 stay
// float32 in shared memory [R][H], private to their thread; the fc is K1's
// warp-shuffle then cross-warp reduction. Rows past N in the last CTA read
// zero and write nothing.
//
// Launch: grid ceil(N / R), block H threads, dynamic shared memory as in
// shared_memory_bytes() of ops/lstm2_int8.py. The C entry point launches on
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 16;  // rows per CTA; ROWS_PER_CTA in ops/lstm2_int8.py

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

// acc[g][r] += sum_q dp4a(hq[q][r], Wp[q][g*H + j]) for q < KQ: int8 products
// of four k at a time, int32 sums
__device__ __forceinline__ void accumulate_q(int (&acc)[4][R], const int* __restrict__ Wp,
                                             const int* __restrict__ hq, int KQ, int H,
                                             int j) {
  const int G = 4 * H;
#pragma unroll 2
  for (int q = 0; q < KQ; ++q) {
    const int* row = Wp + (size_t)q * G + j;
    int w[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) w[g] = row[g * H];
    const int4* s = reinterpret_cast<const int4*>(hq + q * R);
#pragma unroll
    for (int p = 0; p < R / 4; ++p) {
      const int4 v = s[p];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        acc[g][4 * p + 0] = __dp4a(v.x, w[g], acc[g][4 * p + 0]);
        acc[g][4 * p + 1] = __dp4a(v.y, w[g], acc[g][4 * p + 1]);
        acc[g][4 * p + 2] = __dp4a(v.z, w[g], acc[g][4 * p + 2]);
        acc[g][4 * p + 3] = __dp4a(v.w, w[g], acc[g][4 * p + 3]);
      }
    }
  }
}

// acc[g][r] += sum_k xs[k][r] * W[k][g*H + j] for k < D: bf16 weights,
// float32 products
__device__ __forceinline__ void accumulate_x(float (&acc)[4][R],
                                             const __nv_bfloat16* __restrict__ W,
                                             const float* __restrict__ xs, int D, int H,
                                             int j) {
  const int G = 4 * H;
#pragma unroll 2
  for (int k = 0; k < D; ++k) {
    const __nv_bfloat16* row = W + (size_t)k * G + j;
    float w[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) w[g] = __bfloat162float(row[g * H]);
    const float4* s = reinterpret_cast<const float4*>(xs + k * R);
#pragma unroll
    for (int p = 0; p < R / 4; ++p) {
      const float4 v = s[p];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        acc[g][4 * p + 0] = fmaf(v.x, w[g], acc[g][4 * p + 0]);
        acc[g][4 * p + 1] = fmaf(v.y, w[g], acc[g][4 * p + 1]);
        acc[g][4 * p + 2] = fmaf(v.z, w[g], acc[g][4 * p + 2]);
        acc[g][4 * p + 3] = fmaf(v.w, w[g], acc[g][4 * p + 3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(int (&acc)[4][R]) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[g][r] = 0;
}

// gates = int32 sum * column scale (+ nothing else yet)
__device__ __forceinline__ void dequantize(float (&gates)[4][R], const int (&acc)[4][R],
                                           const float* __restrict__ scale, int H, int j) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float s = scale[g * H + j];
#pragma unroll
    for (int r = 0; r < R; ++r) gates[g][r] = (float)acc[g][r] * s;
  }
}

__device__ __forceinline__ void add_bias(float (&gates)[4][R], const float* __restrict__ b,
                                         int H, int j) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float bg = b[g * H + j];
#pragma unroll
    for (int r = 0; r < R; ++r) gates[g][r] += bg;
  }
}

// LSTM cell for unit j of every row: updates c[r][j], writes h into h_out[r]
// and its int8 quantization into byte (j & 3) of word hq[j / 4][r].
__device__ __forceinline__ void cell(const float (&gates)[4][R], float* __restrict__ cs,
                                     int* __restrict__ hq, float (&h_out)[R], int H,
                                     int j) {
  signed char* hq8 = reinterpret_cast<signed char*>(hq);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float i = sigm(gates[0][r]);
    const float f = sigm(gates[1][r]);
    const float g = tanhf(gates[2][r]);
    const float o = sigm(gates[3][r]);
    const float c = f * cs[r * H + j] + i * g;
    cs[r * H + j] = c;
    const float h = o * tanhf(c);
    h_out[r] = h;
    const int q = min(127, max(-127, __float2int_rn(h * 127.0f)));  // half to even
    hq8[((j >> 2) * R + r) * 4 + (j & 3)] = (signed char)q;
  }
}

__global__ void __launch_bounds__(512, 1)
lstm2_int8_fwd_kernel(const __nv_bfloat16* __restrict__ x,   // [T, N, D]
                      const __nv_bfloat16* __restrict__ w1,  // [D, 4H]
                      const int* __restrict__ u1p,           // [H/4, 4H] packed int8
                      const float* __restrict__ s1,          // [4H]
                      const float* __restrict__ b1,          // [4H]
                      const int* __restrict__ w2p,           // [2H/4, 4H] packed int8
                      const float* __restrict__ s2,          // [4H]
                      const float* __restrict__ b2,          // [4H]
                      const float* __restrict__ fcw,         // [H, O]
                      const float* __restrict__ fcb,         // [O]
                      __nv_bfloat16* __restrict__ out,       // [N, T, O]
                      int n_rows, int steps, int D, int H, int O) {
  extern __shared__ __align__(16) float smem[];
  const int KQ = H / 4;
  float* xs = smem;                                    // [D][R]
  int* h1q = reinterpret_cast<int*>(xs + D * R);       // [H/4][R]
  int* h2q = h1q + KQ * R;                             // [H/4][R]
  float* c1s = reinterpret_cast<float*>(h2q + KQ * R);  // [R][H]
  float* c2s = c1s + R * H;                            // [R][H]
  float* red = c2s + R * H;                            // [H/32][R][O]

  const int j = threadIdx.x;  // hidden unit
  const int lane = j & 31, warp = j >> 5, n_warps = H >> 5;
  const int n0 = blockIdx.x * R;

  for (int idx = j; idx < R * (2 * KQ + 2 * H); idx += H) h1q[idx] = 0;  // h1q h2q c1 c2
  __syncthreads();

  int iacc[4][R];
  float gates[4][R];
  float h[R];
  for (int t = 0; t < steps; ++t) {
    // x tile of this step, transposed to [D][R]; rows past N read as zero
    const __nv_bfloat16* xt = x + ((size_t)t * n_rows + n0) * D;
    for (int idx = j; idx < R * D; idx += H) {
      const int r = idx / D, k = idx - r * D;
      xs[k * R + r] = (n0 + r < n_rows) ? __bfloat162float(xt[idx]) : 0.0f;
    }
    __syncthreads();

    // layer 1: (h1q U1q) s1 + x W1 + b1
    zero(iacc);
    accumulate_q(iacc, u1p, h1q, KQ, H, j);
    dequantize(gates, iacc, s1, H, j);
    accumulate_x(gates, w1, xs, D, H, j);
    add_bias(gates, b1, H, j);
    __syncthreads();  // every thread has read the old h1q
    cell(gates, c1s, h1q, h, H, j);
    __syncthreads();  // the new h1q is complete

    // layer 2: [h1q | h2q] [W2q; U2q] s2 + b2
    zero(iacc);
    accumulate_q(iacc, w2p, h1q, KQ, H, j);
    accumulate_q(iacc, w2p + (size_t)KQ * 4 * H, h2q, KQ, H, j);
    dequantize(gates, iacc, s2, H, j);
    add_bias(gates, b2, H, j);
    __syncthreads();  // every thread has read the old h2q
    cell(gates, c2s, h2q, h, H, j);

    // fused fc on bf16(h2): y[r][o] = sum_j bf16(h2[r][j]) fcw[j][o] + fcb[o]
    for (int o = 0; o < O; ++o) {
      const float wj = fcw[j * O + o];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float p = __bfloat162float(__float2bfloat16_rn(h[r])) * wj;
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
      if (n0 + r < n_rows) out[((size_t)(n0 + r) * steps + t) * O + o] = __float2bfloat16_rn(s);
    }
    // the next step's first __syncthreads orders these reads of red before
    // its rewrite, and the x tile is not read again in this step
  }
}

}  // namespace

extern "C" int lstm2_int8_fwd(const void* x, const void* w1, const void* u1p, const void* s1,
                              const void* b1, const void* w2p, const void* s2, const void* b2,
                              const void* fcw, const void* fcb, void* out, int n_rows,
                              int steps, int D, int H, int O, void* stream) {
  if (H % 32 != 0 || H > 512 || n_rows <= 0 || steps < 0 || D <= 0 || O <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)R * (D + H / 2 + 2 * H + (H / 32) * O);
  cudaError_t err = cudaFuncSetAttribute(
      lstm2_int8_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + R - 1) / R);
  lstm2_int8_fwd_kernel<<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const int*>(u1p), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const int*>(w2p),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<const float*>(fcw), static_cast<const float*>(fcb),
      static_cast<__nv_bfloat16*>(out), n_rows, steps, D, H, O);
  return (int)cudaGetLastError();
}
