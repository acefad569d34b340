// Conversions, activations and the mma.sync helpers shared by the float
// LSTM kernels (lstm2_fwd_sweep.cuh, lstm2_bwd_sweep.cuh). T is the weight
// type, float or __nv_bfloat16; arithmetic is float32 throughout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm2 {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v.astype(weight type), kept as a float
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// An element's bits as a plain integer or float, so that a batch of loads
// can be issued before any of them is converted, and zero bits are 0.0.
template <typename T> struct Bits;
template <> struct Bits<float> {
  using type = float;
  static __device__ __forceinline__ float to_f(float v) { return v; }
};
template <> struct Bits<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ float to_f(unsigned short v) {
    return __uint_as_float((unsigned)v << 16);
  }
};

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

// The tensor-core sweeps' operand loads and products (mma.sync m16n8k16).

// Lane l gives the address of row l % 16, column 8 * (l / 16) of a 16 x 16
// bf16 tile; a[0..3] come back as mma.sync's A fragment of that tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The same four 8 x 8 bf16 matrices, each transposed on the way: lane l
// gives the address of row l % 8 of matrix l / 8, and a[i] comes back as
// {M_i[2 (l % 4)][l / 4], M_i[2 (l % 4) + 1][l / 4]}. For operands stored
// with the contraction index as the row (lstm2_bwd_wgrad.cu), this is
// mma.sync's A fragment and the col B fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// d += A (16 x 16, row) B (16 x 8, col): bf16 products, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace lstm2
