// Conversions and activations shared by the float LSTM kernels
// (lstm2_fwd_sweep.cuh, lstm2_bwd_sweep.cuh). T is the weight type, float
// or __nv_bfloat16; arithmetic is float32 throughout.

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

}  // namespace lstm2
