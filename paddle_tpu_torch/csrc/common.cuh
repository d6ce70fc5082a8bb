// Shared helpers of the port's CUDA kernels: element conversion between
// the storage types (float, __nv_bfloat16) and fp32, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace ptt

// The type tag every C entry point takes: 0 float32, 1 bfloat16.
#define PTT_DISPATCH_DTYPE(code, T, ...)              \
  do {                                                \
    if ((code) == 0) {                                \
      using T = float;                                \
      __VA_ARGS__;                                    \
    } else if ((code) == 1) {                         \
      using T = __nv_bfloat16;                        \
      __VA_ARGS__;                                    \
    } else {                                          \
      return (int)cudaErrorInvalidValue;              \
    }                                                 \
  } while (0)
