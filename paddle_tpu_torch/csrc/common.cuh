// Shared helpers of the port's CUDA kernels: element conversion between
// the storage types (float, __nv_bfloat16) and fp32, warp and block
// reductions, and the once-per-device dynamic shared memory limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace ptt {

constexpr int kMaxDevices = 64;

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

// The value rounded to the storage type and back: where the TPU kernels
// cast an fp32 intermediate to the input type before a product.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Sum of v over a block of kThreads threads (a multiple of 32). `scratch`
// holds kThreads / 32 floats in shared memory; the trailing barrier lets
// the caller reuse it right away.
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += scratch[i];
  __syncthreads();
  return total;
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` once per device
// (not on every launch, so that launches can be captured into a CUDA
// graph). The attribute belongs to the current device, so `done` (the
// caller's static flags, one per device) is indexed by it; two threads
// racing here both set it, which is harmless.
template <typename Kernel>
inline cudaError_t raise_smem_limit(Kernel kernel, int bytes,
                                    std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
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
