// RMSNorm forward: y = x * rsqrt(mean(x^2) + eps) * w, statistics and the
// product in fp32, cast to the storage type on the store.
//
// Replaces: paddle_tpu/ops/pallas/norm.py:78 _rms_fwd (_rms_fwd_kernel :51).
// Bound on the H100: memory. Per row it reads H inputs and writes H
//   outputs and does ~4 operations per element, far below the ~295
//   operations per byte where the tensor cores would become the limit.
// Design: one block of 256 threads per row. Each thread strides over the
//   row (neighbouring threads on neighbouring addresses), sums squares in
//   fp32, the block reduces through warp shuffles and one shared array,
//   then the same threads re-read their elements (now in L1/L2) and write
//   y. Any row count and any H: the TPU gate's n % 8 and H % 128 limits
//   were tiling artefacts and do not apply. The Pallas kernel also saves
//   rstd for its backward; that comes with the training slice.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const T* __restrict__ w, T* __restrict__ y,
                                int h, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = y + row * h;
  float ss = 0.f;
  for (int c = threadIdx.x; c < h; c += kThreads) {
    float v = ptt::to_f32(xr[c]);
    ss += v * v;
  }
  __shared__ float partial[kThreads / 32];
  ss = ptt::warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += partial[i];
  const float rstd = rsqrtf(total / (float)h + eps);
  for (int c = threadIdx.x; c < h; c += kThreads) {
    float v = ptt::to_f32(xr[c]) * rstd * ptt::to_f32(w[c]);
    yr[c] = ptt::from_f32<T>(v);
  }
}

}  // namespace

// x, y: [n, h] contiguous; w: [h].
extern "C" int ptt_rms_norm_fwd(const void* x, const void* w, void* y, int n,
                                int h, float eps, int dtype, void* stream) {
  if (n <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T, {
    rms_norm_kernel<T><<<n, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(y), h, eps);
  });
  return (int)cudaGetLastError();
}
