// RMSNorm forward and backward.
//   forward:  y = x · rstd · w,  rstd = rsqrt(mean(x²) + eps), statistics
//             and the product in fp32, cast to the storage type on the
//             store; rstd [n] fp32 is written too when asked for (the
//             backward's input).
//   backward: x̂ = x · rstd,
//             dx = rstd · (w·g − x̂ · mean(w·g·x̂)),
//             dw = Σ_rows g · x̂ in fp32.
//
// Replaces: paddle_tpu/ops/pallas/norm.py:78 _rms_fwd (_rms_fwd_kernel :51)
//   and norm.py:102 _rms_bwd_call (_rms_bwd_kernel :60).
// Bound on the H100: memory. The forward reads x once and writes y once,
//   the backward reads x and g once and writes dx once, at a few operations
//   per element, far below the ~295 operations per byte where the tensor
//   cores would become the limit.
// Design: one block of 256 threads per row (forward) or per run of rows
//   (backward). Each thread strides over the row (neighbouring threads on
//   neighbouring addresses), sums in fp32, the block reduces through warp
//   shuffles and one shared array, then the same threads re-read their
//   elements (now in L1/L2) and write. Any row count and any H: the TPU
//   gate's n % 8 and H % 128 limits were tiling artefacts.
//   dw: on the TPU the grid runs in order and carries dw in its output
//   block across row blocks. Here blocks run in no order, so each backward
//   block keeps a partial dw row for its own rows in shared memory (each
//   thread owns its columns, so no atomics) and writes it out; a second
//   kernel sums the partial rows per column in block order. The block count
//   is fixed by the caller, so the sum order, and the result, is the same
//   on every run and every card.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxH = 16384;  // the dw row in shared memory: 64 KB

template <typename T>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const T* __restrict__ w, T* __restrict__ y,
                                float* __restrict__ rstd_out, int h,
                                float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = y + row * h;
  __shared__ float scratch[kThreads / 32];
  float ss = 0.f;
  for (int c = threadIdx.x; c < h; c += kThreads) {
    float v = ptt::to_f32(xr[c]);
    ss += v * v;
  }
  const float total = ptt::block_sum<kThreads>(ss, scratch);
  const float rstd = rsqrtf(total / (float)h + eps);
  for (int c = threadIdx.x; c < h; c += kThreads) {
    float v = ptt::to_f32(xr[c]) * rstd * ptt::to_f32(w[c]);
    yr[c] = ptt::from_f32<T>(v);
  }
  if (rstd_out != nullptr && threadIdx.x == 0) rstd_out[row] = rstd;
}

template <typename T>
__global__ void rms_norm_bwd_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    const float* __restrict__ rstd,
                                    const T* __restrict__ g,
                                    T* __restrict__ dx,
                                    float* __restrict__ dw_part, int n, int h,
                                    int rows_per_block) {
  extern __shared__ float dw_s[];  // [h]: this block's partial dw row
  __shared__ float scratch[kThreads / 32];
  for (int c = threadIdx.x; c < h; c += kThreads) dw_s[c] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  for (int row = r0; row < r1; ++row) {
    const int64_t base = (int64_t)row * h;
    const float rs = rstd[row];
    float s = 0.f;
    for (int c = threadIdx.x; c < h; c += kThreads) {
      const float xh = ptt::to_f32(x[base + c]) * rs;
      s += ptt::to_f32(g[base + c]) * ptt::to_f32(w[c]) * xh;
    }
    const float mean_wgx = ptt::block_sum<kThreads>(s, scratch) / (float)h;
    for (int c = threadIdx.x; c < h; c += kThreads) {
      const float xh = ptt::to_f32(x[base + c]) * rs;
      const float gv = ptt::to_f32(g[base + c]);
      dx[base + c] =
          ptt::from_f32<T>(rs * (gv * ptt::to_f32(w[c]) - xh * mean_wgx));
      dw_s[c] += gv * xh;  // column c is this thread's alone
    }
  }
  float* part = dw_part + (int64_t)blockIdx.x * h;
  for (int c = threadIdx.x; c < h; c += kThreads) part[c] = dw_s[c];
}

__global__ void rms_dw_reduce_kernel(const float* __restrict__ dw_part,
                                     float* __restrict__ dw, int blocks,
                                     int h) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= h) return;
  float s = 0.f;
  for (int i = 0; i < blocks; ++i) s += dw_part[(int64_t)i * h + c];
  dw[c] = s;
}

}  // namespace

// x, y: [n, h] contiguous; w: [h]; rstd: [n] fp32, or NULL when not wanted.
extern "C" int ptt_rms_norm_fwd(const void* x, const void* w, void* y,
                                void* rstd, int n, int h, float eps,
                                int dtype, void* stream) {
  if (n <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T, {
    rms_norm_kernel<T><<<n, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(y), static_cast<float*>(rstd), h, eps);
  });
  return (int)cudaGetLastError();
}

// x, g, dx: [n, h] contiguous; w: [h]; rstd: [n] fp32 (the forward's);
// dw_part: [blocks, h] fp32 scratch; dw: [h] fp32. h <= 16384.
extern "C" int ptt_rms_norm_bwd(const void* x, const void* w,
                                const void* rstd, const void* g, void* dx,
                                void* dw_part, void* dw, int n, int h,
                                int blocks, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || h > kMaxH || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = (n + blocks - 1) / blocks;
  const size_t bytes = sizeof(float) * (size_t)h;
  cudaError_t err;
  PTT_DISPATCH_DTYPE(dtype, T, {
    static std::atomic<bool> smem_raised[ptt::kMaxDevices];
    err = ptt::raise_smem_limit(rms_norm_bwd_kernel<T>,
                                (int)(sizeof(float) * kMaxH), smem_raised);
    if (err != cudaSuccess) return (int)err;
    rms_norm_bwd_kernel<T><<<blocks, kThreads, bytes, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const float*>(rstd), static_cast<const T*>(g),
        static_cast<T*>(dx), static_cast<float*>(dw_part), n, h,
        rows_per_block);
  });
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rms_dw_reduce_kernel<<<(h + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(dw_part), static_cast<float*>(dw), blocks, h);
  return (int)cudaGetLastError();
}
