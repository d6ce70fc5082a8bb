// Softmax cross-entropy over [N, V] logits, the dense LM-head loss at
// small vocabularies: the per-row log-sum-exp (forward) and the softmax
// times the row's output gradient (backward).
//
//   lse[r] = log sum_c exp(x[r, c])                       (fp32 out)
//   dx[r, c] = exp(x[r, c] - lse[r]) * g[r]               (x's type out)
//
// The -g[r] at each row's label is added outside (as the TPU kernel's
// caller does), and so is the gather of the label logit.
//
// Replaces: paddle_tpu/ops/pallas/softmax_xent.py:89 _lse_call
//   (_lse_kernel :61) and :111 _dx_call (_dx_kernel :82).
// Bound on the H100: memory. The forward reads the logits once and writes
//   4 bytes a row; the backward reads the logits, lse and g and writes
//   dx: about one exp per element, far below the operations-per-byte
//   line of either the fp32 or the tensor-core rate.
// Design: the forward gives each row one warp (8 rows a block of 256
//   threads). A lane walks the columns lane, lane + 32, ... (coalesced
//   across the warp) keeping its own fp32 running maximum and a sum
//   rescaled whenever the maximum grows, the online form of the TPU
//   kernel's per-vocab-block update (:72-77); the 32 partial states merge
//   through warp shuffles. The TPU kernel's 128 x 256 tiling and its
//   lane-replicated [N, 128] output are layout artefacts of its vector
//   unit and are not kept: any N and V are taken here, and lse is [N].
//   The backward is elementwise, one thread an element, the row's lse and
//   g read through the L1.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lse_kernel(const T* __restrict__ x, float* __restrict__ lse, int n, int v) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= n) return;  // whole warps leave together
  const T* xr = x + (int64_t)row * v;
  float m = -INFINITY, l = 0.f;
  for (int c = lane; c < v; c += 32) {
    const float xv = ptt::to_f32(xr[c]);
    if (xv > m) {
      l = l * expf(m - xv) + 1.f;  // exp(-inf) = 0 on the first element
      m = xv;
    } else if (xv != -INFINITY) {  // -inf columns add nothing
      l += expf(xv - m);
    }
  }
  const float mx = ptt::warp_max(m);
  // a lane that saw no column (v < 32) holds m = -inf and adds nothing
  const float part = (m == -INFINITY) ? 0.f : l * expf(m - mx);
  const float total = ptt::warp_sum(part);
  if (lane == 0) lse[row] = mx + logf(total);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const T* __restrict__ x, const float* __restrict__ lse,
          const float* __restrict__ g, T* __restrict__ dx, int64_t total,
          int v) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t row = i / v;
  dx[i] = ptt::from_f32<T>(expf(ptt::to_f32(x[i]) - lse[row]) * g[row]);
}

}  // namespace

// x [n, v] contiguous in `dtype`; lse [n] fp32.
extern "C" int ptt_softmax_xent_lse(const void* x, void* lse, int n, int v,
                                    int dtype, void* stream) {
  if (n <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T, {
    lse_kernel<T><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<float*>(lse), n, v);
  });
  return (int)cudaGetLastError();
}

// x, dx [n, v] contiguous in `dtype`; lse, g [n] fp32.
extern "C" int ptt_softmax_xent_dx(const void* x, const void* lse,
                                   const void* g, void* dx, int n, int v,
                                   int dtype, void* stream) {
  if (n <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)n * v;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T, {
    dx_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(lse),
        static_cast<const float*>(g), static_cast<T*>(dx), total, v);
  });
  return (int)cudaGetLastError();
}
