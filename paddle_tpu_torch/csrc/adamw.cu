// AdamW update of one parameter tensor, in place:
//   m = b1·m + (1 − b1)·g,   v = b2·v + (1 − b2)·g²,
//   p = p − lr·(m·c1 / (sqrt(v·c2) + eps) + wd·p),
// with c1 = 1 / (1 − b1^t), c2 = 1 / (1 − b2^t) the bias corrections of
// step t. m and v are fp32; p is float32 or bfloat16; g is float32 or
// bfloat16 and is upcast here. All arithmetic in fp32, p rounded once on
// the store. The seven scalars are arguments, so one build serves every
// step of a schedule.
//
// Replaces: paddle_tpu/ops/pallas/adamw.py:39 adamw_update (_adamw_kernel
//   :25, call :72).
// Bound on the H100: memory. Per element it reads p, m, v, g and writes p,
//   m, v (22 bytes for bf16 p and g) at ~15 operations.
// Design: a grid-stride elementwise pass directly over the flat tensors;
//   the TPU kernel's padding to [rows, 128] and its block rows do not apply.
//   Neighbouring threads take neighbouring elements, so every access is
//   coalesced. CUDA C++ rather than Triton, as the rule is.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // H100 SMs × resident blocks

template <typename P, typename G>
__global__ void adamw_kernel(P* __restrict__ p, float* __restrict__ m,
                             float* __restrict__ v, const G* __restrict__ g,
                             int64_t n, float lr, float b1, float b2,
                             float eps, float wd, float c1, float c2) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float gf = ptt::to_f32(g[i]);
    const float mi = b1 * m[i] + (1.f - b1) * gf;
    const float vi = b2 * v[i] + (1.f - b2) * gf * gf;
    float pf = ptt::to_f32(p[i]);
    const float update = (mi * c1) / (sqrtf(vi * c2) + eps);
    pf = pf - lr * (update + wd * pf);
    p[i] = ptt::from_f32<P>(pf);
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

// p [n] (p_dtype), m, v [n] fp32, g [n] (g_dtype), all contiguous.
extern "C" int ptt_adamw(void* p, void* m, void* v, const void* g, int64_t n,
                         float lr, float b1, float b2, float eps, float wd,
                         float c1, float c2, int p_dtype, int g_dtype,
                         void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  PTT_DISPATCH_DTYPE(p_dtype, P, {
    PTT_DISPATCH_DTYPE(g_dtype, G, {
      adamw_kernel<P, G><<<blocks, kThreads, 0, s>>>(
          static_cast<P*>(p), static_cast<float*>(m), static_cast<float*>(v),
          static_cast<const G*>(g), n, lr, b1, b2, eps, wd, c1, c2);
    });
  });
  return (int)cudaGetLastError();
}
