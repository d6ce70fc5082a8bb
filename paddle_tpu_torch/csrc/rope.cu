// Rotary position embedding, split halves: for x [B, T, H, D] and fp32
// tables cos/sin [T, D/2] shared by the batch, or [B, T, D/2] of each
// row's own positions (the serving engine's slots decode at different
// positions; the tables are gathered on the device from their positions),
//   out[..., i]      = x1 * cos - x2 * sin * sign
//   out[..., i + D/2] = x2 * cos + x1 * sin * sign
// with x1 = x[..., i], x2 = x[..., i + D/2], in fp32. sign = -1 rotates by
// the negative angle, which is the backward of the forward rotation.
//
// Replaces: paddle_tpu/ops/pallas/rope.py:48 _rope_call (_rope_kernel :39).
// Bound on the H100: memory. It reads x and the tables once and writes
//   out once, at ~6 operations per pair.
// Design: elementwise, one thread per (b, t, h, i) pair, directly in the
//   [B, T, H, D] layout (the TPU kernel transposed to [B, H, T, D] for its
//   tiling; nothing here needs it). Consecutive threads take consecutive
//   i, so each half row is read and written coalesced. Any T, T = 1
//   (decode) included: the TPU's bt % 8 gate does not apply.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void rope_kernel(const T* __restrict__ x,
                            const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t,
                            T* __restrict__ out, int64_t pairs, int t_len,
                            int heads, int d2, int per_row, float sign) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= pairs) return;
  const int i = (int)(p % d2);
  const int64_t row = p / d2;                // (b, t, h) flattened
  // the table row: (b, t) for per-row tables, t for shared ones
  const int64_t bt = row / heads;
  const int64_t tr = per_row ? bt : bt % t_len;
  const float c = cos_t[tr * d2 + i];
  const float s = sin_t[tr * d2 + i] * sign;
  const int64_t base = row * (2 * (int64_t)d2);
  const float x1 = ptt::to_f32(x[base + i]);
  const float x2 = ptt::to_f32(x[base + d2 + i]);
  out[base + i] = ptt::from_f32<T>(x1 * c - x2 * s);
  out[base + d2 + i] = ptt::from_f32<T>(x2 * c + x1 * s);
}

}  // namespace

// x, out: [B, T, H, D] contiguous; cos, sin: fp32 contiguous, [T, D/2]
// (per_row = 0) or [B, T, D/2] (per_row = 1).
extern "C" int ptt_rope(const void* x, const void* cos_t, const void* sin_t,
                        void* out, int b, int t, int h, int d, int per_row,
                        float sign, int dtype, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || d <= 0 || d % 2)
    return (int)cudaErrorInvalidValue;
  const int d2 = d / 2;
  const int64_t pairs = (int64_t)b * t * h * d2;
  const int64_t blocks = (pairs + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T, {
    rope_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), static_cast<T*>(out), pairs, t, h,
        d2, per_row, sign);
  });
  return (int)cudaGetLastError();
}
