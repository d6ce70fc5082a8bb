// One-token decode attention over the stacked static KV cache.
// q [B, Hq, D], the step's own k/v kn/vn [B, Hkv, D], the WHOLE cache
// k_cache/v_cache [L, B, Hkv, S, D] (float layout), out [B, Hq, D].
// Layer `layer` is read in place through its offset (no per-layer slice
// is ever copied); only positions [0, index) are read, and the fresh
// token joins the softmax first. q-head h·G + g reads kv-head h.
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py:211 raw_call
//   (_kernel :98), float layout. The int8 layout is later work.
// Bound on the H100: memory. Each step reads index·Hkv·D·2 cache
//   elements per batch row for ~4·G operations per element pair, far
//   below the tensor cores' operations-per-byte line.
// Design: one block of 4 warps per (b, kv-head). All G query heads of the
//   group are computed together, so each cache row is read once for the
//   group. A lane owns D/32 columns (lane + 32·c): loads are coalesced
//   across the warp. Warps take interleaved positions j = warp + 4·i in
//   [0, index) and keep their own fp32 online softmax (max, sum,
//   accumulator in registers); warp 0 starts from the fresh token. The
//   four partial states merge through shared memory at the end. Any S
//   and any index are taken: nothing past index is read.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kn,
              const T* __restrict__ vn, const T* __restrict__ k_cache,
              const T* __restrict__ v_cache, T* __restrict__ out, int nb,
              int hkv, int s_len, int layer, int index, float scale) {
  constexpr int C = D / 32;
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int hq = hkv * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float qr[G][C];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < C; ++c)
      qr[g][c] = ptt::to_f32(q[((int64_t)b * hq + h * G + g) * D + lane + 32 * c]) * scale;

  float m[G], l[G], acc[G][C];
  if (warp == 0) {
    float knr[C], vnr[C];
    const int64_t off = ((int64_t)b * hkv + h) * D + lane;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      knr[c] = ptt::to_f32(kn[off + 32 * c]);
      vnr[c] = ptt::to_f32(vn[off + 32 * c]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) part = fmaf(qr[g][c], knr[c], part);
      m[g] = ptt::warp_sum(part);
      l[g] = 1.f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] = vnr[c];
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] = 0.f;
    }
  }

  const int64_t head_off =
      ((((int64_t)layer * nb + b) * hkv + h) * (int64_t)s_len) * D + lane;
  const T* kc = k_cache + head_off;
  const T* vc = v_cache + head_off;
  for (int j = warp; j < index; j += kWarps) {
    float kr[C], vr[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      kr[c] = ptt::to_f32(kc[(int64_t)j * D + 32 * c]);
      vr[c] = ptt::to_f32(vc[(int64_t)j * D + 32 * c]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) part = fmaf(qr[g][c], kr[c], part);
      const float s = ptt::warp_sum(part);
      const float m_new = fmaxf(m[g], s);
      const float alpha = __expf(m[g] - m_new);
      const float p = __expf(s - m_new);
      l[g] = l[g] * alpha + p;
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] = fmaf(p, vr[c], acc[g][c] * alpha);
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) sm_acc[warp][g][lane + 32 * c] = acc[g][c];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < G * D; e += kWarps * 32) {
    const int g = e / D, d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(sm_m[w][g] - mx);  // 0 for a warp with no rows
      den = fmaf(sm_l[w][g], f, den);
      num = fmaf(sm_acc[w][g][d], f, num);
    }
    out[((int64_t)b * hq + h * G + g) * D + d] = ptt::from_f32<T>(num / den);
  }
}

template <typename T, int D>
int launch_d(int g, const void* q, const void* kn, const void* vn,
             const void* kc, const void* vc, void* out, int b, int hkv,
             int s_len, int layer, int index, float scale, cudaStream_t s) {
  dim3 grid(hkv, b);
#define PTT_DECODE_CASE(GV)                                                 \
  case GV:                                                                  \
    decode_kernel<T, D, GV><<<grid, kWarps * 32, 0, s>>>(                   \
        static_cast<const T*>(q), static_cast<const T*>(kn),                \
        static_cast<const T*>(vn), static_cast<const T*>(kc),               \
        static_cast<const T*>(vc), static_cast<T*>(out), b, hkv, s_len,     \
        layer, index, scale);                                               \
    break;
  switch (g) {
    PTT_DECODE_CASE(1)
    PTT_DECODE_CASE(2)
    PTT_DECODE_CASE(4)
    PTT_DECODE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PTT_DECODE_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// q/out [B, Hq, D], kn/vn [B, Hkv, D], caches [L, B, Hkv, S, D], all
// contiguous. D in {64, 128, 256}; G = Hq / Hkv in {1, 2, 4, 8};
// 0 <= index <= S; 0 <= layer < L.
extern "C" int ptt_decode_attention(const void* q, const void* kn,
                                    const void* vn, const void* k_cache,
                                    const void* v_cache, void* out, int b,
                                    int hq, int hkv, int s_len, int d,
                                    int layer, int index, float scale,
                                    int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv || index < 0 || index > s_len)
    return (int)cudaErrorInvalidValue;
  const int g = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T, {
    switch (d) {
      case 64:
        return launch_d<T, 64>(g, q, kn, vn, k_cache, v_cache, out, b, hkv,
                               s_len, layer, index, scale, s);
      case 128:
        return launch_d<T, 128>(g, q, kn, vn, k_cache, v_cache, out, b, hkv,
                                s_len, layer, index, scale, s);
      case 256:
        return launch_d<T, 256>(g, q, kn, vn, k_cache, v_cache, out, b, hkv,
                                s_len, layer, index, scale, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaErrorInvalidValue;
}
