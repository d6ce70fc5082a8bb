// One-token decode attention over the stacked static KV cache.
// q [B, Hq, D], the step's own k/v kn/vn [B, Hkv, D], the WHOLE cache
// k_cache/v_cache [L, B, Hkv, S, D], out [B, Hq, D]. Two layouts: float
// (the cache in q's type) and int8 (int8 k/v with fp32 per-position
// scales k_scale/v_scale [L, B, Hkv, S]). Layer `layer` is read in place
// through its offset (no per-layer slice is ever copied); only positions
// [0, index) are read, and the fresh token joins the softmax first.
// q-head h·G + g reads kv-head h. `index` is one value for the batch, or,
// where `slot_index` [B] int32 is given, each row's own value read from
// device memory (the serving engine's slots sit at different positions,
// and a CUDA graph that captures the launch replays it at the positions
// of the moment).
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py:211 raw_call
//   (_kernel :98), both layouts.
// Bound on the H100: memory. Each step reads index·Hkv·D·2 cache
//   elements per batch row (2 bytes each in bf16, 1 in int8, plus 8
//   bytes of scales per position) for ~4·G operations per element pair,
//   far below the tensor cores' operations-per-byte line.
// int8 numerics follow the Pallas kernel (:134-172), not the JAX einsum
//   arm: k and v convert exactly to fp32 (|x| <= 127); the k scale folds
//   into each position's fp32 logit, the v scale into its probability,
//   which is then rounded to q's type (the Pallas kernel's cast before its
//   PV product); the softmax's sum takes the unrounded probabilities. The
//   step's own k/v attend raw. That rounding depends on the running
//   maximum each probability is taken against, so the int8 layout runs
//   its softmax in log2 units with every running maximum rounded up to an
//   integer: rescaling by another maximum is then a power of two, which
//   commutes with the rounding, and the result equals a softmax taken
//   against the final maximum (the plain version's) up to the exps' own
//   last bits.
// Design: one block of 4 warps per (b, kv-head). All G query heads of the
//   group are computed together, so each cache row is read once for the
//   group. A lane owns D/32 columns (lane + 32·c): loads are coalesced
//   across the warp. Warps take interleaved positions j = warp + 4·i in
//   [0, index) and keep their own fp32 online softmax (max, sum,
//   accumulator in registers); warp 0 starts from the fresh token. The
//   four partial states merge through shared memory at the end. Any S
//   and any index are taken: nothing past index is read.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kWarps = 4;

template <typename CT>
__device__ __forceinline__ float load_f32(CT v) {
  return ptt::to_f32(v);
}
template <>
__device__ __forceinline__ float load_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

constexpr float kLog2e = 1.4426950408889634f;

// The softmax's exp and running-maximum anchor: natural units and the
// maximum itself for the float layout; log2 units and the maximum rounded
// up to an integer for the int8 layout (see the note above).
template <bool QUANT>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (QUANT) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  } else {
    return __expf(x);
  }
}
template <bool QUANT>
__device__ __forceinline__ float softmax_anchor(float s) {
  if constexpr (QUANT) return ceilf(s);
  return s;
}

// CT is the cache's element type: T (float layout) or int8_t (QUANT).
template <typename T, typename CT, bool QUANT, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kn,
              const T* __restrict__ vn, const CT* __restrict__ k_cache,
              const CT* __restrict__ v_cache,
              const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ slot_index, T* __restrict__ out,
              int nb, int hkv, int s_len, int layer, int index_arg,
              float scale) {
  constexpr int C = D / 32;
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int hq = hkv * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int index = slot_index ? min(max(slot_index[b], 0), s_len)
                               : index_arg;

  float qr[G][C];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < C; ++c)
      qr[g][c] = ptt::to_f32(q[((int64_t)b * hq + h * G + g) * D + lane + 32 * c]) *
                 (QUANT ? scale * kLog2e : scale);

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
      const float s = ptt::warp_sum(part);
      m[g] = softmax_anchor<QUANT>(s);
      const float p = softmax_exp<QUANT>(s - m[g]);  // 1 in the float layout
      l[g] = p;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] = p * vnr[c];
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

  const int64_t row_off =
      (((int64_t)layer * nb + b) * hkv + h) * (int64_t)s_len;
  const CT* kc = k_cache + row_off * D + lane;
  const CT* vc = v_cache + row_off * D + lane;
  for (int j = warp; j < index; j += kWarps) {
    float kr[C], vr[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      kr[c] = load_f32(kc[(int64_t)j * D + 32 * c]);
      vr[c] = load_f32(vc[(int64_t)j * D + 32 * c]);
    }
    float ks = 1.f, vs = 1.f;
    if constexpr (QUANT) {
      ks = k_scale[row_off + j];
      vs = v_scale[row_off + j];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) part = fmaf(qr[g][c], kr[c], part);
      float s = ptt::warp_sum(part);
      if constexpr (QUANT) s *= ks;
      const float m_new = fmaxf(m[g], softmax_anchor<QUANT>(s));
      const float alpha = softmax_exp<QUANT>(m[g] - m_new);
      const float p = softmax_exp<QUANT>(s - m_new);
      l[g] = l[g] * alpha + p;
      m[g] = m_new;
      float pv = p;
      if constexpr (QUANT) pv = ptt::round_to<T>(p * vs);
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[g][c] = fmaf(pv, vr[c], acc[g][c] * alpha);
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
      // 0 for a warp with no rows
      const float f = softmax_exp<QUANT>(sm_m[w][g] - mx);
      den = fmaf(sm_l[w][g], f, den);
      num = fmaf(sm_acc[w][g][d], f, num);
    }
    out[((int64_t)b * hq + h * G + g) * D + d] = ptt::from_f32<T>(num / den);
  }
}

template <typename T, typename CT, bool QUANT, int D>
int launch_d(int g, const void* q, const void* kn, const void* vn,
             const void* kc, const void* vc, const float* ks,
             const float* vs, const int* slot_index, void* out, int b,
             int hkv, int s_len, int layer, int index, float scale,
             cudaStream_t s) {
  dim3 grid(hkv, b);
#define PTT_DECODE_CASE(GV)                                                 \
  case GV:                                                                  \
    decode_kernel<T, CT, QUANT, D, GV><<<grid, kWarps * 32, 0, s>>>(        \
        static_cast<const T*>(q), static_cast<const T*>(kn),                \
        static_cast<const T*>(vn), static_cast<const CT*>(kc),              \
        static_cast<const CT*>(vc), ks, vs, slot_index,                     \
        static_cast<T*>(out), b, hkv, s_len, layer, index, scale);          \
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

template <typename CT, bool QUANT>
int dispatch(const void* q, const void* kn, const void* vn,
             const void* k_cache, const void* v_cache, const float* k_scale,
             const float* v_scale, const int* slot_index, void* out, int b,
             int hq, int hkv, int s_len, int d, int layer, int index,
             float scale, int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv ||
      (!slot_index && (index < 0 || index > s_len)))
    return (int)cudaErrorInvalidValue;
  const int g = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T, {
    using C = typename std::conditional<QUANT, CT, T>::type;
    switch (d) {
      case 64:
        return launch_d<T, C, QUANT, 64>(g, q, kn, vn, k_cache, v_cache,
                                         k_scale, v_scale, slot_index, out,
                                         b, hkv, s_len, layer, index, scale,
                                         s);
      case 128:
        return launch_d<T, C, QUANT, 128>(g, q, kn, vn, k_cache, v_cache,
                                          k_scale, v_scale, slot_index, out,
                                          b, hkv, s_len, layer, index, scale,
                                          s);
      case 256:
        return launch_d<T, C, QUANT, 256>(g, q, kn, vn, k_cache, v_cache,
                                          k_scale, v_scale, slot_index, out,
                                          b, hkv, s_len, layer, index, scale,
                                          s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/out [B, Hq, D], kn/vn [B, Hkv, D], caches [L, B, Hkv, S, D] in q's
// type, all contiguous. D in {64, 128, 256}; G = Hq / Hkv in
// {1, 2, 4, 8}; 0 <= layer < L. slot_index null: every row reads
// [0, index), 0 <= index <= S; else row b reads [0, slot_index[b])
// (int32 [B], clamped to [0, S]) and index is not read.
extern "C" int ptt_decode_attention(const void* q, const void* kn,
                                    const void* vn, const void* k_cache,
                                    const void* v_cache,
                                    const int* slot_index, void* out, int b,
                                    int hq, int hkv, int s_len, int d,
                                    int layer, int index, float scale,
                                    int dtype, void* stream) {
  return dispatch<void, false>(q, kn, vn, k_cache, v_cache, nullptr,
                               nullptr, slot_index, out, b, hq, hkv, s_len,
                               d, layer, index, scale, dtype, stream);
}

// The int8 layout: k_cache/v_cache int8 [L, B, Hkv, S, D], k_scale/
// v_scale fp32 [L, B, Hkv, S]; q, kn, vn and out as above.
extern "C" int ptt_decode_attention_int8(
    const void* q, const void* kn, const void* vn, const void* k_cache,
    const void* v_cache, const float* k_scale, const float* v_scale,
    const int* slot_index, void* out, int b, int hq, int hkv, int s_len,
    int d, int layer, int index, float scale, int dtype, void* stream) {
  return dispatch<int8_t, true>(q, kn, vn, k_cache, v_cache, k_scale,
                                v_scale, slot_index, out, b, hq, hkv, s_len,
                                d, layer, index, scale, dtype, stream);
}
