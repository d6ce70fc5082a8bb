// The one-token decode attention kernel that the stacked-cache kernels
// (decode_attention.cu) and the paged-pool kernels
// (paged_decode_attention.cu) share. Only where a position's row lies
// differs between them; that is the `Rows` policy each source defines:
//   Rows::at(b, h) -> Walk, with Walk::fill (the positions [0, fill) that
//   slot b reads) and Walk::row(j) (position j's row index into the leaf
//   viewed as [rows, D], which is also the scales' index).
// Because both sources instantiate this one body, an int8 step through the
// page table equals the slots' pages gathered into a stacked cache and run
// through the stacked kernel bit for bit.
//
// Two layouts: float (k/v in q's type) and int8 (QUANT: int8 k/v with fp32
// per-position scales k_scale/v_scale, one a row). q [B, Hq, D], the
// step's own k/v kn/vn [B, Hkv, D], out [B, Hq, D]; q-head h·G + g reads
// kv-head h. The fresh token joins the softmax first.
// int8 numerics follow the Pallas kernels (decode_attention.py:134-172,
//   paged_decode_attention.py:140-158), not the JAX einsum arm: k and v
//   convert exactly to fp32 (|x| <= 127); the k scale folds into each
//   position's fp32 logit, the v scale into its probability, which is then
//   rounded to q's type (the Pallas kernels' cast before their PV product);
//   the softmax's sum takes the unrounded probabilities. The step's own
//   k/v attend raw. That rounding depends on the running maximum each
//   probability is taken against, so the int8 layout runs its softmax in
//   log2 units with every running maximum rounded up to an integer:
//   rescaling by another maximum is then a power of two, which commutes
//   with the rounding, and the result equals a softmax taken against the
//   final maximum (the plain version's) up to the exps' own last bits.
// Design: one block of 4 warps per (b, kv-head). All G query heads of the
//   group are computed together, so each row is read once for the group.
//   A lane owns D/32 columns (lane + 32·c): loads are coalesced across the
//   warp. Warps take interleaved positions j = warp + 4·i in [0, fill) and
//   keep their own fp32 online softmax (max, sum, accumulator in
//   registers), the loop unrolled by 4; warp 0 starts from the fresh
//   token. The four partial states merge through shared memory at the
//   end.
#pragma once

#include "common.cuh"

#include <type_traits>

namespace ptt {
namespace decode {

constexpr int kWarps = 4;
constexpr float kLog2e = 1.4426950408889634f;

template <typename CT>
__device__ __forceinline__ float load_f32(CT v) {
  return to_f32(v);
}
template <>
__device__ __forceinline__ float load_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

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
template <typename T, typename CT, bool QUANT, int D, int G, typename Rows>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kn,
              const T* __restrict__ vn, const CT* __restrict__ k_rows,
              const CT* __restrict__ v_rows,
              const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, const Rows rows,
              T* __restrict__ out, int hkv, float scale) {
  constexpr int C = D / 32;
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int hq = hkv * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const typename Rows::Walk walk = rows.at(b, h);

  float qr[G][C];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < C; ++c)
      qr[g][c] = to_f32(q[((int64_t)b * hq + h * G + g) * D + lane + 32 * c]) *
                 (QUANT ? scale * kLog2e : scale);

  float m[G], l[G], acc[G][C];
  if (warp == 0) {
    float knr[C], vnr[C];
    const int64_t off = ((int64_t)b * hkv + h) * D + lane;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      knr[c] = to_f32(kn[off + 32 * c]);
      vnr[c] = to_f32(vn[off + 32 * c]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) part = fmaf(qr[g][c], knr[c], part);
      const float s = warp_sum(part);
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

  // unrolled so that a warp has several positions' loads in flight: the
  // walk is bound by load latency, not by bytes
#pragma unroll 4
  for (int j = warp; j < walk.fill; j += kWarps) {
    const int64_t r = walk.row(j);
    const int64_t elem = r * D + lane;
    float kr[C], vr[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      kr[c] = load_f32(k_rows[elem + 32 * c]);
      vr[c] = load_f32(v_rows[elem + 32 * c]);
    }
    float ks = 1.f, vs = 1.f;
    if constexpr (QUANT) {
      ks = k_scale[r];
      vs = v_scale[r];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) part = fmaf(qr[g][c], kr[c], part);
      float s = warp_sum(part);
      if constexpr (QUANT) s *= ks;
      const float m_new = fmaxf(m[g], softmax_anchor<QUANT>(s));
      const float alpha = softmax_exp<QUANT>(m[g] - m_new);
      const float p = softmax_exp<QUANT>(s - m_new);
      l[g] = l[g] * alpha + p;
      m[g] = m_new;
      float pv = p;
      if constexpr (QUANT) pv = round_to<T>(p * vs);
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
    out[((int64_t)b * hq + h * G + g) * D + d] = from_f32<T>(num / den);
  }
}

template <typename T, typename CT, bool QUANT, int D, typename Rows>
int launch_d(int g, const void* q, const void* kn, const void* vn,
             const void* k, const void* v, const float* ks, const float* vs,
             const Rows& rows, void* out, int b, int hkv, float scale,
             cudaStream_t s) {
  dim3 grid(hkv, b);
#define PTT_DECODE_CASE(GV)                                                 \
  case GV:                                                                  \
    decode_kernel<T, CT, QUANT, D, GV, Rows><<<grid, kWarps * 32, 0, s>>>(  \
        static_cast<const T*>(q), static_cast<const T*>(kn),                \
        static_cast<const T*>(vn), static_cast<const CT*>(k),               \
        static_cast<const CT*>(v), ks, vs, rows, static_cast<T*>(out), hkv, \
        scale);                                                             \
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

// Launch over the grid (hkv, b) for the type tag `dtype`, head_dim d in
// {64, 128, 256} and G = hq / hkv in {1, 2, 4, 8}. CT is the int8 layout's
// element type where QUANT, ignored (q's type) otherwise.
template <typename CT, bool QUANT, typename Rows>
int launch(const void* q, const void* kn, const void* vn, const void* k,
           const void* v, const float* k_scale, const float* v_scale,
           const Rows& rows, void* out, int b, int hq, int hkv, int d,
           float scale, int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  const int g = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T, {
    using C = typename std::conditional<QUANT, CT, T>::type;
    switch (d) {
      case 64:
        return launch_d<T, C, QUANT, 64>(g, q, kn, vn, k, v, k_scale,
                                         v_scale, rows, out, b, hkv, scale,
                                         s);
      case 128:
        return launch_d<T, C, QUANT, 128>(g, q, kn, vn, k, v, k_scale,
                                          v_scale, rows, out, b, hkv, scale,
                                          s);
      case 256:
        return launch_d<T, C, QUANT, 256>(g, q, kn, vn, k, v, k_scale,
                                          v_scale, rows, out, b, hkv, scale,
                                          s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace ptt
