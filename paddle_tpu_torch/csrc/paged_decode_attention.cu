// One-token decode attention over the paged KV pool, one query token a
// slot, each slot at its own position.
// q [B, Hq, D], the step's own k/v kn/vn [B, Hkv, D], the WHOLE pool
// k_pool/v_pool [N + 1, L, Hkv, P, D] (page 0 is the null page), the page
// table [B, M] int32 and the fill positions pos [B] int32, out [B, Hq, D].
// Slot b attends to its positions [0, pos[b]), position p read in place
// from page table[b, p / P] at offset p % P of layer `layer`, plus its
// fresh k/v, under one streaming softmax. Nothing is gathered: the page
// indirection is an address computation. q-head h·G + g reads kv-head h.
//
// Replaces: paddle_tpu/ops/pallas/paged_decode_attention.py:175 raw_call
//   (_kernel :105), the float pool layout. The int8 pool is not ported.
// Bound on the H100: memory. A step reads pos[b]·Hkv·D·2 pool elements a
//   slot (plus the table) for ~4·G operations per element pair, far
//   below the tensor cores' operations-per-byte line.
// Design: the stacked-cache decode kernel (decode_attention.cu) with its
//   row address taken through the page table: one block of 4 warps per
//   (slot, kv-head); all G query heads of the group together, so each
//   pool row is read once for the group; a lane owns D/32 columns; warps
//   take interleaved positions and keep their own fp32 online softmax,
//   warp 0 starting from the fresh token; the partial states merge
//   through shared memory. The TPU kernel's grid walks pages one DMA'd
//   block at a time and clamps past the last live page; here the loop
//   simply ends at pos[b]. pos and the table are read from device memory,
//   so a CUDA graph that captures the launch replays it at the slots'
//   current positions and pages.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                    const T* __restrict__ vn, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, T* __restrict__ out,
                    int hkv, int n_layers, int page, int max_pages,
                    int layer, float scale) {
  constexpr int C = D / 32;
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int hq = hkv * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // positions past the table's reach are not read
  const int fill = min(max(pos[b], 0), max_pages * page);
  const int* row = table + (int64_t)b * max_pages;

  float qr[G][C];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < C; ++c)
      qr[g][c] = ptt::to_f32(
                     q[((int64_t)b * hq + h * G + g) * D + lane + 32 * c]) *
                 scale;

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

  for (int j = warp; j < fill; j += kWarps) {
    const int64_t pid = row[j / page];
    const int64_t elem =
        (((pid * n_layers + layer) * hkv + h) * page + j % page) * D + lane;
    float kr[C], vr[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      kr[c] = ptt::to_f32(k_pool[elem + 32 * c]);
      vr[c] = ptt::to_f32(v_pool[elem + 32 * c]);
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
      for (int c = 0; c < C; ++c)
        acc[g][c] = fmaf(p, vr[c], acc[g][c] * alpha);
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
             const void* kp, const void* vp, const int* table,
             const int* pos, void* out, int b, int hkv, int n_layers,
             int page, int max_pages, int layer, float scale,
             cudaStream_t s) {
  dim3 grid(hkv, b);
#define PTT_PAGED_CASE(GV)                                                  \
  case GV:                                                                  \
    paged_decode_kernel<T, D, GV><<<grid, kWarps * 32, 0, s>>>(             \
        static_cast<const T*>(q), static_cast<const T*>(kn),                \
        static_cast<const T*>(vn), static_cast<const T*>(kp),               \
        static_cast<const T*>(vp), table, pos, static_cast<T*>(out), hkv,   \
        n_layers, page, max_pages, layer, scale);                           \
    break;
  switch (g) {
    PTT_PAGED_CASE(1)
    PTT_PAGED_CASE(2)
    PTT_PAGED_CASE(4)
    PTT_PAGED_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PTT_PAGED_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// q/out [B, Hq, D], kn/vn [B, Hkv, D], pools [N + 1, L, Hkv, P, D] in q's
// type, table [B, M] int32, pos [B] int32, all contiguous. D in
// {64, 128, 256}; G = Hq / Hkv in {1, 2, 4, 8}; 0 <= layer < L. Page ids
// in the table must lie in [0, N]; pos is clamped to [0, M·P].
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* kn, const void* vn, const void* k_pool,
    const void* v_pool, const void* table, const void* pos, void* out,
    int b, int hq, int hkv, int n_layers, int page, int max_pages, int d,
    int layer, float scale, int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv || page <= 0 || max_pages <= 0 ||
      layer < 0 || layer >= n_layers)
    return (int)cudaErrorInvalidValue;
  const int g = hq / hkv;
  const int* tb = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T, {
    switch (d) {
      case 64:
        return launch_d<T, 64>(g, q, kn, vn, k_pool, v_pool, tb, ps, out, b,
                               hkv, n_layers, page, max_pages, layer, scale,
                               s);
      case 128:
        return launch_d<T, 128>(g, q, kn, vn, k_pool, v_pool, tb, ps, out, b,
                                hkv, n_layers, page, max_pages, layer, scale,
                                s);
      case 256:
        return launch_d<T, 256>(g, q, kn, vn, k_pool, v_pool, tb, ps, out, b,
                                hkv, n_layers, page, max_pages, layer, scale,
                                s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaErrorInvalidValue;
}
