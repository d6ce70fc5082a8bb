// Flash attention forward, optionally causal, with grouped-query heads.
// q [B, Tq, Hq, D], k/v [B, Tk, Hkv, D], o [B, Tq, Hq, D] (the framework
// layout, no transpose); q-head h reads kv-head h / (Hq / Hkv). Causal
// visibility is offset by Tk - Tq: row i sees keys j <= i + Tk - Tq. The
// log-sum-exp per row (lse [B, Hq, Tq] fp32) is written when lse != NULL,
// for the training slice's backward.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py:128 _fwd
//   (_fwd_kernel :81).
// Bound on the H100: operations at long sequences (4·T²·D per head for
//   QK^T and PV, halved by causality), bytes at short ones. At the main
//   path's prefill (T = 128, D = 128) the q/k/v/o bytes dominate.
// Design: one block of 4 warps per (b, q-head, 64-row q tile). The q tile
//   (pre-scaled) and one 64-row k tile and v tile at a time sit in shared
//   memory as fp32 (k rows padded by one word so the 32 lanes reading 32
//   different keys hit 32 banks). Each warp owns 16 q rows; for each row
//   a lane scores keys lane and lane + 32, the warp reduces max and sum,
//   and the lane updates its D/32 accumulator columns (lane + 32·i) with
//   the broadcast probabilities. Running max, sum and accumulator stay in
//   fp32 registers: no [T, T] array exists anywhere. The k loop stops at
//   the diagonal of the tile's last row. Ragged T is masked, so no
//   T % block gate. This is the simple form: CUDA-core FMAs, no wgmma,
//   TMA or pipelining yet (later work). The backward kernels are in
//   flash_attention_bwd.cu.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;  // q rows per warp

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, int hq, int hkv,
                 float scale, int causal) {
  constexpr int C = D / 32;  // accumulator columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;                    // [kBQ][D]
  float* k_s = q_s + kBQ * D;           // [kBK][D + 1]
  float* v_s = k_s + kBK * (D + 1);     // [kBK][D]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int delta = tk - tq;

  for (int e = tid; e < kBQ * D; e += kWarps * 32) {
    const int r = e / D, d = e % D, qi = q0 + r;
    float val = 0.f;
    if (qi < tq) val = ptt::to_f32(q[(((int64_t)b * tq + qi) * hq + h) * D + d]);
    q_s[e] = val * scale;
  }

  float acc[kRows][C];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  const int last_q = min(q0 + kBQ, tq) - 1;
  const int kv_end = causal ? min(tk, last_q + delta + 1) : tk;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and q_s written)
    for (int e = tid; e < kBK * D; e += kWarps * 32) {
      const int j = e / D, d = e % D, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < tk) {
        const int64_t off = (((int64_t)b * tk + kj) * hkv + hk) * D + d;
        kv = ptt::to_f32(k[off]);
        vv = ptt::to_f32(v[off]);
      }
      k_s[j * (D + 1) + d] = kv;
      v_s[j * D + d] = vv;
    }
    __syncthreads();

    const int kj0 = k0 + lane, kj1 = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      const int qi = q0 + row;
      if (qi >= tq) continue;  // warp-uniform
      const float* qr = q_s + row * D;
      const float* k0r = k_s + lane * (D + 1);
      const float* k1r = k_s + (lane + 32) * (D + 1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        const float qd = qr[d];
        s0 = fmaf(qd, k0r[d], s0);
        s1 = fmaf(qd, k1r[d], s1);
      }
      const bool ok0 = kj0 < tk && (!causal || kj0 <= qi + delta);
      const bool ok1 = kj1 < tk && (!causal || kj1 <= qi + delta);
      s0 = ok0 ? s0 : -INFINITY;
      s1 = ok1 ? s1 : -INFINITY;
      const float tile_max = ptt::warp_max(fmaxf(s0, s1));
      if (tile_max == -INFINITY) continue;  // warp-uniform: row sees none
      const float m_new = fmaxf(m[r], tile_max);
      const float p0 = ok0 ? __expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? __expf(s1 - m_new) : 0.f;
      const float alpha = __expf(m[r] - m_new);  // 0 while m[r] = -inf
      l[r] = l[r] * alpha + ptt::warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float pj0 = __shfl_sync(0xffffffffu, p0, j);
        const float pj1 = __shfl_sync(0xffffffffu, p1, j);
        const float* v0r = v_s + j * D + lane;
        const float* v1r = v_s + (j + 32) * D + lane;
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[r][c] = fmaf(pj0, v0r[32 * c], fmaf(pj1, v1r[32 * c], acc[r][c]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= tq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    T* orow = o + (((int64_t)b * tq + qi) * hq + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c)
      orow[lane + 32 * c] = ptt::from_f32<T>(acc[r][c] * inv);
    if (lse != nullptr && lane == 0)
      lse[((int64_t)b * hq + h) * tq + qi] =
          l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int tq, int tk, int hq, int hkv, float scale, int causal,
           cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<D>();
  static std::atomic<bool> smem_raised[ptt::kMaxDevices];
  cudaError_t err = ptt::raise_smem_limit(flash_fwd_kernel<T, D>, (int)bytes,
                                          smem_raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T, D><<<grid, kWarps * 32, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      tq, tk, hq, hkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// All tensors contiguous; lse may be NULL. D in {64, 128, 256}.
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int b, int tq, int tk, int hq,
                                       int hkv, int d, float scale,
                                       int causal, int dtype, void* stream) {
  if (b <= 0 || tq <= 0 || tk <= 0 || hkv <= 0 || hq % hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T, {
    switch (d) {
      case 64:
        return launch<T, 64>(q, k, v, o, lse, b, tq, tk, hq, hkv, scale,
                             causal, s);
      case 128:
        return launch<T, 128>(q, k, v, o, lse, b, tq, tk, hq, hkv, scale,
                              causal, s);
      case 256:
        return launch<T, 256>(q, k, v, o, lse, b, tq, tk, hq, hkv, scale,
                              causal, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaErrorInvalidValue;
}
