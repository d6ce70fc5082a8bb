// Flash attention backward, optionally causal, with grouped-query heads:
// two kernels, dq and dk/dv, in the layout of flash_attention.cu (q, o, dO
// [B, Tq, Hq, D], k/v [B, Tk, Hkv, D]; q-head h reads kv-head h / G with
// G = Hq / Hkv; row i sees keys j <= i + Tk - Tq when causal). Both
// recompute the probabilities from the forward's row log-sum-exp,
//   P = exp(S - lse),  S = scale · q kᵀ,
// and take delta = rowsum(dO · O) (lse, delta [B, Hq, Tq] fp32, computed
// by the caller as the JAX package does outside its kernels):
//   dS = P ∘ (dO vᵀ − delta) · scale,  dq = dS k,  dk = dSᵀ q,  dv = Pᵀ dO.
// Scores, P and dS stay in fp32; P and dS are rounded to the input type
// before the products, as the TPU kernels cast them (flash_attention.py
// :199-201, :236-246).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py:261 _bwd_impl, its
//   dq kernel (_dq_kernel :175, call :282) and its dk/dv kernel
//   (_dkv_kernel :215, call :308).
// Bound on the H100: operations. Per head the backward does five products
//   of T·T·D multiply-adds (S, dO vᵀ, dq, dk, dv; S and dO vᵀ again in the
//   second kernel), halved by causality; its bytes are a few [T, D] rows.
// Design: the simple CUDA-core form, as flash_attention.cu: fp32 tiles in
//   shared memory, one lane per key (dq) or per query (dk/dv) and its
//   neighbour 32 rows on, fp32 accumulators in registers, probabilities
//   broadcast through warp shuffles. No [T, T] array exists anywhere, no
//   atomics, so every result is deterministic.
//   - dq: one block of 8 warps per (b, q-head, q tile); it loops over the
//     k tiles up to the diagonal of its last row.
//   - dk/dv: one block of 8 warps per (b, kv-head, k tile); it loops over
//     the group's G q-heads and, for each, over the q tiles from the
//     diagonal on, and writes [B, Tk, Hkv, D] directly. The TPU kernel
//     writes per-q-head [B, Hq, Tk, D] and sums the groups outside; here
//     the group sum is part of the fp32 accumulation, so no such buffer.
//   Ragged T is masked: no T % block gate. Tiles shrink at D = 256 to stay
//   inside 227 KB of shared memory. Tensor cores (mma.sync / wgmma) are
//   later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPair = 64;  // rows a warp's lanes cover: lane and lane + 32

// ------------------------------------------------------------------ dq

template <int D>
__host__ __device__ constexpr int dq_rows() {
  return D == 256 ? 32 : 64;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q and dO tiles [BQ][D]; k and v tiles [64][D + 1] (padded: lanes read
  // 32 different keys at one column)
  return sizeof(float) * (2 * (size_t)dq_rows<D>() * D +
                          2 * (size_t)kPair * (D + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int tq, int tk, int hq, int hkv, float scale,
                    int causal) {
  constexpr int BQ = dq_rows<D>();
  constexpr int RW = BQ / kWarps;  // q rows per warp
  constexpr int C = D / 32;        // accumulator columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;                  // [BQ][D]
  float* do_s = q_s + BQ * D;         // [BQ][D]
  float* k_s = do_s + BQ * D;         // [64][D + 1]
  float* v_s = k_s + kPair * (D + 1); // [64][D + 1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int delta_qk = tk - tq;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e % D, qi = q0 + r;
    float qv = 0.f, dv = 0.f;
    if (qi < tq) {
      const int64_t off = (((int64_t)b * tq + qi) * hq + h) * D + d;
      qv = ptt::to_f32(q[off]);
      dv = ptt::to_f32(dout[off]);
    }
    q_s[e] = qv;
    do_s[e] = dv;
  }
  float row_lse[RW], row_delta[RW], acc[RW][C];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int qi = q0 + warp * RW + r;
    const int64_t at = ((int64_t)b * hq + h) * tq + qi;
    row_lse[r] = qi < tq ? lse[at] : 0.f;
    row_delta[r] = qi < tq ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  const int last_q = min(q0 + BQ, tq) - 1;
  const int kv_end = causal ? min(tk, last_q + delta_qk + 1) : tk;

  for (int k0 = 0; k0 < kv_end; k0 += kPair) {
    __syncthreads();  // previous tile consumed (and q_s / do_s written)
    for (int e = tid; e < kPair * D; e += kThreads) {
      const int j = e / D, d = e % D, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < tk) {
        const int64_t off = (((int64_t)b * tk + kj) * hkv + hk) * D + d;
        kv = ptt::to_f32(k[off]);
        vv = ptt::to_f32(v[off]);
      }
      k_s[j * (D + 1) + d] = kv;
      v_s[j * (D + 1) + d] = vv;
    }
    __syncthreads();

    const int kj0 = k0 + lane, kj1 = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = warp * RW + r;
      const int qi = q0 + row;
      if (qi >= tq) continue;  // warp-uniform
      if (causal && k0 > qi + delta_qk) continue;  // tile past the diagonal
      const float* qr = q_s + row * D;
      const float* dr = do_s + row * D;
      const float* k0r = k_s + lane * (D + 1);
      const float* k1r = k_s + (lane + 32) * (D + 1);
      const float* v0r = v_s + lane * (D + 1);
      const float* v1r = v_s + (lane + 32) * (D + 1);
      float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float qd = qr[d], od = dr[d];
        s0 = fmaf(qd, k0r[d], s0);
        s1 = fmaf(qd, k1r[d], s1);
        dp0 = fmaf(od, v0r[d], dp0);
        dp1 = fmaf(od, v1r[d], dp1);
      }
      const bool ok0 = kj0 < tk && (!causal || kj0 <= qi + delta_qk);
      const bool ok1 = kj1 < tk && (!causal || kj1 <= qi + delta_qk);
      const float p0 = ok0 ? __expf(s0 * scale - row_lse[r]) : 0.f;
      const float p1 = ok1 ? __expf(s1 * scale - row_lse[r]) : 0.f;
      const float ds0 = ptt::round_to<T>(p0 * (dp0 - row_delta[r]) * scale);
      const float ds1 = ptt::round_to<T>(p1 * (dp1 - row_delta[r]) * scale);
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float dj0 = __shfl_sync(0xffffffffu, ds0, j);
        const float dj1 = __shfl_sync(0xffffffffu, ds1, j);
        const float* kr0 = k_s + j * (D + 1) + lane;
        const float* kr1 = k_s + (j + 32) * (D + 1) + lane;
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[r][c] = fmaf(dj0, kr0[32 * c], fmaf(dj1, kr1[32 * c], acc[r][c]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int qi = q0 + warp * RW + r;
    if (qi >= tq) continue;
    T* out = dq + (((int64_t)b * tq + qi) * hq + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) out[lane + 32 * c] = ptt::from_f32<T>(acc[r][c]);
  }
}

// --------------------------------------------------------------- dk/dv

template <int D>
__host__ __device__ constexpr int dkv_rows() {
  return D == 256 ? 32 : 64;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // q and dO tiles [64][D + 1] (padded: lanes read 32 different queries at
  // one column), k and v tiles [BK][D], lse and delta of the q tile
  return sizeof(float) * (2 * (size_t)kPair * (D + 1) +
                          2 * (size_t)dkv_rows<D>() * D + 2 * kPair);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int tq, int tk, int hq, int hkv,
                      float scale, int causal) {
  constexpr int BK = dkv_rows<D>();
  constexpr int RW = BK / kWarps;  // k rows per warp
  constexpr int C = D / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                     // [64][D + 1]
  float* do_s = q_s + kPair * (D + 1);   // [64][D + 1]
  float* k_s = do_s + kPair * (D + 1);   // [BK][D]
  float* v_s = k_s + BK * D;             // [BK][D]
  float* lse_s = v_s + BK * D;           // [64]
  float* dta_s = lse_s + kPair;          // [64]

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int delta_qk = tk - tq;

  for (int e = tid; e < BK * D; e += kThreads) {
    const int j = e / D, d = e % D, kj = k0 + j;
    float kv = 0.f, vv = 0.f;
    if (kj < tk) {
      const int64_t off = (((int64_t)b * tk + kj) * hkv + hk) * D + d;
      kv = ptt::to_f32(k[off]);
      vv = ptt::to_f32(v[off]);
    }
    k_s[e] = kv;
    v_s[e] = vv;
  }
  float dk_acc[RW][C], dv_acc[RW][C];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // the first query row that sees key k0 is k0 - delta_qk
  const int q_begin = causal ? max(0, k0 - delta_qk) / kPair * kPair : 0;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int q0 = q_begin; q0 < tq; q0 += kPair) {
      __syncthreads();  // previous tile consumed (and k_s / v_s written)
      for (int e = tid; e < kPair * D; e += kThreads) {
        const int i = e / D, d = e % D, qi = q0 + i;
        float qv = 0.f, ov = 0.f;
        if (qi < tq) {
          const int64_t off = (((int64_t)b * tq + qi) * hq + h) * D + d;
          qv = ptt::to_f32(q[off]);
          ov = ptt::to_f32(dout[off]);
        }
        q_s[i * (D + 1) + d] = qv;
        do_s[i * (D + 1) + d] = ov;
      }
      if (tid < kPair) {
        const int qi = q0 + tid;
        const int64_t at = ((int64_t)b * hq + h) * tq + qi;
        lse_s[tid] = qi < tq ? lse[at] : 0.f;
        dta_s[tid] = qi < tq ? delta[at] : 0.f;
      }
      __syncthreads();

      const int qi0 = q0 + lane, qi1 = q0 + lane + 32;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int j = warp * RW + r;
        const int kj = k0 + j;
        if (kj >= tk) continue;  // warp-uniform
        if (causal && kj > q0 + kPair - 1 + delta_qk) continue;  // no row sees it
        const float* kr = k_s + j * D;
        const float* vr = v_s + j * D;
        const float* q0r = q_s + lane * (D + 1);
        const float* q1r = q_s + (lane + 32) * (D + 1);
        const float* o0r = do_s + lane * (D + 1);
        const float* o1r = do_s + (lane + 32) * (D + 1);
        float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float kd = kr[d], vd = vr[d];
          s0 = fmaf(q0r[d], kd, s0);
          s1 = fmaf(q1r[d], kd, s1);
          dp0 = fmaf(o0r[d], vd, dp0);
          dp1 = fmaf(o1r[d], vd, dp1);
        }
        const bool ok0 = qi0 < tq && (!causal || kj <= qi0 + delta_qk);
        const bool ok1 = qi1 < tq && (!causal || kj <= qi1 + delta_qk);
        const float p0 = ok0 ? __expf(s0 * scale - lse_s[lane]) : 0.f;
        const float p1 = ok1 ? __expf(s1 * scale - lse_s[lane + 32]) : 0.f;
        const float ds0 = ptt::round_to<T>(p0 * (dp0 - dta_s[lane]) * scale);
        const float ds1 =
            ptt::round_to<T>(p1 * (dp1 - dta_s[lane + 32]) * scale);
        const float pr0 = ptt::round_to<T>(p0), pr1 = ptt::round_to<T>(p1);
#pragma unroll 4
        for (int i = 0; i < 32; ++i) {
          const float pi0 = __shfl_sync(0xffffffffu, pr0, i);
          const float pi1 = __shfl_sync(0xffffffffu, pr1, i);
          const float di0 = __shfl_sync(0xffffffffu, ds0, i);
          const float di1 = __shfl_sync(0xffffffffu, ds1, i);
          const float* or0 = do_s + i * (D + 1) + lane;
          const float* or1 = do_s + (i + 32) * (D + 1) + lane;
          const float* qr0 = q_s + i * (D + 1) + lane;
          const float* qr1 = q_s + (i + 32) * (D + 1) + lane;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            dv_acc[r][c] = fmaf(pi0, or0[32 * c],
                                fmaf(pi1, or1[32 * c], dv_acc[r][c]));
            dk_acc[r][c] = fmaf(di0, qr0[32 * c],
                                fmaf(di1, qr1[32 * c], dk_acc[r][c]));
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int kj = k0 + warp * RW + r;
    if (kj >= tk) continue;
    const int64_t off = (((int64_t)b * tk + kj) * hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[off + lane + 32 * c] = ptt::from_f32<T>(dk_acc[r][c]);
      dv[off + lane + 32 * c] = ptt::from_f32<T>(dv_acc[r][c]);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int tq,
              int tk, int hq, int hkv, float scale, int causal,
              cudaStream_t s) {
  constexpr size_t bytes = dq_smem_bytes<D>();
  static std::atomic<bool> smem_raised[ptt::kMaxDevices];
  cudaError_t err = ptt::raise_smem_limit(flash_bwd_dq_kernel<T, D>,
                                          (int)bytes, smem_raised);
  if (err != cudaSuccess) return (int)err;
  constexpr int BQ = dq_rows<D>();
  dim3 grid((tq + BQ - 1) / BQ, hq, b);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), tq, tk, hq, hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int b, int tq, int tk, int hq, int hkv,
                float scale, int causal, cudaStream_t s) {
  constexpr size_t bytes = dkv_smem_bytes<D>();
  static std::atomic<bool> smem_raised[ptt::kMaxDevices];
  cudaError_t err = ptt::raise_smem_limit(flash_bwd_dkdv_kernel<T, D>,
                                          (int)bytes, smem_raised);
  if (err != cudaSuccess) return (int)err;
  constexpr int BK = dkv_rows<D>();
  dim3 grid((tk + BK - 1) / BK, hkv, b);
  flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, hq, hkv, scale,
      causal);
  return (int)cudaGetLastError();
}

bool bad_shape(int b, int tq, int tk, int hq, int hkv) {
  return b <= 0 || tq <= 0 || tk <= 0 || hkv <= 0 || hq % hkv;
}

}  // namespace

// All tensors contiguous: q, dout, dq [b, tq, hq, d]; k, v [b, tk, hkv, d];
// lse, delta [b, hq, tq] fp32. D in {64, 128, 256}.
extern "C" int ptt_flash_attention_bwd_dq(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dq, int b, int tq, int tk,
                                          int hq, int hkv, int d, float scale,
                                          int causal, int dtype,
                                          void* stream) {
  if (bad_shape(b, tq, tk, hq, hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T, {
    switch (d) {
      case 64:
        return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, b, tq, tk, hq,
                                hkv, scale, causal, s);
      case 128:
        return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, b, tq, tk,
                                 hq, hkv, scale, causal, s);
      case 256:
        return launch_dq<T, 256>(q, k, v, dout, lse, delta, dq, b, tq, tk,
                                 hq, hkv, scale, causal, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaErrorInvalidValue;
}

// dk, dv [b, tk, hkv, d], the sums over each kv-head's group of q-heads.
extern "C" int ptt_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int tq,
    int tk, int hq, int hkv, int d, float scale, int causal, int dtype,
    void* stream) {
  if (bad_shape(b, tq, tk, hq, hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T, {
    switch (d) {
      case 64:
        return launch_dkdv<T, 64>(q, k, v, dout, lse, delta, dk, dv, b, tq,
                                  tk, hq, hkv, scale, causal, s);
      case 128:
        return launch_dkdv<T, 128>(q, k, v, dout, lse, delta, dk, dv, b, tq,
                                   tk, hq, hkv, scale, causal, s);
      case 256:
        return launch_dkdv<T, 256>(q, k, v, dout, lse, delta, dk, dv, b, tq,
                                   tk, hq, hkv, scale, causal, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaErrorInvalidValue;
}
