// LayerNorm forward and backward.
//   forward:  mean = Σx / h, var = Σ(x − mean)² / h (two passes, not
//             Welford and not E[x²] − mean²), rstd = rsqrt(var + eps),
//             x̂ = (x − mean) · rstd, y = x̂ · w + b; statistics and the
//             affine step in fp32, y cast to the storage type on the
//             store; mean [n] and rstd [n] fp32 written too when asked
//             for (the backward's inputs).
//   backward: wg = g · w,
//             dx = rstd · (wg − mean(wg) − x̂ · mean(wg · x̂)),
//             dw = Σ_rows g · x̂, db = Σ_rows g, both in fp32.
//
// Replaces: paddle_tpu/ops/pallas/norm.py:212 _ln_fwd (_ln_fwd_kernel
//   :176) and norm.py:256 _ln_bwd_call (_ln_bwd_kernel :189).
// Bound on the H100: memory. The forward reads x once and writes y once,
//   the backward reads x and g once and writes dx once, at ~10 operations
//   per element, far below the ~295 operations per byte where the tensor
//   cores would become the limit.
// Design: as csrc/rms_norm.cu. One block of 256 threads per row
//   (forward) or per run of rows (backward); each thread strides over the
//   row, neighbouring threads on neighbouring addresses; fp32 sums reduce
//   through warp shuffles and one shared array. The forward's second and
//   third passes re-read the row from L1/L2, not from HBM. Any row count
//   and any h: the TPU gate (h % 128, n % 8) was a tiling artefact, so
//   GPT's decode step (n = 4) runs the kernel too.
//   dw/db: the TPU grid runs in order and carries both sums in its output
//   blocks across row blocks. Here blocks run in no order, so each
//   backward block keeps partial dw and db rows for its own rows in
//   shared memory (each thread owns its columns: no atomics) and writes
//   them out; a second kernel sums the partial rows per column in block
//   order. The caller fixes the block count, so the sum order, and the
//   result, is the same on every run and every card.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxH = 16384;  // dw and db rows in shared memory: 128 KB

template <typename T>
__global__ void layer_norm_kernel(const T* __restrict__ x,
                                  const T* __restrict__ w,
                                  const T* __restrict__ b, T* __restrict__ y,
                                  float* __restrict__ mean_out,
                                  float* __restrict__ rstd_out, int h,
                                  float eps) {
  const int64_t base = (int64_t)blockIdx.x * h;
  __shared__ float scratch[kThreads / 32];
  float s = 0.f;
  for (int c = threadIdx.x; c < h; c += kThreads) s += ptt::to_f32(x[base + c]);
  const float mean = ptt::block_sum<kThreads>(s, scratch) / (float)h;
  float ss = 0.f;
  for (int c = threadIdx.x; c < h; c += kThreads) {
    const float d = ptt::to_f32(x[base + c]) - mean;
    ss += d * d;
  }
  const float rstd =
      rsqrtf(ptt::block_sum<kThreads>(ss, scratch) / (float)h + eps);
  for (int c = threadIdx.x; c < h; c += kThreads) {
    const float xh = (ptt::to_f32(x[base + c]) - mean) * rstd;
    y[base + c] = ptt::from_f32<T>(xh * ptt::to_f32(w[c]) + ptt::to_f32(b[c]));
  }
  if (threadIdx.x == 0) {
    if (mean_out != nullptr) mean_out[blockIdx.x] = mean;
    if (rstd_out != nullptr) rstd_out[blockIdx.x] = rstd;
  }
}

// Two sums over the block at once: (a, b) -> (Σa, Σb). `scratch` holds
// 2 · kThreads / 32 floats; the trailing barrier lets the caller reuse it.
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float* scratch) {
  a = ptt::warp_sum(a);
  b = ptt::warp_sum(b);
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    scratch[warp] = a;
    scratch[kWarps + warp] = b;
  }
  __syncthreads();
  float2 total = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    total.x += scratch[i];
    total.y += scratch[kWarps + i];
  }
  __syncthreads();
  return total;
}

template <typename T>
__global__ void layer_norm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const T* __restrict__ g, T* __restrict__ dx,
    float* __restrict__ dw_part, float* __restrict__ db_part, int n, int h,
    int rows_per_block) {
  extern __shared__ float acc_s[];  // [2, h]: this block's dw and db rows
  float* dw_s = acc_s;
  float* db_s = acc_s + h;
  __shared__ float scratch[2 * kThreads / 32];
  for (int c = threadIdx.x; c < h; c += kThreads) dw_s[c] = db_s[c] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  for (int row = r0; row < r1; ++row) {
    const int64_t base = (int64_t)row * h;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < h; c += kThreads) {
      const float xh = (ptt::to_f32(x[base + c]) - mu) * rs;
      const float wg = ptt::to_f32(g[base + c]) * ptt::to_f32(w[c]);
      s1 += wg;
      s2 += wg * xh;
    }
    const float2 sums = block_sum2(s1, s2, scratch);
    const float c1 = sums.x / (float)h, c2 = sums.y / (float)h;
    for (int c = threadIdx.x; c < h; c += kThreads) {
      const float xh = (ptt::to_f32(x[base + c]) - mu) * rs;
      const float gv = ptt::to_f32(g[base + c]);
      dx[base + c] =
          ptt::from_f32<T>(rs * (gv * ptt::to_f32(w[c]) - c1 - xh * c2));
      dw_s[c] += gv * xh;  // column c is this thread's alone
      db_s[c] += gv;
    }
  }
  const int64_t out = (int64_t)blockIdx.x * h;
  for (int c = threadIdx.x; c < h; c += kThreads) {
    dw_part[out + c] = dw_s[c];
    db_part[out + c] = db_s[c];
  }
}

__global__ void ln_reduce_kernel(const float* __restrict__ dw_part,
                                 const float* __restrict__ db_part,
                                 float* __restrict__ dw,
                                 float* __restrict__ db, int blocks, int h) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= h) return;
  float sw = 0.f, sb = 0.f;
  for (int i = 0; i < blocks; ++i) {
    sw += dw_part[(int64_t)i * h + c];
    sb += db_part[(int64_t)i * h + c];
  }
  dw[c] = sw;
  db[c] = sb;
}

}  // namespace

// x, y: [n, h] contiguous; w, b: [h] in x's type; mean, rstd: [n] fp32,
// either NULL when not wanted.
extern "C" int ptt_layer_norm_fwd(const void* x, const void* w,
                                  const void* b, void* y, void* mean,
                                  void* rstd, int n, int h, float eps,
                                  int dtype, void* stream) {
  if (n <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T, {
    layer_norm_kernel<T><<<n, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<T*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), h, eps);
  });
  return (int)cudaGetLastError();
}

// x, g, dx: [n, h] contiguous; w: [h]; mean, rstd: [n] fp32 (the
// forward's); dw_part, db_part: [blocks, h] fp32 scratch; dw, db: [h]
// fp32. h <= 16384.
extern "C" int ptt_layer_norm_bwd(const void* x, const void* w,
                                  const void* mean, const void* rstd,
                                  const void* g, void* dx, void* dw_part,
                                  void* db_part, void* dw, void* db, int n,
                                  int h, int blocks, int dtype,
                                  void* stream) {
  if (n <= 0 || h <= 0 || h > kMaxH || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = (n + blocks - 1) / blocks;
  const size_t bytes = 2 * sizeof(float) * (size_t)h;
  cudaError_t err;
  PTT_DISPATCH_DTYPE(dtype, T, {
    static std::atomic<bool> smem_raised[ptt::kMaxDevices];
    err = ptt::raise_smem_limit(layer_norm_bwd_kernel<T>,
                                (int)(2 * sizeof(float) * kMaxH),
                                smem_raised);
    if (err != cudaSuccess) return (int)err;
    layer_norm_bwd_kernel<T><<<blocks, kThreads, bytes, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<const T*>(g), static_cast<T*>(dx),
        static_cast<float*>(dw_part), static_cast<float*>(db_part), n, h,
        rows_per_block);
  });
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_reduce_kernel<<<(h + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(dw_part), static_cast<const float*>(db_part),
      static_cast<float*>(dw), static_cast<float*>(db), blocks, h);
  return (int)cudaGetLastError();
}
