// Fused LM head ⊗ cross-entropy: the per-row loss terms of
// logits = h @ W (h [N, E], W [E, V], bf16) and both gradients, without the
// [N, V] logits ever existing in device memory.
//
// Replaces: paddle_tpu/ops/pallas/linear_xent.py:187 _fwd_call (B11),
//   :221 _dh_call (B12) and :247 _dw_call (B13) (kernels :103-180).
// Bound on the H100: operations. The forward is one product (2·N·E·V); the
//   backward recomputes the logits (2·N·E·V) and takes one product for each
//   gradient it is asked for (2·N·E·V each): 8·N·E·V for the head, where the
//   TPU's two backward kernels, each recomputing its logits, take 10.
// Design: every product runs on the tensor cores through one tile routine
//   (tile_product): a block of 8 warps owns a 128 x 128 fp32 tile,
//   streams the reduction axis 32 deep through shared memory (the next
//   step's global loads in flight in registers while the current step
//   multiplies), and each warp holds 4 x 2 wmma 16x16x16 accumulators (bf16
//   in, fp32 out). Ragged rows, columns and depth are zero-filled on load,
//   so no shape gate: any N, E and V. Plain wmma, no wgmma, TMA or warp
//   specialisation yet (later work).
//   - forward: the TPU walks the vocab axis in order with a running max and
//     sum in scratch. Here each block takes 128 rows and a group of 8 vocab
//     tiles, keeps the running (max, sum, label logit) per row in shared
//     memory, and writes one partial per (group, row); a second kernel
//     merges the groups per row in group order: deterministic, no atomics.
//     A partial vocab tile masks its missing columns out of the max.
//   - backward: the TPU keeps a [bN, E] (dH) or [E, bV] (dW) fp32
//     accumulator in VMEM across its grid, 512 KB at E = 2048, past the
//     227 KB a block may hold. Here one entry walks the vocabulary in
//     chunks of Vc columns: one kernel recomputes the chunk's logits and
//     writes dlogits = (exp(logits − lse) − onehot)·g, rounded to bf16 as
//     the TPU rounds it before its products, into a [N, Vc] scratch; then
//     one product takes dH += dlogits · W_chunkᵀ into an fp32 [N, E] buffer
//     (bf16 dH written after the last chunk) and another dW_chunk = hᵀ ·
//     dlogits with the whole N reduced in one fp32 tile accumulator. Either
//     product may be skipped (dH or dW alone). A label outside [0, V)
//     selects nothing and adds no one-hot term.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 128;                      // tile rows
constexpr int kBN = 128;                      // tile columns
constexpr int kBK = 32;                       // reduction depth per step
constexpr int kThreads = 256;                 // 8 warps: 2 rows x 4 columns
constexpr int kWM = 64, kWN = 32;             // one warp's part of the tile
constexpr int kFM = kWM / 16, kFN = kWN / 16;  // its 4 x 2 fragments
constexpr int kPad = 8;                       // bf16 padding per tile row
constexpr int kOperandElems = kBM * (kBK + kPad);  // >= kBK * (kBM + kPad)
constexpr int kCLd = kBN + 4;                 // fp32 tile row, padded
constexpr size_t kTileBytes = sizeof(float) * kBM * kCLd;
constexpr size_t kFwdBytes = kTileBytes + 3 * sizeof(float) * kBM;
constexpr int kTilesPerGroup = 8;             // forward: vocab tiles a block
static_assert(kBK * (kBM + kPad) <= kOperandElems, "operand tile size");
static_assert(2 * sizeof(uint16_t) * kOperandElems <= kTileBytes,
              "the fp32 tile reuses the operand tiles' shared memory");

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// An R x C tile of a bf16 matrix whose element (r, c) is
// p[(r0 + r) * ld + c0 + c], zero where r0 + r >= r_ext or c0 + c >= c_ext.
// C is the contiguous axis. Each thread moves kSegs runs of 8 elements:
// one 16-byte load where the run is whole and `vec` (p 16-byte aligned,
// ld % 8 == 0), element by element otherwise.
template <int R, int C>
struct TileLoader {
  static constexpr int kRuns = C / 8;
  static constexpr int kSegs = R * C / 8 / kThreads;
  static_assert(kSegs * kThreads * 8 == R * C, "tile splits evenly");
  uint4 regs[kSegs];

  __device__ __forceinline__ void load(const uint16_t* __restrict__ p,
                                       int64_t ld, int r0, int c0, int r_ext,
                                       int c_ext, bool vec) {
#pragma unroll
    for (int s = 0; s < kSegs; ++s) {
      const int seg = threadIdx.x + s * kThreads;
      const int r = r0 + seg / kRuns;
      const int c = c0 + (seg % kRuns) * 8;
      if (r < r_ext && vec && c + 8 <= c_ext) {
        regs[s] = *reinterpret_cast<const uint4*>(p + (int64_t)r * ld + c);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (r < r_ext) {
          const uint16_t* row = p + (int64_t)r * ld;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (c + i < c_ext)
              w[i / 2] |= (uint32_t)row[c + i] << (16 * (i % 2));
        }
        regs[s] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }

  __device__ __forceinline__ void store(uint16_t* tile) const {
#pragma unroll
    for (int s = 0; s < kSegs; ++s) {
      const int seg = threadIdx.x + s * kThreads;
      *reinterpret_cast<uint4*>(tile + (seg / kRuns) * (C + kPad) +
                                (seg % kRuns) * 8) = regs[s];
    }
  }
};

__device__ __forceinline__ int warp_row0() {
  return (threadIdx.x / 32) / (kBN / kWN) * kWM;
}
__device__ __forceinline__ int warp_col0() {
  return (threadIdx.x / 32) % (kBN / kWN) * kWN;
}

// acc = A[m0 : m0+128, 0:K] · B[0:K, n0 : n0+128] on the tensor cores (bf16
// in, fp32 accumulators); rows past M, columns past N and depth past K
// count as zero. A is M x K: a[m * lda + k], or a[k * lda + m] when
// kAColMajor. B is K x N: b[k * ldb + n], or b[n * ldb + k] when
// kBColMajor. Each operand tile sits in shared memory in its global
// orientation, and the wmma layout reads it as it lies. Ends with a barrier:
// the caller may reuse the shared memory at once.
template <bool kAColMajor, bool kBColMajor>
__device__ __forceinline__ void tile_product(
    const uint16_t* __restrict__ a, int64_t lda, bool a_vec,
    const uint16_t* __restrict__ b, int64_t ldb, bool b_vec, int m0, int n0,
    int M, int N, int K, Acc (&acc)[kFM][kFN], uint16_t* a_s,
    uint16_t* b_s) {
  constexpr bool kADepthRow = !kAColMajor;  // A's depth is contiguous
  constexpr bool kBDepthRow = kBColMajor;   // B's depth is contiguous
  using ALayout =
      std::conditional_t<kAColMajor, wmma::col_major, wmma::row_major>;
  using BLayout =
      std::conditional_t<kBColMajor, wmma::col_major, wmma::row_major>;
  constexpr int kALd = kADepthRow ? kBK + kPad : kBM + kPad;
  constexpr int kBLd = kBDepthRow ? kBK + kPad : kBN + kPad;
  TileLoader<kADepthRow ? kBM : kBK, kADepthRow ? kBK : kBM> la;
  TileLoader<kBDepthRow ? kBN : kBK, kBDepthRow ? kBK : kBN> lb;
  const int wm = warp_row0(), wn = warp_col0();

#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto fetch = [&](int k0) {
    if constexpr (kADepthRow)
      la.load(a, lda, m0, k0, M, K, a_vec);
    else
      la.load(a, lda, k0, m0, K, M, a_vec);
    if constexpr (kBDepthRow)
      lb.load(b, ldb, n0, k0, N, K, b_vec);
    else
      lb.load(b, ldb, k0, n0, K, N, b_vec);
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous step's tiles
    la.store(a_s);
    lb.store(b_s);
    __syncthreads();
    if (k0 + kBK < K) fetch(k0 + kBK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout>
          fa[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout>
          fb[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
        const int r = wm + 16 * i;
        const uint16_t* src =
            kADepthRow ? a_s + r * kALd + kk : a_s + kk * kALd + r;
        wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const __nv_bfloat16*>(src), kALd);
      }
#pragma unroll
      for (int j = 0; j < kFN; ++j) {
        const int c = wn + 16 * j;
        const uint16_t* src =
            kBDepthRow ? b_s + c * kBLd + kk : b_s + kk * kBLd + c;
        wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const __nv_bfloat16*>(src), kBLd);
      }
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __syncthreads();
}

// The accumulators into the fp32 tile c_s [kBM][kCLd]; ends with a barrier.
__device__ __forceinline__ void stash(Acc (&acc)[kFM][kFN], float* c_s) {
  const int wm = warp_row0(), wn = warp_col0();
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
      wmma::store_matrix_sync(c_s + (wm + 16 * i) * kCLd + wn + 16 * j,
                              acc[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();
}

// B11, pass 1: block (row tile, vocab group). Per row, the running max m,
// sum l of exp(logit − m) and the label's logit s over the group's vocab
// tiles, written to part_{m,l,s}[group][row].
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const uint16_t* __restrict__ h, const uint16_t* __restrict__ w,
                const int* __restrict__ labels, float* __restrict__ part_m,
                float* __restrict__ part_l, float* __restrict__ part_s, int n,
                int e, int v, bool h_vec, bool w_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* a_s = reinterpret_cast<uint16_t*>(smem);
  uint16_t* b_s = a_s + kOperandElems;
  float* c_s = reinterpret_cast<float*>(smem);
  float* m_s = reinterpret_cast<float*>(smem + kTileBytes);
  float* l_s = m_s + kBM;
  float* s_s = l_s + kBM;

  const int m0 = blockIdx.x * kBM;
  const int group = blockIdx.y;
  const int t_end = min(ceil_div(v, kBN), (group + 1) * kTilesPerGroup);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
    s_s[r] = 0.f;
  }

  Acc acc[kFM][kFN];
  for (int t = group * kTilesPerGroup; t < t_end; ++t) {
    const int n0 = t * kBN;
    tile_product<false, false>(h, e, h_vec, w, v, w_vec, m0, n0, n, v, e, acc,
                               a_s, b_s);
    stash(acc, c_s);
    constexpr int kRowsPerWarp = kBM / (kThreads / 32);
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int gr = m0 + r;
      if (gr >= n) break;  // warp-uniform
      const int lab = labels[gr];
      float x[kBN / 32];
      float tile_max = -INFINITY, hit = 0.f;
#pragma unroll
      for (int q = 0; q < kBN / 32; ++q) {
        const int gc = n0 + lane + 32 * q;
        x[q] = gc < v ? c_s[r * kCLd + lane + 32 * q] : -INFINITY;
        tile_max = fmaxf(tile_max, x[q]);
        if (gc < v && gc == lab) hit += x[q];
      }
      tile_max = ptt::warp_max(tile_max);
      hit = ptt::warp_sum(hit);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tile_max);  // finite: n0 < v
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kBN / 32; ++q)
        sum += n0 + lane + 32 * q < v ? expf(x[q] - m_new) : 0.f;
      sum = ptt::warp_sum(sum);
      if (lane == 0) {
        l_s[r] = l_s[r] * expf(m_old - m_new) + sum;
        m_s[r] = m_new;
        s_s[r] += hit;
      }
      __syncwarp();
    }
    __syncthreads();  // the fp32 tile is read; the next product reuses it
  }
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const int gr = m0 + r;
    if (gr < n) {
      const int64_t i = (int64_t)group * n + gr;
      part_m[i] = m_s[r];
      part_l[i] = l_s[r];
      part_s[i] = s_s[r];
    }
  }
}

// B11, pass 2: per row, the groups' partials merged in group order.
__global__ void xent_merge_kernel(const float* __restrict__ part_m,
                                  const float* __restrict__ part_l,
                                  const float* __restrict__ part_s,
                                  float* __restrict__ lse,
                                  float* __restrict__ sel, int n, int groups) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float m = -INFINITY;
  for (int g = 0; g < groups; ++g) m = fmaxf(m, part_m[(int64_t)g * n + i]);
  float l = 0.f, s = 0.f;
  for (int g = 0; g < groups; ++g) {
    const int64_t j = (int64_t)g * n + i;
    l += part_l[j] * expf(part_m[j] - m);
    s += part_s[j];
  }
  lse[i] = m + logf(l);
  sel[i] = s;
}

// B12/B13, pass 1: dlog[r][c] = bf16((exp(logit − lse[r]) − [c0 + c ==
// label[r]]) · g[r]) for the vocab chunk [c0, c0 + cw), logits recomputed.
__global__ void __launch_bounds__(kThreads)
xent_dlogits_kernel(const uint16_t* __restrict__ h,
                    const uint16_t* __restrict__ w,
                    const int* __restrict__ labels,
                    const float* __restrict__ lse,
                    const float* __restrict__ g, __nv_bfloat16* __restrict__ dlog,
                    int n, int e, int v, int c0, int cw, int ldd, bool h_vec,
                    bool w_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* a_s = reinterpret_cast<uint16_t*>(smem);
  uint16_t* b_s = a_s + kOperandElems;
  float* c_s = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  Acc acc[kFM][kFN];
  tile_product<false, false>(h, e, h_vec, w + c0, v, w_vec, m0, n0, n, cw, e,
                             acc, a_s, b_s);
  stash(acc, c_s);
  for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
    const int r = idx / kBN, c = idx % kBN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < n && gc < cw) {
      const float p = expf(c_s[r * kCLd + c] - lse[gr]);
      const float onehot = c0 + gc == labels[gr] ? 1.f : 0.f;
      dlog[(int64_t)gr * ldd + gc] = __float2bfloat16((p - onehot) * g[gr]);
    }
  }
}

// B12/B13, pass 2: C = A · B for one chunk. With `acc`, C is added to the
// fp32 acc [M][N] (`accumulate`) or replaces it; with `out`, C (after the
// addition) is also written in bf16 to out[r * ldo + c].
template <bool kAColMajor, bool kBColMajor>
__global__ void __launch_bounds__(kThreads)
xent_product_kernel(const uint16_t* __restrict__ a, int64_t lda, bool a_vec,
                    const uint16_t* __restrict__ b, int64_t ldb, bool b_vec,
                    int M, int N, int K, float* __restrict__ acc_out,
                    int accumulate, __nv_bfloat16* __restrict__ out,
                    int64_t ldo) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* a_s = reinterpret_cast<uint16_t*>(smem);
  uint16_t* b_s = a_s + kOperandElems;
  float* c_s = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  Acc acc[kFM][kFN];
  tile_product<kAColMajor, kBColMajor>(a, lda, a_vec, b, ldb, b_vec, m0, n0,
                                       M, N, K, acc, a_s, b_s);
  stash(acc, c_s);
  for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
    const int r = idx / kBN, c = idx % kBN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) {
      float val = c_s[r * kCLd + c];
      if (acc_out != nullptr) {
        const int64_t o = (int64_t)gr * N + gc;
        if (accumulate) val += acc_out[o];
        acc_out[o] = val;
      }
      if (out != nullptr) out[(int64_t)gr * ldo + gc] = __float2bfloat16(val);
    }
  }
}

bool vec_ok(const void* p, int64_t ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0;
}

template <typename Kernel>
cudaError_t raise_limit(Kernel kernel, size_t bytes,
                        std::atomic<bool>* done) {
  return ptt::raise_smem_limit(kernel, (int)bytes, done);
}

cudaError_t launch_dlogits(const uint16_t* h, const uint16_t* w,
                           const int* labels, const float* lse,
                           const float* g, __nv_bfloat16* dlog, int n, int e,
                           int v, int c0, int cw, int ldd, cudaStream_t s) {
  static std::atomic<bool> raised[ptt::kMaxDevices];
  cudaError_t err = raise_limit(xent_dlogits_kernel, kTileBytes, raised);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(n, kBM), ceil_div(cw, kBN));
  xent_dlogits_kernel<<<grid, kThreads, kTileBytes, s>>>(
      h, w, labels, lse, g, dlog, n, e, v, c0, cw, ldd, vec_ok(h, e),
      vec_ok(w + c0, v));
  return cudaGetLastError();
}

template <bool kAColMajor, bool kBColMajor>
cudaError_t launch_product(const uint16_t* a, int64_t lda,
                           const uint16_t* b, int64_t ldb, int M, int N,
                           int K, float* acc, int accumulate,
                           __nv_bfloat16* out, int64_t ldo, cudaStream_t s) {
  static std::atomic<bool> raised[ptt::kMaxDevices];
  auto kernel = xent_product_kernel<kAColMajor, kBColMajor>;
  cudaError_t err = raise_limit(kernel, kTileBytes, raised);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(M, kBM), ceil_div(N, kBN));
  kernel<<<grid, kThreads, kTileBytes, s>>>(a, lda, vec_ok(a, lda), b, ldb,
                                            vec_ok(b, ldb), M, N, K, acc,
                                            accumulate, out, ldo);
  return cudaGetLastError();
}

bool bad_shape(int n, int e, int v) { return n <= 0 || e <= 0 || v <= 0; }

}  // namespace

// Vocab groups of the forward: its partials are float [3][groups][n].
extern "C" int ptt_linear_xent_groups(int v) {
  return ceil_div(ceil_div(v, kBN), kTilesPerGroup);
}

// h [n, e], w [e, v] bf16 contiguous, labels [n] int32; part float
// [3][groups][n]; lse, sel float [n].
extern "C" int ptt_linear_xent_fwd(const void* h, const void* w,
                                   const void* labels, void* part, void* lse,
                                   void* sel, int n, int e, int v,
                                   void* stream) {
  if (bad_shape(n, e, v)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static std::atomic<bool> raised[ptt::kMaxDevices];
  cudaError_t err = raise_limit(xent_fwd_kernel, kFwdBytes, raised);
  if (err != cudaSuccess) return (int)err;
  const int groups = ptt_linear_xent_groups(v);
  float* pm = static_cast<float*>(part);
  float* pl = pm + (int64_t)groups * n;
  float* ps = pl + (int64_t)groups * n;
  const uint16_t* hp = static_cast<const uint16_t*>(h);
  const uint16_t* wp = static_cast<const uint16_t*>(w);
  dim3 grid(ceil_div(n, kBM), groups);
  xent_fwd_kernel<<<grid, kThreads, kFwdBytes, s>>>(
      hp, wp, static_cast<const int*>(labels), pm, pl, ps, n, e, v,
      vec_ok(hp, e), vec_ok(wp, v));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xent_merge_kernel<<<ceil_div(n, 256), 256, 0, s>>>(
      pm, pl, ps, static_cast<float*>(lse), static_cast<float*>(sel), n,
      groups);
  return (int)cudaGetLastError();
}

// The backward's shared walk: dh [n, e] and/or dw [e, v] (bf16; either may
// be null) from h, w, labels, lse [n] and g [n] (float); dlog bf16 scratch
// [n][ldd] with ldd >= vc; acc float [n, e] scratch (needed with dh). The
// vocabulary is walked in chunks of vc columns, each chunk's dlogits
// computed once for both products.
extern "C" int ptt_linear_xent_bwd(const void* h, const void* w,
                                   const void* labels, const void* lse,
                                   const void* g, void* dlog, void* acc,
                                   void* dh, void* dw, int n, int e, int v,
                                   int vc, int ldd, void* stream) {
  if (bad_shape(n, e, v) || vc <= 0 || ldd < vc ||
      (dh == nullptr && dw == nullptr) || (dh != nullptr && acc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* hp = static_cast<const uint16_t*>(h);
  const uint16_t* wp = static_cast<const uint16_t*>(w);
  __nv_bfloat16* dl = static_cast<__nv_bfloat16*>(dlog);
  const uint16_t* dlp = reinterpret_cast<const uint16_t*>(dl);
  for (int c0 = 0; c0 < v; c0 += vc) {
    const int cw = min(vc, v - c0);
    cudaError_t err = launch_dlogits(
        hp, wp, static_cast<const int*>(labels),
        static_cast<const float*>(lse), static_cast<const float*>(g), dl, n,
        e, v, c0, cw, ldd, s);
    if (err != cudaSuccess) return (int)err;
    if (dh != nullptr) {
      // dH (n x e) += dlog (n x cw) · W[:, c0:c0+cw]ᵀ: B(k, j) =
      // w[j * v + c0 + k]
      err = launch_product<false, true>(
          dlp, ldd, wp + c0, v, n, e, cw, static_cast<float*>(acc), c0 > 0,
          c0 + cw >= v ? static_cast<__nv_bfloat16*>(dh) : nullptr, e, s);
      if (err != cudaSuccess) return (int)err;
    }
    if (dw != nullptr) {
      // dW[:, c0:c0+cw] (e x cw) = hᵀ (e x n) · dlog (n x cw): A(i, k) =
      // h[k * e + i]
      err = launch_product<true, false>(
          hp, e, dlp, ldd, e, cw, n, nullptr, 0,
          static_cast<__nv_bfloat16*>(dw) + c0, v, s);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaSuccess;
}
