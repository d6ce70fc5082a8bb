// Selective scan, the Mamba SSM recurrence, forward and backward, fp32:
//   h_t = exp(dt_t A) * h_{t-1} + dt_t u_t B_t,   y_t = <h_t, C_t> + D u_t
// u, dt, y [nb, T, Ei]; A [Ei, N]; B, C [nb, T, N]; D [Ei]; the initial
// state h0 and the final state hlast [nb, Ei, N] (h0 may be null: zeros).
//
// Replaces: paddle_tpu/ops/pallas/selective_scan.py:112 _fwd_call
//   (_fwd_kernel :77) and :210 _bwd_call (_bwd_kernel :132). The Pallas
//   forward neither takes an initial state nor returns the final one; this
//   one does both, so that a prefill runs the kernel with its carried
//   state.
// Bound on the H100: memory for the bytes (u, dt and y, 4 bytes each, per
//   token and channel) and the special-function units for the N exps per
//   token and channel (16 a cycle per SM). T is sequential: one (b, e, n)
//   chain's steps depend on each other, and at the training shape
//   (8 x 2048 channels, N = 16) there are only 262,144 chains, so the loop
//   runs at the latency of one fma a step per chain, hidden by the other
//   chains of the SM.
// Design: a block owns 32 channels of one batch row, 4 threads a channel,
//   each thread SPT = ceil(N/4) states in registers (N <= 32). The loop
//   over T is inside the block (the TPU's sequential grid axis), over time
//   tiles staged in shared memory with coalesced loads (u, dt as 32
//   consecutive channels, B and C rows shared by the block). y reduces
//   over the 4 threads of a channel with two warp shuffles and leaves
//   through a shared tile, coalesced.
//   The forward also writes the state entering every KS-th step (KS =
//   64 / SPT: 16 steps at N = 16) when the backward will need it. KS is
//   the kernel's own choice (the result does not depend on it): it is
//   short enough that the backward keeps one interval's KS x SPT states
//   in registers (64 floats a thread), which a 128-step TPU chunk could
//   not (8 KB a chain). The price is 4/KS bytes of saved state per byte
//   of u: 134 MB at the training shape, written by the forward and read
//   by the backward.
//   The backward walks the intervals in reverse. For each it stages u,
//   dt, dy, B and C, recomputes the interval's states from the saved one
//   into registers, and runs the adjoint g_t = dy_t C_t + exp(dt_{t+1} A)
//   g_{t+1} with the message exp(dt A) g carried across intervals in
//   registers. du and ddt reduce over the 4 threads of a channel. dB and
//   dC reduce over all Ei channels: within the block over the warp's 8
//   channels by shuffles and over the 4 warps in order through shared
//   memory, then one partial row per channel block goes to global memory
//   ([nb, Ei/32, T, N]) and the wrapper sums those in order (the TPU kernel
//   writes the same per-block partials, :197-202). dA sums over T in
//   registers and leaves as per-batch partials [nb, Ei, N], summed by the
//   wrapper over the batch as the TPU wrapper does (:296). No atomics: the
//   same inputs give the same bits on every run.
#include "common.cuh"

namespace {

constexpr int kChannels = 32;                   // channels per block
constexpr int kLanes = 4;                       // threads per channel
constexpr int kThreads = kChannels * kLanes;    // 128
constexpr int kWarps = kThreads / 32;
constexpr int kFwdTile = 64;                    // time steps per forward tile
constexpr int kStateRegs = 64;                  // KS * SPT, the backward's

template <int SPT>
__global__ void __launch_bounds__(kThreads)
scan_fwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ Dv,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ hsave, float* __restrict__ hlast, int T,
                int Ei, int N, int nsave) {
  constexpr int NP = kLanes * SPT;
  constexpr int KS = kStateRegs / SPT;
  __shared__ float s_u[kFwdTile][kChannels];
  __shared__ float s_dt[kFwdTile][kChannels];
  __shared__ float s_y[kFwdTile][kChannels];
  __shared__ float s_B[kFwdTile][NP];
  __shared__ float s_C[kFwdTile][NP];

  const int tid = threadIdx.x;
  const int el = tid / kLanes, ng = tid % kLanes;
  const int b = blockIdx.y;
  const int e0 = blockIdx.x * kChannels, e = e0 + el;
  const bool live = e < Ei;
  const int64_t state_off = ((int64_t)b * Ei + e) * N;

  float a[SPT], h[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int n = ng * SPT + j;
    const bool ok = live && n < N;
    a[j] = ok ? A[(int64_t)e * N + n] : 0.f;
    h[j] = (ok && h0 != nullptr) ? h0[state_off + n] : 0.f;
  }
  const float d = live ? Dv[e] : 0.f;

  for (int t0 = 0; t0 < T; t0 += kFwdTile) {
    const int nt = min(kFwdTile, T - t0);
    for (int i = tid; i < kFwdTile * kChannels; i += kThreads) {
      const int k = i / kChannels, c = i % kChannels;
      const bool ok = k < nt && e0 + c < Ei;
      const int64_t off = ((int64_t)b * T + t0 + k) * Ei + e0 + c;
      s_u[k][c] = ok ? u[off] : 0.f;
      s_dt[k][c] = ok ? dt[off] : 0.f;
    }
    for (int i = tid; i < kFwdTile * NP; i += kThreads) {
      const int k = i / NP, n = i % NP;
      const bool ok = k < nt && n < N;
      const int64_t off = ((int64_t)b * T + t0 + k) * N + n;
      s_B[k][n] = ok ? Bm[off] : 0.f;
      s_C[k][n] = ok ? Cm[off] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < nt; ++k) {
      const int t = t0 + k;
      if (hsave != nullptr && t % KS == 0 && live) {
        float* dst = hsave + (((int64_t)b * nsave + t / KS) * Ei + e) * N;
#pragma unroll
        for (int j = 0; j < SPT; ++j)
          if (ng * SPT + j < N) dst[ng * SPT + j] = h[j];
      }
      const float dtv = s_dt[k][el], uv = s_u[k][el];
      const float dtu = dtv * uv;
      float yp = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int n = ng * SPT + j;
        const float dA = __expf(dtv * a[j]);
        h[j] = fmaf(dA, h[j], dtu * s_B[k][n]);
        yp = fmaf(h[j], s_C[k][n], yp);
      }
      yp += __shfl_xor_sync(0xffffffffu, yp, 1);
      yp += __shfl_xor_sync(0xffffffffu, yp, 2);
      if (ng == 0) s_y[k][el] = fmaf(uv, d, yp);
    }
    __syncthreads();
    for (int i = tid; i < nt * kChannels; i += kThreads) {
      const int k = i / kChannels, c = i % kChannels;
      if (e0 + c < Ei) y[((int64_t)b * T + t0 + k) * Ei + e0 + c] = s_y[k][c];
    }
  }
  if (hlast != nullptr && live) {
#pragma unroll
    for (int j = 0; j < SPT; ++j)
      if (ng * SPT + j < N) hlast[state_off + ng * SPT + j] = h[j];
  }
}

template <int SPT>
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ hsave,
                const float* __restrict__ dy,
                const float* __restrict__ dhlast, float* __restrict__ du,
                float* __restrict__ ddt, float* __restrict__ dB_part,
                float* __restrict__ dC_part, float* __restrict__ dA_part,
                float* __restrict__ dh0, int T, int Ei, int N, int nsave) {
  constexpr int NP = kLanes * SPT;
  constexpr int KS = kStateRegs / SPT;
  __shared__ float s_u[KS][kChannels];
  __shared__ float s_dt[KS][kChannels];
  __shared__ float s_dy[KS][kChannels];
  __shared__ float s_du[KS][kChannels];
  __shared__ float s_ddt[KS][kChannels];
  __shared__ float s_B[KS][NP];
  __shared__ float s_C[KS][NP];
  __shared__ float s_dBw[kWarps][KS][NP];
  __shared__ float s_dCw[kWarps][KS][NP];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int el = tid / kLanes, ng = tid % kLanes;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int e0 = blk * kChannels, e = e0 + el;
  const bool live = e < Ei;
  const int64_t state_off = ((int64_t)b * Ei + e) * N;

  float a[SPT], m[SPT], dacc[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int n = ng * SPT + j;
    const bool ok = live && n < N;
    a[j] = ok ? A[(int64_t)e * N + n] : 0.f;
    m[j] = (ok && dhlast != nullptr) ? dhlast[state_off + n] : 0.f;
    dacc[j] = 0.f;
  }

  for (int c = nsave - 1; c >= 0; --c) {
    const int t0 = c * KS, nt = min(KS, T - t0);
    for (int i = tid; i < KS * kChannels; i += kThreads) {
      const int k = i / kChannels, ch = i % kChannels;
      const bool ok = k < nt && e0 + ch < Ei;
      const int64_t off = ((int64_t)b * T + t0 + k) * Ei + e0 + ch;
      s_u[k][ch] = ok ? u[off] : 0.f;
      s_dt[k][ch] = ok ? dt[off] : 0.f;
      s_dy[k][ch] = ok ? dy[off] : 0.f;
    }
    for (int i = tid; i < KS * NP; i += kThreads) {
      const int k = i / NP, n = i % NP;
      const bool ok = k < nt && n < N;
      const int64_t off = ((int64_t)b * T + t0 + k) * N + n;
      s_B[k][n] = ok ? Bm[off] : 0.f;
      s_C[k][n] = ok ? Cm[off] : 0.f;
    }
    __syncthreads();

    // the interval's states, recomputed from the one the forward saved:
    // hb enters step 0, hs[k] leaves step k
    float hb[SPT], hs[KS][SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int n = ng * SPT + j;
      hb[j] = (live && n < N)
                  ? hsave[(((int64_t)b * nsave + c) * Ei + e) * N + n]
                  : 0.f;
    }
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float dtv = s_dt[k][el], dtu = dtv * s_u[k][el];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float prev = k == 0 ? hb[j] : hs[k - 1][j];
        hs[k][j] = fmaf(__expf(dtv * a[j]), prev,
                        dtu * s_B[k][ng * SPT + j]);
      }
    }

    // the adjoint, last step first (steps k >= nt carry zeros and are
    // skipped, block-uniformly)
#pragma unroll
    for (int k = KS - 1; k >= 0; --k) {
      if (k < nt) {
        const float dtv = s_dt[k][el], uv = s_u[k][el], dyv = s_dy[k][el];
        const float dtu = dtv * uv;
        float s1 = 0.f, dd = 0.f, db[SPT], dc[SPT];
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          const int n = ng * SPT + j;
          const float dA = __expf(dtv * a[j]);
          const float g = fmaf(s_C[k][n], dyv, m[j]);
          m[j] = dA * g;
          s1 = fmaf(g, s_B[k][n], s1);
          const float gdh = g * dA * (k == 0 ? hb[j] : hs[k - 1][j]);
          dd = fmaf(gdh, a[j], dd);
          dacc[j] = fmaf(gdh, dtv, dacc[j]);
          db[j] = g * dtu;
          dc[j] = hs[k][j] * dyv;
        }
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        dd += __shfl_xor_sync(0xffffffffu, dd, 1);
        dd += __shfl_xor_sync(0xffffffffu, dd, 2);
        if (ng == 0) {
          s_du[k][el] = dtv * s1;
          s_ddt[k][el] = fmaf(uv, s1, dd);
        }
        // over the warp's 8 channels (lanes 4 apart share a state slot)
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
#pragma unroll
          for (int o = kLanes; o < 32; o <<= 1) {
            db[j] += __shfl_xor_sync(0xffffffffu, db[j], o);
            dc[j] += __shfl_xor_sync(0xffffffffu, dc[j], o);
          }
        }
        if (lane < kLanes) {
#pragma unroll
          for (int j = 0; j < SPT; ++j) {
            s_dBw[warp][k][ng * SPT + j] = db[j];
            s_dCw[warp][k][ng * SPT + j] = dc[j];
          }
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < nt * kChannels; i += kThreads) {
      const int k = i / kChannels, ch = i % kChannels;
      if (e0 + ch < Ei) {
        const int64_t off = ((int64_t)b * T + t0 + k) * Ei + e0 + ch;
        du[off] = s_du[k][ch];
        ddt[off] = s_ddt[k][ch];
      }
    }
    for (int i = tid; i < nt * NP; i += kThreads) {
      const int k = i / NP, n = i % NP;
      if (n < N) {
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sb += s_dBw[w][k][n];
          sc += s_dCw[w][k][n];
        }
        const int64_t off = (((int64_t)b * nblk + blk) * T + t0 + k) * N + n;
        dB_part[off] = sb;
        dC_part[off] = sc;
      }
    }
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int n = ng * SPT + j;
      if (n < N) {
        dA_part[state_off + n] = dacc[j];
        if (dh0 != nullptr) dh0[state_off + n] = m[j];
      }
    }
  }
}

// states per thread for N states (0: N unsupported)
int states_per_thread(int n) {
  if (n <= 0) return 0;
  if (n <= 2 * kLanes) return 2;
  if (n <= 4 * kLanes) return 4;
  if (n <= 8 * kLanes) return 8;
  return 0;
}

bool shapes_ok(int nb, int T, int Ei, int N, int nsave) {
  const int spt = states_per_thread(N);
  if (nb <= 0 || T <= 0 || Ei <= 0 || spt == 0 || nb > 65535) return false;
  const int ks = kStateRegs / spt;
  return nsave == (T + ks - 1) / ks;
}

}  // namespace

// All fp32 and contiguous. h0, hsave and hlast may be null (zeros in; not
// written). hsave [nb, nsave, Ei, N]: the state entering steps 0, KS,
// 2 KS, ..., nsave = ceil(T / KS), KS = 64 / states_per_thread(N).
extern "C" int ptt_selective_scan_fwd(const float* u, const float* dt,
                                      const float* A, const float* Bm,
                                      const float* Cm, const float* Dv,
                                      const float* h0, float* y, float* hsave,
                                      float* hlast, int nb, int T, int Ei,
                                      int N, int nsave, void* stream) {
  if (!shapes_ok(nb, T, Ei, N, nsave)) return (int)cudaErrorInvalidValue;
  const dim3 grid((Ei + kChannels - 1) / kChannels, nb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_SCAN_FWD(SPT)                                                   \
  scan_fwd_kernel<SPT><<<grid, kThreads, 0, s>>>(u, dt, A, Bm, Cm, Dv, h0,  \
                                                 y, hsave, hlast, T, Ei, N, \
                                                 nsave)
  switch (states_per_thread(N)) {
    case 2: PTT_SCAN_FWD(2); break;
    case 4: PTT_SCAN_FWD(4); break;
    case 8: PTT_SCAN_FWD(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PTT_SCAN_FWD
  return (int)cudaGetLastError();
}

// du, ddt [nb, T, Ei] (du without the D dy term); dB_part, dC_part
// [nb, ceil(Ei / 32), T, N] (one partial per channel block); dA_part
// [nb, Ei, N]; dh0 [nb, Ei, N] (may be null); dhlast may be null (zeros).
extern "C" int ptt_selective_scan_bwd(const float* u, const float* dt,
                                      const float* A, const float* Bm,
                                      const float* Cm, const float* hsave,
                                      const float* dy, const float* dhlast,
                                      float* du, float* ddt, float* dB_part,
                                      float* dC_part, float* dA_part,
                                      float* dh0, int nb, int T, int Ei,
                                      int N, int nsave, void* stream) {
  if (!shapes_ok(nb, T, Ei, N, nsave)) return (int)cudaErrorInvalidValue;
  const dim3 grid((Ei + kChannels - 1) / kChannels, nb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_SCAN_BWD(SPT)                                                 \
  scan_bwd_kernel<SPT><<<grid, kThreads, 0, s>>>(                         \
      u, dt, A, Bm, Cm, hsave, dy, dhlast, du, ddt, dB_part, dC_part,     \
      dA_part, dh0, T, Ei, N, nsave)
  switch (states_per_thread(N)) {
    case 2: PTT_SCAN_BWD(2); break;
    case 4: PTT_SCAN_BWD(4); break;
    case 8: PTT_SCAN_BWD(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PTT_SCAN_BWD
  return (int)cudaGetLastError();
}
