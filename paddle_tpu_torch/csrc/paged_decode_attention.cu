// One-token decode attention over the paged KV pool, one query token a
// slot, each slot at its own position.
// q [B, Hq, D], the step's own k/v kn/vn [B, Hkv, D], the WHOLE pool
// k_pool/v_pool [N + 1, L, Hkv, P, D] (page 0 is the null page), the page
// table [B, M] int32 and the fill positions pos [B] int32, out [B, Hq, D].
// Slot b attends to its positions [0, pos[b]), position p read in place
// from page table[b, p / P] at offset p % P of layer `layer`, plus its
// fresh k/v, under one streaming softmax. Nothing is gathered: the page
// indirection is an address computation. q-head h·G + g reads kv-head h.
// Two pool layouts: float (the pool in q's type) and int8 (int8 k/v with
// fp32 per-position scales k_scale/v_scale [N + 1, L, Hkv, P]).
//
// Replaces: paddle_tpu/ops/pallas/paged_decode_attention.py:175 raw_call
//   (_kernel :105), both pool layouts.
// Bound on the H100: memory. A step reads pos[b]·Hkv·D·2 pool elements a
//   slot (2 bytes each in bf16, 1 in int8, plus 8 bytes of scales per
//   position) and the table for ~4·G operations per element pair, far
//   below the tensor cores' operations-per-byte line.
// int8 numerics and design: the shared decode kernel (decode_kernel.cuh)
//   that the stacked-cache kernel (decode_attention.cu) runs too, with a
//   position's row address taken through the page table: an int8 step
//   equals the slots' pages gathered into a stacked cache and run through
//   that kernel bit for bit. The TPU kernel's grid walks pages one DMA'd
//   block at a time and clamps past the last live page; here the loop
//   simply ends at pos[b]. pos and the table are read from device memory,
//   so a CUDA graph that captures the launch replays it at the slots'
//   current positions and pages.
#include "decode_kernel.cuh"

namespace {

// Position j of slot b, kv-head h: [table[b, j / P], layer, h, j % P] of
// the pool's leading four axes [N + 1, L, Hkv, P] (the scales' index too).
// Positions past the table's reach are not read.
struct PagedRows {
  const int* table;  // [B, M] int32
  const int* pos;    // [B] int32
  int hkv, n_layers, page, max_pages, layer;

  struct Walk {
    const int* ids;       // slot b's table row
    int64_t page_stride;  // rows of one page id: L · Hkv · P
    int64_t off;          // row of (layer, h, offset 0) within a page id
    int page, fill;
    __device__ __forceinline__ int64_t row(int j) const {
      return ids[j / page] * page_stride + off + j % page;
    }
  };
  __device__ __forceinline__ Walk at(int b, int h) const {
    return {table + (int64_t)b * max_pages, (int64_t)n_layers * hkv * page,
            ((int64_t)layer * hkv + h) * page, page,
            min(max(pos[b], 0), max_pages * page)};
  }
};

template <typename CT, bool QUANT>
int dispatch(const void* q, const void* kn, const void* vn,
             const void* k_pool, const void* v_pool, const float* k_scale,
             const float* v_scale, const void* table, const void* pos,
             void* out, int b, int hq, int hkv, int n_layers, int page,
             int max_pages, int d, int layer, float scale, int dtype,
             void* stream) {
  if (page <= 0 || max_pages <= 0 || layer < 0 || layer >= n_layers)
    return (int)cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(table),
                       static_cast<const int*>(pos), hkv, n_layers, page,
                       max_pages, layer};
  return ptt::decode::launch<CT, QUANT>(q, kn, vn, k_pool, v_pool, k_scale,
                                        v_scale, rows, out, b, hq, hkv, d,
                                        scale, dtype, stream);
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
  return dispatch<void, false>(q, kn, vn, k_pool, v_pool, nullptr, nullptr,
                               table, pos, out, b, hq, hkv, n_layers, page,
                               max_pages, d, layer, scale, dtype, stream);
}

// The int8 pool: k_pool/v_pool int8 [N + 1, L, Hkv, P, D], k_scale/
// v_scale fp32 [N + 1, L, Hkv, P], contiguous; the rest as above.
extern "C" int ptt_paged_decode_attention_int8(
    const void* q, const void* kn, const void* vn, const void* k_pool,
    const void* v_pool, const float* k_scale, const float* v_scale,
    const void* table, const void* pos, void* out, int b, int hq, int hkv,
    int n_layers, int page, int max_pages, int d, int layer, float scale,
    int dtype, void* stream) {
  return dispatch<int8_t, true>(q, kn, vn, k_pool, v_pool, k_scale, v_scale,
                                table, pos, out, b, hq, hkv, n_layers, page,
                                max_pages, d, layer, scale, dtype, stream);
}
