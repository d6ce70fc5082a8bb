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
// int8 numerics and design: the shared decode kernel (decode_kernel.cuh),
//   with a position's row at its offset in the stacked cache. Any S and
//   any index are taken: nothing past index is read.
#include "decode_kernel.cuh"

namespace {

// Row j of batch row b, kv-head h: [layer, b, h, j] of the cache's leading
// four axes [L, B, Hkv, S] (the scales' index too).
struct StackedRows {
  const int* slot_index;  // [B] int32, or null: every row reads [0, index)
  int nb, hkv, s_len, layer, index;

  struct Walk {
    int64_t off;
    int fill;
    __device__ __forceinline__ int64_t row(int j) const { return off + j; }
  };
  __device__ __forceinline__ Walk at(int b, int h) const {
    return {(((int64_t)layer * nb + b) * hkv + h) * (int64_t)s_len,
            slot_index ? min(max(slot_index[b], 0), s_len) : index};
  }
};

template <typename CT, bool QUANT>
int dispatch(const void* q, const void* kn, const void* vn,
             const void* k_cache, const void* v_cache, const float* k_scale,
             const float* v_scale, const int* slot_index, void* out, int b,
             int hq, int hkv, int s_len, int d, int layer, int index,
             float scale, int dtype, void* stream) {
  if (!slot_index && (index < 0 || index > s_len))
    return (int)cudaErrorInvalidValue;
  const StackedRows rows{slot_index, b, hkv, s_len, layer, index};
  return ptt::decode::launch<CT, QUANT>(q, kn, vn, k_cache, v_cache, k_scale,
                                        v_scale, rows, out, b, hq, hkv, d,
                                        scale, dtype, stream);
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
