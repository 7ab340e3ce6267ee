// Dense GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, pallas_call at :130): one query token per row attends
// over a dense per-row slab [B, S, KV, D] up to cache_len (one scalar for
// the batch, as in the reference; a per-row [B] length is taken too, for
// the ragged decode path), with optional sliding window and tanh softcap;
// f32 online softmax.
//
// Bound on an H100: bytes — (cache_len * KV * D * 2 elements of K/V read
// once) / 3.35 TB/s; 4 * H * D flops per token is far below the card's
// ~295 flops per byte.  On the single-robot serving path (S = 70) the call
// moves ~2 MB at full width and is launch-bound.
//
// Design: the same online-softmax body as the paged kernel
// (attention_common.cuh), over a strided slab instead of a page table: one
// block per (row, KV head), the G query heads resident, and a loop over the
// live tokens [lo, len) only — the TPU grid's S/blk_s blocks past the
// length are never visited.

#include "attention_common.cuh"

namespace {

struct DenseRows {
  int64_t base;          // (b * S * KV + kvh) * D
  int64_t token_stride;  // KV * D
  __device__ int64_t operator()(int t) const { return base + t * token_stride; }
};

template <typename T>
__global__ void __launch_bounds__(rapid::DEC_THREADS)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lens, int len_all,
                    T* __restrict__ out, int S, int H, int KV, int D, int window,
                    float scale, float cap) {
  const int b = blockIdx.x, kvh = blockIdx.y, G = H / KV;
  const int len = lens != nullptr ? lens[b] : len_all;
  const int hi = max(0, min(len, S));
  const int lo = window > 0 ? max(0, len - window) : 0;
  const DenseRows rows{((int64_t)b * S * KV + kvh) * D, (int64_t)KV * D};
  const int64_t qo = ((int64_t)b * H + (int64_t)kvh * G) * D;
  rapid::decode_rows<T>(q + qo, k, v, out + qo, G, D, lo, hi, scale, cap, rows);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lens, int len_all,
           void* out, int B, int S, int H, int KV, int D, int window, float scale, float cap,
           cudaStream_t stream) {
  dense_decode_kernel<T><<<dim3(B, KV), rapid::DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens,
      len_all, static_cast<T*>(out), S, H, KV, D, window, scale, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// cache_lens may be null: then every row attends over cache_len tokens.
extern "C" int decode_attention(const void* q, const void* cache_k, const void* cache_v,
                                const int* cache_lens, int cache_len, void* out, int B, int S,
                                int H, int KV, int D, int window, float scale, float cap,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, cache_k, cache_v, cache_lens, cache_len, out, B, S, H, KV,
                                 D, window, scale, cap, s);
  return launch<float>(q, cache_k, cache_v, cache_lens, cache_len, out, B, S, H, KV, D, window,
                       scale, cap, s);
}
