// Paged GQA decode attention for Hopper (sm_90a), ragged batches.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_decode_attention, pallas_call at :144): one query token per row
// attends over that row's K/V, which lives in fixed-size pages of a shared
// pool [P, page, KV, D] addressed through page_table [B, MAXP], with
// per-row lengths cache_lens [B]; optional sliding window
// (pos >= len - window) and tanh logit softcap; f32 online softmax.
//
// Bound on an H100: bytes.  Each row reads len * KV * D * 2 elements of K/V
// once and does 4 * H * D flops per token read, far below the card's ~295
// flops per byte; the least time is (K/V bytes read) / 3.35 TB/s.  On the
// serving path (one robot, <= 70 tokens, 32 KV heads of 128) that is a few
// hundred KB per call, so the kernel is launch-bound.
//
// Design: one block per (row, KV head); the G query heads of that KV head
// stay resident in shared memory, so each K/V byte is read once per block.
// The TPU grid visits all MAXP pages of every row and masks the dead ones;
// here the block loops only over the row's live tokens [lo, len), walking
// the page table per 64-token tile, so short rows cost little and a row of
// length 0 writes zeros.  Page size is any positive value (16, the serving
// default, and 128, the Pallas default, included); D <= 256, D % 8 == 0,
// G <= 16, f32 or bf16.

#include "attention_common.cuh"

namespace {

struct PagedRows {
  const int* table;  // this row's page-table entries
  int page;
  int64_t token_stride;  // KV * D
  int64_t head_off;      // kvh * D
  __device__ int64_t operator()(int t) const {
    const int64_t slot = (int64_t)table[t / page] * page + t % page;
    return slot * token_stride + head_off;
  }
};

template <typename T>
__global__ void __launch_bounds__(rapid::DEC_THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lens, T* __restrict__ out, int H, int KV,
                    int D, int page, int maxp, int window, float scale, float cap) {
  const int b = blockIdx.x, kvh = blockIdx.y, G = H / KV;
  const int len = lens[b];
  const int hi = max(0, min(len, maxp * page));
  const int lo = window > 0 ? max(0, len - window) : 0;
  const PagedRows rows{table + (int64_t)b * maxp, page, (int64_t)KV * D, (int64_t)kvh * D};
  const int64_t qo = ((int64_t)b * H + (int64_t)kvh * G) * D;
  rapid::decode_rows<T>(q + qo, kp, vp, out + qo, G, D, lo, hi, scale, cap, rows);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table, const int* lens,
           void* out, int B, int H, int KV, int D, int page, int maxp, int window,
           float scale, float cap, cudaStream_t stream) {
  paged_decode_kernel<T><<<dim3(B, KV), rapid::DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table,
      lens, static_cast<T*>(out), H, KV, D, page, maxp, window, scale, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const int* page_table, const int* cache_lens, void* out,
                                      int B, int H, int KV, int D, int page, int maxp,
                                      int window, float scale, float cap, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, cache_lens, out, B, H, KV,
                                 D, page, maxp, window, scale, cap, s);
  return launch<float>(q, k_pages, v_pages, page_table, cache_lens, out, B, H, KV, D, page,
                       maxp, window, scale, cap, s);
}
