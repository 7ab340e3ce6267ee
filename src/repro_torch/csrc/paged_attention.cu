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
// flops per byte, so no tensor cores; the least time is (K/V bytes read) /
// 3.35 TB/s.  On the serving path (one robot, <= 70 tokens, 32 KV heads of
// 128) that is ~1 MB per call, below one launch's latency.
//
// Design: flash-decoding (attention_common.cuh).  The TPU grid walks all
// MAXP pages of every row and masks the dead ones; here the grid is
// (B, KV, n_split), n_split ranges of split_len tokens (a whole number of
// pages) over the table's MAXP * page slots, and each block visits only the
// live tokens of its range.  It first copies its range's page-table entries
// into shared memory, then stages K/V tiles through shared memory with
// cp.async (a page of one KV head is `page` rows of D contiguous elements
// at a stride of KV * D); a second kernel merges the partials when
// n_split > 1.  Page size is any positive value (16, the serving default,
// and 128, the Pallas default, included); D <= 256, D % 8 == 0, G <= 16,
// f32 or bf16.

#include "attention_common.cuh"

namespace {

struct PagedRows {
  const int* table;  // the range's page-table entries, in shared memory
  int first_page;    // page index of table[0]
  int page;
  int64_t token_stride;  // KV * D
  int64_t head_off;      // kvh * D
  __device__ int64_t operator()(int t) const {
    const int p = t / page;
    const int64_t slot = (int64_t)table[p - first_page] * page + (t - p * page);
    return slot * token_stride + head_off;
  }
};

template <typename T, int GM>
__global__ void __launch_bounds__(rapid::DEC_THREADS)
paged_decode_split(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ table,
                   const int* __restrict__ lens, T* __restrict__ out, float* __restrict__ ws,
                   int H, int KV, int D, int page, int maxp, int window, float scale,
                   float cap, int split_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z, G = H / KV;
  const int pages = split_len / page;
  const rapid::DecodeSmem L(G, D, sizeof(T), split_len, pages);
  const int len = lens[b];
  const int hi = min(max(0, min(len, maxp * page)), (split + 1) * split_len);
  const int lo = max(window > 0 ? max(0, len - window) : 0, split * split_len);
  int* tbl = reinterpret_cast<int*>(smem + L.tbl_off);
  const int first = split * pages;
  if (hi > lo) {
    for (int i = threadIdx.x; i < pages && first + i < maxp; i += rapid::DEC_THREADS)
      tbl[i] = table[(int64_t)b * maxp + first + i];
  }
  __syncthreads();
  const PagedRows rows{tbl, first, page, (int64_t)KV * D, (int64_t)kvh * D};
  const int pair = b * KV + kvh;
  rapid::decode_range<T, GM>(smem, L, q + (int64_t)pair * G * D, kp, vp, rows, G, D, lo, hi,
                             scale, cap,
                             rapid::decode_dst<T>(out, ws, gridDim.x * KV, pair, split,
                                                  gridDim.z, G, D));
}

template <typename T, int GM>
int launch(const void* q, const void* kp, const void* vp, const int* table, const int* lens,
           void* out, void* ws, int B, int H, int KV, int D, int page, int maxp, int window,
           float scale, float cap, int n_split, int split_len, cudaStream_t stream) {
  static int granted = 48 * 1024;
  const int G = H / KV;
  const rapid::DecodeSmem L(G, D, sizeof(T), split_len, split_len / page);
  auto kernel = paged_decode_split<T, GM>;
  cudaError_t st = rapid::allow_smem(kernel, L.total, &granted);
  if (st != cudaSuccess) return (int)st;
  kernel<<<dim3(B, KV, n_split), rapid::DEC_THREADS, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table,
      lens, static_cast<T*>(out), static_cast<float*>(ws), H, KV, D, page, maxp, window,
      scale, cap, split_len);
  st = cudaGetLastError();
  if (st != cudaSuccess || n_split == 1) return (int)st;
  return (int)rapid::launch_combine<T>(static_cast<const float*>(ws), static_cast<T*>(out),
                                       B * KV, n_split, G, D, stream);
}

template <typename T>
int launch_g(const void* q, const void* kp, const void* vp, const int* table, const int* lens,
             void* out, void* ws, int B, int H, int KV, int D, int page, int maxp, int window,
             float scale, float cap, int n_split, int split_len, cudaStream_t stream) {
  const int G = H / KV;
#define RAPID_LAUNCH(GM)                                                                   \
  return launch<T, GM>(q, kp, vp, table, lens, out, ws, B, H, KV, D, page, maxp, window,   \
                       scale, cap, n_split, split_len, stream)
  if (G <= 1) RAPID_LAUNCH(1);
  if (G <= 2) RAPID_LAUNCH(2);
  if (G <= 4) RAPID_LAUNCH(4);
  if (G <= 8) RAPID_LAUNCH(8);
  RAPID_LAUNCH(16);
#undef RAPID_LAUNCH
}

}  // namespace

// split_len is a multiple of page.  ws: float32 workspace of
// B * KV * n_split * G * (D + 2) floats (unused, may be null, when
// n_split == 1).
extern "C" int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const int* page_table, const int* cache_lens, void* out,
                                      void* ws, int B, int H, int KV, int D, int page,
                                      int maxp, int window, float scale, float cap,
                                      int n_split, int split_len, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_g<__nv_bfloat16>(q, k_pages, v_pages, page_table, cache_lens, out, ws, B, H,
                                   KV, D, page, maxp, window, scale, cap, n_split, split_len,
                                   s);
  return launch_g<float>(q, k_pages, v_pages, page_table, cache_lens, out, ws, B, H, KV, D,
                         page, maxp, window, scale, cap, n_split, split_len, s);
}
