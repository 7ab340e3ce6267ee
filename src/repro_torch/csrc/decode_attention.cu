// Dense GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, pallas_call at :130): one query token per row attends
// over a dense per-row slab [B, S, KV, D] up to cache_len (one scalar for
// the batch, as in the reference; a per-row [B] length is taken too, for
// the ragged decode path), with optional sliding window and tanh softcap;
// f32 online softmax.
//
// Bound on an H100: bytes — (live tokens * KV * D * 2 elements of K/V read
// once) / 3.35 TB/s; 4 * H * D flops per token is far below the card's
// ~295 flops per byte, so no tensor cores.  At S = len = 4096, H = KV = 32
// that is 67 MB, 0.020 ms; on the single-robot serving path (len <= 70)
// ~1 MB, below one launch's latency.
//
// Design: flash-decoding (attention_common.cuh).  The grid is
// (B, KV, n_split): each block takes split_len tokens of one (row, KV head)
// -- the TPU grid's sequential walk over S becomes n_split blocks side by
// side -- clipped to the row's live window [lo, min(len, S)), staging K/V
// tiles through shared memory with cp.async; a second kernel merges the
// partials when n_split > 1.  Token t of row b, KV head h sits at element
// ((b * S + t) * KV + h) * D.

#include "attention_common.cuh"

namespace {

struct DenseRows {
  int64_t base;          // (b * S * KV + kvh) * D
  int64_t token_stride;  // KV * D
  __device__ int64_t operator()(int t) const { return base + t * token_stride; }
};

template <typename T, int GM>
__global__ void __launch_bounds__(rapid::DEC_THREADS)
dense_decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ lens, int len_all, T* __restrict__ out,
                   float* __restrict__ ws, int S, int H, int KV, int D, int window,
                   float scale, float cap, int split_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z, G = H / KV;
  const rapid::DecodeSmem L(G, D, sizeof(T), split_len, 0);
  const int len = lens != nullptr ? lens[b] : len_all;
  const int hi = min(max(0, min(len, S)), (split + 1) * split_len);
  const int lo = max(window > 0 ? max(0, len - window) : 0, split * split_len);
  const DenseRows rows{((int64_t)b * S * KV + kvh) * D, (int64_t)KV * D};
  const int pair = b * KV + kvh;
  rapid::decode_range<T, GM>(smem, L, q + (int64_t)pair * G * D, k, v, rows, G, D, lo, hi,
                             scale, cap,
                             rapid::decode_dst<T>(out, ws, gridDim.x * KV, pair, split,
                                                  gridDim.z, G, D));
}

template <typename T, int GM>
int launch(const void* q, const void* k, const void* v, const int* lens, int len_all,
           void* out, void* ws, int B, int S, int H, int KV, int D, int window, float scale,
           float cap, int n_split, int split_len, cudaStream_t stream) {
  static int granted = 48 * 1024;
  const int G = H / KV;
  const rapid::DecodeSmem L(G, D, sizeof(T), split_len, 0);
  auto kernel = dense_decode_split<T, GM>;
  cudaError_t st = rapid::allow_smem(kernel, L.total, &granted);
  if (st != cudaSuccess) return (int)st;
  kernel<<<dim3(B, KV, n_split), rapid::DEC_THREADS, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens,
      len_all, static_cast<T*>(out), static_cast<float*>(ws), S, H, KV, D, window, scale,
      cap, split_len);
  st = cudaGetLastError();
  if (st != cudaSuccess || n_split == 1) return (int)st;
  return (int)rapid::launch_combine<T>(static_cast<const float*>(ws), static_cast<T*>(out),
                                       B * KV, n_split, G, D, stream);
}

template <typename T>
int launch_g(const void* q, const void* k, const void* v, const int* lens, int len_all,
             void* out, void* ws, int B, int S, int H, int KV, int D, int window,
             float scale, float cap, int n_split, int split_len, cudaStream_t stream) {
  const int G = H / KV;
#define RAPID_LAUNCH(GM)                                                                    \
  return launch<T, GM>(q, k, v, lens, len_all, out, ws, B, S, H, KV, D, window, scale, cap, \
                       n_split, split_len, stream)
  if (G <= 1) RAPID_LAUNCH(1);
  if (G <= 2) RAPID_LAUNCH(2);
  if (G <= 4) RAPID_LAUNCH(4);
  if (G <= 8) RAPID_LAUNCH(8);
  RAPID_LAUNCH(16);
#undef RAPID_LAUNCH
}

}  // namespace

// cache_lens may be null: then every row attends over cache_len tokens.
// ws: float32 workspace of B * KV * n_split * G * (D + 2) floats (unused,
// may be null, when n_split == 1).
extern "C" int decode_attention(const void* q, const void* cache_k, const void* cache_v,
                                const int* cache_lens, int cache_len, void* out, void* ws,
                                int B, int S, int H, int KV, int D, int window, float scale,
                                float cap, int n_split, int split_len, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_g<__nv_bfloat16>(q, cache_k, cache_v, cache_lens, cache_len, out, ws, B, S,
                                   H, KV, D, window, scale, cap, n_split, split_len, s);
  return launch_g<float>(q, cache_k, cache_v, cache_lens, cache_len, out, ws, B, S, H, KV, D,
                         window, scale, cap, n_split, split_len, s);
}
