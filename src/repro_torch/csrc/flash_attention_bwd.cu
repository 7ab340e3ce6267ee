// Flash-attention backward for Hopper (sm_90a): the gradient of the
// training attention, dq, dk, dv from q, k, v, the forward's output, its
// per-row log-sum-exp and dout.
//
// Replaces no Pallas kernel: the JAX package trains through a jnp custom
// VJP (repro/models/attention.py:198-289, strip_bwd at :261), which has no
// Pallas counterpart.  The port sends its training attention through its
// own forward kernel (csrc/flash_attention.cu, which writes the lse when
// asked) and this backward, as one torch.autograd.Function
// (kernels/ops.py flash_attention_train).  Same function as strip_bwd:
//   sc    = softcap(q.k * scale)           scores of visible (q, k) pairs
//   p     = exp(sc - lse)                  recomputed, never stored
//   delta = rowsum(dout * out)
//   dv    = sum over rows of p * dout
//   ds    = p * (dout.v - delta) * (1 - (sc / cap)^2 if cap) * scale
//   dq    = ds . k,   dk = sum over rows of ds * q
// with GQA: the G query heads of a KV head add into its dk and dv.  Masks:
// causal, sliding window (q - k) < window, the ragged end; any S.
//
// Bound on an H100: operations at the training shapes (openvla-7b, S =
// 256, D = 128: 2.5x the forward's 4 * H * D flops per visible pair), bytes
// below S ~ 100.  This is the first, simple kernel (right before fast): f32
// FMAs out of shared memory for both element types, no tensor cores.  Its
// design:
//   * three launches on one stream: (1) delta, one warp a (row, head);
//     (2) dk and dv, one block per (batch row, KV head, 32-key tile), the
//     tile's K and V resident in shared memory while the block walks the
//     32-row tiles of query rows that can see it (rows packed over the G
//     heads of the KV head, as the forward packs them: packed row R is
//     position R / G of head kvh * G + R % G), so the GQA sum and the sum
//     over rows stay in registers and every dk / dv element is written
//     once, with no atomics; (3) dq, one block per (batch row, KV head,
//     32 packed rows), Q and dout resident while the block walks the key
//     tiles its rows can see, dq accumulated in f32 registers and cast at
//     the end.  Launches (2) and (3) recompute p each: 7 of the FA-2
//     backward's 5 products, the price of no atomics and a result that is
//     the same on every run;
//   * scores and dout.v: lane j takes key j of the tile, warp w rows w,
//     w + 8, w + 16, w + 24; K and V rows padded to an odd stride so the
//     32 lanes hit 32 banks, Q and dout rows read as broadcasts;
//   * the products into dk / dv (dq): a thread owns keys (rows) w + 8 r and
//     columns lane + 32 c, so each shared load of a dout or q (k) column
//     feeds four FMAs;
//   * bf16 inputs are widened to f32 in shared memory; every sum is f32,
//     and the outputs are rounded to the input type once.
// Causal tile skip: a key tile visits only the query rows from its first
// key on (and before its last key + window), a query tile only the keys up
// to its last row (and from its first row - window + 1).

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rapid::from_f;
using rapid::load8;

constexpr int BW_THREADS = 256;
constexpr int BW_WARPS = BW_THREADS / 32;
constexpr int BW_BQ = 32;  // packed query rows a tile
constexpr int BW_BK = 32;  // keys a tile (one per lane)
constexpr int BW_RW = BW_BQ / BW_WARPS;  // rows (or keys) a warp owns: 4
constexpr int PS = BW_BK + 1;            // row stride of the p / ds tiles

// Shared memory of either main kernel (floats): two row tiles of q-side
// rows and two of keys, [rows][DT + 1] each, the p and ds tiles, lse and
// delta of the q rows.
__host__ __device__ constexpr int bwd_smem_bytes(int dt) {
  return (int)sizeof(float) * (2 * (BW_BQ + BW_BK) * (dt + 1) + 2 * BW_BQ * PS + 2 * BW_BQ);
}

// rows [0, n) of a tile into dst [n][DP] as f32: row t from src + off(t)
// (off < 0: a zero row), columns [D, DP) zero
template <typename T, typename Off>
__device__ __forceinline__ void load_tile(float* dst, int DP, int n, int D, const T* src,
                                          const Off& off) {
  const int cpr = (DP - 1) / 8;
  for (int c = threadIdx.x; c < n * cpr; c += BW_THREADS) {
    const int t = c / cpr, col = (c % cpr) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int64_t o = off(t);
    if (o >= 0 && col < D) load8(src + o + col, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[t * DP + col + e] = f[e];
  }
  if (threadIdx.x < n) dst[threadIdx.x * DP + DP - 1] = 0.f;
}

// delta[b, h, p] = sum_d dout[b, p, h, d] * out[b, p, h, d]: one warp a row
template <typename T>
__global__ void __launch_bounds__(BW_THREADS)
bwd_delta(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
          int B, int S, int H, int D) {
  const int row = blockIdx.x * BW_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= B * S * H) return;
  const T* o = out + (int64_t)row * D;
  const T* g = dout + (int64_t)row * D;
  float acc = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    float a[8], x[8];
    load8(o + c, a);
    load8(g + c, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(a[e], x[e], acc);
  }
  acc = rapid::warp_sum(acc);
  if (lane == 0) {
    const int h = row % H, bp = row / H;
    delta[((int64_t)(bp / S) * H + h) * S + bp % S] = acc;
  }
}

// p and ds of one (row tile, key tile) into p_s / ds_s [BQ][PS]: lane j is
// key k0 + j, warp w rows w + 8 r.  Row i is packed row r0 + i (position
// (r0 + i) / G), valid below r_hi; key j valid below kn.
__device__ __forceinline__ void tile_p_ds(const float* q_s, const float* do_s, const float* k_s,
                                          const float* v_s, const float* lse_s,
                                          const float* dl_s, float* p_s, float* ds_s, int DP,
                                          int D, int r0, int r_hi, int G, int k0, int kn,
                                          int causal, int window, float scale, float cap) {
  const int warp = threadIdx.x / 32, j = threadIdx.x % 32;
  float s[BW_RW], dp[BW_RW];
#pragma unroll
  for (int r = 0; r < BW_RW; ++r) s[r] = dp[r] = 0.f;
  const float* kj = k_s + j * DP;
  const float* vj = v_s + j * DP;
  for (int d = 0; d < D; ++d) {
    const float kd = kj[d], vd = vj[d];
#pragma unroll
    for (int r = 0; r < BW_RW; ++r) {
      const int i = warp + BW_WARPS * r;
      s[r] = fmaf(q_s[i * DP + d], kd, s[r]);
      dp[r] = fmaf(do_s[i * DP + d], vd, dp[r]);
    }
  }
  const int kpos = k0 + j;
#pragma unroll
  for (int r = 0; r < BW_RW; ++r) {
    const int i = warp + BW_WARPS * r, R = r0 + i, pos = R / G;
    float p = 0.f, ds = 0.f;
    if (R < r_hi && j < kn && (!causal || pos >= kpos) && (window <= 0 || pos - kpos < window)) {
      const float x = s[r] * scale;
      const float sc = cap > 0.f ? cap * tanhf(x / cap) : x;
      p = expf(sc - lse_s[i]);
      ds = p * (dp[r] - dl_s[i]);
      if (cap > 0.f) {
        const float t = sc / cap;
        ds *= 1.f - t * t;
      }
      ds *= scale;
    }
    p_s[i * PS + j] = p;
    ds_s[i * PS + j] = ds;
  }
}

// dk, dv: one block per (pair, key tile), blockIdx.x = tile * pairs + pair
// (causal: the first tiles see the most rows and start first)
template <typename T, int DT>
__global__ void __launch_bounds__(BW_THREADS)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int B, int S,
         int H, int KV, int D, int causal, int window, float scale, float cap) {
  constexpr int DP = DT + 1, NC = DT / 32;
  extern __shared__ float sm[];
  float* k_s = sm;
  float* v_s = k_s + BW_BK * DP;
  float* q_s = v_s + BW_BK * DP;
  float* do_s = q_s + BW_BQ * DP;
  float* p_s = do_s + BW_BQ * DP;
  float* ds_s = p_s + BW_BQ * PS;
  float* lse_s = ds_s + BW_BQ * PS;
  float* dl_s = lse_s + BW_BQ;

  const int G = H / KV, pairs = B * KV;
  const int pair = blockIdx.x % pairs, k0 = (blockIdx.x / pairs) * BW_BK;
  const int b = pair / KV, kvh = pair % KV;
  const int kn = min(BW_BK, S - k0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t q_row = (int64_t)H * D, kv_row = (int64_t)KV * D;
  const int64_t kv_base = (int64_t)b * S * kv_row + (int64_t)kvh * D;
  auto key_off = [&](int t) -> int64_t { return t < kn ? kv_base + (k0 + t) * kv_row : -1; };
  load_tile(k_s, DP, BW_BK, D, k, key_off);
  load_tile(v_s, DP, BW_BK, D, v, key_off);

  // the packed rows that see a key of this tile: positions [p_lo, p_hi)
  const int p_lo = causal ? k0 : 0;
  const int p_hi = window > 0 ? min(S, k0 + kn - 1 + window) : S;
  const int r_lo = p_lo * G, r_hi = p_hi * G;

  float acc_k[BW_RW][NC], acc_v[BW_RW][NC];
#pragma unroll
  for (int r = 0; r < BW_RW; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int r0 = r_lo; r0 < r_hi; r0 += BW_BQ) {
    __syncthreads();  // the previous row tile's readers are done
    auto row_off = [&](int t) -> int64_t {
      const int R = r0 + t;
      return R < r_hi ? ((int64_t)b * S + R / G) * q_row + (int64_t)(kvh * G + R % G) * D : -1;
    };
    load_tile(q_s, DP, BW_BQ, D, q, row_off);
    load_tile(do_s, DP, BW_BQ, D, dout, row_off);
    if (threadIdx.x < BW_BQ) {
      const int R = r0 + threadIdx.x;
      const int64_t at = ((int64_t)b * H + kvh * G + R % G) * S + R / G;
      lse_s[threadIdx.x] = R < r_hi ? lse[at] : 0.f;
      dl_s[threadIdx.x] = R < r_hi ? delta[at] : 0.f;
    }
    __syncthreads();
    tile_p_ds(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, DP, D, r0, r_hi, G, k0, kn, causal,
              window, scale, cap);
    __syncthreads();
    // dv[j] += p[i, j] dout[i], dk[j] += ds[i, j] q[i]: keys warp + 8 r
    for (int i = 0; i < BW_BQ; ++i) {
      float gv[NC], qv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        gv[c] = do_s[i * DP + lane + 32 * c];
        qv[c] = q_s[i * DP + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < BW_RW; ++r) {
        const float pj = p_s[i * PS + warp + BW_WARPS * r];
        const float dsj = ds_s[i * PS + warp + BW_WARPS * r];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc_v[r][c] = fmaf(pj, gv[c], acc_v[r][c]);
          acc_k[r][c] = fmaf(dsj, qv[c], acc_k[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BW_RW; ++r) {
    const int j = warp + BW_WARPS * r;
    if (j >= kn) continue;
    const int64_t at = kv_base + (k0 + j) * kv_row;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[at + d] = from_f<T>(acc_k[r][c]);
        dv[at + d] = from_f<T>(acc_v[r][c]);
      }
    }
  }
}

// dq: one block per (pair, 32 packed rows), blockIdx.x = (n_tiles - 1 -
// tile) * pairs + pair (causal: the last tiles see the most keys and start
// first)
template <typename T, int DT>
__global__ void __launch_bounds__(BW_THREADS)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, T* __restrict__ dq, int B, int S, int H, int KV, int D,
       int causal, int window, float scale, float cap, int n_tiles) {
  constexpr int DP = DT + 1, NC = DT / 32;
  extern __shared__ float sm[];
  float* q_s = sm;
  float* do_s = q_s + BW_BQ * DP;
  float* k_s = do_s + BW_BQ * DP;
  float* v_s = k_s + BW_BK * DP;
  float* p_s = v_s + BW_BK * DP;
  float* ds_s = p_s + BW_BQ * PS;
  float* lse_s = ds_s + BW_BQ * PS;
  float* dl_s = lse_s + BW_BQ;

  const int G = H / KV, pairs = B * KV, rows_total = S * G;
  const int pair = blockIdx.x % pairs, tile = n_tiles - 1 - blockIdx.x / pairs;
  const int b = pair / KV, kvh = pair % KV;
  const int r0 = tile * BW_BQ, r_hi = min(r0 + BW_BQ, rows_total);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t q_row = (int64_t)H * D, kv_row = (int64_t)KV * D;
  const int64_t kv_base = (int64_t)b * S * kv_row + (int64_t)kvh * D;
  auto row_off = [&](int t) -> int64_t {
    const int R = r0 + t;
    return R < r_hi ? ((int64_t)b * S + R / G) * q_row + (int64_t)(kvh * G + R % G) * D : -1;
  };
  load_tile(q_s, DP, BW_BQ, D, q, row_off);
  load_tile(do_s, DP, BW_BQ, D, dout, row_off);
  if (threadIdx.x < BW_BQ) {
    const int R = r0 + threadIdx.x;
    const int64_t at = ((int64_t)b * H + kvh * G + R % G) * S + R / G;
    lse_s[threadIdx.x] = R < r_hi ? lse[at] : 0.f;
    dl_s[threadIdx.x] = R < r_hi ? delta[at] : 0.f;
  }
  const int p_first = r0 / G, p_last = (r_hi - 1) / G;
  const int k_hi = causal ? p_last + 1 : S;
  const int k_lo = window > 0 ? max(0, p_first - window + 1) : 0;

  float acc[BW_RW][NC];
#pragma unroll
  for (int r = 0; r < BW_RW; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += BW_BK) {
    const int kn = min(BW_BK, k_hi - k0);
    __syncthreads();  // the previous key tile's readers are done
    auto key_off = [&](int t) -> int64_t { return t < kn ? kv_base + (k0 + t) * kv_row : -1; };
    load_tile(k_s, DP, BW_BK, D, k, key_off);
    load_tile(v_s, DP, BW_BK, D, v, key_off);
    __syncthreads();
    tile_p_ds(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, DP, D, r0, r_hi, G, k0, kn, causal,
              window, scale, cap);
    __syncthreads();
    // dq[i] += ds[i, j] k[j]: rows warp + 8 r
    for (int j = 0; j < kn; ++j) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = k_s[j * DP + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < BW_RW; ++r) {
        const float dsj = ds_s[(warp + BW_WARPS * r) * PS + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(dsj, kv[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BW_RW; ++r) {
    const int64_t o = row_off(warp + BW_WARPS * r);
    if (o < 0) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dq[o + d] = from_f<T>(acc[r][c]);
    }
  }
}

template <typename T, int DT>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int H,
           int KV, int D, int causal, int window, float scale, float cap, int grid_dq,
           int grid_dkdv, cudaStream_t stream) {
  static int granted_dq = 48 * 1024, granted_kv = 48 * 1024;
  const int smem = bwd_smem_bytes(DT);
  auto kdq = bwd_dq<T, DT>;
  auto kkv = bwd_dkdv<T, DT>;
  cudaError_t st = rapid::allow_smem(kdq, smem, &granted_dq);
  if (st == cudaSuccess) st = rapid::allow_smem(kkv, smem, &granted_kv);
  if (st != cudaSuccess) return (int)st;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const int rows = B * S * H;
  bwd_delta<T><<<(rows + BW_WARPS - 1) / BW_WARPS, BW_THREADS, 0, stream>>>(
      static_cast<const T*>(out), gt, delta, B, S, H, D);
  st = cudaGetLastError();
  if (st != cudaSuccess) return (int)st;
  kkv<<<grid_dkdv, BW_THREADS, smem, stream>>>(qt, kt, vt, gt, lse, delta, static_cast<T*>(dk),
                                                static_cast<T*>(dv), B, S, H, KV, D, causal,
                                                window, scale, cap);
  st = cudaGetLastError();
  if (st != cudaSuccess) return (int)st;
  kdq<<<grid_dq, BW_THREADS, smem, stream>>>(qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), B,
                                             S, H, KV, D, causal, window, scale, cap,
                                             grid_dq / (B * KV));
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (q_tile, k_tile, grids) is kernels/_lib.py flash_bwd_plan's; a
// plan that does not fit the kernels is refused (cudaErrorInvalidValue).
// lse and delta: float32 [B, H, S] (delta is written here); dq like q, dk
// and dv like k.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int S, int H, int KV, int D,
                                   int causal, int window, float scale, float cap, int dtype,
                                   int q_tile, int k_tile, int grid_dq, int grid_dkdv,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || KV < 1 || H % KV || D < 8 || D > rapid::MAX_D || D % 8)
    return (int)cudaErrorInvalidValue;
  const int pairs = B * KV, G = H / KV;
  if (q_tile != BW_BQ || k_tile != BW_BK ||
      grid_dq != (S * G + BW_BQ - 1) / BW_BQ * pairs || grid_dkdv != (S + BW_BK - 1) / BW_BK * pairs)
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define RAPID_BWD(T, DT)                                                                         \
  return launch<T, DT>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, H, KV, D, causal, window,   \
                       scale, cap, grid_dq, grid_dkdv, s)
  if (dtype == 0) {
    if (D <= 64) RAPID_BWD(float, 64);
    if (D <= 128) RAPID_BWD(float, 128);
    RAPID_BWD(float, 256);
  }
  if (dtype == 1) {
    if (D <= 64) RAPID_BWD(bf16, 64);
    if (D <= 128) RAPID_BWD(bf16, 128);
    RAPID_BWD(bf16, 256);
  }
  return (int)cudaErrorInvalidValue;
#undef RAPID_BWD
}
