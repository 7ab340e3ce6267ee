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
// 256, D = 128: 2.5x the forward's 4 * H * D flops per visible pair, FA-2's
// five products), bytes below S ~ 100.  Rows are packed over the G query
// heads of a KV head, as the forward packs them: packed row R is position
// R / G of head kvh * G + R % G, so the G heads share every K / V tile.
//
// bf16 (tensor cores; bwd_delta, then bwd_main_tc).  The first port of
// this kernel did f32 FMAs out of shared memory and ran 8.6x SDPA's
// backward at openvla-7b's shape, 45x at G = 16.  Its design now:
//   * every product is mma.sync.m16n8k16 (bf16 in, f32 accumulate) on
//     ldmatrix operands; tiles stay bf16 in shared memory, rows padded by 8
//     elements (16 bytes) so that every ldmatrix phase hits 8 distinct
//     16-byte bank groups; copies are 16-byte cp.async, two stages, the next
//     tile's copies in flight while the current one is computed;
//   * dk / dv blocks (4 warps): one per (batch row, KV head, key tile of BN
//     keys, split).  The K and V tile stays resident while the block walks
//     the tiles of BM packed query rows that can see it; warp w owns keys
//     16 (w % KM) .. + 16 (KM = BN / 16) and the columns of dk / dv chunk
//     w / KM.  Per row tile, in registers: S^T = K Q^T and dP^T = V dO^T
//     (16 keys x BM rows), P^T = exp(softcap(S^T scale) - lse), dS^T = P^T
//     (dP^T - delta) (1 - (sc/cap)^2) scale, then dV += P^T dO and dK +=
//     dS^T Q with P and dS rounded to bf16 as the A operand (the C layout
//     of two 8-column tiles is the A layout of one 16-row step) and dO, Q
//     by ldmatrix.trans, each A fragment feeding every column's
//     accumulator in turn.  dk and dv are summed in float32 registers and
//     written once.  BN = BM = 64 for D <= 128; 32 for D = 256, where a
//     warp's 16 keys would need 256 accumulator registers: the two warps
//     of a key m-tile split the 256 columns and both compute its S^T and
//     dP^T (6 products' work for 4);
//   * GQA split: a KV head's G query heads are cut into `splits` groups of
//     G / splits heads, one dk / dv block each, so that the grid reaches the
//     132 SMs (G = 16 at B = 1, KV = 4, S = 256: 16 blocks unsplit, 256 at
//     splits = 16).  With splits > 1 each block writes float32 partials into
//     a workspace [splits][B, S, KV, D] (dk, then dv) and bwd_reduce sums
//     them in split order and casts: no atomics, the same result every run;
//   * dq blocks (4 warps): one per (batch row, KV head, 64 packed rows), Q
//     and dO resident while the block walks the key tiles its rows can see;
//     warp w owns rows 16 w .. + 16: S = Q K^T, dP = dO V^T, P, dS as
//     above, dQ += dS K (K by ldmatrix.trans), dq in float32 registers,
//     cast once.  Seven products in all against FA-2's five (dq atomics
//     into a float32 workspace, then a convert pass): the price of a result
//     that is the same on every run;
//   * one launch (bwd_main_tc) runs both kinds of block, interleaved, each
//     kind heaviest first: the dk / dv and dq blocks of a (batch row, KV
//     head) run together and share their Q, dO, K, V reads in L2, and the
//     two kinds' tails overlap (on an H100 it beat two launches at the
//     training shapes, PERF.md).  delta = rowsum(dout * out) comes first,
//     its own launch (bwd_delta, 8-32 lanes a row), since both kinds read
//     it.  Where D = 256 the dq blocks take one K / V stage, which
//     keeps both kinds at two blocks an SM;
//   * no branch around an aligned warp-wide instruction on the hot path: a
//     warp skips a whole tile that none of its (row, key) pairs can see, and
//     the mask (p = 0) runs only on tiles that cut the diagonal or the
//     window's edge.  The ragged end needs no mask: rows past the block's
//     last visible row and keys past the last key are zero-filled by the
//     src-size form of cp.async, with lse = delta = 0, so they give p = 1,
//     dp = ds = 0 and add exactly 0 to dv (dO = 0), dk (ds = 0), dq (K = 0);
//     the garbage in accumulators of rows or keys past the end is never
//     stored.  The mmas run over all DT columns (D padded with zeros);
//   * causal and window tile skip: a key tile visits only the query rows
//     from its first key on (and before its last key + window), a query
//     tile only the keys up to its last row (and from its first row -
//     window + 1).
// At the training shapes (S = 256-1024) the kernel is bound by how fast a
// warp's dependent ldmatrix -> mma chains run (registers: the 128 float32
// accumulators of dk and dv leave no room to load fragments a step ahead,
// and hold the SM to 8 warps), not by bytes: a variant whose blocks all
// read one (batch row, KV head), so from L2, ran no faster.
// P and dS are rounded to bf16 before their products, as every tensor-core
// backward does (SDPA's too); the plain version keeps both in float32.  The
// stated tolerance (chip_smoke.py BWD_TOL) bounds that rounding per element
// by 2^-8 times the sum of the absolute terms.
//
// float32 (bwd_dkdv, bwd_dq: the first port's scalar kernels, kept): tensor
// cores take f32 only as TF32, which would miss the float32 tolerance (1e-4
// of a leaf in the training twins).  f32 FMAs out of shared memory, tiles of
// 32 keys and 32 packed rows widened in shared memory, dk / dv one block per
// (batch row, KV head, key tile), dq one per (batch row, KV head, query
// tile).
//
// One call is 3 launches in float32 (delta, dk / dv, dq) and 2 in bf16
// (delta, then dq and dk / dv together; 3 with a split: the reduce),
// counted as one by the Python launcher.  The plan (tiles, splits, grids) is
// kernels/_lib.py flash_bwd_plan's; a plan that does not fit these kernels
// is refused.

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rapid::from_f;
using rapid::load8;

// ---------------------------------------------------------------------------
// delta (both types) and the float32 scalar kernels
// ---------------------------------------------------------------------------

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

// delta[b, h, p] = sum_d dout[b, p, h, d] * out[b, p, h, d] (both element
// types): LPR lanes a (row, head) (a power of two >= D / 8), 8 elements a
// lane, 256 / LPR rows a block
template <typename T, int LPR>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
          int B, int S, int H, int D) {
  const int row = blockIdx.x * (256 / LPR) + threadIdx.x / LPR, c = threadIdx.x % LPR;
  const bool live = row < B * S * H;
  float acc = 0.f;
  if (live && c < D / 8) {
    float a[8], x[8];
    load8(out + (int64_t)row * D + c * 8, a);
    load8(dout + (int64_t)row * D + c * 8, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(a[e], x[e], acc);
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && c == 0) {
    const int h = row % H, bp = row / H;
    delta[((int64_t)(bp / S) * H + h) * S + bp % S] = acc;
  }
}

// the delta launch for D <= DT
template <typename T, int DT>
cudaError_t launch_delta(const void* out, const void* dout, float* delta, int B, int S, int H,
                         int D, cudaStream_t stream) {
  constexpr int LPR = DT / 8 <= 8 ? 8 : DT / 8;  // 8, 16 or 32 lanes a row
  const int rows = B * S * H;
  bwd_delta<T, LPR><<<(rows + 256 / LPR - 1) / (256 / LPR), 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, B, S, H, D);
  return cudaGetLastError();
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

// ---------------------------------------------------------------------------
// bf16 tensor-core kernels
// ---------------------------------------------------------------------------

using rapid::cp_async16_zfill;
using rapid::cp_async4_zfill;
using rapid::ex2;
using rapid::ldsm_x4;
using rapid::ldsm_x4_t;
using rapid::LOG2E;
using rapid::mma_bf16;
using rapid::pack_bf16;
using rapid::smem_u32;
using rapid::softcap_scaled;

constexpr int TC_THREADS = 128;
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int TC_Q_TILE = 64;  // packed rows a dq block takes (16 a warp)

// keys a dk / dv block holds and packed query rows it walks a step (and keys
// a dq tile holds): 64, or 32 where D > 128 leaves fewer registers
__host__ __device__ constexpr int tc_k_tile(int dt) { return dt <= 128 ? 64 : 32; }

// Shared memory, bf16 rows of SR = DT + 8.  dk / dv: K, V [BN][SR]; Q, dO
// [2 stages][BM][SR]; lse, delta (float) and positions (int) [2][BM].
__host__ __device__ constexpr int tc_dkdv_smem(int dt) {
  return 6 * tc_k_tile(dt) * (dt + 8) * 2 + 3 * 2 * tc_k_tile(dt) * 4;
}
// dq: Q, dO [64][SR]; K, V [stages][BN][SR]; lse, delta [64].  Two stages,
// one where D > 128: the dq and dk / dv blocks share a launch, and one stage
// keeps both at two blocks an SM.
__host__ __device__ constexpr int tc_dq_stages(int dt) { return dt <= 128 ? 2 : 1; }
__host__ __device__ constexpr int tc_dq_smem(int dt) {
  return (2 * TC_Q_TILE + 2 * tc_dq_stages(dt) * tc_k_tile(dt)) * (dt + 8) * 2 +
         2 * TC_Q_TILE * 4;
}

// ldmatrix lane addresses (bytes) into a [rows][SR] bf16 tile at `base`:
// the A operand of 16 rows from `row` (x4: rows 0-7 / 8-15 x columns 0-7 /
// 8-15); a B operand whose n index is the tile's row (two n-tiles of 8 rows
// x 16 columns); a B operand whose k index is the tile's row, by .trans (16
// rows x two n-tiles of 8 columns).  A 16-column step adds 32 bytes, 16 rows
// 16 * SR * 2.
__device__ __forceinline__ unsigned lane_a(const bf16* base, int row, int SR, int lane) {
  return smem_u32(base) + ((row + lane % 16) * SR + (lane / 16) * 8) * 2;
}
__device__ __forceinline__ unsigned lane_b(const bf16* base, int SR, int lane) {
  return smem_u32(base) + (((lane / 16) * 8 + lane % 8) * SR + ((lane / 8) % 2) * 8) * 2;
}
__device__ __forceinline__ unsigned lane_bt(const bf16* base, int col, int SR, int lane) {
  return smem_u32(base) + ((((lane / 8) % 2) * 8 + lane % 8) * SR + (lane / 16) * 8 + col) * 2;
}

// acc (16 x N) += A (16 x DT) . B^T, B [N][DT] rows: A at a_ln (lane_a), B
// at b_ln (lane_b); RB the row stride in bytes
template <int DT, int N, int RB>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], unsigned a_ln, unsigned b_ln) {
#pragma unroll
  for (int kd = 0; kd < DT / 16; ++kd) {
    unsigned fa[4];
    ldsm_x4(fa, a_ln + kd * 32);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      unsigned fb[4];
      ldsm_x4(fb, b_ln + np * 16 * RB + kd * 32);
      mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
      mma_bf16(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc (16 x NC) += P (16 x K) . B, B [K][..] rows at bt_ln (lane_bt, its
// first column included): P as bf16 A fragments, one per 16-row step of B.
// Row steps outside, column steps inside: each A fragment feeds NC / 8
// independent accumulators in turn (column steps outside would chain K / 16
// mmas on two of them)
template <int K, int NC, int RB>
__device__ __forceinline__ void mma_pb(float (&acc)[NC / 8][4], const unsigned (&pf)[K / 16][4],
                                       unsigned bt_ln) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < NC / 16; ++dp) {
      unsigned fv[4];
      ldsm_x4_t(fv, bt_ln + kk * 16 * RB + dp * 32);
      mma_bf16(acc[2 * dp], pf[kk], fv[0], fv[1]);
      mma_bf16(acc[2 * dp + 1], pf[kk], fv[2], fv[3]);
    }
  }
}

// the C fragments of a 16 x K tile, rounded to bf16, as the A fragments of
// its K / 16 steps
template <int K>
__device__ __forceinline__ void c_to_a(unsigned (&pf)[K / 16][4], const float (&c)[K / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    pf[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    pf[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    pf[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    pf[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) a[n][0] = a[n][1] = a[n][2] = a[n][3] = 0.f;
}

// p and ds of one score in place: s (unscaled score, softcapped into units
// of 1 / scale) -> p, dp -> ds
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse2, float dl, bool vis,
                                     float scale, float scale_log2, float cap, float cap_in,
                                     float cap_out) {
  const float sc = cap > 0.f ? softcap_scaled(s, cap_in, cap_out) : s;
  const float p = vis ? ex2(fmaf(sc, scale_log2, -lse2)) : 0.f;
  float ds = p * (dp - dl);
  if (cap > 0.f) {
    const float t = sc * cap_in;  // sc * scale / cap = tanh(s scale / cap)
    ds *= 1.f - t * t;
  }
  s = p;
  dp = ds * scale;
}

// zero the pad columns [D, DT) of `rows` rows from `base` (cp.async writes
// only [0, D))
__device__ __forceinline__ void zero_pad(bf16* base, int rows, int SR, int D, int DT) {
  const int pad = (DT - D) / 8;
  for (int e = threadIdx.x; e < rows * pad; e += blockDim.x)
    *reinterpret_cast<uint4*>(base + (e / pad) * SR + D + (e % pad) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
}

// Copies of packed rows [r0, r0 + n) into q_dst / do_dst [n][SR]: packed row
// R is position R / Gs of head h0 + R % Gs; rows >= r_hi zero-filled, with
// lse and delta (float [n]) zero; pos_dst (if any) [n] gets R / Gs.  A
// thread copies chunk tid % CPT of rows tid / CPT, + TC_THREADS / CPT, ...
template <int CPT>
__device__ __forceinline__ void issue_rows(const bf16* q, const bf16* dout, const float* lse,
                                           const float* delta, bf16* q_dst, bf16* do_dst,
                                           float* lse_dst, float* dl_dst, int* pos_dst, int SR,
                                           int r0, int n, int r_hi, int b, int S, int H, int D,
                                           int h0, int Gs) {
  constexpr int RS = TC_THREADS / CPT;
  const int tid = threadIdx.x, c = tid % CPT, t0 = tid / CPT;
  const int64_t q_row = (int64_t)H * D;
  if (c < D / 8) {
    int R = r0 + t0, pos = R / Gs, hh = R - pos * Gs;
    const int dpos = RS / Gs, dh = RS % Gs;
    for (int t = t0; t < n; t += RS) {
      const bool ok = R < r_hi;
      const int64_t off =
          ok ? ((int64_t)b * S + pos) * q_row + (int64_t)(h0 + hh) * D + c * 8 : 0;
      cp_async16_zfill(q_dst + t * SR + c * 8, q + off, ok);
      cp_async16_zfill(do_dst + t * SR + c * 8, dout + off, ok);
      R += RS;
      pos += dpos;
      hh += dh;
      if (hh >= Gs) {
        hh -= Gs;
        ++pos;
      }
    }
  }
  if (tid < n) {
    const int R = r0 + tid, pos = R / Gs;
    const bool ok = R < r_hi;
    const int64_t at = ok ? ((int64_t)b * H + h0 + R - pos * Gs) * S + pos : 0;
    cp_async4_zfill(lse_dst + tid, lse + at, ok);
    cp_async4_zfill(dl_dst + tid, delta + at, ok);
    if (pos_dst != nullptr) pos_dst[tid] = pos;
  }
}

// K and V rows [k0, k0 + kn) into k_dst / v_dst [BN][SR], rows [kn, BN) zero
template <int CPT, int BN>
__device__ __forceinline__ void issue_keys(const bf16* k, const bf16* v, bf16* k_dst,
                                           bf16* v_dst, int SR, int k0, int kn, int64_t kv_base,
                                           int64_t kv_row, int D) {
  constexpr int RS = TC_THREADS / CPT;
  const int c = threadIdx.x % CPT;
  if (c >= D / 8) return;
  for (int t = threadIdx.x / CPT; t < BN; t += RS) {
    const bool ok = t < kn;
    const int64_t off = ok ? kv_base + (k0 + t) * kv_row + c * 8 : 0;
    cp_async16_zfill(k_dst + t * SR + c * 8, k + off, ok);
    cp_async16_zfill(v_dst + t * SR + c * 8, v + off, ok);
  }
}

// dk, dv of block L = tile * (pairs * splits) + pair * splits + split
// (causal: key tile 0 sees the most rows and starts first).  ws == nullptr:
// dk / dv written as bf16; else float32 partials at ws[split] (dk) and
// ws[splits + split] (dv), each [B, S, KV, D].
template <int DT>
__device__ __forceinline__ void dkdv_block(
    int L, unsigned char* smem_raw, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ ws, int B, int S, int H, int KV, int D, int causal, int window,
    float scale, float cap, int splits) {
  constexpr int BN = tc_k_tile(DT), BM = BN, SR = DT + 8, RB = SR * 2;
  constexpr int KM = BN / 16, NC = DT / (TC_WARPS / KM), CPT = DT / 8;
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);     // [BN][SR]
  bf16* v_s = k_s + BN * SR;                         // [BN][SR]
  bf16* q_s = v_s + BN * SR;                         // [2][BM][SR]
  bf16* do_s = q_s + 2 * BM * SR;                    // [2][BM][SR]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BM * SR);  // [2][BM]
  float* dl_s = lse_s + 2 * BM;                      // [2][BM]
  int* pos_s = reinterpret_cast<int*>(dl_s + 2 * BM);  // [2][BM]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / KV, Gs = G / splits, units = B * KV * splits;
  const int unit = L % units, k0 = (L / units) * BN;
  const int pair = unit / splits, sp = unit % splits;
  const int b = pair / KV, kvh = pair % KV, h0 = kvh * G + sp * Gs;
  const int kn = min(BN, S - k0);
  // the packed rows (of this split's Gs heads) that see a key of this tile
  const int p_lo = causal ? k0 : 0;
  const int p_hi = window > 0 ? min(S, k0 + kn - 1 + window) : S;
  const int r_lo = p_lo * Gs, r_hi = p_hi * Gs;
  const int nt = (r_hi - r_lo + BM - 1) / BM;
  const int64_t kv_row = (int64_t)KV * D;
  const int64_t kv_base = (int64_t)b * S * kv_row + (int64_t)kvh * D;

  if (D != DT) zero_pad(k_s, 2 * BN + 4 * BM, SR, D, DT);
  issue_keys<CPT, BN>(k, v, k_s, v_s, SR, k0, kn, kv_base, kv_row, D);
  issue_rows<CPT>(q, dout, lse, delta, q_s, do_s, lse_s, dl_s, pos_s, SR, r_lo, BM, r_hi, b, S,
                  H, D, h0, Gs);
  rapid::cp_async_commit();  // K, V and the first row tile: one group

  // warp: keys 16 km .. + 16 of the tile, dk / dv columns [col0, col0 + NC)
  const int km = warp % KM, col0 = (warp / KM) * NC;
  const int g = lane / 4, t4 = lane % 4;
  const int kw0 = k0 + 16 * km;
  const unsigned ka_ln = lane_a(k_s, 16 * km, SR, lane), va_ln = lane_a(v_s, 16 * km, SR, lane);
  const unsigned qb_ln = lane_b(q_s, SR, lane), dob_ln = lane_b(do_s, SR, lane);
  const unsigned qt_ln = lane_bt(q_s, col0, SR, lane), dot_ln = lane_bt(do_s, col0, SR, lane);
  const float scale_log2 = scale * LOG2E;
  const float cap_in = cap > 0.f ? scale / cap : 0.f, cap_out = cap > 0.f ? cap / scale : 0.f;

  float acc_k[NC / 8][4], acc_v[NC / 8][4];
  zero(acc_k);
  zero(acc_v);

  for (int it = 0; it < nt; ++it) {
    const int r0 = r_lo + it * BM, stage = it & 1;
    if (it + 1 < nt) {
      const int nx = stage ^ 1;
      issue_rows<CPT>(q, dout, lse, delta, q_s + nx * BM * SR, do_s + nx * BM * SR,
                      lse_s + nx * BM, dl_s + nx * BM, pos_s + nx * BM, SR, r0 + BM, BM, r_hi,
                      b, S, H, D, h0, Gs);
      rapid::cp_async_commit();
      rapid::cp_async_wait<1>();
    } else {
      rapid::cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and K, V, the zero columns, pos) visible to all

    // positions [pa, pb] of the tile's rows against this warp's keys
    const int pa = r0 / Gs, pb = (min(r0 + BM, r_hi) - 1) / Gs;
    const bool live = kw0 < k0 + kn && !(causal && pb < kw0) &&
                      !(window > 0 && pa - (kw0 + 15) >= window);
    if (live) {
      const bool need_mask = (causal && pa < kw0 + 15) || (window > 0 && pb - kw0 >= window);
      float s[BM / 8][4], dp[BM / 8][4];
      zero(s);
      zero(dp);
      mma_abt<DT, BM, RB>(s, ka_ln, qb_ln + stage * BM * RB);
      mma_abt<DT, BM, RB>(dp, va_ln, dob_ln + stage * BM * RB);
      // element (n, e): key kw0 + g + 8 (e / 2), row 8 n + 2 t4 + (e & 1) of the tile
      const float* ls = lse_s + stage * BM;
      const float* dls = dl_s + stage * BM;
      const int* ps = pos_s + stage * BM;
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * n + 2 * t4 + (e & 1);
          bool vis = true;
          if (need_mask) {
            const int key = kw0 + g + 8 * (e / 2), pos = ps[i];
            vis = (!causal || pos >= key) && (window <= 0 || pos - key < window);
          }
          p_ds(s[n][e], dp[n][e], ls[i] * LOG2E, dls[i], vis, scale, scale_log2, cap, cap_in,
               cap_out);
        }
      }
      unsigned pf[BM / 16][4];
      c_to_a<BM>(pf, s);
      mma_pb<BM, NC, RB>(acc_v, pf, dot_ln + stage * BM * RB);
      c_to_a<BM>(pf, dp);
      mma_pb<BM, NC, RB>(acc_k, pf, qt_ln + stage * BM * RB);
    }
    __syncthreads();  // the stage is free for the copies of tile it + 2
  }

  // acc (n, e): key 16 km + g + 8 (e / 2) of the tile, column col0 + 8 n + 2 t4 + (e & 1)
  const int64_t part = (int64_t)B * S * kv_row;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int j = 16 * km + g + 8 * hf;
    if (j >= kn) continue;
    const int64_t at = kv_base + (k0 + j) * kv_row;
#pragma unroll
    for (int n = 0; n < NC / 8; ++n) {
      const int col = col0 + 8 * n + 2 * t4;
      if (col >= D) continue;
      if (ws == nullptr) {
        *reinterpret_cast<unsigned*>(dk + at + col) =
            pack_bf16(acc_k[n][2 * hf], acc_k[n][2 * hf + 1]);
        *reinterpret_cast<unsigned*>(dv + at + col) =
            pack_bf16(acc_v[n][2 * hf], acc_v[n][2 * hf + 1]);
      } else {
        *reinterpret_cast<float2*>(ws + sp * part + at + col) =
            make_float2(acc_k[n][2 * hf], acc_k[n][2 * hf + 1]);
        *reinterpret_cast<float2*>(ws + (splits + sp) * part + at + col) =
            make_float2(acc_v[n][2 * hf], acc_v[n][2 * hf + 1]);
      }
    }
  }
}

// dk (blockIdx.y = 0) or dv (1) = the sum of the splits' float32 partials,
// in split order; 4 elements a thread (n is a multiple of 8)
__global__ void __launch_bounds__(256)
bwd_reduce(const float* __restrict__ ws, bf16* __restrict__ dk, bf16* __restrict__ dv,
           int64_t n, int splits) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const float* src = ws + blockIdx.y * splits * n + i;
  float4 a = *reinterpret_cast<const float4*>(src);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 x = *reinterpret_cast<const float4*>(src + sp * n);
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  uint2 o;
  o.x = pack_bf16(a.x, a.y);
  o.y = pack_bf16(a.z, a.w);
  *reinterpret_cast<uint2*>((blockIdx.y ? dv : dk) + i) = o;
}

// dq of block L = (n_tiles - 1 - tile) * pairs + pair (causal: the last
// tiles see the most keys and start first)
template <int DT>
__device__ __forceinline__ void dq_block(
    int L, unsigned char* smem_raw, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int B, int S, int H, int KV, int D,
    int causal, int window, float scale, float cap, int n_tiles) {
  constexpr int BN = tc_k_tile(DT), BM = TC_Q_TILE, SR = DT + 8, RB = SR * 2, CPT = DT / 8;
  constexpr int ST = tc_dq_stages(DT);
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BM][SR]
  bf16* do_s = q_s + BM * SR;                     // [BM][SR]
  bf16* kv_s = do_s + BM * SR;                    // [ST stages][K, V][BN][SR]
  float* lse_s = reinterpret_cast<float*>(kv_s + 2 * ST * BN * SR);  // [BM]
  float* dl_s = lse_s + BM;                       // [BM]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / KV, pairs = B * KV, rows_total = S * G;
  const int pair = L % pairs, tile = n_tiles - 1 - L / pairs;
  const int b = pair / KV, kvh = pair % KV;
  const int r0 = tile * BM;
  const int p_first = r0 / G, p_last = (min(r0 + BM, rows_total) - 1) / G;
  const int k_hi = causal ? p_last + 1 : S;
  const int k_lo = window > 0 ? max(0, p_first - window + 1) : 0;
  const int nkt = (k_hi - k_lo + BN - 1) / BN;
  const int64_t kv_row = (int64_t)KV * D;
  const int64_t kv_base = (int64_t)b * S * kv_row + (int64_t)kvh * D;

  if (D != DT) zero_pad(q_s, 2 * BM + 2 * ST * BN, SR, D, DT);
  issue_rows<CPT>(q, dout, lse, delta, q_s, do_s, lse_s, dl_s, nullptr, SR, r0, BM, rows_total,
                  b, S, H, D, kvh * G, G);
  issue_keys<CPT, BN>(k, v, kv_s, kv_s + BN * SR, SR, k_lo, min(BN, k_hi - k_lo), kv_base, kv_row,
                      D);
  rapid::cp_async_commit();  // Q, dO and the first K / V tile: one group

  // this warp's rows: thread rows Rw + g + 8 h, positions [pw0, pw1]
  const int g = lane / 4, t4 = lane % 4;
  const int Rw = r0 + 16 * warp;
  const bool warp_live = Rw < rows_total;
  const int pw0 = Rw / G, pw1 = (min(Rw + 16, rows_total) - 1) / G;
  const int pos[2] = {(Rw + g) / G, (Rw + g + 8) / G};
  const unsigned qa_ln = lane_a(q_s, 16 * warp, SR, lane);
  const unsigned doa_ln = lane_a(do_s, 16 * warp, SR, lane);
  const unsigned kb_ln = lane_b(kv_s, SR, lane), vb_ln = lane_b(kv_s + BN * SR, SR, lane);
  const unsigned kt_ln = lane_bt(kv_s, 0, SR, lane);
  const float scale_log2 = scale * LOG2E;
  const float cap_in = cap > 0.f ? scale / cap : 0.f, cap_out = cap > 0.f ? cap / scale : 0.f;

  float acc[DT / 8][4];
  zero(acc);

  for (int it = 0; it < nkt; ++it) {
    const int k0 = k_lo + it * BN, stage = ST == 2 ? it & 1 : 0;
    if (ST == 1) {  // this tile's copies now (the first in the prologue)
      if (it > 0) {
        issue_keys<CPT, BN>(k, v, kv_s, kv_s + BN * SR, SR, k0, min(BN, k_hi - k0), kv_base,
                            kv_row, D);
        rapid::cp_async_commit();
      }
      rapid::cp_async_wait<0>();
    } else if (it + 1 < nkt) {  // the next tile's copies in flight
      const int nx = stage ^ 1;
      issue_keys<CPT, BN>(k, v, kv_s + nx * 2 * BN * SR, kv_s + (nx * 2 + 1) * BN * SR, SR,
                          k0 + BN, min(BN, k_hi - k0 - BN), kv_base, kv_row, D);
      rapid::cp_async_commit();
      rapid::cp_async_wait<1>();
    } else {
      rapid::cp_async_wait<0>();
    }
    __syncthreads();  // this tile visible to all

    const int k_end = min(k0 + BN, k_hi) - 1;  // the tile's last key that any row sees
    const bool live = warp_live && !(causal && pw1 < k0) && !(window > 0 && pw0 - k_end >= window);
    if (live) {
      const bool need_mask = (causal && k_end > pw0) || (window > 0 && pw1 - k0 >= window);
      float s[BN / 8][4], dp[BN / 8][4];
      zero(s);
      zero(dp);
      mma_abt<DT, BN, RB>(s, qa_ln, kb_ln + stage * 2 * BN * RB);
      mma_abt<DT, BN, RB>(dp, doa_ln, vb_ln + stage * 2 * BN * RB);
      float l2[2], dl[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        l2[hf] = lse_s[16 * warp + g + 8 * hf] * LOG2E;
        dl[hf] = dl_s[16 * warp + g + 8 * hf];
      }
      // element (n, e): row g + 8 (e / 2) of the warp, key k0 + 8 n + 2 t4 + (e & 1)
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool vis = true;
          if (need_mask) {
            const int key = k0 + 8 * n + 2 * t4 + (e & 1), p = pos[e / 2];
            vis = (!causal || p >= key) && (window <= 0 || p - key < window);
          }
          p_ds(s[n][e], dp[n][e], l2[e / 2], dl[e / 2], vis, scale, scale_log2, cap, cap_in,
               cap_out);
        }
      }
      unsigned pf[BN / 16][4];
      c_to_a<BN>(pf, dp);
      mma_pb<BN, DT, RB>(acc, pf, kt_ln + stage * 2 * BN * RB);
    }
    __syncthreads();  // the stage is free for the copies of tile it + ST
  }

  if (!warp_live) return;
  const int64_t q_row = (int64_t)H * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int R = Rw + g + 8 * hf;
    if (R >= rows_total) continue;
    const int64_t at = ((int64_t)b * S + R / G) * q_row + (int64_t)(kvh * G + R % G) * D;
#pragma unroll
    for (int n = 0; n < DT / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col < D)
        *reinterpret_cast<unsigned*>(dq + at + col) = pack_bf16(acc[n][2 * hf], acc[n][2 * hf + 1]);
    }
  }
}

// One launch for both: block L is a dk / dv block or a dq block, the two
// kinds interleaved (each heaviest first) while both remain, so that the dk
// / dv and dq blocks of a (batch row, KV head) run together and share their
// Q, dO, K and V reads in L2, and the two kinds' tails overlap.
template <int DT>
__global__ void __launch_bounds__(TC_THREADS)
bwd_main_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dq, bf16* __restrict__ dk,
            bf16* __restrict__ dv, float* __restrict__ ws, int B, int S, int H, int KV, int D,
            int causal, int window, float scale, float cap, int splits, int grid_dq,
            int grid_dkdv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = blockIdx.x, both = 2 * min(grid_dq, grid_dkdv);
  const bool is_dq = L < both ? (L & 1) : grid_dq > grid_dkdv;
  const int idx = L < both ? L >> 1 : L - both / 2;
  if (is_dq)
    dq_block<DT>(idx, smem_raw, q, k, v, dout, lse, delta, dq, B, S, H, KV, D, causal, window,
                 scale, cap, grid_dq / (B * KV));
  else
    dkdv_block<DT>(idx, smem_raw, q, k, v, dout, lse, delta, dk, dv, ws, B, S, H, KV, D, causal,
                   window, scale, cap, splits);
}

template <typename T, int DT>
int launch_simt(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S,
                int H, int KV, int D, int causal, int window, float scale, float cap,
                int grid_dq, int grid_dkdv, cudaStream_t stream) {
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
  st = launch_delta<T, DT>(out, dout, delta, B, S, H, D, stream);
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

template <int DT>
int launch_tc(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const float* lse, float* delta, void* dq, void* dk, void* dv, float* ws, int B,
              int S, int H, int KV, int D, int causal, int window, float scale, float cap,
              int splits, int grid_dq, int grid_dkdv, cudaStream_t stream) {
  static int granted = 48 * 1024;
  const int smem = max(tc_dkdv_smem(DT), tc_dq_smem(DT));
  auto kmain = bwd_main_tc<DT>;
  cudaError_t st = rapid::allow_smem(kmain, smem, &granted);
  if (st != cudaSuccess) return (int)st;
  const bf16* gt = static_cast<const bf16*>(dout);
  bf16* dkt = static_cast<bf16*>(dk);
  bf16* dvt = static_cast<bf16*>(dv);
  st = launch_delta<bf16, DT>(out, dout, delta, B, S, H, D, stream);
  if (st != cudaSuccess) return (int)st;
  kmain<<<grid_dq + grid_dkdv, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), gt,
      lse, delta, static_cast<bf16*>(dq), dkt, dvt, ws, B, S, H, KV, D, causal, window, scale,
      cap, splits, grid_dq, grid_dkdv);
  st = cudaGetLastError();
  if (st != cudaSuccess || splits == 1) return (int)st;
  const int64_t n = (int64_t)B * S * KV * D;
  bwd_reduce<<<dim3((unsigned)((n / 4 + 255) / 256), 2), 256, 0, stream>>>(ws, dkt, dvt, n,
                                                                           splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (q_tile, k_tile, splits, grids) is kernels/_lib.py
// flash_bwd_plan's; a plan that does not fit the kernels is refused
// (cudaErrorInvalidValue).  lse and delta: float32 [B, H, S] (delta is
// written here); dq like q, dk and dv like k; ws: float32 [2][splits][B, S,
// KV, D] when splits > 1 (bf16 only), else null.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, void* ws, int B, int S, int H, int KV,
                                   int D, int causal, int window, float scale, float cap,
                                   int dtype, int q_tile, int k_tile, int splits,
                                   int grid_dq, int grid_dkdv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || KV < 1 || H % KV || D < 8 || D > rapid::MAX_D || D % 8)
    return (int)cudaErrorInvalidValue;
  const int pairs = B * KV, G = H / KV;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* w = static_cast<float*>(ws);
  if (dtype == 0) {
    if (q_tile != BW_BQ || k_tile != BW_BK || splits != 1 || ws != nullptr ||
        grid_dq != (S * G + BW_BQ - 1) / BW_BQ * pairs ||
        grid_dkdv != (S + BW_BK - 1) / BW_BK * pairs)
      return (int)cudaErrorInvalidValue;
#define RAPID_BWD(DT)                                                                            \
  return launch_simt<float, DT>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, H, KV, D, causal,  \
                                window, scale, cap, grid_dq, grid_dkdv, s)
    if (D <= 64) RAPID_BWD(64);
    if (D <= 128) RAPID_BWD(128);
    RAPID_BWD(256);
#undef RAPID_BWD
  }
  if (dtype == 1) {
    const int dt = D <= 64 ? 64 : D <= 128 ? 128 : 256;
    if (q_tile != TC_Q_TILE || k_tile != tc_k_tile(dt) ||
        splits < 1 || G % splits || (splits > 1) != (ws != nullptr) ||
        grid_dq != (S * G + TC_Q_TILE - 1) / TC_Q_TILE * pairs ||
        grid_dkdv != (S + k_tile - 1) / k_tile * pairs * splits)
      return (int)cudaErrorInvalidValue;
#define RAPID_BWD(DT)                                                                            \
  return launch_tc<DT>(q, k, v, out, dout, l, dl, dq, dk, dv, w, B, S, H, KV, D, causal, window, \
                       scale, cap, splits, grid_dq, grid_dkdv, s)
    if (dt == 64) RAPID_BWD(64);
    if (dt == 128) RAPID_BWD(128);
    RAPID_BWD(256);
#undef RAPID_BWD
  }
  return (int)cudaErrorInvalidValue;
}
