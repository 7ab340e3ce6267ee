// Causal flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :127; body _kernel at :40), which is the
// same function as the model's blockwise prefill _sdpa_chunked
// (repro/models/attention.py:115): q [B,S,H,D] attends k/v [B,S,KV,D] with
// GQA by h / (H/KV), causal mask, optional sliding window (q - k) < window
// and tanh logit softcap, f32 scores and f32 online softmax, output in the
// input dtype.  Any S: the ragged edge is masked.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): bytes for the prompts
// served here -- q, k, v read once and out written once: 0.000137 ms at
// S = 14 and 0.00293 ms at S = 300 (H = KV = 32, D = 128) -- and
// operations from S ~ 1-2k on: 4 * H * D flops per visible (q, k) pair,
// 137.5 GFLOP = 0.139 ms at S = 4096 causal.  Scalar f32 FMAs out of shared
// memory (the first port of this kernel) run at a few TFLOP/s, bound by
// their shared-memory loads, so bf16 goes to the tensor cores.  There the
// short prompts are bound by the chain of dependent steps one block runs
// (copies, mma latency: an mma.sync result is ready some 60 cycles after
// issue, so a warp needs ~8 independent mmas in flight) and the long ones
// by how many independent mmas each warp keeps in flight (registers allow
// two warps per SM sub-partition).
//
// Design, bf16 (flash_tc, FlashAttention-2 layout):
//   * rows: a block takes 16 x MT x warps packed rows of one (batch row,
//     KV head) pair; packed row r is position r / G of query head
//     kvh * G + r % G, so the G query heads of a KV head share every K/V
//     tile (Jamba, G = 8: the 14-token prompt is 112 rows).  Each warp owns
//     MT m-tiles of 16 rows: MT = 2 (long prompts, D <= 128) makes every
//     K/V fragment a warp loads feed two mmas.  The host plan
//     (kernels/_lib.py flash_plan) picks MT and the warps so that the
//     blocks cover the SMs, and orders the 1-D grid so that the longest
//     query tiles start first;
//   * staging: Q, then K and V tiles of BN keys come into shared memory as
//     bf16 by 16-byte cp.async, two stages, the next tile's copies in flight
//     while the current one is computed; Q and the first tile form one copy
//     group, so a one-tile block (a 14-token prompt) waits once.  Rows are
//     padded by 8 elements (16 bytes), which makes every ldmatrix phase hit
//     8 distinct 16-byte bank groups;
//   * no branch around an aligned warp-wide instruction (ldmatrix, mma):
//     each would cost a warp synchronisation on the hot path.  The mmas
//     run over all DT columns (D padded with zeros) and all BN keys of a
//     tile; V rows past a tile's last key are zero-filled by the src-size
//     form of cp.async, and scores past it are masked;
//   * causal and window tile skip: a block visits key tiles from its
//     window's lower bound up to its last row's causal limit, and a warp
//     skips the tiles that its own rows cannot see;
//   * S = Q.K^T by mma.sync.m16n8k16 (bf16 in, f32 out) with ldmatrix
//     operands, a 16-column step's fragments loaded together (one step
//     ahead when MT = 1); softcap and mask in registers, the mask only on
//     tiles that cut the diagonal, the window edge or the ragged end; the
//     scale folded into the exponent's FMA; row max and sum over the quad
//     by shuffles (the sum is reduced once, at the end);
//   * P is rounded to bf16 in registers and is the A operand of P.V as it
//     stands (no round trip through shared memory), as the model's own
//     attention rounds its probabilities to the value dtype
//     (repro/models/attention.py:110); V comes by ldmatrix.trans;
//   * the output goes through the warp's Q rows in shared memory and out in
//     16-byte stores.
// float32 (flash_simt): tensor cores take f32 only as TF32, which would
// miss the 1e-5 tolerance, so f32 keeps the first port's scalar body: one
// block per (16 positions, query head, batch row), f32 FMAs out of shared
// memory.
//
// Training: given an lse pointer, both bodies also write each row's
// log-sum-exp of its softcapped, scaled scores, float32 [B, H, S] (what the
// backward kernel, csrc/flash_attention_bwd.cu, recomputes P from); a null
// pointer writes nothing (serving).

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rapid::cp_async16_zfill;
using rapid::ex2;
using rapid::ldsm_x4;
using rapid::ldsm_x4_t;
using rapid::LOG2E;
using rapid::mma_bf16;
using rapid::pack_bf16;
using rapid::smem_u32;
using rapid::softcap_scaled;

// ---------------------------------------------------------------------------
// bf16 tensor-core body
// ---------------------------------------------------------------------------

constexpr int TC_MAX_WARPS = 4;

// keys a K/V tile holds: 64, or 32 where D > 128 leaves fewer registers
__host__ __device__ constexpr int tc_key_tile(int dt) { return dt <= 128 ? 64 : 32; }

// Shared memory of a block, bf16: Q [rows][SR], then K and V [2 stages][BN][SR]
// each; SR = DT + 8 (the pad keeps ldmatrix free of bank conflicts).
__host__ __device__ constexpr int tc_smem_bytes(int rows, int dt) {
  return (rows + 4 * tc_key_tile(dt)) * (dt + 8) * 2;
}

// DT bounds D (a multiple of 16, >= D) and sizes the accumulators; a warp
// owns MT m-tiles of 16 rows.  Grid: n_tiles * B * KV blocks of 32 * warps
// threads, each taking 16 * MT * warps packed rows.
template <int DT, int MT>
__global__ void __launch_bounds__(TC_MAX_WARPS * 32)
flash_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         bf16* __restrict__ out, float* __restrict__ lse, int B, int S, int H, int KV, int D,
         int causal, int window, float scale, float cap, int n_tiles) {
  constexpr int BN = tc_key_tile(DT), SR = DT + 8, RB = SR * 2, WR = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthr = blockDim.x, BM = WR * (nthr / 32);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / KV, pairs = B * KV, rows_total = S * G;
  const int L = blockIdx.x, pair = L % pairs, tile = n_tiles - 1 - L / pairs;
  const int b = pair / KV, kvh = pair % KV;
  const int r0 = tile * BM;
  const int p_first = r0 / G, p_last = (min(r0 + BM, rows_total) - 1) / G;
  const int k_hi = causal ? p_last + 1 : S;
  const int k_lo = window > 0 ? max(0, p_first - window + 1) : 0;
  const int nkt = (k_hi - k_lo + BN - 1) / BN;

  const int cpr = D / 8;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BM][SR]
  bf16* k_s = q_s + BM * SR;                      // [2][BN][SR]
  bf16* v_s = k_s + 2 * BN * SR;                  // [2][BN][SR]

  // The mmas run over all DT columns and all BN keys of a tile, with no
  // branch around them (a branch around an aligned warp-wide instruction
  // costs a warp synchronisation each time).  So the columns [D, DT) of
  // every row are zero (cp.async writes only [0, D)), V rows past a
  // tile's last key are zero-filled, and scores past it are masked.
  if (D != DT) {
    const int pad = (DT - D) / 8;
    for (int e = tid; e < (BM + 4 * BN) * pad; e += nthr)
      *reinterpret_cast<uint4*>(q_s + (e / pad) * SR + D + (e % pad) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }

  const int64_t q_row = (int64_t)H * D, kv_row = (int64_t)KV * D;
  const bf16* kb = k + (int64_t)b * S * kv_row + (int64_t)kvh * D;
  const bf16* vb = v + (int64_t)b * S * kv_row + (int64_t)kvh * D;
  // copy c of a tile is (row c / cpr, chunk c % cpr); a thread's copies step
  // by nthr, carried as (row, chunk) without a division
  const int t_first = tid / cpr, c_first = tid - t_first * cpr;
  const int t_step = nthr / cpr, c_step = nthr - t_step * cpr;
  // global offset of packed row R (valid when R < rows_total)
  auto q_off = [&](int R) {
    return ((int64_t)b * S + R / G) * q_row + (int64_t)(kvh * G + R % G) * D;
  };
  // the K (or V) tile of keys [k0, k0 + BN) into stage `stage` of dst; rows
  // [kn, rows) zero-filled (V: every row, so that 0 * V stays 0)
  auto issue = [&](const bf16* src, bf16* dst, int k0, int stage, int rows) {
    const int kn = min(BN, k_hi - k0);
    dst += stage * BN * SR;
    for (int t = t_first, c = c_first; t < rows;) {
      const bool ok = t < kn;
      const int64_t off = (ok ? (int64_t)(k0 + t) * kv_row : 0) + c * 8;
      cp_async16_zfill(dst + t * SR + c * 8, src + off, ok);
      t += t_step;
      c += c_step;
      if (c >= cpr) {
        c -= cpr;
        ++t;
      }
    }
  };

  // Q rows: packed row R = r0 + t is (position R / G, head kvh * G + R % G),
  // carried along with t without a division
  {
    const int step_p = t_step / G, step_h = t_step % G;
    int pq = (r0 + t_first) / G, hq = (r0 + t_first) % G;
    for (int t = t_first, c = c_first; t < BM;) {
      const bool ok = r0 + t < rows_total;
      const int64_t off = ((int64_t)b * S + pq) * q_row + (int64_t)(kvh * G + hq) * D;
      cp_async16_zfill(q_s + t * SR + c * 8, q + (ok ? off : 0) + c * 8, ok);
      t += t_step;
      pq += step_p;
      hq += step_h;
      c += c_step;
      if (c >= cpr) {
        c -= cpr;
        ++t;
        ++hq;
      }
      if (hq >= G) {
        hq -= G;
        ++pq;
      }
    }
  }
  issue(kb, k_s, k_lo, 0, min(BN, k_hi - k_lo));
  issue(vb, v_s, k_lo, 0, BN);
  rapid::cp_async_commit();  // Q and the first K/V tile: one group

  // this warp's rows; thread row (mt, h) is Rw + 16 mt + 8 h + lane / 4
  const int g = lane / 4, t4 = lane % 4;
  const int Rw = r0 + WR * warp;
  const bool warp_live = Rw < rows_total;
  const int pw0 = Rw / G, pw1 = (min(Rw + WR, rows_total) - 1) / G;
  int pos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    pos[mt][0] = (Rw + 16 * mt + g) / G;
    pos[mt][1] = (Rw + 16 * mt + g + 8) / G;
  }
  // ldmatrix lane addresses: Q rows (A, row-major), K rows (B as col-major),
  // V rows (B through .trans)
  const unsigned q_ln = smem_u32(q_s) + ((WR * warp + lane % 16) * SR + (lane / 16) * 8) * 2;
  const unsigned k_ln = smem_u32(k_s) + (((lane / 16) * 8 + lane % 8) * SR + ((lane / 8) % 2) * 8) * 2;
  const unsigned v_ln = smem_u32(v_s) + ((((lane / 8) % 2) * 8 + lane % 8) * SR + (lane / 16) * 8) * 2;
  // scores stay unscaled; exponents are fma(s, scale * log2 e, -m) with m
  // in log2 units; a softcap maps s to (cap / scale) tanh(s scale / cap)
  const float scale_log2 = scale * LOG2E;
  const float cap_in = cap > 0.f ? scale / cap : 0.f, cap_out = cap > 0.f ? cap / scale : 0.f;

  float o[MT][DT / 8][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < DT / 8; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = rapid::NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int it = 0; it < nkt; ++it) {
    const int k0 = k_lo + it * BN, stage = it & 1;
    if (it + 1 < nkt) {
      issue(kb, k_s, k0 + BN, stage ^ 1, min(BN, k_hi - k0 - BN));
      issue(vb, v_s, k0 + BN, stage ^ 1, BN);
      rapid::cp_async_commit();
      rapid::cp_async_wait<1>();
    } else {
      rapid::cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q, and the zero columns) visible to all

    // the keys of this tile that this warp's rows can see: [k0, k0 + kw)
    int kw = min(BN, k_hi - k0);
    if (causal) kw = min(kw, pw1 + 1 - k0);
    const bool live = warp_live && kw > 0 && !(window > 0 && pw0 - (k0 + kw - 1) >= window);
    if (live) {
      const int kend = k0 + kw;
      const bool need_mask = kw < BN || (causal && kend - 1 > pw0) ||
                             (window > 0 && pw1 - k0 >= window);
      const unsigned kst = k_ln + stage * BN * RB;

      // S = Q . K^T.  A 16-column step's operands are loaded together before
      // its mmas; with one m-tile a warp loads one step ahead (NB buffers).
      constexpr int NB = MT == 1 ? 2 : 1;
      float s[MT][BN / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
      unsigned fa[NB][MT][4], fb[NB][BN / 16][4];
#pragma unroll
      for (int kd = 0; kd < DT / 16 + NB - 1; ++kd) {
        if (kd < DT / 16) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) ldsm_x4(fa[kd % NB][mt], q_ln + mt * 16 * RB + kd * 32);
#pragma unroll
          for (int np = 0; np < BN / 16; ++np)
            ldsm_x4(fb[kd % NB][np], kst + np * 16 * RB + kd * 32);
        }
        const int c = kd - (NB - 1);
        if (c >= 0) {
#pragma unroll
          for (int np = 0; np < BN / 16; ++np) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(s[mt][2 * np], fa[c % NB][mt], fb[c % NB][np][0], fb[c % NB][np][1]);
              mma_bf16(s[mt][2 * np + 1], fa[c % NB][mt], fb[c % NB][np][2], fb[c % NB][np][3]);
            }
          }
        }
      }

      // softcap, then the mask (only on tiles that cut the diagonal, the
      // window edge or the ragged end), each a loop of its own.  Element
      // (n, e) is key k0 + 2 t4 + j, j = 8 n + (e & 1); a row at position p
      // sees it iff j < kend - k0 - 2 t4, j <= p - k0 - 2 t4 (causal) and
      // p - k0 - 2 t4 - j < window.
      if (cap > 0.f) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < BN / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][n][e] = softcap_scaled(s[mt][n][e], cap_in, cap_out);
      }
      if (need_mask) {
        const int base = k0 + 2 * t4, jend = kend - base;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int dq = pos[mt][h] - base;
            const int jmax = causal ? min(jend - 1, dq) : jend - 1;
            const int jmin = window > 0 ? dq - window + 1 : -1;
#pragma unroll
            for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int j = 8 * n + e;
                if (j > jmax || j < jmin) s[mt][n][2 * h + e] = rapid::NEG_INF;
              }
            }
          }
        }
      }

      // online softmax: row max over the quad, rescale, exponentiate
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx[2] = {rapid::NEG_INF, rapid::NEG_INF};
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
        }
        float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float t = mx[i] == rapid::NEG_INF ? rapid::NEG_INF : mx[i] * scale_log2;
          const float m_new = fmaxf(m[mt][i], t);
          // a row that has seen no visible key yet: 2^(NEG_INF - 0) = 0
          mu[i] = m_new == rapid::NEG_INF ? 0.f : m_new;
          alpha[i] = ex2(m[mt][i] - mu[i]);
          m[mt][i] = m_new;
          l[mt][i] *= alpha[i];
        }
#pragma unroll
        for (int n = 0; n < DT / 8; ++n) {
          o[mt][n][0] *= alpha[0];
          o[mt][n][1] *= alpha[0];
          o[mt][n][2] *= alpha[1];
          o[mt][n][3] *= alpha[1];
        }
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[mt][n][e], scale_log2, -mu[e / 2]));
            s[mt][n][e] = p;
            sum[e / 2] += p;
          }
        }
        l[mt][0] += sum[0];
        l[mt][1] += sum[1];
      }

      // P rounded to bf16 in registers for every 16-key step (the C layout
      // of two 8-key tiles is the A layout of one step; the scores'
      // registers die here)
      unsigned pf[BN / 16][MT][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pf[kk][mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pf[kk][mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pf[kk][mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pf[kk][mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
      }

      // O += P . V: for each 16-column step of V the B fragments of every
      // key step come by ldmatrix.trans (one column step ahead of their
      // mmas when a warp has one m-tile).  The key-step-outer order would
      // need the V fragments of every column step at once: with two m-tiles
      // that spills.
      const unsigned vst = v_ln + stage * BN * RB;
      unsigned fv[NB][BN / 16][4];
#pragma unroll
      for (int dp = 0; dp < DT / 16 + NB - 1; ++dp) {
        if (dp < DT / 16) {
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
            ldsm_x4_t(fv[dp % NB][kk], vst + kk * 16 * RB + dp * 32);
        }
        const int c = dp - (NB - 1);
        if (c >= 0) {
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(o[mt][2 * c], pf[kk][mt], fv[c % NB][kk][0], fv[c % NB][kk][1]);
              mma_bf16(o[mt][2 * c + 1], pf[kk][mt], fv[c % NB][kk][2], fv[c % NB][kk][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the copies of tile it + 2
  }

  if (!warp_live) return;
  // normalise, stage the warp's rows in its own Q rows, store 16 bytes a lane
  bf16* o_s = q_s + WR * warp * SR;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float t = l[mt][i];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      inv[i] = 1.f / fmaxf(t, 1e-30f);
      // m is in log2 units: lse = ln 2 * (m + log2 l)
      const int R = Rw + 16 * mt + 8 * i + g;
      if (lse != nullptr && t4 == 0 && R < rows_total)
        lse[((int64_t)b * H + kvh * G + R % G) * S + R / G] =
            (m[mt][i] + log2f(fmaxf(t, 1e-30f))) * 0.6931471805599453f;
    }
#pragma unroll
    for (int n = 0; n < DT / 8; ++n) {
      if (n < cpr) {
        *reinterpret_cast<unsigned*>(o_s + (16 * mt + g) * SR + n * 8 + 2 * t4) =
            pack_bf16(o[mt][n][0] * inv[0], o[mt][n][1] * inv[0]);
        *reinterpret_cast<unsigned*>(o_s + (16 * mt + g + 8) * SR + n * 8 + 2 * t4) =
            pack_bf16(o[mt][n][2] * inv[1], o[mt][n][3] * inv[1]);
      }
    }
  }
  __syncwarp();
  for (int c = lane; c < WR * cpr; c += 32) {
    const int r = c / cpr, col = (c % cpr) * 8, R = Rw + r;
    if (R < rows_total)
      *reinterpret_cast<uint4*>(out + q_off(R) + col) =
          *reinterpret_cast<const uint4*>(o_s + r * SR + col);
  }
}

template <int DT, int MT>
int launch_tc(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
              int H, int KV, int D, int causal, int window, float scale, float cap, int warps,
              int key_tile, int grid_x, cudaStream_t stream) {
  static int granted = 48 * 1024;
  const int pairs = B * KV, rows = 16 * MT * warps;
  if (key_tile != tc_key_tile(DT) || warps < 1 || warps > TC_MAX_WARPS || grid_x % pairs)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = grid_x / pairs;
  if ((int64_t)n_tiles * rows < (int64_t)S * (H / KV)) return (int)cudaErrorInvalidValue;
  const int smem = tc_smem_bytes(rows, DT);
  auto kernel = flash_tc<DT, MT>;
  cudaError_t st = rapid::allow_smem(kernel, smem, &granted);
  if (st != cudaSuccess) return (int)st;
  kernel<<<grid_x, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, B, S, H, KV, D, causal, window, scale, cap, n_tiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 SIMT body
// ---------------------------------------------------------------------------

constexpr int FA_THREADS = 128;
constexpr int FA_WARPS = FA_THREADS / 32;
constexpr int FA_BQ = 16;
constexpr int FA_BK = 32;
constexpr int FA_ACC = FA_BQ * rapid::MAX_D / FA_THREADS;

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal, int window) {
  return qp < S && kp < S && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// One block per (FA_BQ query rows, head, batch row); key tiles of FA_BK from
// the window's lower bound (rounded down to FA_BK) up to the causal limit of
// its last row.  K rows are padded by one float so that a warp's lanes hit
// distinct banks.
__global__ void __launch_bounds__(FA_THREADS)
flash_simt(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ out, float* __restrict__ lse, int S, int H, int KV, int D,
           int causal, int window, float scale, float cap) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* q_s = smem;                  // [FA_BQ][DP]
  float* k_s = q_s + FA_BQ * DP;      // [FA_BK][DP]
  float* v_s = k_s + FA_BK * DP;      // [FA_BK][D]
  float* p_s = v_s + FA_BK * D;       // [FA_BQ][FA_BK + 1]
  float* m_s = p_s + FA_BQ * (FA_BK + 1);
  float* l_s = m_s + FA_BQ;
  float* a_s = l_s + FA_BQ;

  const int q0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nc = D / 8;
  const int64_t q_row = (int64_t)H * D, kv_row = (int64_t)KV * D;
  const float* qb = q + (int64_t)b * S * q_row + (int64_t)h * D;
  const float* kb = k + (int64_t)b * S * kv_row + (int64_t)kvh * D;
  const float* vb = v + (int64_t)b * S * kv_row + (int64_t)kvh * D;

  for (int c = tid; c < FA_BQ * nc; c += FA_THREADS) {
    const int i = c / nc, col = (c % nc) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + i < S) rapid::load8(qb + (q0 + i) * q_row + col, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) q_s[i * DP + col + e] = f[e];
  }
  if (tid < FA_BQ) {
    m_s[tid] = rapid::NEG_INF;
    l_s[tid] = 0.f;
  }

  const int q_last = min(q0 + FA_BQ, S) - 1;
  const int k_hi = causal ? q_last + 1 : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float acc[FA_ACC];
#pragma unroll
  for (int i = 0; i < FA_ACC; ++i) acc[i] = 0.f;

  for (int k0 = (k_lo / FA_BK) * FA_BK; k0 < k_hi; k0 += FA_BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < FA_BK * nc; c += FA_THREADS) {
      const int j = c / nc, col = (c % nc) * 8;
      float kf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float vf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + j < S) {
        rapid::load8(kb + (k0 + j) * kv_row + col, kf);
        rapid::load8(vb + (k0 + j) * kv_row + col, vf);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        k_s[j * DP + col + e] = kf[e];
        v_s[j * D + col + e] = vf[e];
      }
    }
    __syncthreads();

    // scores: lanes of a warp take the FA_BK keys of one query row
    for (int r = 0; r < FA_BQ * FA_BK; r += FA_THREADS) {
      const int pidx = r + tid, i = pidx / FA_BK, j = pidx % FA_BK;
      if (i < FA_BQ) {
        const float* qi = q_s + i * DP;
        const float* kj = k_s + j * DP;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qi[d], kj[d], s);
        s = rapid::softcap(s * scale, cap);
        p_s[i * (FA_BK + 1) + j] =
            visible(q0 + i, k0 + j, S, causal, window) ? s : rapid::NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one warp per query row, one lane per key
    for (int i = warp; i < FA_BQ; i += FA_WARPS) {
      const float s = p_s[i * (FA_BK + 1) + lane];
      const bool ok = visible(q0 + i, k0 + lane, S, causal, window);
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, rapid::warp_max(s));
      // explicit re-mask: for fully masked rows s - m_new == 0 would give 1
      const float p = ok ? expf(s - m_new) : 0.f;
      const float sum = rapid::warp_sum(p);
      p_s[i * (FA_BK + 1) + lane] = p;
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        a_s[i] = a;
        l_s[i] = l_s[i] * a + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // values: each thread owns output elements (i, d), neighbouring d per lane
#pragma unroll
    for (int x = 0; x < FA_ACC; ++x) {
      const int e = tid + x * FA_THREADS;
      if (e < FA_BQ * D) {
        const int i = e / D, d = e % D;
        const float* pi = p_s + i * (FA_BK + 1);
        float a = acc[x] * a_s[i];
#pragma unroll 8
        for (int j = 0; j < FA_BK; ++j) a = fmaf(pi[j], v_s[j * D + d], a);
        acc[x] = a;
      }
    }
  }
  __syncthreads();
  float* ob = out + (int64_t)b * S * q_row + (int64_t)h * D;
#pragma unroll
  for (int x = 0; x < FA_ACC; ++x) {
    const int e = tid + x * FA_THREADS;
    if (e < FA_BQ * D) {
      const int i = e / D, d = e % D;
      if (q0 + i < S) ob[(q0 + i) * q_row + d] = acc[x] / fmaxf(l_s[i], 1e-30f);
    }
  }
  if (lse != nullptr && tid < FA_BQ && q0 + tid < S)
    lse[((int64_t)b * H + h) * S + q0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

int launch_simt(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
                int H, int KV, int D, int causal, int window, float scale, float cap, int rows,
                int warps, int key_tile, int gx, int gy, int gz, cudaStream_t stream) {
  static int granted = 48 * 1024;
  if (rows != FA_BQ || warps != FA_WARPS || key_tile != FA_BK || gx != (S + FA_BQ - 1) / FA_BQ ||
      gy != H || gz != B)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * (FA_BQ * (D + 1) + FA_BK * (D + 1) + FA_BK * D +
                                         FA_BQ * (FA_BK + 1) + 3 * FA_BQ);
  cudaError_t st = rapid::allow_smem(flash_simt, smem, &granted);
  if (st != cudaSuccess) return (int)st;
  flash_simt<<<dim3(gx, gy, gz), FA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, S, H, KV, D, causal, window, scale, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (rows, warps, key_tile, grid) is kernels/_lib.py flash_plan's;
// a plan that does not fit the kernel is refused (cudaErrorInvalidValue).
// lse: float32 [B, H, S], or null (not written).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               void* lse, int B, int S, int H, int KV, int D, int causal,
                               int window, float scale, float cap, int dtype, int rows, int warps,
                               int key_tile, int gx, int gy, int gz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || KV < 1 || H % KV || D < 8 || D > rapid::MAX_D || D % 8)
    return (int)cudaErrorInvalidValue;
  if (dtype != 1)
    return launch_simt(q, k, v, out, static_cast<float*>(lse), B, S, H, KV, D, causal, window,
                       scale, cap, rows, warps, key_tile, gx, gy, gz, s);
  // bf16: rows = 16 * MT * warps, MT (m-tiles a warp) 1, or 2 when D <= 128
  if (gy != 1 || gz != 1 || warps < 1 || rows % (16 * warps)) return (int)cudaErrorInvalidValue;
  const int mt = rows / (16 * warps);
#define RAPID_LAUNCH(DT, MT)                                                                    \
  return launch_tc<DT, MT>(q, k, v, out, static_cast<float*>(lse), B, S, H, KV, D, causal,     \
                           window, scale, cap, warps, key_tile, gx, s)
  if (mt == 1) {
    if (D <= 64) RAPID_LAUNCH(64, 1);
    if (D <= 128) RAPID_LAUNCH(128, 1);
    RAPID_LAUNCH(256, 1);
  }
  if (mt == 2) {
    if (D <= 64) RAPID_LAUNCH(64, 2);
    if (D <= 128) RAPID_LAUNCH(128, 2);
  }
  return (int)cudaErrorInvalidValue;
#undef RAPID_LAUNCH
}
