// Shared device code for the decode attention kernels (paged and dense):
// flash-decoding for Hopper.
//
// One decode call attends one query token per row over that row's K/V.
// The grid is (B, KV, n_split): the KV length is cut into n_split ranges of
// split_len tokens (the host picks both from bounds it knows, never from a
// length on the device), and one block of DEC_THREADS threads attends the G
// query heads of one KV head of one row over one range, clipped on the
// device to the row's live tokens [lo, hi).  With n_split == 1 the block
// writes the output; otherwise it writes a float32 partial (m, l, o[G, D]:
// running max, softmax sum, unnormalised output) and decode_combine() merges
// a row's partials in split order, so the result is the same every run.
//
// Bound on an H100: bytes.  Decode does 4 flops per K/V element per query
// head, 1 (G = 1) to ~8 (G = 8) flops per byte in bf16, two orders below the
// ~295 at which the tensor cores would bind, so the tensor cores are not
// used: every multiply is a float32 FMA.  What the design does about the
// bytes:
//   * n_split ranges put several blocks on every SM at long lengths (a
//     (B, KV) grid alone is 8-32 blocks at the serving shapes, on 132 SMs);
//   * K and V reach shared memory by 16-byte cp.async.cg copies, tiles of
//     `tile` tokens in two stages: the next tile's copies are in flight
//     while the current one is computed.  A row of D = 128 bf16 is 16
//     threads x 16 bytes, so the copies are wide and coalesced;
//   * the paged kernel loads its range's page-table entries into shared
//     memory once, before the first copy, so no copy waits on a table read.
// Per tile, from shared memory:
//   1. scores: thread (grp, sub) takes 8 contiguous d (chunk `sub`) of
//      token grp, grp + ngrp, ...; its chunk of each query row sits in
//      registers (G <= 8); the lpt lanes of a token reduce the G dot
//      products together by shuffles;
//   2. online softmax, one warp per query head (f32, NEG_INF = -1e30);
//   3. values: the same thread owns the 8 d of chunk `sub` for all G heads
//      over its tokens, reading each V chunk once for the G heads; the ngrp
//      partial sums are added in a fixed order at the end of the range.
// A range with no live token leaves m = NEG_INF, l = 0, o = 0; a row of
// length 0 writes zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rapid {

constexpr float NEG_INF = -1e30f;
constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int MAX_D = 256;  // the flash kernel's bound
constexpr int MAX_G = 16;
constexpr int MAX_TILE = 64;
constexpr int STAGE_BYTES = 32 * 1024;  // one stage: a K tile and a V tile

// Shared-memory layout of one decode block (bytes), the same on the host
// (to size the launch) and the device.
struct DecodeSmem {
  int tile;    // tokens per K/V tile
  int lpt;     // lanes per token: a power of two >= D / 8
  int ngrp;    // token groups: DEC_THREADS / lpt
  int stage;   // bytes of one stage (K tile + V tile)
  int q_off, p_off, ml_off, tbl_off, total;

  __host__ __device__ DecodeSmem(int G, int D, int elem, int split_len, int tbl_entries) {
    tile = STAGE_BYTES / (2 * D * elem);
    if (tile > MAX_TILE) tile = MAX_TILE;
    const int want = (split_len + 7) / 8 * 8;
    if (want < tile) tile = want;
    lpt = 1;
    while (lpt < D / 8) lpt <<= 1;
    ngrp = DEC_THREADS / lpt;
    stage = 2 * tile * D * elem;
    const int red = ngrp * G * D * 4;  // the value sums' reduction, after the stages
    const int region = 2 * stage > red ? 2 * stage : red;
    int gm = 1;  // q rows padded with zeros to the kernel's head bound GM
    while (gm < G) gm <<= 1;
    q_off = region;
    p_off = q_off + gm * D * 4;
    ml_off = p_off + G * tile * 4;
    tbl_off = ml_off + 3 * MAX_G * 4;
    total = tbl_off + tbl_entries * 4;
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Eight consecutive elements (16-byte aligned) widened to f32.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float softcap(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks of the flash kernels (forward and backward)
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// 16 bytes, or 16 zero bytes when !valid (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

// 4 bytes, or 4 zero bytes when !valid
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c[16x8] += a[16x16] . b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x; 2^NEG_INF = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cap_out * tanh(x * cap_in), tanh(y) = 1 - 2 / (2^(2 y log2 e) + 1): two
// MUFU operations, absolute error ~1e-7 (tanhf inline is ~20 instructions,
// and the tile body repeats it for every score a thread holds)
__device__ __forceinline__ float softcap_scaled(float x, float cap_in, float cap_out) {
  const float e = ex2(x * (2.f * LOG2E) * cap_in);
  return cap_out * (1.f - __fdividef(2.f, e + 1.f));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Where a range's result goes: the output rows (n_split == 1) or a
// partial (o [G, D], m [G], l [G]) in the float32 workspace.
template <typename T>
struct DecodeOut {
  T* out;   // [G, D] or nullptr
  float* o;
  float* m;
  float* l;
};

// Attends the G query rows q_head [G, D] over tokens [lo, hi) of one KV
// head; rows(t) is the element offset of token t's D-vector in k and v.
// GM >= G is a compile-time bound that sizes the accumulators.
template <typename T, int GM, typename RowMap>
__device__ void decode_range(unsigned char* smem, const DecodeSmem& L,
                             const T* __restrict__ q_head, const T* __restrict__ k,
                             const T* __restrict__ v, const RowMap& rows, int G, int D,
                             int lo, int hi, float scale, float cap, const DecodeOut<T>& dst) {
  float* q_s = reinterpret_cast<float*>(smem + L.q_off);
  float* p_s = reinterpret_cast<float*>(smem + L.p_off);
  float* m_s = reinterpret_cast<float*>(smem + L.ml_off);
  float* l_s = m_s + MAX_G;
  float* alpha_s = l_s + MAX_G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = L.tile, lpt = L.lpt, ngrp = L.ngrp;
  const int nc = D / 8, sub = tid % lpt, grp = tid / lpt;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  const int cpr = D / EPC;             // copies per row

  // K tile of stage s at smem + s * stage, V tile right after it
  auto k_tile = [&](int s) { return reinterpret_cast<T*>(smem + s * L.stage); };
  auto v_tile = [&](int s) { return reinterpret_cast<T*>(smem + s * L.stage) + tile * D; };
  // copy i of a tile is (row i / cpr, chunk i % cpr); a thread's copies
  // step by DEC_THREADS, carried as (row, chunk) without a division
  const int t_first = tid / cpr, c_first = tid - t_first * cpr;
  const int t_step = DEC_THREADS / cpr, c_step = DEC_THREADS - t_step * cpr;
  auto issue = [&](int t0, int n, int s) {
    T* ks = k_tile(s);
    T* vs = v_tile(s);
    for (int t = t_first, c = c_first; t < n;) {
      const int64_t off = rows(t0 + t) + c * EPC;
      cp_async16(ks + t * D + c * EPC, k + off);
      cp_async16(vs + t * D + c * EPC, v + off);
      t += t_step;
      c += c_step;
      if (c >= cpr) {
        c -= cpr;
        ++t;
      }
    }
    cp_async_commit();
  };

  // the combine kernel, if any, may be scheduled now; it waits for this
  // grid's results (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int ntiles = hi > lo ? (hi - lo + tile - 1) / tile : 0;
  if (ntiles > 0) issue(lo, min(tile, hi - lo), 0);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // up to 8 heads, a thread keeps its chunk of each query row in registers
  // (read once from device memory); 16 heads read q_s (rows G..GM-1 zero)
  constexpr bool QREG = GM <= 8;
  if constexpr (!QREG) {
    for (int e = tid; e < GM * D; e += DEC_THREADS) q_s[e] = e < G * D ? to_f(q_head[e]) : 0.f;
  }
  float q_r[QREG ? GM : 1][8];
  float acc[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if constexpr (QREG) {
      if (g < G && sub < nc) {
        load8(q_head + g * D + sub * 8, q_r[g]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) q_r[g][i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = lo + it * tile, n = min(tile, hi - t0);
    if (it + 1 < ntiles) {
      issue(t0 + tile, min(tile, hi - t0 - tile), (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's copies (and q, m, l) are visible to all

    // 1. scores; every warp runs the same number of passes (shuffles below).
    // The GM heads' dot products are formed first and reduced together, so
    // their shuffle chains overlap (query rows G..GM-1 are zeros).
    const T* ks = k_tile(it & 1);
#pragma unroll 2
    for (int base = 0; base < n; base += ngrp) {
      const int t = base + grp;
      const bool live = t < n && sub < nc;
      float part[GM];
      if (live) {
        float kf[8];
        load8(ks + t * D + sub * 8, kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float qf[8];
          if constexpr (QREG) {
#pragma unroll
            for (int i = 0; i < 8; ++i) qf[i] = q_r[g][i];
          } else {
            load8(q_s + g * D + sub * 8, qf);
          }
          part[g] = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) part[g] = fmaf(kf[i], qf[i], part[g]);
        }
      } else {
#pragma unroll
        for (int g = 0; g < GM; ++g) part[g] = 0.f;
      }
      for (int off = lpt / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < GM; ++g) part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      }
      if (sub == 0 && t < n) {
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G) p_s[g * tile + t] = softcap(part[g] * scale, cap);
      }
    }
    __syncthreads();

    // 2. online softmax, one warp per query head
    for (int g = warp; g < G; g += DEC_WARPS) {
      float* pg = p_s + g * tile;
      float mx = NEG_INF;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, pg[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(pg[t] - m_new);
        pg[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 3. values: each V chunk read once, used for all G heads
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float a = alpha_s[g];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] *= a;
      }
    }
    if (sub < nc) {
      const T* vs = v_tile(it & 1);
#pragma unroll 2
      for (int t = grp; t < n; t += ngrp) {
        float vf[8];
        load8(vs + t * D + sub * 8, vf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float p = p_s[g * tile + t];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
          }
        }
      }
    }
    __syncthreads();  // the stage and p_s are free for the next tile
  }
  if (ntiles == 0) __syncthreads();  // q, m, l written above

  // the ngrp groups' sums, added in a fixed order (the stages are free)
  float* red = reinterpret_cast<float*>(smem);
  if (sub < nc) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        float4* r = reinterpret_cast<float4*>(red + (grp * G + g) * D + sub * 8);
        r[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        r[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
    }
  }
  __syncthreads();
  const int GD = G * D;
  for (int e = tid; e < GD; e += DEC_THREADS) {
    float o = 0.f;
    for (int j = 0; j < ngrp; ++j) o += red[j * GD + e];
    if (dst.out != nullptr) {
      dst.out[e] = from_f<T>(o / fmaxf(l_s[e / D], 1e-30f));
    } else {
      dst.o[e] = o;
    }
  }
  if (dst.out == nullptr && tid < G) {
    dst.m[tid] = m_s[tid];
    dst.l[tid] = l_s[tid];
  }
}

// Workspace of a split call, float32: o [pairs, n_split, G, D], then m and
// l [pairs, n_split, G] (pairs = B * KV).
template <typename T>
__device__ __forceinline__ DecodeOut<T> decode_dst(T* out, float* ws, int pairs, int pair,
                                                   int split, int n_split, int G, int D) {
  const int64_t r = (int64_t)pair * n_split + split;
  if (n_split == 1) return DecodeOut<T>{out + (int64_t)pair * G * D, nullptr, nullptr, nullptr};
  float* m = ws + (int64_t)pairs * n_split * G * D;
  float* l = m + (int64_t)pairs * n_split * G;
  return DecodeOut<T>{nullptr, ws + r * G * D, m + r * G, l + r * G};
}

// Merges the n_split partials of one (row, KV head) pair and one query
// head g (grid (B * KV, G)), in split order: out = sum_s w_s o_s / sum_s
// w_s l_s with w_s = e^(m_s - M), M = max_s m_s.  Warp 0 computes the
// weights into shared memory (dynamic, n_split floats); then thread (c, j)
// adds the float4 chunk c of o over splits j, j + ngrp, ... and the ngrp
// sums are added in a fixed order.  Empty partials (m = NEG_INF, l = 0,
// o = 0) add nothing; a pair with no live token writes zeros.  Launched
// as a programmatic dependent of the split kernel: it may start while the
// split kernel drains, and waits for its results at griddepcontrol.wait.
template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
decode_combine(const float* __restrict__ ws, T* __restrict__ out, int pairs, int n_split,
               int G, int D) {
  extern __shared__ float w_s[];
  __shared__ float4 red_s[DEC_THREADS];
  __shared__ float inv_s;
  const int pair = blockIdx.x, g = blockIdx.y, tid = threadIdx.x, GD = G * D;
  const float* o = ws + (int64_t)pair * n_split * GD + (int64_t)g * D;
  const float* m = ws + (int64_t)pairs * n_split * GD + (int64_t)pair * n_split * G + g;
  const float* l = m + (int64_t)pairs * n_split * G;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tid < 32) {
    float mx = NEG_INF;
    for (int s = tid; s < n_split; s += 32) mx = fmaxf(mx, m[(int64_t)s * G]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int s = tid; s < n_split; s += 32) {
      const float w = expf(m[(int64_t)s * G] - mx);
      w_s[s] = w;
      den = fmaf(w, l[(int64_t)s * G], den);
    }
    den = warp_sum(den);
    if (tid == 0) inv_s = 1.f / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const int nq = D / 4, ngrp = DEC_THREADS / nq, c = tid % nq, j = tid / nq;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j < ngrp) {
#pragma unroll 4
    for (int s = j; s < n_split; s += ngrp) {
      const float w = w_s[s];
      const float4 x = *reinterpret_cast<const float4*>(o + (int64_t)s * GD + c * 4);
      acc.x = fmaf(w, x.x, acc.x);
      acc.y = fmaf(w, x.y, acc.y);
      acc.z = fmaf(w, x.z, acc.z);
      acc.w = fmaf(w, x.w, acc.w);
    }
  }
  red_s[tid] = acc;
  __syncthreads();
  const float* red = reinterpret_cast<const float*>(red_s);
  for (int d = tid; d < D; d += DEC_THREADS) {
    float sum = 0.f;
    for (int jj = 0; jj < ngrp; ++jj) sum += red[jj * D + d];
    out[(int64_t)pair * GD + (int64_t)g * D + d] = from_f<T>(sum * inv_s);
  }
}

// Launches decode_combine for a split call on `stream`, allowed to start
// before the split kernel ends (programmatic dependent launch).
template <typename T>
cudaError_t launch_combine(const float* ws, T* out, int pairs, int n_split, int G, int D,
                           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pairs, G);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = n_split * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_combine<T>, ws, out, pairs, n_split, G, D);
}

// Raises the kernel's dynamic shared-memory limit to `bytes` once (the
// first launch that needs more than the 48 KB default); returns the CUDA
// status.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int* granted) {
  if (bytes <= *granted) return cudaSuccess;
  const cudaError_t st =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (st == cudaSuccess) *granted = bytes;
  return st;
}

}  // namespace rapid
