// Shared device code for the decode attention kernels (paged and dense).
//
// decode_rows() attends the G query heads of one KV head of one row over
// the token range [lo, hi) of that row's K/V, with an f32 online softmax.
// Where each token's K/V row lives is the caller's business: a RowMap
// functor turns a token index into an element offset (a page-table walk
// for the paged kernel, a strided slab for the dense one).
//
// Per tile of DEC_TILE tokens:
//   1. scores: every warp takes TPW tokens at a time; the LPT lanes of a
//      token each load one 8-element chunk of its K row (16 bytes in bf16)
//      and dot it with the G resident queries, reduced by warp shuffles;
//   2. softmax: one warp per query head rescales (m, l) with the tile max;
//   3. values: each thread owns up to ACC output elements (g, d) of the
//      G x D accumulator and adds p[g][t] * V[t][d] over the tile; threads
//      of a warp read neighbouring d, so V reads are coalesced.
// Only live tokens are visited, so a row of length 0 writes zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rapid {

constexpr float NEG_INF = -1e30f;
constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_TILE = 64;
constexpr int MAX_D = 256;
constexpr int MAX_G = 16;
constexpr int DEC_ACC = MAX_G * MAX_D / DEC_THREADS;

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

// q_head: the G query rows of this KV head ([G, D], contiguous);
// out_head: where the G output rows go.  k/v: the caches' base pointers;
// rows(t) is the element offset of token t's D-vector for this KV head.
template <typename T, typename RowMap>
__device__ void decode_rows(const T* __restrict__ q_head, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out_head,
                            int G, int D, int lo, int hi, float scale, float cap,
                            const RowMap& rows) {
  __shared__ float q_s[MAX_G * MAX_D];
  __shared__ float s_s[MAX_G][DEC_TILE];
  __shared__ int64_t off_s[DEC_TILE];
  __shared__ float m_s[MAX_G], l_s[MAX_G], alpha_s[MAX_G];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int GD = G * D;
  for (int e = tid; e < GD; e += DEC_THREADS) q_s[e] = to_f(q_head[e]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int nc = D / 8;  // 8-element chunks per row
  int lpt = 1;           // lanes per token: a power of two >= nc
  while (lpt < nc) lpt <<= 1;
  const int tpw = 32 / lpt;  // tokens per warp per pass
  const int sub = lane % lpt, slot = lane / lpt;

  float acc[DEC_ACC];
#pragma unroll
  for (int i = 0; i < DEC_ACC; ++i) acc[i] = 0.f;

  for (int t0 = lo; t0 < hi; t0 += DEC_TILE) {
    const int n = min(DEC_TILE, hi - t0);
    __syncthreads();  // previous tile's readers are done with s_s / off_s
    for (int t = tid; t < n; t += DEC_THREADS) off_s[t] = rows(t0 + t);
    __syncthreads();

    // 1. scores
    for (int base = warp * tpw; base < n; base += DEC_WARPS * tpw) {
      const int t = base + slot;
      const bool live = t < n && sub < nc;
      float kf[8];
      if (live) {
        load8(k + off_s[t] + sub * 8, kf);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[i] = 0.f;
      }
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
        if (live) {
          const float* qg = q_s + g * D + sub * 8;
#pragma unroll
          for (int i = 0; i < 8; ++i) part = fmaf(kf[i], qg[i], part);
        }
        for (int off = lpt / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (sub == 0 && t < n) s_s[g][t] = softcap(part * scale, cap);
      }
    }
    __syncthreads();

    // 2. online softmax, one warp per query head
    for (int g = warp; g < G; g += DEC_WARPS) {
      float mx = NEG_INF;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s_s[g][t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(s_s[g][t] - m_new);
        s_s[g][t] = p;
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

    // 3. values
#pragma unroll
    for (int i = 0; i < DEC_ACC; ++i) {
      const int e = tid + i * DEC_THREADS;
      if (e < GD) {
        const int g = e / D, d = e % D;
        float a = acc[i] * alpha_s[g];
#pragma unroll 8
        for (int t = 0; t < n; ++t) a = fmaf(s_s[g][t], to_f(v[off_s[t] + d]), a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < DEC_ACC; ++i) {
    const int e = tid + i * DEC_THREADS;
    if (e < GD) out_head[e] = from_f<T>(acc[i] / fmaxf(l_s[e / D], 1e-30f));
  }
}

}  // namespace rapid
