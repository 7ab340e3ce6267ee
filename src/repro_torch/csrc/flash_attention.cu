// Causal flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :127), which is the same function as the
// model's blockwise prefill _sdpa_chunked (repro/models/attention.py:115):
// q [B,S,H,D] attends k/v [B,S,KV,D] with GQA by h / (H/KV), causal mask,
// optional sliding window (q - k) < window and tanh logit softcap, f32
// scores and f32 online softmax, output in the input dtype.
//
// Bound on an H100: operations for long prompts — 4 * B * H * D flops per
// unmasked (q, k) pair against 989 TFLOP/s in bf16 — and bytes (q, k, v
// read once, out written once, / 3.35 TB/s) for short ones.  The serving
// prompt is 14 tokens (7 qd + 7 tau state tokens), where both bounds are
// below a microsecond and the kernel is launch-bound.
//
// Design: one block per (b, h, tile of FA_BQ query rows).  The block loops
// over key tiles of FA_BK only from the window's lower bound up to the
// causal limit of its last row; the TPU needs S divisible by its blocks,
// here the ragged edge is masked so any S works.  Scores, softmax and the
// value sum are scalar f32 FMAs out of shared memory (K rows padded by one
// float so the lanes of a warp hit distinct banks); wgmma and TMA are left
// for a later, faster version.

#include "attention_common.cuh"

namespace {

constexpr int FA_THREADS = 128;
constexpr int FA_WARPS = FA_THREADS / 32;
constexpr int FA_BQ = 16;
constexpr int FA_BK = 32;
constexpr int FA_ACC = FA_BQ * rapid::MAX_D / FA_THREADS;

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal, int window) {
  return qp < S && kp < S && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int S, int H, int KV, int D, int causal, int window,
             float scale, float cap) {
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
  const T* qb = q + (int64_t)b * S * q_row + (int64_t)h * D;
  const T* kb = k + (int64_t)b * S * kv_row + (int64_t)kvh * D;
  const T* vb = v + (int64_t)b * S * kv_row + (int64_t)kvh * D;

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
  T* ob = out + (int64_t)b * S * q_row + (int64_t)h * D;
#pragma unroll
  for (int x = 0; x < FA_ACC; ++x) {
    const int e = tid + x * FA_THREADS;
    if (e < FA_BQ * D) {
      const int i = e / D, d = e % D;
      if (q0 + i < S) ob[(q0 + i) * q_row + d] = rapid::from_f<T>(acc[x] / fmaxf(l_s[i], 1e-30f));
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)FA_BQ * (D + 1) + (size_t)FA_BK * (D + 1) +
                          (size_t)FA_BK * D + (size_t)FA_BQ * (FA_BK + 1) + 3 * FA_BQ);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int KV,
           int D, int causal, int window, float scale, float cap, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + FA_BQ - 1) / FA_BQ, H, B);
  flash_kernel<T><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, KV, D, causal, window, scale, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                               int S, int H, int KV, int D, int causal, int window, float scale,
                               float cap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, D, causal, window, scale, cap, s);
  return launch<float>(q, k, v, out, B, S, H, KV, D, causal, window, scale, cap, s);
}
