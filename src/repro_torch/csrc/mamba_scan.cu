// Mamba-2 chunked SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py (mamba_scan,
// pallas_call at :106), and takes an initial state as the reference's
// ssd_chunked does (models/ssm.py:94-158).  Per chunk of L steps, with
// cum = the inclusive prefix sum of dt * a over the chunk:
//   y[t]  = sum_{s<=t} (C_t . B_s) exp(cum[t] - cum[s]) dt[s] x[s]
//         + exp(cum[t]) C_t . h                      (the carried state)
//   h    <- h exp(cum[L-1]) + sum_s exp(cum[L-1] - cum[s]) dt[s] x[s] B_s^T
// x [B,S,H,P], dt [B,S,H], a [H], B/C [B,S,N], h0 [B,H,P,N] (or null) ->
// y [B,S,H,P], hT [B,H,P,N]; all float32.
//
// Bound on an H100: at the serving chunk (L = 14), bytes — x and y
// (S * H * P floats each), the final state (H * P * N) and the small
// inputs, read or written once: ~2.9 MB at B=1, S=14, H=256, P=64, N=16,
// so the call is launch-bound.  The intra-chunk form costs ~L/2 * (2N + 2P)
// float32 flops per step, head and channel row, so from L ~ 100 on the
// operations bound it (L = 256: ~2.5x the bytes' time).
//
// Design: the TPU grid walks (batch, head tile, chunk) in order and carries
// the state in VMEM across the sequential chunk axis.  GPU blocks run in no
// order, so one block owns one (batch, head) and loops over the chunks
// itself, carrying h [P, N] in shared memory.  The [L, L] decay matrix is
// never materialised (256 KB at L = 256): the masked weights
// (C_t . B_s) exp(cum[t] - cum[s]) dt[s] are built one 32-column tile of s
// at a time in shared memory (s > t is masked before exp, which would
// overflow), and each thread adds the tile into its registers for a fixed
// channel p and the steps t = t0, t0 + 256/P, ....  cum is a block scan
// (warp shuffles, then the warp totals) kept in float64: over a 256-step
// chunk it reaches ~-10^3 on fast-decaying heads, where a float32 ulp
// (~1e-4) would put a 1e-4 relative error on every decay factor; in
// float64 the differences cum[t] - cum[s] are exact to float32 rounding.
// B is stored transposed with a padded row, and h with a padded row,
// against shared-memory bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_L = 256;
constexpr int MAX_P = 64;
constexpr int MAX_N = 32;
constexpr int TS = 32;                          // s-columns per weight tile
constexpr int ACC = MAX_L * MAX_P / THREADS;    // y outputs a thread owns

// Inclusive prefix sum of v over the block's threads (in thread order).
__device__ double block_scan(double v, double* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double t = lane < WARPS ? warp_tot[lane] : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += o;
    }
    if (lane < WARPS) warp_tot[lane] = t;
  }
  __syncthreads();
  return warp > 0 ? v + warp_tot[warp - 1] : v;
}

__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const float* __restrict__ bm,
                  const float* __restrict__ c, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ hT, int S, int H, int P, int N,
                  int L) {
  extern __shared__ double sm[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int NP = N + 1, LP = L + 1;
  double* cum = sm;            // [L]        float64 prefix sums of dt * a
  double* wtot = cum + L;      // [WARPS]
  float* xs = reinterpret_cast<float*>(wtot + WARPS);  // [L][P]
  float* cs = xs + L * P;      // [L][N]
  float* bt = cs + L * N;      // [N][L+1]   B transposed
  float* w = bt + N * LP;      // [L][TS]    one tile of masked weights
  float* hs = w + L * TS;      // [P][N+1]   carried state
  float* dts = hs + P * NP;    // [L]
  float* u = dts + L;          // [L]        exp(cum[L-1] - cum[s]) dt[s]

  const float ah = a[h];
  const int64_t hbase = ((int64_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS)
    hs[(e / N) * NP + e % N] = h0 != nullptr ? h0[hbase + e] : 0.f;

  const int rows = THREADS / P;  // steps covered by one pass of the threads
  const int pp = tid % P, t0 = tid / P;
  for (int s0 = 0; s0 < S; s0 += L) {
    __syncthreads();  // the previous chunk is done with shared memory
    for (int e = tid; e < L * P; e += THREADS)
      xs[e] = x[(((int64_t)b * S + s0 + e / P) * H + h) * P + e % P];
    for (int e = tid; e < L * N; e += THREADS) {
      const int t = e / N, n = e % N;
      const int64_t off = ((int64_t)b * S + s0 + t) * N + n;
      cs[e] = c[off];
      bt[n * LP + t] = bm[off];
    }
    float d = 0.f;
    if (tid < L) {
      d = dt[((int64_t)b * S + s0 + tid) * H + h];
      dts[tid] = d;
    }
    const double cv = block_scan(tid < L ? (double)(d * ah) : 0.0, wtot);
    if (tid < L) cum[tid] = cv;
    __syncthreads();
    const double cl = cum[L - 1];
    if (tid < L) u[tid] = expf((float)(cl - cum[tid])) * dts[tid];

    // ---- intra-chunk quadratic form, one tile of s at a time ----
    float acc[ACC];
#pragma unroll
    for (int k = 0; k < ACC; ++k) acc[k] = 0.f;
    for (int sb = 0; sb < L; sb += TS) {
      const int ts = min(TS, L - sb);
      __syncthreads();  // the previous tile has been read
      for (int e = tid; e < L * TS; e += THREADS) {
        const int t = e / TS, j = e % TS, s = sb + j;
        float v = 0.f;
        if (j < ts && s <= t) {
          float g = 0.f;
          for (int n = 0; n < N; ++n) g += cs[t * N + n] * bt[n * LP + s];
          v = g * expf((float)(cum[t] - cum[s])) * dts[s];
        }
        w[e] = v;
      }
      __syncthreads();
      for (int j = 0; j < ts; ++j) {
        const float xv = xs[(sb + j) * P + pp];
#pragma unroll
        for (int k = 0; k < ACC; ++k) {
          const int t = t0 + rows * k;
          if (t < L && t >= sb) acc[k] += w[t * TS + j] * xv;
        }
      }
    }

    // ---- the carried state's contribution; write y ----
#pragma unroll
    for (int k = 0; k < ACC; ++k) {
      const int t = t0 + rows * k;
      if (t < L) {
        float yc = 0.f;
        for (int n = 0; n < N; ++n) yc += cs[t * N + n] * hs[pp * NP + n];
        y[(((int64_t)b * S + s0 + t) * H + h) * P + pp] = acc[k] + expf((float)cum[t]) * yc;
      }
    }
    __syncthreads();  // every thread has read the state it entered with

    // ---- state update ----
    const float dec = expf((float)cl);
    for (int e = tid; e < P * N; e += THREADS) {
      const int p = e / N, n = e % N;
      float sacc = 0.f;
      for (int s = 0; s < L; ++s) sacc += u[s] * bt[n * LP + s] * xs[s * P + p];
      hs[p * NP + n] = hs[p * NP + n] * dec + sacc;
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += THREADS) hT[hbase + e] = hs[(e / N) * NP + e % N];
}

// Shared memory a launch needs, in bytes (0 if the shape is not taken).
int smem_bytes(int P, int N, int L) {
  if (L < 1 || L > MAX_L || P < 1 || P > MAX_P || THREADS % P || N < 1 || N > MAX_N) return 0;
  return (int)sizeof(double) * (L + WARPS) +
         (int)sizeof(float) * (L * P + L * N + N * (L + 1) + L * TS + P * (N + 1) + 2 * L);
}

}  // namespace

// h0 may be null: the scan then starts from a zero state.  S % L == 0.
extern "C" int mamba_scan(const float* x, const float* dt, const float* a, const float* bm,
                          const float* c, const float* h0, float* y, float* hT, int B, int S,
                          int H, int P, int N, int L, void* stream) {
  const int smem = smem_bytes(P, N, L);
  if (smem == 0 || S % L) return (int)cudaErrorInvalidValue;
  static int smem_set = 0;  // the largest dynamic shared memory opted into so far
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  mamba_scan_kernel<<<dim3(H, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, dt, a, bm, c, h0, y, hT, S, H, P, N, L);
  return (int)cudaGetLastError();
}
