// RAPID monitor statistics for Hopper (sm_90a): the window z-score of the
// acceleration magnitude with a running-sigma floor, and the Eq. 5 moving
// average of the torque power with its running z-score.
//
// Replaces the Pallas TPU kernel repro/kernels/rolling_stats.py
// (rolling_stats, pallas_call at :136), whose _kernel (:51-94) walks the ticks
// in order with ring buffers.  m_acc, tau_pow [N, T] -> score_acc, score_tau,
// m_tau [N, T], all float32, row-major.  Per tick t: the window sums over
// inputs t-w+1..t (count min(t + 1, w)), and Welford running stats over m_acc
// and over m_tau.
//
// Bound on an H100: bytes -- 5 * N * T floats read or written once (fleet
// N = 1024, T = 600: 12.3 MB, 3.7 us); ~40 flops a tick a stream are far below
// the float32 rate per byte.  A stream is a chain of T dependent ticks, so a
// thread a stream is bound by that chain's latency instead.
//
// Design: one warp a stream, the horizon split over its 32 lanes.  Only the
// two Welford accumulators (count, mean, M2) carry state from tick to tick:
// the window sums at tick t are sums of inputs, and m_tau depends only on
// inputs.  A warp stages a super-tile of 32 segments of `seg` ticks (plus a
// halo of the max(wa, wt) ticks before it) in shared memory with 16-byte
// loads, then
//   pass A: each lane recomputes the torque window sum at its segment's start
//           from the staged inputs, runs m_tau over its segment (an output)
//           and summarises m_acc and m_tau as Welford triples;
//   scan:   an exclusive warp scan (__shfl_up_sync, 5 steps) of Chan's merge
//           gives each lane the stats entering its segment; the triple of
//           lane 31 carries into the next super-tile;
//   pass B: each lane recomputes the acceleration window sums at its
//           segment's start, runs its ticks and stages both scores (score_tau
//           over the dead tau_pow tile); the warp writes the three outputs
//           back with 16-byte stores.
// No ring buffer and no runtime `%`.  The reciprocal of the tick count is one
// fast division a tick, shared by both Welford updates, and the scores use
// fast divisions (within the monitor's tolerances).  Shared arrays are indexed
// through pad(i) = i + i / 32 against bank conflicts between segments.
// seg and the halo come from the launcher (kernels/rolling_stats.py
// monitor_plan), which this entry point checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;        // streams a block: one warp each
constexpr int MAX_SEG = 32;     // ticks a lane takes in one super-tile
constexpr int MAX_RING = 192;   // window_acc + window_tau

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }
__host__ __device__ inline int padded(int n) { return n + (n >> 5) + 1; }  // floats for n entries

struct Stats {
  float n, mean, m2;
};

// Chan's merge: the stats of a's ticks followed by b's.
__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n, d = b.mean - a.mean, f = b.n / n;
  return {n, fmaf(d, f, a.mean), a.m2 + b.m2 + d * d * a.n * f};
}

__device__ __forceinline__ Stats shfl_up(Stats s, int off) {
  return {__shfl_up_sync(0xffffffffu, s.n, off), __shfl_up_sync(0xffffffffu, s.mean, off),
          __shfl_up_sync(0xffffffffu, s.m2, off)};
}

__device__ __forceinline__ Stats shfl(Stats s, int lane) {
  return {__shfl_sync(0xffffffffu, s.n, lane), __shfl_sync(0xffffffffu, s.mean, lane),
          __shfl_sync(0xffffffffu, s.m2, lane)};
}

// One Welford step with r = 1 / (new count).
__device__ __forceinline__ void welford(Stats& s, float v, float r) {
  s.n += 1.f;
  const float d = v - s.mean;
  s.mean = fmaf(d, r, s.mean);
  s.m2 = fmaf(d, v - s.mean, s.m2);
}

// buf[pad(i0 + i)] = row[t0 + i] for i < cnt: the warp's loads issued
// together, 16 bytes a lane where the row is aligned.
__device__ void load_row(const float* __restrict__ row, int t0, int cnt, float* buf, int i0,
                         int lane) {
  const float* src = row + t0;
  const int head = min(cnt, (int)((4 - ((uintptr_t)src >> 2)) & 3));
  const int nvec = (cnt - head) >> 2, tail = head + 4 * nvec;
  if (lane < head) buf[pad(i0 + lane)] = src[lane];
#pragma unroll 4
  for (int v = lane; v < nvec; v += 32) {
    const float4 q = *reinterpret_cast<const float4*>(src + head + 4 * v);
    const int i = i0 + head + 4 * v;
    buf[pad(i)] = q.x;
    buf[pad(i + 1)] = q.y;
    buf[pad(i + 2)] = q.z;
    buf[pad(i + 3)] = q.w;
  }
  if (tail + lane < cnt) buf[pad(i0 + tail + lane)] = src[tail + lane];
}

// row[t0 + i] = buf[pad(i0 + i)] for i < cnt, 16 bytes a lane where aligned.
__device__ void store_row(float* __restrict__ row, int t0, int cnt, const float* buf, int i0,
                          int lane) {
  float* dst = row + t0;
  const int head = min(cnt, (int)((4 - ((uintptr_t)dst >> 2)) & 3));
  const int nvec = (cnt - head) >> 2, tail = head + 4 * nvec;
  if (lane < head) dst[lane] = buf[pad(i0 + lane)];
#pragma unroll 4
  for (int v = lane; v < nvec; v += 32) {
    const int i = i0 + head + 4 * v;
    *reinterpret_cast<float4*>(dst + head + 4 * v) =
        make_float4(buf[pad(i)], buf[pad(i + 1)], buf[pad(i + 2)], buf[pad(i + 3)]);
  }
  if (tail + lane < cnt) dst[tail + lane] = buf[pad(i0 + tail + lane)];
}

__global__ void __launch_bounds__(WARPS * 32)
rolling_stats_kernel(const float* __restrict__ macc, const float* __restrict__ taup,
                     float* __restrict__ sa, float* __restrict__ st, float* __restrict__ mt,
                     int N, int T, int wa, int wt, float floor_a, float floor_t, float eps,
                     int seg, int halo) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n = (int64_t)blockIdx.x * WARPS + warp;
  if (n >= N) return;  // the whole warp: nothing below synchronises the block
  const int span = 32 * seg, in_len = padded(halo + span), out_len = padded(span);
  // staged inputs, tick t at pad(t - tb + halo); score_tau goes over tau_pow
  // (dead after pass A) at the same place; m_tau and score_acc at pad(t - tb)
  float* ia = smem + warp * (2 * in_len + 2 * out_len);
  float* it = ia + in_len;
  float* om = it + in_len;
  float* oa = om + out_len;
  const int64_t row = n * T;
  const float inv_wa = 1.f / wa, inv_wt = 1.f / wt;
  const Stats none = {0.f, 0.f, 0.f};

  Stats ca = none, cm = none;  // m_acc and m_tau stats of the ticks before the super-tile
  for (int tb = 0; tb < T; tb += span) {
    const int len = min(span, T - tb), lo = max(0, tb - halo);
    load_row(macc + row, lo, tb + len - lo, ia, lo - tb + halo, lane);
    load_row(taup + row, lo, tb + len - lo, it, lo - tb + halo, lane);
    __syncwarp();
    const int sl = (len + 31) >> 5;  // this super-tile's segment: ticks tb + k0 .. tb + k1 - 1
    const int k0 = min(lane * sl, len), k1 = min(k0 + sl, len), ts = tb + k0;

    // pass A: the torque window sum recomputed at the segment's start, m_tau
    // over the segment (an output), and the segment's stats of m_acc and m_tau
    Stats pa = none, pm = none;
    if (k0 < k1) {
      float tsum = 0.f;
      for (int t = max(0, ts - wt); t < ts; ++t) tsum += it[pad(t - tb + halo)];
      for (int k = k0; k < k1; ++k) {
        const int t = tb + k, i = k + halo;
        const float old = t >= wt ? it[pad(i - wt)] : 0.f;
        tsum += it[pad(i)] - old;
        const float m_tau = tsum * (t + 1 >= wt ? inv_wt : __fdividef(1.f, (float)(t + 1)));
        om[pad(k)] = m_tau;
        const float r = __fdividef(1.f, pa.n + 1.f);
        welford(pa, ia[pad(i)], r);
        welford(pm, m_tau, r);
      }
    }
    // the stats entering each lane's segment: an exclusive scan of Chan's merge
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Stats qa = shfl_up(pa, off), qm = shfl_up(pm, off);
      if (lane >= off) {
        pa = merge(qa, pa);
        pm = merge(qm, pm);
      }
    }
    Stats ea = shfl_up(pa, 1), em = shfl_up(pm, 1);
    if (lane == 0) ea = em = none;
    Stats ra = merge(ca, ea), rm = merge(cm, em);
    ca = merge(ca, shfl(pa, 31));
    cm = merge(cm, shfl(pm, 31));
    __syncwarp();  // every lane is done with tau_pow

    // pass B: the acceleration window recomputed at the segment's start, the
    // running stats and both scores
    if (k0 < k1) {
      float asum = 0.f, asq = 0.f;
      for (int t = max(0, ts - wa); t < ts; ++t) {
        const float v = ia[pad(t - tb + halo)];
        asum += v;
        asq = fmaf(v, v, asq);
      }
      for (int k = k0; k < k1; ++k) {
        const int t = tb + k, i = k + halo;
        const float ma = ia[pad(i)];
        const float old = t >= wa ? ia[pad(i - wa)] : 0.f;
        asum += ma - old;
        asq += ma * ma - old * old;
        const float r = __fdividef(1.f, (float)(t + 1));  // 1 / the running count
        const float ic = t + 1 >= wa ? inv_wa : r;
        const float mean_a = asum * ic;
        const float var_a = fmaxf(asq * ic - mean_a * mean_a, 0.f);
        const float m_tau = om[pad(k)];
        welford(ra, ma, r);
        welford(rm, m_tau, r);
        // max(sqrt(var), sqrt(running var)) = sqrt(max(...)): one root
        const float sig_a = fmaxf(sqrtf(fmaxf(var_a, ra.m2 * r)), floor_a);
        const float sig_t = fmaxf(sqrtf(fmaxf(rm.m2 * r, 0.f)), floor_t);
        oa[pad(k)] = __fdividef(ma - mean_a, sig_a + eps);
        it[pad(i)] = __fdividef(m_tau - rm.mean, sig_t + eps);
      }
    }
    __syncwarp();
    store_row(sa + row, tb, len, oa, 0, lane);
    store_row(st + row, tb, len, it, halo, lane);
    store_row(mt + row, tb, len, om, 0, lane);
    __syncwarp();  // the buffers are free for the next super-tile
  }
}

}  // namespace

// seg: ticks a lane takes in a super-tile of 32 * seg; halo: the ticks staged
// before a super-tile (>= max(window_acc, window_tau) when T > 32 * seg).
extern "C" int rolling_stats(const float* m_acc, const float* tau_pow, float* score_acc,
                             float* score_tau, float* m_tau, int N, int T, int window_acc,
                             int window_tau, float sigma_floor_acc, float sigma_floor_tau,
                             float eps, int seg, int halo, void* stream) {
  if (N < 1 || T < 1 || window_acc < 1 || window_tau < 1 ||
      window_acc + window_tau > MAX_RING || seg < 1 || seg > MAX_SEG || halo < 0 ||
      (T > 32 * seg && (halo < window_acc || halo < window_tau)))
    return (int)cudaErrorInvalidValue;
  const int smem = WARPS * (2 * padded(halo + 32 * seg) + 2 * padded(32 * seg)) * (int)sizeof(float);
  static int smem_set = 48 * 1024;  // the dynamic shared memory opted into so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rolling_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int blocks = (N + WARPS - 1) / WARPS;
  rolling_stats_kernel<<<blocks, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      m_acc, tau_pow, score_acc, score_tau, m_tau, N, T, window_acc, window_tau,
      sigma_floor_acc, sigma_floor_tau, eps, seg, halo);
  return (int)cudaGetLastError();
}
