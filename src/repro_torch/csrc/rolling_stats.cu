// RAPID monitor statistics for Hopper (sm_90a): ring-buffer window z-score
// of the acceleration magnitude with a running-sigma floor, and the Eq. 5
// moving average of the torque power with its running z-score.
//
// Replaces the Pallas TPU kernel repro/kernels/rolling_stats.py
// (rolling_stats, pallas_call at :136); the per-tick arithmetic follows its
// _kernel (:51-94) operation for operation: incremental window sum and sum
// of squares (not a rescan), cnt = min(t + 1, window), Welford running
// stats.  m_acc, tau_pow [N, T] -> score_acc, score_tau, m_tau [N, T], all
// float32, row-major.
//
// Bound on an H100: bytes — 5 * N * T floats read or written once; ~40
// flops a tick a stream are far below the card's float32 rate per byte.
// In practice each stream is a chain of T dependent ticks, so the kernel is
// bound by that chain's latency, not by either rate.
//
// Design: one thread per stream, one warp (32 streams) per block, so N =
// 1024 streams already spread over 32 SMs (the TPU's 128-stream tiles would
// give 8 blocks).  The ring buffers (window_acc + window_tau floats a
// stream) cannot live in registers, which are not indexed dynamically; they
// live in shared memory, laid out [slot][stream] so a warp's accesses fall
// in distinct banks.  Streams are rows T floats apart, so a thread reading
// its own row would make 32 separate memory transactions a tick: instead
// the warp stages 32 ticks of its 32 streams at a time through shared tiles
// (one 128-byte row segment per load), and writes the three outputs back
// the same way.  Tiles have a padded row against bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STREAMS = 32;   // streams per block: one warp
constexpr int TT = 32;        // ticks staged per tile
constexpr int MAX_RING = 192; // window_acc + window_tau, in floats a stream

__global__ void __launch_bounds__(STREAMS)
rolling_stats_kernel(const float* __restrict__ macc, const float* __restrict__ taup,
                     float* __restrict__ sa, float* __restrict__ st, float* __restrict__ mt,
                     int N, int T, int wa, int wt, float floor_a, float floor_t, float eps) {
  extern __shared__ float ring[];  // [wa + wt][STREAMS]
  __shared__ float in_a[STREAMS][TT + 1], in_t[STREAMS][TT + 1];
  __shared__ float o_a[STREAMS][TT + 1], o_t[STREAMS][TT + 1], o_m[STREAMS][TT + 1];
  const int lane = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * STREAMS;
  const int nrows = (int)min((int64_t)STREAMS, (int64_t)N - n0);
  float* abuf = ring;
  float* tbuf = ring + wa * STREAMS;
  for (int i = 0; i < wa + wt; ++i) ring[i * STREAMS + lane] = 0.f;

  float asum = 0.f, asq = 0.f, tsum = 0.f;
  float ra_c = 0.f, ra_m = 0.f, ra_2 = 0.f;  // Welford (count, mean, m2) over m_acc
  float rt_c = 0.f, rt_m = 0.f, rt_2 = 0.f;  // ... over m_tau
  for (int tb = 0; tb < T; tb += TT) {
    const int nt = min(TT, T - tb);
    for (int r = 0; r < nrows; ++r) {
      if (lane < nt) {
        const int64_t off = (n0 + r) * T + tb + lane;
        in_a[r][lane] = macc[off];
        in_t[r][lane] = taup[off];
      }
    }
    __syncwarp();
    if (lane < nrows) {
      for (int k = 0; k < nt; ++k) {
        const int t = tb + k;
        const float ma = in_a[lane][k], tp = in_t[lane][k];

        // acceleration window (incremental ring update)
        float* sa_slot = &abuf[(t % wa) * STREAMS + lane];
        const float old = *sa_slot;
        *sa_slot = ma;
        asum = asum + ma - old;
        asq = asq + ma * ma - old * old;
        const float cnt_a = (float)min(t + 1, wa);
        const float mean_a = asum / cnt_a;
        const float var_a = fmaxf(asq / cnt_a - mean_a * mean_a, 0.f);

        // running stats over m_acc (the sigma floor)
        ra_c = ra_c + 1.f;
        const float d1 = ma - ra_m;
        ra_m = ra_m + d1 / ra_c;
        ra_2 = ra_2 + d1 * (ma - ra_m);
        const float sig_run = sqrtf(fmaxf(ra_2 / ra_c, 0.f));
        const float sig_a = fmaxf(fmaxf(sqrtf(var_a), sig_run), floor_a);
        o_a[lane][k] = (ma - mean_a) / (sig_a + eps);

        // torque short window (Eq. 5 moving average)
        float* st_slot = &tbuf[(t % wt) * STREAMS + lane];
        const float oldt = *st_slot;
        *st_slot = tp;
        tsum = tsum + tp - oldt;
        const float cnt_t = (float)min(t + 1, wt);
        const float m_tau = tsum / cnt_t;
        o_m[lane][k] = m_tau;

        // running stats over m_tau
        rt_c = rt_c + 1.f;
        const float d2 = m_tau - rt_m;
        rt_m = rt_m + d2 / rt_c;
        rt_2 = rt_2 + d2 * (m_tau - rt_m);
        const float sig_t = fmaxf(sqrtf(fmaxf(rt_2 / rt_c, 0.f)), floor_t);
        o_t[lane][k] = (m_tau - rt_m) / (sig_t + eps);
      }
    }
    __syncwarp();
    for (int r = 0; r < nrows; ++r) {
      if (lane < nt) {
        const int64_t off = (n0 + r) * T + tb + lane;
        sa[off] = o_a[r][lane];
        st[off] = o_t[r][lane];
        mt[off] = o_m[r][lane];
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int rolling_stats(const float* m_acc, const float* tau_pow, float* score_acc,
                             float* score_tau, float* m_tau, int N, int T, int window_acc,
                             int window_tau, float sigma_floor_acc, float sigma_floor_tau,
                             float eps, void* stream) {
  if (N < 1 || T < 1 || window_acc < 1 || window_tau < 1 ||
      window_acc + window_tau > MAX_RING)
    return (int)cudaErrorInvalidValue;
  const int blocks = (N + STREAMS - 1) / STREAMS;
  const int smem = (window_acc + window_tau) * STREAMS * (int)sizeof(float);
  rolling_stats_kernel<<<blocks, STREAMS, smem, static_cast<cudaStream_t>(stream)>>>(
      m_acc, tau_pow, score_acc, score_tau, m_tau, N, T, window_acc, window_tau,
      sigma_floor_acc, sigma_floor_tau, eps);
  return (int)cudaGetLastError();
}
