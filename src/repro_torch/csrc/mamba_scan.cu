// Mamba-2 chunked SSD scan for Hopper (sm_90a): chunk-parallel, in three
// stages that mirror the reference's ssd_chunked (repro/models/ssm.py:94-158).
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py (mamba_scan,
// pallas_call at :106), and takes an initial state as ssd_chunked does.  Per
// chunk of L steps, with cum = the inclusive prefix sum of dt * a over it:
//   y[t]  = sum_{s<=t} G[t,s] exp(cum[t] - cum[s]) dt[s] x[s]
//         + exp(cum[t]) C_t . h_in                   (the carried state)
//   h    <- h_in exp(cum[L-1]) + sc,  sc = sum_s exp(cum[L-1] - cum[s]) dt[s] x[s] B_s^T
// with G = C B^T.  x [B,S,H,P], dt [B,S,H], a [H], B/C [B,S,N], h0 [B,H,P,N]
// (or null) -> y [B,S,H,P], hT [B,H,P,N]; all float32.
//
// Bound on an H100: at Jamba's served prompt (L = S = 14, H = 256, P = 64,
// N = 16) bytes: x and y (S*H*P floats each), hT and the small inputs, ~2.9 MB
// read or written once, 0.87 us.  The intra-chunk product costs ~L/2 * 2P
// flops a step, head and channel (G itself only once a chunk, shared by the
// heads), so from L ~ 100 on the float32 operations bound it (L = 256: ~2x
// the bytes' time).
//
// Design.  The TPU kernel walks the chunks of a head in order with the state
// in VMEM; here the chunk chain is cut out of the heavy work:
//   1. state blocks, one per (batch, chunk, group of heads): cum in float64,
//      and sc [P, N] of each head, in 4 x 4 register tiles;
//   2. the pass, one thread per state element: h_in[c] = h, h <- h dec + sc
//      over the chunks in order (P*N values a head, so the serial chain is
//      short); writes hT;
//   3. scan blocks, one per (batch, chunk, tile of tq query rows, group of
//      heads): G = C B^T for the tile's rows and every key step up to the
//      tile's end, computed once and shared by the group's heads; key steps
//      past the tile's end are never visited, and s > t is masked before the
//      exp (which would overflow above the diagonal).  Per head and tile of
//      TS key steps, the weights go to shared memory once; a thread owns
//      4 rows x 4 channels of y, so each pair of float4 shared loads feeds 16
//      FMAs.  A key tile wholly before the rows needs no weights: its decay
//      factors into exp(cum[t] - cum[t0]) exp(cum[t0] - cum[s]), both <= 1
//      while cum falls (as it does for dt > 0 > a; a head whose cum rises
//      keeps the one-factor weights), so x is scaled by the second, G read
//      as it is, and the sum scaled by the first at the diagonal tile.  No
//      [L, L] tensor reaches device memory; no accumulator grows with L.
// x tiles reach shared memory by cp.async, two buffers, the next in flight
// during a tile's product; a block's other inputs are copied together with
// its first x tile.  When the prompt is one chunk (S <= chunk, as served),
// the pass has nothing to carry: one launch holds the scan blocks and the
// state blocks, and both read h0 directly.  Otherwise the three stages are
// three launches, the last two programmatic dependents of the one before, so
// a scan block builds G and its first heads' products before it waits for
// h_in.  The launcher counts one launch a call.
// cum stays in float64: over a 256-step chunk it reaches ~-10^3 on fast
// heads, where a float32 ulp (~1e-4) would put a 1e-4 relative error on
// every decay factor; in float64 the differences cum[t] - cum[s] are exact to
// float32 rounding.  Rows tq, heads a block and threads come from the host's
// plan (kernels/_lib.py mamba_plan), which the launcher checks here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_L = 256, MAX_P = 64, MAX_N = 32, MAX_THREADS = 256;
constexpr int LOG_TS = 5, TS = 1 << LOG_TS;  // key steps a weight tile holds
constexpr int PASS_THREADS = 256, PASS_BLOCKS = 132 * 8;  // the pass: grid-stride

struct Scan {
  const float *x, *dt, *a, *bm, *c, *h0;
  float *y, *hT, *sc, *dec, *hin;
  int B, S, H, P, N, L, nc, hg, groups, rtiles, n_scan, vec;
};

__host__ __device__ inline int up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Byte offsets into a block's dynamic shared memory, and its thread split.
struct Layout {
  int cum, dts;       // [hg][L] float64 prefix sums; [hg][L] dt (state blocks: the weights u)
  int rising;         // [hg] int: the head's dt * a is positive somewhere in the chunk
  int gt, ct, tiles;  // scan: G [lr][tq] (key-major), C [N][tq], then the tiles: x
                      // [2][hc][TS][p4] (two buffers), weights [hc][TS][tq]; B^T
                      // [N][lr+4] over the second buffer until G is built
  int hs;             // scan: the entering states [hc][N][p4+4]
  int bsn, xs2, h0s;  // state: B [lr][n4], x [2][hcs][TS][p4], h0 [hcs][P*N]
  int total, state_total;
  int units, units_s, hc, hcs;  // threads a head takes, heads at once (scan, state)
};

__host__ __device__ inline Layout layout(int L, int P, int N, int tq, int hg, int threads) {
  Layout o;
  const int p4 = up(P, 4), n4 = up(N, 4), lr = up(L, 4);
  o.units = tq / 4 * (p4 / 4);
  o.units_s = p4 / 4 * (n4 / 4);
  o.hc = imin(hg, threads / o.units);
  o.hcs = imin(hg, threads / o.units_s);
  o.cum = 0;
  o.dts = up(8 * hg * L, 16);
  o.rising = o.dts + up(4 * hg * L, 16);
  const int common = o.rising + up(4 * hg, 16);
  o.gt = common;
  o.ct = o.gt + 4 * lr * tq;
  o.tiles = o.ct + 4 * N * tq;
  o.hs = o.tiles + imax(4 * o.hc * TS * p4 + 4 * N * (lr + 4),
                        4 * o.hc * (2 * TS * p4 + TS * tq));
  o.bsn = common;
  o.xs2 = o.bsn + 4 * lr * n4;
  o.h0s = o.xs2 + 2 * 4 * o.hcs * TS * p4;
  o.state_total = o.h0s + up(4 * o.hcs * P * N, 16);
  o.total = imax(o.hs + 4 * o.hc * N * (p4 + 4), o.state_total);
  return o;
}

__device__ __forceinline__ void fma44(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(av[i], bv[k], acc[i][k]);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes, int valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of one x tile into xs and commits it as one group: heads
// h_off .. h_off + nh - 1 of the group, steps s0 .. s0 + ts - 1, as
// xs[(sl * TS + j) * p4 + p]; rows past ts, heads past the group or H and
// channels past P are zero-filled.
__device__ __forceinline__ void copy_x(const Scan& k, int64_t row0, int g, int h_off, int nh,
                                       int s0, int ts, int cg, float* xs) {
  const int lq = __ffs(cg) - 1;
  for (int e = threadIdx.x; e < nh * TS * cg; e += blockDim.x) {
    const int sl = e >> lq >> LOG_TS, j = (e >> lq) & (TS - 1), q = e & (cg - 1);
    const int hh = h_off + sl, hd = g * k.hg + hh;
    const bool ok = j < ts && hh < k.hg && hd < k.H;
    const float* src = ok ? k.x + ((row0 + s0 + j) * k.H + hd) * k.P + 4 * q : k.x;
    if (k.vec) {
      cp_async(xs + 4 * e, src, 16, ok ? 16 : 0);
    } else {  // P < 4, or x not 16-byte aligned
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = ok && 4 * q + i < k.P;
        cp_async(xs + 4 * e + i, in ? src + i : k.x, 4, in ? 4 : 0);
      }
    }
  }
  cp_async_commit();
}

// cp.async of one float, or a zero where the source is out of range.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok, const float* any) {
  cp_async(dst, ok ? src : any, 4, ok ? 4 : 0);
}

// Starts the copies of the states of the nh heads from h_off (P*N floats a
// head from src): dst[sl][p][n] when stride is 0, else transposed,
// dst[(sl * N + n) * stride + p].  The caller commits.
__device__ __forceinline__ void copy_states(const Scan& k, const float* src, int g, int h_off,
                                            int nh, float* dst, int stride = 0) {
  const int N = k.N, PN = k.P * N;
  const int heads = imax(0, imin(nh, imin(k.hg - h_off, k.H - g * k.hg - h_off)));
  const float* base = src + (int64_t)(g * k.hg + h_off) * PN;
  if (stride == 0 && PN % 4 == 0 && ((uintptr_t)base & 15) == 0) {  // a straight copy, 16 B
    for (int e = threadIdx.x; e < heads * PN / 4; e += blockDim.x)
      cp_async(dst + 4 * e, base + 4 * e, 16, 16);
    return;
  }
  for (int e = threadIdx.x; e < heads * PN; e += blockDim.x) {
    const int sl = e / PN, pn = e % PN;
    float* d = stride == 0 ? dst + e : dst + (sl * N + pn % N) * stride + pn / N;
    cp_async(d, base + e, 4, 4);
  }
}

// Starts the copies dts[hh][s] = dt of head g * hg + hh at step s < len of the
// chunk (0 past H).
__device__ __forceinline__ void copy_dts(const Scan& k, int64_t row0, int g, int len,
                                         float* dts) {
  for (int e = threadIdx.x; e < k.hg * len; e += blockDim.x) {
    const int t = e / k.hg, hh = e % k.hg, head = g * k.hg + hh;
    cp4(dts + hh * k.L + t, k.dt + (row0 + t) * k.H + head, head < k.H, k.x);
  }
}

// cum[hh][s] = the inclusive float64 prefix sum over s < len of dt * a, one
// warp a head; rising[hh] (if given) = whether dt * a > 0 anywhere there.
__device__ __forceinline__ void cum_scan(const Scan& k, int g, int len, const float* dts,
                                         double* cum, int* rising = nullptr) {
  const int L = k.L, hg = k.hg, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int hh = warp; hh < hg; hh += blockDim.x >> 5) {
    const int head = g * hg + hh;
    const float ah = head < k.H ? __ldg(k.a + head) : 0.f;
    double carry = 0.0;
    bool up = false;
    for (int s0 = 0; s0 < len; s0 += 32) {
      const int s = s0 + lane;
      double v = s < len ? (double)(dts[hh * L + s] * ah) : 0.0;
      up = up || v > 0.0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += o;
      }
      if (s < len) cum[hh * L + s] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    up = __any_sync(0xffffffffu, up);
    if (rising != nullptr && lane == 0) rising[hh] = up;
  }
}

// Stage 1: sc of each head of the group (or, for one chunk, hT itself).  A
// thread owns 4 channels x 4 state columns of a head; x tiles stream through
// two shared buffers by cp.async, the next in flight during the product.
__device__ __forceinline__ void state_block(const Scan& k, int idx, char* smem,
                                            const Layout& lo) {
  const int g = idx % k.groups, bc = idx / k.groups, b = bc / k.nc, c = bc % k.nc;
  const int L = k.L, P = k.P, N = k.N, H = k.H, hg = k.hg;
  const int p4 = up(P, 4), n4 = up(N, 4), lr = up(L, 4), cg = p4 / 4;
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)b * k.S + (int64_t)c * L;
  double* cum = reinterpret_cast<double*>(smem + lo.cum);
  float* u = reinterpret_cast<float*>(smem + lo.dts);
  float* bsn = reinterpret_cast<float*>(smem + lo.bsn);
  float* xbuf = reinterpret_cast<float*>(smem + lo.xs2);
  float* h0s = reinterpret_cast<float*>(smem + lo.h0s);
  const int hcs = lo.hcs, tiles = (L + TS - 1) / TS, items = (hg + hcs - 1) / hcs * tiles;
  const int tile = hcs * TS * p4;  // floats a buffer
  // one chunk: hT = h0 dec + sc
  const float* h0 = k.nc == 1 && k.h0 != nullptr ? k.h0 + (int64_t)b * H * P * N : nullptr;

  copy_x(k, row0, g, 0, hcs, 0, min(TS, L), cg, xbuf);  // in flight during the prologue
  for (int e = tid; e < lr * n4; e += blockDim.x) {
    const int s = e / n4, n = e % n4;
    cp4(bsn + e, k.bm + (row0 + s) * N + n, s < L && n < N, k.x);
  }
  copy_dts(k, row0, g, L, u);
  if (h0 != nullptr) copy_states(k, h0, g, 0, hcs, h0s);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  cum_scan(k, g, L, u, cum);
  __syncthreads();
  // u[hh][s] = exp(cum[L-1] - cum[s]) dt[s]: the weight of step s in sc
  for (int e = tid; e < hg * L; e += blockDim.x) {
    const int hh = e / L;
    u[e] = expf((float)(cum[hh * L + L - 1] - cum[e])) * u[e];
  }

  const int slot = tid / lo.units_s, q = tid % lo.units_s, pc = q % cg, nq = q / cg;
  float acc[4][4];
  for (int it = 0; it < items; ++it) {
    const int h_off = it / tiles * hcs, s0 = it % tiles * TS, ts = min(TS, L - s0);
    const int hh = h_off + slot, head = g * hg + hh;
    const bool active = slot < hcs && hh < hg && head < H;
    if (s0 == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc[i][kk] = 0.f;
    }
    __syncthreads();  // u is ready; the other buffer (and h0s) has been read
    if (h0 != nullptr && s0 == 0 && h_off > 0) {
      copy_states(k, h0, g, h_off, hcs, h0s);
      cp_async_commit();
    }
    if (it + 1 < items) {
      const int h1 = (it + 1) / tiles * hcs, s1 = (it + 1) % tiles * TS;
      copy_x(k, row0, g, h1, hcs, s1, min(TS, L - s1), cg, xbuf + (it + 1) % 2 * tile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this item's tile has landed
    if (!active) continue;
    const float* xr = xbuf + it % 2 * tile + slot * TS * p4 + pc * 4;
    const float* br = bsn + s0 * n4 + nq * 4;
    const float* ur = u + hh * L + s0;
#pragma unroll 4
    for (int j = 0; j < ts; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + j * p4);
      const float f = ur[j];
      fma44(acc, make_float4(xv.x * f, xv.y * f, xv.z * f, xv.w * f),
            *reinterpret_cast<const float4*>(br + j * n4));
    }
    if (s0 + TS < L) continue;  // the head pass goes on
    const float dec = expf((float)cum[hh * L + L - 1]);
    const int64_t PN = (int64_t)P * N;
    float* out = k.nc == 1 ? k.hT + ((int64_t)b * H + head) * PN
                           : k.sc + ((int64_t)bc * H + head) * PN;
    const float* h0r = h0s + slot * P * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pc * 4 + i;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int n = nq * 4 + kk;
        if (p < P && n < N) {
          const int o = p * N + n;
          out[o] = h0 != nullptr ? fmaf(h0r[o], dec, acc[i][kk]) : acc[i][kk];
        }
      }
    }
    if (k.nc > 1 && q == 0) k.dec[(int64_t)bc * H + head] = dec;
  }
}

// Stage 3: y for TQ rows of one chunk and every head of the group.
template <int TQ>
__device__ __forceinline__ void scan_block(const Scan& k, int idx, char* smem,
                                           const Layout& lo) {
  // the row tiles of one (batch, chunk, group) are neighbours, longest first:
  // they share x and B in L2
  const int r = k.rtiles - 1 - idx % k.rtiles, rest = idx / k.rtiles;
  const int g = rest % k.groups, bc = rest / k.groups, b = bc / k.nc, c = bc % k.nc;
  const int L = k.L, P = k.P, N = k.N, H = k.H, hg = k.hg;
  constexpr int tq = TQ;
  const int p4 = up(P, 4), cg = p4 / 4, lb = up(L, 4) + 4, hp = p4 + 4;
  const int t0 = r * tq, s_end = min(L, t0 + tq), se4 = up(s_end, 4);
  const int tid = threadIdx.x, nt = blockDim.x, hc = lo.hc;
  const int tiles = (s_end + TS - 1) / TS, items = (hg + hc - 1) / hc * tiles;
  const int64_t row0 = (int64_t)b * k.S + (int64_t)c * L;
  double* cum = reinterpret_cast<double*>(smem + lo.cum);
  float* dts = reinterpret_cast<float*>(smem + lo.dts);
  float* gt = reinterpret_cast<float*>(smem + lo.gt);
  float* ct = reinterpret_cast<float*>(smem + lo.ct);
  float* xs = reinterpret_cast<float*>(smem + lo.tiles);  // two buffers
  float* ws = xs + 2 * hc * TS * p4;
  float* bt = xs + hc * TS * p4;  // over the second buffer and ws until G is built
  float* hs = reinterpret_cast<float*>(smem + lo.hs);
  // the state entering the chunk: h0 (one chunk), h_in from the pass (several;
  // zero at chunk 0 without h0), or none
  const float* hsrc = nullptr;
  if (k.nc == 1) {
    if (k.h0 != nullptr) hsrc = k.h0 + (int64_t)b * H * P * N;
  } else if (c > 0 || k.h0 != nullptr) {
    hsrc = k.hin + (int64_t)bc * H * P * N;
  }

  copy_x(k, row0, g, 0, hc, 0, min(TS, s_end), cg, xs);  // in flight during the prologue
  for (int e = tid; e < tq * N; e += nt)
    cp4(ct + e % N * tq + e / N, k.c + (row0 + t0) * N + e, t0 + e / N < L, k.x);
  for (int e = tid; e < se4 * N; e += nt)
    cp4(bt + e % N * lb + e / N, k.bm + row0 * N + e, e / N < s_end, k.x);
  copy_dts(k, row0, g, s_end, dts);
  if (hsrc != nullptr && k.nc == 1) copy_states(k, hsrc, g, 0, hc, hs, hp);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  int* rising = reinterpret_cast<int*>(smem + lo.rising);
  cum_scan(k, g, s_end, dts, cum, rising);
  __syncthreads();
  // G[s][t] = C_t . B_s for t in the tile and s < s_end, 4 x 4 a thread
  constexpr int gq = tq / 4;
  for (int e = tid; e < se4 / 4 * gq; e += nt) {
    const int tq4 = e % gq, s4 = e / gq;
    float acc[4][4] = {};
    for (int n = 0; n < N; ++n)
      fma44(acc, *reinterpret_cast<const float4*>(bt + n * lb + s4 * 4),
            *reinterpret_cast<const float4*>(ct + n * tq + tq4 * 4));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(gt + (s4 * 4 + i) * tq + tq4 * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }

  const int slot = tid / lo.units, q = tid % lo.units, pc = q % cg, tr = q / cg;
  float acc[4][4];
  for (int it = 0; it < items; ++it) {
    const int h_off = it / tiles * hc, s0 = it % tiles * TS, ts = min(TS, s_end - s0);
    const int hh = h_off + slot, head = g * hg + hh;
    const bool active = slot < hc && hh < hg && head < H;
    if (s0 == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc[i][kk] = 0.f;
    }
    __syncthreads();  // G is built; the other buffer, ws (and hs) have been read
    if (hsrc != nullptr && s0 + TS >= s_end && (h_off > 0 || k.nc > 1)) {
      // the pass's last tile: its heads' entering states
      if (k.nc > 1 && h_off == 0) {
        // h_in is the pass kernel's output: wait for it here, after G and
        // the first heads' products
        asm volatile("griddepcontrol.wait;\n" ::: "memory");
      }
      copy_states(k, hsrc, g, h_off, hc, hs, hp);
      cp_async_commit();
    }
    if (it + 1 < items) {
      const int h1 = (it + 1) / tiles * hc, s1 = (it + 1) % tiles * TS;
      copy_x(k, row0, g, h1, hc, s1, min(TS, s_end - s1), cg, xs + (it + 1) % 2 * hc * TS * p4);
    }
    // A key tile wholly before the rows (s < t0 <= t) takes its decay in two
    // factors, exp(cum[t] - cum[t0]) exp(cum[t0] - cum[s]), each <= 1 where
    // cum does not rise: the second scales x, the first the sum once all
    // such tiles are in, and the product reads G itself.  Other tiles build
    // their weights G[t,s] exp(cum[t] - cum[s]) dt[s], s <= t, in ws.
    bool falling = true;  // no head of the pass has a rising cum (the block agrees)
    for (int sl = 0; sl < hc && h_off + sl < hg; ++sl) falling = falling && !rising[h_off + sl];
    const bool split = falling && s0 + TS <= t0;
    float* xcur = xs + it % 2 * hc * TS * p4;
    if (!split) {
      for (int e = tid; e < hc * TS * tq; e += nt) {
        const int sl = e / (TS * tq), j = e / tq % TS, t = e % tq;
        const int h2 = h_off + sl, s = s0 + j, tt = t0 + t;
        float w = 0.f;
        if (j < ts && s <= tt && tt < L && h2 < hg && g * hg + h2 < H)
          w = gt[s * tq + t] * expf((float)(cum[h2 * L + tt] - cum[h2 * L + s])) *
              dts[h2 * L + s];
        ws[e] = w;
      }
    }
    if (it + 1 < items)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    if (split) {
      // x[s] *= exp(cum[t0] - cum[s]) dt[s], each thread on the quads it copied
      const int lq = __ffs(cg) - 1;
      for (int e = tid; e < hc * TS * cg; e += nt) {
        const int row = e >> lq, sl = row >> LOG_TS, j = row & (TS - 1), h2 = h_off + sl;
        const int s = s0 + j;
        const float f =
            j < ts && h2 < hg ? expf((float)(cum[h2 * L + t0] - cum[h2 * L + s])) * dts[h2 * L + s]
                              : 0.f;
        float4* v = reinterpret_cast<float4*>(xcur) + e;
        *v = make_float4(v->x * f, v->y * f, v->z * f, v->w * f);
      }
    }
    __syncthreads();  // this item's x tile has landed (and is scaled), ws is built
    if (falling && s0 == t0 && t0 > 0 && active) {
      // the first tile on the diagonal: the sum of the earlier tiles takes
      // its factor exp(cum[t] - cum[t0])
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + tr * 4 + i;
        const float f = t < s_end ? expf((float)(cum[hh * L + t] - cum[hh * L + t0])) : 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc[i][kk] *= f;
      }
    }
    if (active) {
      const float* wr = (split ? gt + s0 * tq : ws + slot * TS * tq) + tr * 4;
      const float* xr = xcur + slot * TS * p4 + pc * 4;
#pragma unroll 4
      for (int j = 0; j < ts; ++j)
        fma44(acc, *reinterpret_cast<const float4*>(wr + j * tq),
              *reinterpret_cast<const float4*>(xr + j * p4));
    }
    if (s0 + TS < s_end || !active) continue;  // the head pass goes on

    if (hsrc != nullptr) {  // the carried state
      float cr[4][4] = {};
      for (int n = 0; n < N; ++n)
        fma44(cr, *reinterpret_cast<const float4*>(ct + n * tq + tr * 4),
              *reinterpret_cast<const float4*>(hs + (slot * N + n) * hp + pc * 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + tr * 4 + i;
        const float d = t < L ? expf((float)cum[hh * L + t]) : 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc[i][kk] = fmaf(d, cr[i][kk], acc[i][kk]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + tr * 4 + i;
      if (t >= L) continue;
      float* yr = k.y + ((row0 + t) * H + head) * P + pc * 4;
      if (k.vec) {
        *reinterpret_cast<float4*>(yr) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (pc * 4 + kk < P) yr[kk] = acc[i][kk];
      }
    }
  }
}

// Blocks [0, n_scan) are scan blocks, the rest state blocks (one chunk).
template <int TQ>
__global__ void __launch_bounds__(MAX_THREADS, TQ == 64 ? 2 : 1) ssd_chunk(Scan k) {
  extern __shared__ __align__(16) char smem[];
  const Layout lo = layout(k.L, k.P, k.N, TQ, k.hg, blockDim.x);
  const int idx = blockIdx.x;
  if (idx < k.n_scan)
    scan_block<TQ>(k, idx, smem, lo);
  else
    state_block(k, idx - k.n_scan, smem, lo);
}

// Stage 1 on its own (several chunks).
__global__ void __launch_bounds__(MAX_THREADS) ssd_state(Scan k) {
  extern __shared__ __align__(16) char smem[];
  // let the pass's blocks start
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // (the state blocks' part of the layout does not depend on the row tile)
  const Layout lo = layout(k.L, k.P, k.N, 16, k.hg, blockDim.x);
  state_block(k, blockIdx.x, smem, lo);
}

// Stage 2: the chain over the chunks, one thread per (batch, head, p, n).
__global__ void __launch_bounds__(PASS_THREADS) ssd_pass(Scan k) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // sc and dec are stage 1's
  const int64_t hpn = (int64_t)k.H * k.P * k.N, total = k.B * hpn;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = e / hpn, hp = e % hpn, head = hp / ((int64_t)k.P * k.N);
    float h = k.h0 != nullptr ? k.h0[e] : 0.f;
    for (int c = 0; c < k.nc; ++c) {
      const int64_t bc = b * k.nc + c;
      k.hin[bc * hpn + hp] = h;
      h = fmaf(h, k.dec[bc * k.H + head], k.sc[bc * hpn + hp]);
    }
    k.hT[e] = h;
  }
}

// Raises a kernel's dynamic shared-memory limit to `bytes` the first time a
// launch needs more than it was granted.
cudaError_t allow_smem(void (*kernel)(Scan), int bytes, int* granted) {
  if (bytes <= *granted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

cudaError_t launch(void (*kernel)(Scan), const Scan& k, int blocks, int threads, int smem,
                   cudaStream_t stream, bool dependent) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, k);
}

}  // namespace

// The plan (tq rows a scan block, hg heads a block, threads a block) comes
// from the host (kernels/_lib.py mamba_plan).  sc [B,nc,H,P,N], dec
// [B,nc,H] and hin [B,nc,H,P,N] are the launcher's workspaces, used when
// S > L (else null).  vec: P % 4 == 0 and x, y 16-byte aligned.  h0 may be
// null: the scan then starts from a zero state.
extern "C" int mamba_scan(const float* x, const float* dt, const float* a, const float* bm,
                          const float* c, const float* h0, float* y, float* hT, float* sc,
                          float* dec, float* hin, int B, int S, int H, int P, int N, int L,
                          int tq, int hg, int threads, int vec, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > MAX_L || S < L || S % L || P < 1 || P > MAX_P ||
      256 % P || N < 1 || N > MAX_N || (tq != 16 && tq != 32 && tq != 64) || hg < 1 ||
      threads < 32 || threads > MAX_THREADS || threads % 32 || (vec && P % 4))
    return (int)cudaErrorInvalidValue;
  const int nc = S / L;
  if (nc > 1 && (sc == nullptr || dec == nullptr || hin == nullptr))
    return (int)cudaErrorInvalidValue;
  const Layout lo = layout(L, P, N, tq, hg, threads);
  if (lo.units > threads || lo.units_s > threads || lo.total > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  Scan k{x, dt, a, bm, c, h0, y, hT, sc, dec, hin, B, S, H, P, N, L, nc, hg,
         (H + hg - 1) / hg, (L + tq - 1) / tq, 0, vec};
  void (*chunk_kernel)(Scan) = tq == 16 ? ssd_chunk<16> : tq == 32 ? ssd_chunk<32> : ssd_chunk<64>;
  // the dynamic shared memory opted into so far: ssd_chunk by tq, then ssd_state
  static int granted[4] = {48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024};
  cudaError_t err = allow_smem(chunk_kernel, lo.total, &granted[tq / 32]);
  if (err == cudaSuccess && nc > 1) err = allow_smem(ssd_state, lo.state_total, &granted[3]);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  const int scan_blocks = k.rtiles * B * nc * k.groups, state_blocks = B * nc * k.groups;
  if (nc == 1) {  // one launch: scan blocks and state blocks side by side
    k.n_scan = scan_blocks;
    err = launch(chunk_kernel, k, scan_blocks + state_blocks, threads, lo.total, st, false);
  } else {
    err = launch(ssd_state, k, state_blocks, threads, lo.state_total, st, false);
    if (err == cudaSuccess) {
      const int64_t need = ((int64_t)B * H * P * N + PASS_THREADS - 1) / PASS_THREADS;
      const int blocks = (int)(need < PASS_BLOCKS ? need : PASS_BLOCKS);
      err = launch(ssd_pass, k, blocks, PASS_THREADS, 0, st, true);
    }
    if (err == cudaSuccess) {
      k.n_scan = scan_blocks;
      err = launch(chunk_kernel, k, scan_blocks, threads, lo.total, st, true);
    }
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
