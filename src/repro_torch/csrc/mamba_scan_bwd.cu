// The backward of the Mamba-2 chunked SSD scan (csrc/mamba_scan.cu) for
// Hopper (sm_90a): chunk-parallel, in the forward's three stages run the
// other way, plus a reduce.
//
// Replaces no TPU kernel: the JAX package trains through XLA's autodiff of
// ssd_chunked (repro/models/ssm.py:94), and the Pallas scan
// (repro/kernels/mamba_scan.py) has no backward.  The port's training path
// needs one on the card (kernels/ops.py _MambaScanTrain); its plain version
// is kernels/ref.py mamba_scan_bwd_ref, whose docstring has the math.  Per
// (batch row, chunk, head), with cum the inclusive prefix sum of dt * a over
// the chunk's L steps, E[t,s] = exp(cum[t] - cum[s]) for s <= t, G = C B^T:
//   dh_in  = exp(cum[L-1]) dh_out + sum_t exp(cum[t]) dy_t C_t^T  (chunks in
//            reverse; dh_out of the last chunk = dh_t; dh0 = dh_in of chunk 0)
//   r_s    = sum_{t>=s} G[t,s] E[t,s] dy_t + exp(cum[L-1] - cum[s]) dh_out B_s
//   dx_s   = dt_s r_s,  ddt_s = x_s . r_s + dla_s a
//   Q[t,s] = E[t,s] dt_s (dy_t . x_s),  dC_t = sum_s Q B_s + exp(cum[t]) h_in^T dy_t,
//   dB_s   = sum_t Q C_t + exp(cum[L-1] - cum[s]) dt_s dh_out^T x_s (both over heads)
//   dcum_t = sum_{s<t} G Q[t,s] - sum_{t'>t} G Q[t',t] - V_t
//            + exp(cum[t]) dy_t . h_in C_t
//            + [t = L-1] (sum_s V_s + exp(cum[L-1]) <dh_out, h_in>),
//   V_s = exp(cum[L-1] - cum[s]) dt_s x_s . dh_out B_s; dla = its reverse
//   prefix sum in the chunk, da = sum dla dt.  The diagonal pair G Q[t,t]
//   would enter dcum_t on both sides and cancel; at a large dt it is by far
//   the largest term, and float32 sums that held it would keep its rounding
//   (~1e-3 on ddt, ~5e-3 of da's scale, against a float64 truth), so it
//   enters neither.
// x, dy, dx [B,S,H,P], dt, ddt [B,S,H], a, da [H], B/C, dB/dC [B,S,N],
// h_in [B,nc,H,P,N], dh_t (or null: zeros), dh0 [B,H,P,N]; all float32.
//
// Bound on an H100: at Jamba's training shape (B 2, S 1024, H 256, P 64,
// N 16, L 256) the float32 operations, ~26 GFLOP (per causal pair and head
// dy_t . x_s and the r sum over P, dB and dC over N; G once a pair), 0.39 ms
// at 67 TFLOP/s, against ~0.46 GB of inputs and outputs, 0.14 ms.
//
// Design.  Four launches on one stream:
//   1. bwd_state, one block a (batch row, chunk, head): cum in float64 (as
//      the forward keeps it), the chunk decay exp(cum[L-1]) and dS =
//      sum_t exp(cum[t]) dy_t C_t^T;
//   2. bwd_pass, one block a (batch row, head), a thread a few state
//      elements: over the chunks in reverse, dh_out of each chunk (written
//      over its dS), the decay term exp(cum[L-1]) <dh_out, h_in> (a block
//      sum in a fixed order), and dh0;
//   3. bwd_chunk, one block a (row tile of 64 steps s, batch row, chunk,
//      group of HG heads): the heads' x rows stay in shared memory; the
//      steps t >= the tile's first s are walked in tiles of 64, and each
//      tile's G = C_t B_s^T is built once, in registers, for the block's
//      heads.  Per head and tile a thread owns 4 t x 4 s pairs: their
//      dy_t . x_s, then E (s > t masked BEFORE the exp, which would
//      overflow there), K = G E, Q and W = G Q off the diagonal go to
//      shared memory, the rows of W are summed across the 16 lanes that
//      share them and its columns by 4 lanes a step s; then r (4 s x 4
//      channels a thread, in registers for every head of the group), dB (a
//      thread a step and 4 state columns) and dC of the tile's t (the same,
//      summed over the group's heads) take their products from K, Q, dy, C
//      and B.  r starts from the state term; the carried state's terms are
//      added on the tile's own steps.  dx and the direct part of ddt are
//      written at the end, with the tile's own rows of dcum (their row
//      sums less their column sums and V); dB, dC and the rows of dcum are
//      per-block partials, each element written by one block;
//   4. bwd_reduce: a block a head sums its rows of dcum in a fixed order,
//      takes their reverse prefix sum over each chunk in float64, finishes
//      ddt and sums da over the batch rows and chunks; the other blocks sum
//      the partials of dB (over head groups) and dC (over head groups and
//      the row tiles at or before the step's).
// No float atomics anywhere, so a rerun gives the same bits.  The heads a
// block (HG) comes from the host's plan (kernels/_lib.py mamba_bwd_plan);
// the workspaces are the launcher's (kernels/mamba_scan_bwd.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_L = 256, MAX_P = 64, MAX_N = 32;
constexpr int R = 64;         // steps a row tile (s) and a t tile hold
constexpr int KP = R + 4;     // row stride of the K, Q and W tiles
constexpr int THREADS = 256;  // every kernel's block
constexpr int SMS = 132;

struct Bwd {
  const float *x, *dt, *a, *bm, *c, *hin, *dy, *dht;
  float *dx, *ddt, *da, *dbm, *dc, *dh0;
  float* ds;     // [B,nc,H,P,N]: dS, then dh_out (the pass writes over it)
  float* dec;    // [B,nc,H] exp(cum[L-1])
  float* dterm;  // [B,nc,H] exp(cum[L-1]) <dh_out, h_in>
  float* rowp;   // [B*nc, rt, H, L] the chunk blocks' rows of dcum
  float* dbp;    // [groups, B*S, N] their dB
  float* dcp;    // [B*nc, rt, groups, L, N] their dC
  int B, S, H, P, N, L, nc, rt, hg, groups, p4, n4, xp;
};

__host__ __device__ inline int up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Byte offsets into a chunk block's dynamic shared memory.
struct Layout {
  int cum;    // [hg][L] float64 prefix sums
  int dts;    // [hg][L] dt
  int xs;     // [hg][R][xp] x rows of the tile
  int bs;     // [R][n4] B rows of the tile
  int ct;     // [R][n4] C rows of the t tile
  int dys;    // [R][xp] dy rows of the t tile, one head
  int kq;     // [3][R][KP] K, Q and W; before the t tiles dh_out [p4][n4] and its transpose
  int hin;    // [p4][n4] h_in of one head
  int hd;     // [R][n4] exp(cum[t]) h_in^T dy_t
  int vs, rdiag;        // [hg][R] V_s; the rows of dcum on the tile's own steps
  int carry, vsum;      // [R], [hg]
  int total;
};

__host__ __device__ inline Layout layout(int L, int hg, int p4, int n4) {
  Layout o;
  const int xp = p4 + 4;
  o.cum = 0;
  o.dts = up(8 * hg * L, 16);
  o.xs = o.dts + up(4 * hg * L, 16);
  o.bs = o.xs + 4 * hg * R * xp;
  o.ct = o.bs + 4 * R * n4;
  o.dys = o.ct + 4 * R * n4;
  o.kq = o.dys + 4 * R * xp;
  o.hin = o.kq + 4 * 3 * R * KP;
  o.hd = o.hin + 4 * p4 * n4;
  o.vs = o.hd + 4 * R * n4;
  o.rdiag = o.vs + 4 * hg * R;
  o.carry = o.rdiag + 4 * hg * R;
  o.vsum = o.carry + 4 * R;
  o.total = o.vsum + 16;
  return o;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The sum over the 16 lanes that share bit 4 of the lane id (a fixed tree).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// cum[hh * L + s] = the inclusive float64 prefix sum over s < L of the
// float32 products dts[hh * L + s] * a[head], one warp a head (the forward's
// cum_scan).
__device__ void cum_scan(const float* dts, const float* a, int h_first, int nh, int H, int L,
                         double* cum) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int hh = warp; hh < nh; hh += blockDim.x >> 5) {
    const int head = h_first + hh;
    const float ah = head < H ? __ldg(a + head) : 0.f;
    double carry = 0.0;
    for (int s0 = 0; s0 < L; s0 += 32) {
      const int s = s0 + lane;
      double v = s < L ? (double)(dts[hh * L + s] * ah) : 0.0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += o;
      }
      if (s < L) cum[hh * L + s] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
}

// Launch 1: the chunk decay and dS of one (batch row, chunk, head).
__global__ void __launch_bounds__(THREADS) bwd_state(Bwd k) {
  __shared__ double cum[MAX_L];
  __shared__ float dts[MAX_L], ef[MAX_L];
  __shared__ __align__(16) float dys[R * MAX_P];
  __shared__ __align__(16) float cs[R * MAX_N];
  const int head = blockIdx.x % k.H, bc = blockIdx.x / k.H, b = bc / k.nc, c = bc % k.nc;
  const int L = k.L, P = k.P, N = k.N, PN = P * N, H = k.H, tid = threadIdx.x;
  const int64_t row0 = (int64_t)b * k.S + (int64_t)c * L;
  for (int t = tid; t < L; t += THREADS) dts[t] = k.dt[(row0 + t) * H + head];
  __syncthreads();
  cum_scan(dts, k.a, head, 1, H, L, cum);
  __syncthreads();
  for (int t = tid; t < L; t += THREADS) ef[t] = expf((float)cum[t]);
  if (tid == 0) k.dec[(int64_t)bc * H + head] = expf((float)cum[L - 1]);
  float acc[8] = {};  // state element tid + THREADS * i (P * N <= 2048)
  for (int t0 = 0; t0 < L; t0 += R) {
    const int nt = imin(R, L - t0);
    __syncthreads();
    for (int e = tid; e < nt * P; e += THREADS) {
      const int tl = e / P, p = e % P;
      dys[e] = k.dy[((row0 + t0 + tl) * H + head) * P + p] * ef[t0 + tl];
    }
    for (int e = tid; e < nt * N; e += THREADS) cs[e] = k.c[(row0 + t0) * N + e];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + THREADS * i;
      if (e < PN) {
        const int p = e / N, n = e % N;
        float v = acc[i];
        for (int tl = 0; tl < nt; ++tl) v = fmaf(dys[tl * P + p], cs[tl * N + n], v);
        acc[i] = v;
      }
    }
  }
  float* out = k.ds + ((int64_t)bc * H + head) * PN;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = tid + THREADS * i;
    if (e < PN) out[e] = acc[i];
  }
}

// Launch 2: the states' gradient over the chunks in reverse, one (batch
// row, head) a block.
__global__ void __launch_bounds__(THREADS) bwd_pass(Bwd k) {
  __shared__ float red[THREADS / 32];
  const int head = blockIdx.x % k.H, b = blockIdx.x / k.H, H = k.H, PN = k.P * k.N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t own = ((int64_t)b * H + head) * PN;
  float dh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = tid + THREADS * i;
    dh[i] = e < PN && k.dht != nullptr ? k.dht[own + e] : 0.f;
  }
  for (int c = k.nc - 1; c >= 0; --c) {
    const int64_t bc = (int64_t)b * k.nc + c, base = (bc * H + head) * PN;
    const float dec = k.dec[bc * H + head];
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + THREADS * i;
      if (e < PN) {
        part = fmaf(dh[i], k.hin[base + e], part);
        const float s = k.ds[base + e];
        k.ds[base + e] = dh[i];  // dh_out of chunk c
        dh[i] = fmaf(dh[i], dec, s);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) s += red[w];
      k.dterm[bc * H + head] = dec * s;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = tid + THREADS * i;
    if (e < PN) k.dh0[own + e] = dh[i];
  }
}

// Launch 3: one row tile of steps s, for HG heads.  Thread roles: pairs
// (rows 4 pt.. of the t tile x rows 4 ps.. of the s tile), r (rows 4 rs.. x
// channels 4 rp..), and dB / dC units (a row and 4 state columns, two a
// thread at most).
template <int HG>
__global__ void __launch_bounds__(THREADS, 1) bwd_chunk(Bwd k) {
  extern __shared__ __align__(16) char smem[];
  const int L = k.L, P = k.P, N = k.N, H = k.H, p4 = k.p4, n4 = k.n4, xp = k.xp, nq4 = n4 / 4;
  const Layout lo = layout(L, HG, p4, n4);
  double* cum = reinterpret_cast<double*>(smem + lo.cum);
  float* dts = reinterpret_cast<float*>(smem + lo.dts);
  float* xs = reinterpret_cast<float*>(smem + lo.xs);
  float* bs = reinterpret_cast<float*>(smem + lo.bs);
  float* ct = reinterpret_cast<float*>(smem + lo.ct);
  float* dys = reinterpret_cast<float*>(smem + lo.dys);
  float* ks = reinterpret_cast<float*>(smem + lo.kq);
  float* qs = ks + R * KP;
  float* ws = qs + R * KP;
  float* rdiag = reinterpret_cast<float*>(smem + lo.rdiag);
  float* hin = reinterpret_cast<float*>(smem + lo.hin);
  float* hd = reinterpret_cast<float*>(smem + lo.hd);
  float* vs = reinterpret_cast<float*>(smem + lo.vs);
  float* carry = reinterpret_cast<float*>(smem + lo.carry);
  float* vsum = reinterpret_cast<float*>(smem + lo.vsum);

  const int nbc = k.B * k.nc, idx = blockIdx.x;
  const int j = idx / (nbc * k.groups), rest = idx % (nbc * k.groups);
  const int g = rest % k.groups, bc = rest / k.groups, b = bc / k.nc, c = bc % k.nc;
  const int s0 = j * R, ns = imin(R, L - s0), h_first = g * HG, tid = threadIdx.x;
  const int64_t row0 = (int64_t)b * k.S + (int64_t)c * L;
  const int pt = tid >> 4, ps = tid & 15;  // pair roles
  const int rs = tid >> 4, rp = tid & 15;  // r roles
  const bool r_on = 4 * rp < p4;
  const int cs_ = tid >> 2, cpart = tid & 3;  // column roles: step s, rows cpart * 16 ..

  for (int e = tid; e < HG * L; e += THREADS) {
    const int hh = e / L, t = e % L, head = h_first + hh;
    dts[e] = head < H ? k.dt[(row0 + t) * H + head] : 0.f;
  }
  for (int e = tid; e < R * n4; e += THREADS) {
    const int sl = e / n4, n = e % n4;
    bs[e] = sl < ns && n < N ? k.bm[(row0 + s0 + sl) * N + n] : 0.f;
  }
  for (int e = tid; e < HG * R * p4; e += THREADS) {
    const int hh = e / (R * p4), sl = e / p4 % R, p = e % p4, head = h_first + hh;
    xs[(hh * R + sl) * xp + p] =
        head < H && sl < ns && p < P ? k.x[((row0 + s0 + sl) * H + head) * P + p] : 0.f;
  }
  __syncthreads();
  cum_scan(dts, k.a, h_first, HG, H, L, cum);

  // The state terms, before the t tiles: r = exp(cum[L-1] - cum[s]) dh_out
  // B_s, dB += exp(..) dt_s dh_out^T x_s, and the tile's sum of V_s.
  float r[HG][4][4];
  float col[HG] = {};  // this thread's part of the column sums of W at step cs_
  float db[2][4] = {};
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    const int head = h_first + hh;
    const bool live = head < H;
    float* dho = ks;              // [p4][n4]
    float* dhot = ks + p4 * n4;   // [n4][xp]
    __syncthreads();  // cum is built; the previous head's dh_out has been read
    const float* src = k.ds + ((int64_t)bc * H + head) * P * N;
    for (int e = tid; e < p4 * n4; e += THREADS) {
      const int p = e / n4, n = e % n4;
      const float v = live && p < P && n < N ? src[p * N + n] : 0.f;
      dho[e] = v;
      dhot[n * xp + p] = v;
    }
    __syncthreads();
    const double* cm = cum + hh * L;
    const float* xh = xs + hh * R * xp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sl = 4 * rs + i;
      float acc[4] = {};
      if (r_on && sl < ns) {
        const float es = expf((float)(cm[L - 1] - cm[s0 + sl]));
        for (int n = 0; n < N; ++n) {
          const float bv = bs[sl * n4 + n];
          const float4 d4 = ld4(dhot + n * xp + 4 * rp);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc[kk] = fmaf(bv, at(d4, kk), acc[kk]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc[kk] *= es;
      }
      float v = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        r[hh][i][kk] = acc[kk];
        if (r_on) v = fmaf(xh[sl * xp + 4 * rp + kk], acc[kk], v);
      }
      v = sum16(v);
      if (rp == 0) vs[hh * R + sl] = sl < ns ? v * dts[hh * L + s0 + sl] : 0.f;
    }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int u = tid + THREADS * ii, row = u / nq4, q = u % nq4;
      if (row < ns) {
        const float f = expf((float)(cm[L - 1] - cm[s0 + row])) * dts[hh * L + s0 + row];
        float acc[4] = {};
        for (int p = 0; p < P; ++p) {
          const float xv = xh[row * xp + p];
          const float4 d4 = ld4(dho + p * n4 + 4 * q);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc[kk] = fmaf(xv, at(d4, kk), acc[kk]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) db[ii][kk] = fmaf(f, acc[kk], db[ii][kk]);
      }
    }
    __syncthreads();
    if (tid == 0) {
      float v = 0.f;
      for (int sl = 0; sl < R; ++sl) v += vs[hh * R + sl];
      vsum[hh] = v;
    }
  }

  for (int kt = j; kt < k.rt; ++kt) {
    const int t0 = kt * R, nt = imin(R, L - t0);
    const bool diag = kt == j;
    __syncthreads();  // the last tile's C, dy, K and Q have been read
    for (int e = tid; e < R * n4; e += THREADS) {
      const int tl = e / n4, n = e % n4;
      ct[e] = tl < nt && n < N ? k.c[(row0 + t0 + tl) * N + n] : 0.f;
    }
    __syncthreads();
    float gr[4][4] = {};  // G[t][s] of this thread's pairs, for every head
    for (int n = 0; n < n4; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cv[i] = ld4(ct + (4 * pt + i) * n4 + n);
        bv[i] = ld4(bs + (4 * ps + i) * n4 + n);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          gr[i][kk] += cv[i].x * bv[kk].x + cv[i].y * bv[kk].y + cv[i].z * bv[kk].z +
                       cv[i].w * bv[kk].w;
    }
    float dcr[2][4] = {};

#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const int head = h_first + hh;
      const bool live = head < H;
      const double* cm = cum + hh * L;
      const float* dtv = dts + hh * L;
      const float* xh = xs + hh * R * xp;
      __syncthreads();  // dy, K, Q and hd of the previous head have been read
      for (int e = tid; e < R * p4; e += THREADS) {
        const int tl = e / p4, p = e % p4;
        dys[tl * xp + p] =
            live && tl < nt && p < P ? k.dy[((row0 + t0 + tl) * H + head) * P + p] : 0.f;
      }
      if (diag) {
        const float* src = k.hin + ((int64_t)bc * H + head) * P * N;
        for (int e = tid; e < p4 * n4; e += THREADS) {
          const int p = e / n4, n = e % n4;
          hin[e] = live && p < P && n < N ? src[p * N + n] : 0.f;
        }
      }
      __syncthreads();
      if (diag) {  // the carried state on the tile's own steps
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int u = tid + THREADS * ii, row = u / nq4, q = u % nq4;
          if (row < nt) {
            float acc[4] = {};
            for (int p = 0; p < P; ++p) {
              const float dv = dys[row * xp + p];
              const float4 h4 = ld4(hin + p * n4 + 4 * q);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) acc[kk] = fmaf(dv, at(h4, kk), acc[kk]);
            }
            const float et = expf((float)cm[t0 + row]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              dcr[ii][kk] = fmaf(et, acc[kk], dcr[ii][kk]);
              hd[row * n4 + 4 * q + kk] = et * acc[kk];
            }
          } else if (row < R) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) hd[row * n4 + 4 * q + kk] = 0.f;
          }
        }
        __syncthreads();
        if (tid < R) {
          float v = 0.f;
          for (int n = 0; n < N; ++n) v = fmaf(ct[tid * n4 + n], hd[tid * n4 + n], v);
          carry[tid] = v;
        }
      }
      // the pairs: M = dy_t . x_s, then K, Q and the rows of G Q
      float m[4][4] = {};
      for (int p = 0; p < p4; p += 4) {
        float4 dv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i] = ld4(dys + (4 * pt + i) * xp + p);
          xv[i] = ld4(xh + (4 * ps + i) * xp + p);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            m[i][kk] += dv[i].x * xv[kk].x + dv[i].y * xv[kk].y + dv[i].z * xv[kk].z +
                        dv[i].w * xv[kk].w;
      }
      float wrow[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tl = 4 * pt + i, t = t0 + tl;
        float kv[4], qv[4], wv[4], w = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int sl = 4 * ps + kk, s = s0 + sl;
          kv[kk] = qv[kk] = wv[kk] = 0.f;
          if (tl < nt && sl < ns && s <= t) {  // masked before the exp
            const float e = expf((float)(cm[t] - cm[s]));
            kv[kk] = gr[i][kk] * e;
            qv[kk] = e * dtv[s] * m[i][kk];
            if (s < t) wv[kk] = gr[i][kk] * qv[kk];  // the diagonal enters neither side
            w += wv[kk];
          }
        }
        *reinterpret_cast<float4*>(ks + tl * KP + 4 * ps) = make_float4(kv[0], kv[1], kv[2], kv[3]);
        *reinterpret_cast<float4*>(qs + tl * KP + 4 * ps) = make_float4(qv[0], qv[1], qv[2], qv[3]);
        *reinterpret_cast<float4*>(ws + tl * KP + 4 * ps) = make_float4(wv[0], wv[1], wv[2], wv[3]);
        wrow[i] = sum16(w);
      }
      __syncthreads();  // K, Q, W and the carry terms are in
      if (ps == 0 && live) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tl = 4 * pt + i, t = t0 + tl;
          if (tl < nt) {
            float v = wrow[i];
            if (diag) v += carry[tl];
            if (t == L - 1) v += vsum[hh];
            if (diag)  // written at the end, less its column sum and V
              rdiag[hh * R + tl] = v;
            else
              k.rowp[(((int64_t)bc * k.rt + j) * H + head) * L + t] = v;
          }
        }
      }
      for (int tl = cpart * (R / 4); tl < imin(nt, (cpart + 1) * (R / 4)); ++tl)
        col[hh] += ws[tl * KP + cs_];
      if (r_on) {  // r += K^T dy
        for (int tl = 0; tl < nt; ++tl) {
          const float4 kv = ld4(ks + tl * KP + 4 * rs);
          const float4 dv = ld4(dys + tl * xp + 4 * rp);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) r[hh][i][kk] = fmaf(at(kv, i), at(dv, kk), r[hh][i][kk]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int u = tid + THREADS * ii, row = u / nq4, q = u % nq4;
        if (row < R) {
          for (int tl = 0; tl < nt; ++tl) {  // dB += Q^T C
            const float qv = qs[tl * KP + row];
            const float4 cv = ld4(ct + tl * n4 + 4 * q);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) db[ii][kk] = fmaf(qv, at(cv, kk), db[ii][kk]);
          }
          for (int sl = 0; sl < ns; ++sl) {  // dC += Q B
            const float qv = qs[row * KP + sl];
            const float4 bv = ld4(bs + sl * n4 + 4 * q);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) dcr[ii][kk] = fmaf(qv, at(bv, kk), dcr[ii][kk]);
          }
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {  // the tile's dC, summed over the group's heads
      const int u = tid + THREADS * ii, row = u / nq4, q = u % nq4;
      if (row < nt) {
        float* out = k.dcp + ((((int64_t)bc * k.rt + j) * k.groups + g) * L + t0 + row) * N;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (4 * q + kk < N) out[4 * q + kk] = dcr[ii][kk];
      }
    }
  }

  // dx and the direct part of ddt (x_s . r_s); the tile's own rows of dcum
  __syncthreads();  // rdiag is in
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    const int head = h_first + hh;
    const float* xh = xs + hh * R * xp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sl = 4 * rs + i;
      const bool on = head < H && r_on && sl < ns;
      float v = 0.f;
      if (on) {
        const float dtv = dts[hh * L + s0 + sl];
        float* out = k.dx + ((row0 + s0 + sl) * H + head) * P;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int p = 4 * rp + kk;
          v = fmaf(xh[sl * xp + p], r[hh][i][kk], v);
          if (p < P) out[p] = dtv * r[hh][i][kk];
        }
      }
      v = sum16(v);
      if (rp == 0 && head < H && sl < ns) k.ddt[(row0 + s0 + sl) * H + head] = v;
    }
    float cv = col[hh];  // the column sum of W at step cs_, its 4 parts in a fixed order
    cv += __shfl_xor_sync(0xffffffffu, cv, 1);
    cv += __shfl_xor_sync(0xffffffffu, cv, 2);
    if (cpart == 0 && head < H && cs_ < ns)
      k.rowp[(((int64_t)bc * k.rt + j) * H + head) * L + s0 + cs_] =
          rdiag[hh * R + cs_] - cv - vs[hh * R + cs_];
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {  // the tile's dB, summed over the group's heads
    const int u = tid + THREADS * ii, row = u / nq4, q = u % nq4;
    if (row < ns) {
      float* out = k.dbp + ((int64_t)g * k.B * k.S + row0 + s0 + row) * N;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (4 * q + kk < N) out[4 * q + kk] = db[ii][kk];
    }
  }
}

// Launch 4: blocks [0, H) finish ddt and da of one head; the rest sum dB and dC.
__global__ void __launch_bounds__(THREADS) bwd_reduce(Bwd k) {
  __shared__ double sc[THREADS];
  const int tid = threadIdx.x, L = k.L, H = k.H;
  if (blockIdx.x < H) {
    const int head = blockIdx.x;
    const float ah = k.a[head];
    double da = 0.0;
    for (int bc = 0; bc < k.B * k.nc; ++bc) {
      const int64_t row0 = (int64_t)(bc / k.nc) * k.S + (int64_t)(bc % k.nc) * L;
      float dcum = 0.f, ddir = 0.f, dtu = 0.f;
      if (tid < L) {
        for (int jj = 0; jj <= tid / R; ++jj)
          dcum += k.rowp[(((int64_t)bc * k.rt + jj) * H + head) * L + tid];
        ddir = k.ddt[(row0 + tid) * H + head];
        dtu = k.dt[(row0 + tid) * H + head];
        if (tid == L - 1) dcum += k.dterm[(int64_t)bc * H + head];
      }
      sc[tid] = dcum;
      __syncthreads();
      for (int off = 1; off < L; off <<= 1) {  // reverse inclusive prefix sum, float64
        const double o = tid + off < L ? sc[tid + off] : 0.0;
        __syncthreads();
        sc[tid] += o;
        __syncthreads();
      }
      const double dla = sc[tid];
      if (tid < L) k.ddt[(row0 + tid) * H + head] = ddir + (float)dla * ah;
      __syncthreads();
      sc[tid] = tid < L ? dla * dtu : 0.0;
      __syncthreads();
      for (int off = THREADS / 2; off > 0; off >>= 1) {
        if (tid < off) sc[tid] += sc[tid + off];
        __syncthreads();
      }
      if (tid == 0) da += sc[0];
      __syncthreads();
    }
    if (tid == 0) k.da[head] = (float)da;
    return;
  }
  const int64_t total = (int64_t)k.B * k.S * k.N;
  for (int64_t e = (int64_t)(blockIdx.x - H) * THREADS + tid; e < total;
       e += (int64_t)(gridDim.x - H) * THREADS) {
    const int64_t step = e / k.N, b = step / k.S;
    const int n = (int)(e % k.N), s = (int)(step % k.S), t = s % L;
    const int64_t bc = b * k.nc + s / L;
    float db = 0.f, dc = 0.f;
    for (int g = 0; g < k.groups; ++g) db += k.dbp[g * total + e];
    for (int jj = 0; jj <= t / R; ++jj)
      for (int g = 0; g < k.groups; ++g)
        dc += k.dcp[(((bc * k.rt + jj) * k.groups + g) * L + t) * k.N + n];
    k.dbm[e] = db;
    k.dc[e] = dc;
  }
}

}  // namespace

// hg (heads a chunk block, 1, 2 or 4) comes from the host (kernels/_lib.py
// mamba_bwd_plan); ds, dec, dterm, rowp, dbp and dcp are the launcher's
// workspaces, sized as the Bwd struct says.  dht may be null (zeros).
extern "C" int mamba_scan_bwd(const float* x, const float* dt, const float* a, const float* bm,
                              const float* c, const float* hin, const float* dy, const float* dht,
                              float* dx, float* ddt, float* da, float* dbm, float* dc, float* dh0,
                              float* ds, float* dec, float* dterm, float* rowp, float* dbp,
                              float* dcp, int B, int S, int H, int P, int N, int L, int hg,
                              void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > MAX_L || S < L || S % L || P < 1 || P > MAX_P || N < 1 ||
      N > MAX_N || (hg != 1 && hg != 2 && hg != 4))
    return (int)cudaErrorInvalidValue;
  const int nc = S / L, rt = (L + R - 1) / R, groups = (H + hg - 1) / hg;
  const int p4 = up(P, 4), n4 = up(N, 4);
  Bwd k{x,  dt, a,  bm, c,  hin, dy,  dht, dx, ddt, da, dbm, dc, dh0, ds, dec, dterm,
        rowp, dbp, dcp, B, S, H, P, N, L, nc, rt, hg, groups, p4, n4, p4 + 4};
  const Layout lo = layout(L, hg, p4, n4);
  if (lo.total > 227 * 1024) return (int)cudaErrorInvalidValue;
  void (*chunk)(Bwd) = hg == 1 ? bwd_chunk<1> : hg == 2 ? bwd_chunk<2> : bwd_chunk<4>;
  static int granted[3] = {48 * 1024, 48 * 1024, 48 * 1024};  // by hg: 1, 2, 4
  int& have = granted[hg == 1 ? 0 : hg == 2 ? 1 : 2];
  if (lo.total > have) {
    const cudaError_t err =
        cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, lo.total);
    if (err != cudaSuccess) return (int)err;
    have = lo.total;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t elems = (int64_t)B * S * N;
  const int bc_blocks = (int)((elems + THREADS - 1) / THREADS < SMS * 8
                                  ? (elems + THREADS - 1) / THREADS : SMS * 8);
  bwd_state<<<B * nc * H, THREADS, 0, st>>>(k);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    bwd_pass<<<B * H, THREADS, 0, st>>>(k);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    chunk<<<rt * B * nc * groups, THREADS, lo.total, st>>>(k);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    bwd_reduce<<<H + bc_blocks, THREADS, 0, st>>>(k);
    err = cudaGetLastError();
  }
  return (int)err;
}
