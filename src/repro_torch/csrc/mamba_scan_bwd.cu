// The backward of the Mamba-2 chunked SSD scan (csrc/mamba_scan.cu) for
// Hopper (sm_90a): chunk-parallel, its products on the tensor cores in
// 3xTF32, three launches.
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
// N 16, L 256) ~26 GFLOP (per causal pair and head dy_t . x_s and the r sum
// over P, dB and dC over N; G once a pair): 0.40 ms on float32 FMAs at 67
// TFLOP/s; on the tensor cores in 3xTF32, three products each at 495
// TFLOP/s, 0.16 ms; against ~0.42 GB of inputs and outputs, 0.13 ms.  What
// bounds it in practice: mma.sync's latency (~60 cycles for a TF32
// m16n8k8) and the issue slots of the hi/lo split around each product, at
// 16 warps an SM (the registers of 3xTF32 fragments allow no more).
//
// Numerics.  Every product runs on the tensor cores as
// mma.sync.m16n8k8.tf32 in 3xTF32: each operand is split into a TF32 high
// part (its low 13 mantissa bits masked off) and the float32 residual,
// which the tensor core reads as TF32, and hi.hi + hi.lo + lo.hi go into
// float32 accumulators (~2^-20 of each product's size; one TF32 product
// would keep ~2^-10).  cum stays float64 (as the forward keeps it), s > t
// is masked before the exp, dcum's reverse prefix sums are float64, and no
// sum uses float atomics: each is taken in a fixed order, so a rerun gives
// the same bits.
//
// Design.  Three launches on one stream:
//   1. bwd_state, one block (8 warps) a (batch row, pair of heads), over the
//      chunks in reverse: cum (float64; written out with dt, by chunk and
//      head, for the chunk blocks), dS = sum_t exp(cum[t]) dy_t C_t^T (A =
//      dy^T, B = C scaled as its fragments are read), then dh_out of the
//      chunk (written), the decay term exp(cum[L-1]) <dh_out, h_in> and
//      dh_in, the state kept in the accumulators' layout; dh0 at the end;
//   2. bwd_chunk, one block (16 warps) a (row tile of 64 steps s, batch
//      row, chunk, group of HG <= 2 heads): the heads' x rows, B and their
//      dh_out stay in shared memory; the t tiles from the row tile's own on
//      are walked, each tile's dy (both heads) and C staged in two buffers,
//      the next tile in flight while the current one is used.  Per t tile G
//      = C B^T once for the block's heads; per head M = dy x^T, then in its
//      accumulators E (masked before the exp), K = G E (to shared memory),
//      Q, the rows and columns of W = G Q off the diagonal (lane shuffles in
//      a fixed tree) and the sum of Q over the block's heads; then r += K^T
//      dy.  After the tile's heads, dC += Qsum B and dB += Qsum^T C: one
//      product for all the heads.  r starts from the state term dh_out B_s;
//      the carried state's terms (dy h_in) are added on the tile's own
//      steps (with two heads and N <= 16, both heads' small products -- the
//      carry and dB's state term -- at once, on the two halves of the
//      warps).  Two barriers a head and tile.  dx and the direct part of ddt
//      are written at the end, with the tile's own rows of dcum; dB, dC and
//      the rows of dcum are per-block partials, each element written by one
//      block;
//   3. bwd_reduce: a block a head, a warp a (batch row, chunk), sums its rows
//      of dcum, takes their reverse prefix sum in float64, finishes ddt and
//      sums da (the warps' parts in a fixed order); the other blocks sum the
//      partials of dB (over head groups) and dC (over head groups and the
//      row tiles at or before the step's), 8 threads an element, then in a
//      fixed order.
// Tiles reach shared memory by the TMA (cp.async.bulk, one copy a row of
// the group's heads or a contiguous block, completing on an mbarrier) where
// P and N are multiples of 8, else by 4-byte cp.async.  The x, dy, K and
// Qsum tiles are padded to a row stride of 8 mod 32 floats, so that every
// fragment of the big products is read without bank conflicts, along rows
// as a float2 or down columns.  The heads a block (HG) comes from the host's
// plan (kernels/_lib.py mamba_bwd_plan); the workspaces are the launcher's
// (kernels/mamba_scan_bwd.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_L = 256, MAX_P = 64, MAX_N = 32;
constexpr int R = 64;              // steps a row tile (s) and a t tile of the chunk blocks
constexpr int RS = 32;             // steps a tile of the state blocks
constexpr int TS = 72;             // row stride (floats) of the K / Qsum tile: 8 mod 32
constexpr int CHUNK_THREADS = 512, STATE_THREADS = 256, REDUCE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Bwd {
  const float *x, *dt, *a, *bm, *c, *hin, *dy, *dht;
  float *dx, *ddt, *da, *dbm, *dc, *dh0;
  float* dho;    // [B,nc,H,P,N] dh_out of each chunk
  double* cumw;  // [B,nc,H,L] cum of each chunk and head
  float* dtw;    // [B,nc,H,L] dt of each chunk and head
  float* dterm;  // [B,nc,H] exp(cum[L-1]) <dh_out, h_in>
  float* rowp;   // [B*nc, rt, H, L] the chunk blocks' rows of dcum
  float* dbp;    // [groups, B*S, N] their dB
  float* dcp;    // [B*nc, rt, groups, L, N] their dC
  int B, S, H, P, N, L, nc, rt, groups, p8, n8;
  int bulk;      // rows of x, dy, B, C and the states copied by the TMA (16-byte rows)
};

__host__ __device__ inline int up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// ---------------------------------------------------------------------------
// staging: TMA bulk copies (or cp.async) into padded shared tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(saddr(bar)));
}
// The phase's one arrival, with the bytes its copies will bring.
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [0, rows) of a tile (row stride ds floats) whose row r holds `heads`
// segments of cols8 floats, segment hh at dst + r ds + hh cols8, from src +
// r ld + hh ncols (ncols floats a segment): rows < nrows of segments < live
// copied, the rest zero.  Bulk (ncols == cols8, a multiple of 4, 16-byte
// aligned rows): one TMA copy a row of live segments, issued by the thread
// (lead + row) % nthreads, or, with `block`, one copy of the nrows rows
// (ds == ld == cols8) by the thread lead; the zero rows and segments by
// plain stores, fenced for the async proxy; the bytes are the caller's to
// expect on bar.  Else 4-byte cp.async with zero fill, by every thread.
__device__ void stage(float* dst, int ds, const float* src, int64_t ld, int rows, int nrows,
                      int heads, int live, int ncols, int cols8, bool bulk, bool block,
                      uint64_t* bar, int lead, int nthreads) {
  const int tid = threadIdx.x, per = heads * cols8;
  if (!bulk) {
    for (int e = tid; e < rows * per; e += nthreads) {
      const int r = e / per, hh = e % per / cols8, cc = e % cols8;
      const bool ok = r < nrows && hh < live && cc < ncols;
      cp_async4(dst + r * ds + hh * cols8 + cc, ok ? src + r * ld + hh * ncols + cc : src, ok);
    }
    return;
  }
  if (live > 0) {
    if (block) {
      if (tid == lead && nrows > 0) bulk_copy(dst, src, 4u * nrows * ncols, bar);
    } else {
      for (int r = (tid - lead + nthreads) % nthreads; r < nrows; r += nthreads)
        bulk_copy(dst + r * ds, src + r * ld, 4u * live * ncols, bar);
    }
  }
  if (nrows < rows || live < heads) {
    for (int e = tid; e < rows * per; e += nthreads) {
      const int r = e / per, hh = e % per / cols8;
      if (r >= nrows || hh >= live) dst[r * ds + e % per] = 0.f;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 mma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[j] += A B_j over k in [0, kend) (a multiple of 8) for n-tiles j < non,
// in 3xTF32: hi.hi into d, the two cross terms into an accumulator of its
// own (two independent chains a tile: an mma's latency is ~60 cycles),
// added to d at the end.  la(k0, a) gives the warp's A fragment at depth k0,
// lb(j, k0, b0, b1) the B fragment of n-tile j.  Accumulator element e of a
// tile: row g + 8 (e >> 1), column 2 tig + (e & 1) (g = lane / 4, tig = lane
// % 4).
template <int NT, class LA, class LB>
__device__ __forceinline__ void mma3(float (&d)[NT][4], int kend, int non, LA la, LB lb) {
  float c[NT][4] = {};
#pragma unroll 2
  for (int k0 = 0; k0 < kend; k0 += 8) {
    float af[4];
    la(k0, af);
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(af[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < non) {
        float b0, b1;
        lb(j, k0, b0, b1);
        uint32_t bh0, bl0, bh1, bl1;
        split(b0, bh0, bl0);
        split(b1, bh1, bl1);
        mma_tf32(c[j], al, bh0, bh1);
        mma_tf32(c[j], ah, bl0, bl1);
        mma_tf32(d[j], ah, bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] += c[j][e];
}

// Fragment reads from shared tiles, as offsets from the shared base sm,
// for a row stride st (8 mod 32 floats where the tile is padded: no bank
// conflicts).  Two orders of depth: Pair ("k-pairs", logical k tig and tig
// + 4 at physical k0 + 2 tig and + 1, a float2 along a row, for products
// whose operands both run along their rows) and the mma's own (tig, tig +
// 4), read one float at a time along rows (Row) or down columns (Col).
// Row's reads have two-way conflicts on a padded tile (its products run
// once a head or tile), as all do on the unpadded [steps x N] tiles.
struct Pair {  // rows r0 + g (+ 8), depth k0 + 2 tig (+ 1)
  int o, o8;
  __device__ __forceinline__ Pair(int base, int r0, int st) {
    const int lane = threadIdx.x & 31;
    o = base + (r0 + (lane >> 2)) * st + 2 * (lane & 3);
    o8 = o + 8 * st;
  }
  __device__ __forceinline__ float2 at(const float* sm, int k0, bool plus8 = false) const {
    return *reinterpret_cast<const float2*>(sm + (plus8 ? o8 : o) + k0);
  }
  __device__ __forceinline__ void a(const float* sm, int k0, float (&f)[4]) const {
    const float2 u = at(sm, k0), v = at(sm, k0, true);
    f[0] = u.x;
    f[1] = v.x;
    f[2] = u.y;
    f[3] = v.y;
  }
  __device__ __forceinline__ void b(const float* sm, int k0, float& b0, float& b1) const {
    const float2 u = at(sm, k0);
    b0 = u.x;
    b1 = u.y;
  }
};
struct Row {  // rows r0 + g (+ 8), depth k0 + tig (+ 4)
  int o, o8;
  __device__ __forceinline__ Row(int base, int r0, int st) {
    const int lane = threadIdx.x & 31;
    o = base + (r0 + (lane >> 2)) * st + (lane & 3);
    o8 = o + 8 * st;
  }
  __device__ __forceinline__ void a(const float* sm, int k0, float (&f)[4]) const {
    f[0] = sm[o + k0];
    f[1] = sm[o8 + k0];
    f[2] = sm[o + k0 + 4];
    f[3] = sm[o8 + k0 + 4];
  }
};
struct Col {  // depth rows k0 + tig (+ 4), column c0 + g (+ 8)
  int o, st;
  __device__ __forceinline__ Col(int base, int c0, int st_) : st(st_) {
    const int lane = threadIdx.x & 31;
    o = base + (lane & 3) * st + c0 + (lane >> 2);
  }
  __device__ __forceinline__ void a(const float* sm, int k0, float (&f)[4]) const {
    const int u = o + k0 * st, v = u + 4 * st;
    f[0] = sm[u];
    f[1] = sm[u + 8];
    f[2] = sm[v];
    f[3] = sm[v + 8];
  }
  __device__ __forceinline__ void b(const float* sm, int k0, float& b0, float& b1) const {
    const int u = o + k0 * st;
    b0 = sm[u];
    b1 = sm[u + 4 * st];
  }
};

// The sums of a warp's accumulator rows over the 4 lanes of a quad: ra
// (row g) and rb (row g + 8) in -> the lane's row total out (row g for
// tig < 2, g + 8 for tig >= 2).
__device__ __forceinline__ float quad_rows(float ra, float rb) {
  const bool hi = threadIdx.x & 2;
  float v = hi ? rb : ra;
  v += __shfl_xor_sync(FULL, hi ? ra : rb, 2);
  return v + __shfl_xor_sync(FULL, v, 1);
}

// ---------------------------------------------------------------------------
// launch 1: dS, dh_out, the decay terms and dh0
// ---------------------------------------------------------------------------

// One (batch row, pair of heads) a block, its chunks in reverse.  Warp w
// takes head w / 4 of the pair and rows p in [16 (w % 4), +16) of its dS
// and running state, n-tiles 0 .. n8/8.  Tiles of 32 steps: a dy row holds
// both heads (one TMA copy, as they lie side by side in device memory, row
// stride SW), C rows one contiguous copy; two buffers, the next in flight.
// Warps 0 and 4 load the next chunk's dt of their head into registers while
// the current one runs, and scan it.
constexpr int SH = 2;                            // heads a state block
constexpr int SW = SH * MAX_P + 8;               // row stride of its dy tiles
__global__ void __launch_bounds__(STATE_THREADS) bwd_state(Bwd k) {
  __shared__ float ef[SH][MAX_L];
  __shared__ __align__(16) float tiles_s[2 * RS * SW + 2 * RS * MAX_N];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ float red[STATE_THREADS / 32];
  const int H = k.H, P = k.P, N = k.N, L = k.L, nc = k.nc, p8 = k.p8, n8 = k.n8;
  const int pairs = (H + SH - 1) / SH, h0 = blockIdx.x % pairs * SH, b = blockIdx.x / pairs;
  const int live = imin(SH, H - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int hh = warp >> 2, head = h0 + hh, pm = 16 * (warp & 3), nn = n8 / 8;
  const int tiles = (L + RS - 1) / RS;
  const bool on = hh < live && pm < p8, bulk = k.bulk;
  const int64_t own = ((int64_t)b * H + head) * P * N;
  const float ah = hh < live ? k.a[head] : 0.f;
  float* const sm = tiles_s;

  float dh[4][4], ds[4][4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = pm + g + 8 * (e >> 1), n = 8 * jj + 2 * q + (e & 1);
      dh[jj][e] = k.dht != nullptr && on && jj < nn && p < P && n < N ? k.dht[own + p * N + n]
                                                                          : 0.f;
    }
  if (tid == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float dtn[MAX_L / 32];  // warps 0 and 4: the next chunk's dt of their head, lane + 32 i
  const bool scanner = (warp & 3) == 0 && hh < live;
  auto load_dt = [&](int cc) {
    const int64_t c0 = (int64_t)b * k.S + (int64_t)cc * L;
#pragma unroll
    for (int i = 0; i < MAX_L / 32; ++i) {
      const int t = lane + 32 * i;
      dtn[i] = t < L ? k.dt[(c0 + t) * H + head] : 0.f;
    }
  };
  if (scanner) load_dt(nc - 1);
  __syncthreads();
  auto issue = [&](int flat) {  // tile flat % tiles of chunk nc - 1 - flat / tiles
    const int cc = nc - 1 - flat / tiles, t0 = flat % tiles * RS, nr = imin(RS, L - t0);
    const int64_t r0 = (int64_t)b * k.S + (int64_t)cc * L + t0;
    float* dyt = sm + (flat & 1) * RS * SW;
    float* ct = sm + 2 * RS * SW + (flat & 1) * RS * MAX_N;
    if (bulk && tid == 0) bar_expect(&bars[flat & 1], 4u * nr * (live * P + N));
    stage(dyt, SW, k.dy + (r0 * H + h0) * P, (int64_t)H * P, RS, nr, SH, live, P, p8, bulk, false,
          &bars[flat & 1], 0, STATE_THREADS);
    stage(ct, n8, k.c + r0 * N, N, RS, nr, 1, 1, N, n8, bulk, true, &bars[flat & 1], RS,
          STATE_THREADS);
    cp_commit();
  };
  auto land = [&](int flat) {  // tile flat in, for every thread
    if (bulk)
      bar_wait(&bars[flat & 1], (flat >> 1) & 1);
    else
      cp_wait_all();
    __syncthreads();
  };
  issue(0);
  for (int cc = nc - 1; cc >= 0; --cc) {
    const int64_t bc = (int64_t)b * nc + cc;
    __syncthreads();  // the previous chunk's cum and ef have been read
    if (scanner) {  // cum: the float64 prefix sum of the float32 products dt a
      const int64_t w = (bc * H + head) * L;  // cum and dt, also for the chunk blocks
      double carry = 0.0;
#pragma unroll
      for (int i = 0; i < MAX_L / 32; ++i) {
        const int t = lane + 32 * i;
        if (32 * i < L) {
          double v = t < L ? (double)(dtn[i] * ah) : 0.0;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const double o = __shfl_up_sync(FULL, v, off);
            if (lane >= off) v += o;
          }
          ef[hh][t] = t < L ? expf((float)(carry + v)) : 0.f;  // 0 past L
          if (t < L) {
            k.cumw[w + t] = carry + v;
            k.dtw[w + t] = dtn[i];
          }
          carry += __shfl_sync(FULL, v, 31);
        }
      }
      if (cc > 0) load_dt(cc - 1);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[jj][e] = 0.f;
    for (int i = 0; i < tiles; ++i) {
      const int flat = (nc - 1 - cc) * tiles + i, t0 = i * RS;
      land(flat);  // this tile (and cum, ef) in; the other buffers read
      if (flat + 1 < nc * tiles) issue(flat + 1);
      if (on) {  // dS += dy^T (exp(cum) C): both down their rows t
        const int dyb = (flat & 1) * RS * SW + hh * p8, cb = 2 * RS * SW + (flat & 1) * RS * MAX_N;
        const Col a_dy(dyb, pm, SW);
        const Col b_c[4] = {Col(cb, 0, n8), Col(cb, 8, n8), Col(cb, 16, n8), Col(cb, 24, n8)};
        const float* e2 = ef[hh] + t0 + q;
        mma3<4>(ds, up(imin(RS, L - t0), 8), nn, [&](int k0, float(&af)[4]) { a_dy.a(sm, k0, af); },
                [&](int j, int k0, float& b0, float& b1) {
                  b_c[j].b(sm, k0, b0, b1);
                  b0 *= e2[k0];
                  b1 *= e2[k0 + 4];
                });
      }
    }
    // dh_out of chunk cc, the decay term, then dh_in
    const float dec = hh < live ? ef[hh][L - 1] : 0.f;  // exp(cum[L-1])
    const int64_t base = (bc * H + head) * P * N;
    float part = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = pm + g + 8 * (e >> 1), n = 8 * jj + 2 * q + (e & 1);
        if (on && jj < nn && p < P && n < N) {
          part = fmaf(dh[jj][e], k.hin[base + p * N + n], part);
          k.dho[base + p * N + n] = dh[jj][e];
        }
        dh[jj][e] = fmaf(dh[jj][e], dec, ds[jj][e]);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (tid < live) {  // the head's four warps, in order
      float s = 0.f;
      for (int w = 0; w < 4; ++w) s += red[4 * tid + w];
      k.dterm[bc * H + h0 + tid] = ef[tid][L - 1] * s;
    }
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = pm + g + 8 * (e >> 1), n = 8 * jj + 2 * q + (e & 1);
      if (on && jj < nn && p < P && n < N) k.dh0[own + p * N + n] = dh[jj][e];
    }
}

// ---------------------------------------------------------------------------
// launch 2: the chunk blocks
// ---------------------------------------------------------------------------

// Float offsets into a chunk block's dynamic shared memory (the float64
// prefix sums and the barriers first).  x and dy tiles hold the group's
// heads side by side in a row (xw = HG p8 + 8 floats: 8 mod 32 at P = 64),
// as they lie side by side in device memory; B, C and the states are
// unpadded ([64][n8], [p8][n8]), each one contiguous block.
struct Layout {
  int xw;       // row stride of the x and dy tiles
  int cum;      // [hg][MAX_L] float64 prefix sums (2 floats each)
  int bars;     // 3 mbarriers: the block's inputs, dy / C buffer 0 and 1
  int dts;      // [hg][MAX_L] dt
  int xs;       // [R][xw] x rows of the s tile
  int dys;      // [2][R][xw] dy rows of a t tile
  int ks;       // [R][TS] K of one head, then Qsum of the tile
  int bs;       // [R][n8] B rows of the s tile
  int cts;      // [2][R][n8] C rows of a t tile
  int hs;       // [hg][p8][n8] dh_out of each head, then h_in
  int rowpart;  // [4][R] a head's row sums of W, by column block
  int carryp;   // [hg][4][R] the carry terms, by n-tile
  int xfer;     // [R][n8] the second head's dB state term and carry (2 heads, N <= 16)
  int rdiag;    // [hg][R] the rows of dcum on the tile's own steps
  int vs;       // [hg][R] V_s
  int vsum;     // [4]
  int part;     // [4][hg][R] V, then ddt's parts, by column block
  int colacc;   // [4][hg][R] the column sums of W, by row block
  int total;    // floats
};

__host__ __device__ inline Layout layout(int hg, int p8, int n8) {
  Layout o;
  o.xw = hg * p8 + 8;
  o.cum = 0;
  o.bars = o.cum + 2 * hg * MAX_L;
  o.dts = o.bars + 8;
  o.xs = o.dts + hg * MAX_L;
  o.dys = o.xs + R * o.xw;
  o.ks = o.dys + 2 * R * o.xw;
  o.bs = o.ks + R * TS;
  o.cts = o.bs + R * n8;
  o.hs = o.cts + 2 * R * n8;
  o.rowpart = o.hs + hg * p8 * n8;
  o.carryp = o.rowpart + 4 * R;
  o.xfer = o.carryp + 4 * hg * R;
  o.rdiag = o.xfer + R * n8;
  o.vs = o.rdiag + hg * R;
  o.vsum = o.vs + hg * R;
  o.part = o.vsum + 4;
  o.colacc = o.part + 4 * hg * R;
  o.total = o.colacc + 4 * hg * R;
  return o;
}

// Warp w: rows [16 (w % 4), +16) of every 64-row product; columns [16 (w /
// 4), +16) (two n-tiles) of the [64 x 64] ones (G, M and K, r) and n-tile
// w / 4 of the [64 x N] ones (dB, dC, the state terms), where it exists.
template <int HG>
__global__ void __launch_bounds__(CHUNK_THREADS, 1) bwd_chunk(Bwd k) {
  extern __shared__ __align__(16) float sm[];
  const int L = k.L, P = k.P, N = k.N, H = k.H, p8 = k.p8, n8 = k.n8;
  const bool bulk = k.bulk;
  const Layout lo = layout(HG, p8, n8);
  const int xw = lo.xw;
  double* cum = reinterpret_cast<double*>(sm + lo.cum);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + lo.bars);
  float* dts = sm + lo.dts;
  float* rowpart = sm + lo.rowpart;
  float* carryp = sm + lo.carryp;
  float* xfer = sm + lo.xfer;
  float* rdiag = sm + lo.rdiag;
  float* vs = sm + lo.vs;
  float* vsum = sm + lo.vsum;
  float* part = sm + lo.part;
  float* colacc = sm + lo.colacc;

  const int nbc = k.B * k.nc, idx = blockIdx.x;
  const int j = idx / (nbc * k.groups), rest = idx % (nbc * k.groups);
  const int grp = rest % k.groups, bc = rest / k.groups, b = bc / k.nc, c = bc % k.nc;
  const int s0 = j * R, ns = imin(R, L - s0), h_first = grp * HG;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int wm = 16 * (warp & 3), wc = warp >> 2;  // row block; column block / n-tile
  const int np_on = imin(2, (p8 - 16 * wc) > 0 ? (p8 - 16 * wc) / 8 : 0);  // r's n-tiles
  const bool n_on = 8 * wc < n8;
  const int sa = wm + g, sb = sa + 8;  // the thread's accumulator rows
  // the lane's column of W after the column reduce (lanes with bit 2 clear keep it)
  const int my_col = 16 * wc + 8 * ((lane >> 4) & 1) + 2 * q + ((lane >> 3) & 1);
  const int64_t row0 = (int64_t)b * k.S + (int64_t)c * L, HP = (int64_t)H * P;
  const int live = imin(HG, H - h_first);
  // two heads and N <= 16: the warps of column blocks 2 and 3 take the
  // second head's small products (its dB state term and carry) while 0 and
  // 1 take the first's; they pass their parts through xfer
  const bool par = HG == 2 && n8 <= 16;
  const int ph = wc >> 1, pn = wc & 1;  // that head and n-tile
  const bool p_on = par && 8 * pn < n8;
  const int64_t st0 = ((int64_t)bc * H + h_first) * P * N;  // the group's states

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) bar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the block's inputs on bars[0]: x and B rows of the s tile, dh_out; the
  // first t tile's dy and C on bars[1]; h_in (bars[0] again) after the state
  // terms
  const bool bulk_cum = bulk && L % 4 == 0;  // cum and dt rows of 16-byte multiples
  if (bulk && tid == 0)
    bar_expect(&bars[0], 4u * (live * (ns * P + P * N + (bulk_cum ? 3 * L : 0)) + ns * N));
  stage(sm + lo.xs, xw, k.x + ((row0 + s0) * H + h_first) * P, HP, R, ns, HG, live, P, p8, bulk,
        false, &bars[0], 0, CHUNK_THREADS);
  stage(sm + lo.bs, n8, k.bm + (row0 + s0) * N, N, R, ns, 1, 1, N, n8, bulk, true, &bars[0], 64,
        CHUNK_THREADS);
  for (int hh = 0; hh < HG; ++hh)
    stage(sm + lo.hs + hh * p8 * n8, n8, hh < live ? k.dho + st0 + hh * P * N : k.dho, N, p8, P, 1,
          hh < live ? 1 : 0, N, n8, bulk, true, &bars[0], 96 + 32 * hh, CHUNK_THREADS);
  cp_commit();
  // the group's dy rows of t tile kt and its C rows into buffer (kt - j) & 1;
  // ready at bars[1 + buffer], parity ((kt - j) >> 1) & 1
  auto issue = [&](int kt) {
    const int t0 = kt * R, nt = imin(R, L - t0), buf = (kt - j) & 1;
    uint64_t* bar = &bars[1 + buf];
    if (bulk && tid == 0) bar_expect(bar, 4u * nt * (live * P + N));
    stage(sm + lo.dys + buf * R * xw, xw, k.dy + ((row0 + t0) * H + h_first) * P, HP, R, nt, HG,
          live, P, p8, bulk, false, bar, 64 * (kt & 7), CHUNK_THREADS);
    stage(sm + lo.cts + buf * R * n8, n8, k.c + (row0 + t0) * N, N, R, nt, 1, 1, N, n8, bulk, true,
          bar, 64 * (kt & 7) + 32, CHUNK_THREADS);
    cp_commit();
  };
  issue(j);
  if (bulk_cum) {  // cum and dt of each head, from the state blocks
    if (tid >= 160 && tid < 160 + live) {
      const int hh = tid - 160;
      const int64_t w = ((int64_t)bc * H + h_first + hh) * L;
      bulk_copy(reinterpret_cast<float*>(cum + hh * MAX_L),
                reinterpret_cast<const float*>(k.cumw + w), 8u * L, &bars[0]);
      bulk_copy(dts + hh * MAX_L, k.dtw + w, 4u * L, &bars[0]);
    }
    for (int e = live * MAX_L + tid; e < HG * MAX_L; e += CHUNK_THREADS) {  // no head: a = 0
      dts[e] = 0.f;
      cum[e] = 0.0;
    }
  } else {
    for (int e = tid; e < HG * L; e += CHUNK_THREADS) {
      const int hh = e / L, t = e % L, head = h_first + hh;
      const int64_t w = ((int64_t)bc * H + head) * L + t;
      dts[hh * MAX_L + t] = head < H ? k.dtw[w] : 0.f;
      cum[hh * MAX_L + t] = head < H ? k.cumw[w] : 0.0;
    }
  }
  for (int e = tid; e < 4 * HG * R; e += CHUNK_THREADS) colacc[e] = 0.f;
  if (bulk)
    bar_wait(&bars[0], 0);
  else
    cp_wait_all();
  __syncthreads();  // x, B, dh_out, dt and cum in

  // The state terms, before the t tiles: r = exp(cum[L-1] - cum[s]) dh_out
  // B_s (A = B rows, B = dh_out rows p), V_s, and dB += exp(..) dt_s x_s
  // dh_out (A = x rows, B = dh_out down its rows p).
  float r[HG][2][4];
  float db[4] = {};
  const Pair b_pair(lo.bs, wm, n8);
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    const double* cm = cum + hh * MAX_L;
    const int xo = lo.xs + hh * p8, ho = lo.hs + hh * p8 * n8;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) r[hh][jj][e] = 0.f;
    const Pair hp[2] = {Pair(ho, 16 * wc, n8), Pair(ho, 16 * wc + 8, n8)};
    mma3<2>(r[hh], n8, np_on, [&](int k0, float(&af)[4]) { b_pair.a(sm, k0, af); },
            [&](int jj, int k0, float& b0, float& b1) { hp[jj].b(sm, k0, b0, b1); });
    const float esa = sa < ns ? expf((float)(cm[L - 1] - cm[s0 + sa])) : 0.f;
    const float esb = sb < ns ? expf((float)(cm[L - 1] - cm[s0 + sb])) : 0.f;
    float va = 0.f, vb = 0.f;
    const Pair xp(xo, wm, xw);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      r[hh][jj][0] *= esa;
      r[hh][jj][1] *= esa;
      r[hh][jj][2] *= esb;
      r[hh][jj][3] *= esb;
      if (jj < np_on) {
        const float2 xa = xp.at(sm, 16 * wc + 8 * jj), xb = xp.at(sm, 16 * wc + 8 * jj, true);
        va = fmaf(xa.x, r[hh][jj][0], fmaf(xa.y, r[hh][jj][1], va));
        vb = fmaf(xb.x, r[hh][jj][2], fmaf(xb.y, r[hh][jj][3], vb));
      }
    }
    const float v = quad_rows(va, vb);
    if (!(lane & 1)) part[(wc * HG + hh) * R + ((lane & 2) ? sb : sa)] = v;
  }
  // dB's state term, exp(cum[L-1] - cum[s]) dt_s x_s dh_out, a head at a time
  // on the n-tiles' warps, or both heads at once (par)
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    const int hw = par ? ph : hh;  // the head this warp takes
    if (par ? (p_on && hh == 0) : n_on) {
      const double* cm = cum + hw * MAX_L;
      const int xo = lo.xs + hw * p8, ho = lo.hs + hw * p8 * n8, nb = 8 * (par ? pn : wc);
      float tmp[1][4] = {};
      const Row xr(xo, wm, xw);
      const Col hc(ho, nb, n8);
      mma3<1>(tmp, p8, 1, [&](int k0, float(&af)[4]) { xr.a(sm, k0, af); },
              [&](int, int k0, float& b0, float& b1) { hc.b(sm, k0, b0, b1); });
      const float fa = sa < ns ? expf((float)(cm[L - 1] - cm[s0 + sa])) *
                                     dts[hw * MAX_L + s0 + sa] : 0.f;
      const float fb = sb < ns ? expf((float)(cm[L - 1] - cm[s0 + sb])) *
                                     dts[hw * MAX_L + s0 + sb] : 0.f;
      if (par && hw == 1) {
        *reinterpret_cast<float2*>(xfer + sa * n8 + nb + 2 * q) =
            make_float2(fa * tmp[0][0], fa * tmp[0][1]);
        *reinterpret_cast<float2*>(xfer + sb * n8 + nb + 2 * q) =
            make_float2(fb * tmp[0][2], fb * tmp[0][3]);
      } else {
        db[0] = fmaf(fa, tmp[0][0], db[0]);
        db[1] = fmaf(fa, tmp[0][1], db[1]);
        db[2] = fmaf(fb, tmp[0][2], db[2]);
        db[3] = fmaf(fb, tmp[0][3], db[3]);
      }
    }
  }
  __syncthreads();  // V's parts in; dh_out read
  if (par && n_on) {  // the second head's dB state term
    const float2 u = *reinterpret_cast<const float2*>(xfer + sa * n8 + 8 * wc + 2 * q);
    const float2 v = *reinterpret_cast<const float2*>(xfer + sb * n8 + 8 * wc + 2 * q);
    db[0] += u.x;
    db[1] += u.y;
    db[2] += v.x;
    db[3] += v.y;
  }
  if (bulk && tid == 0) bar_expect(&bars[0], 4u * live * P * N);
  for (int hh = 0; hh < HG; ++hh)  // h_in, for the tile's own steps
    stage(sm + lo.hs + hh * p8 * n8, n8, hh < live ? k.hin + st0 + hh * P * N : k.hin, N, p8, P, 1,
          hh < live ? 1 : 0, N, n8, bulk, true, &bars[0], 32 * hh, CHUNK_THREADS);
  cp_commit();
  for (int e = tid; e < HG * R; e += CHUNK_THREADS) {
    const int hh = e / R, s = e % R;
    const float v = part[(0 * HG + hh) * R + s] + part[(1 * HG + hh) * R + s] +
                    part[(2 * HG + hh) * R + s] + part[(3 * HG + hh) * R + s];
    vs[e] = s < ns ? v * dts[hh * MAX_L + s0 + s] : 0.f;
  }
  __syncthreads();
  if (warp < HG) {  // V summed over the tile, a warp a head (a fixed tree)
    float v = vs[warp * R + lane] + vs[warp * R + 32 + lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    if (lane == 0) vsum[warp] = v;
  }
  if (bulk) bar_wait(&bars[0], 1);  // h_in (the first tile's barrier publishes it)

  // The t tiles; the heads of a tile share its dy and C buffers.
  const Col k_col(lo.ks, wm, TS);  // K, Qsum down their rows t (A of r and dB)
  const Row q_row(lo.ks, wm, TS);  // Qsum along its rows t (A of dC)
  const Col b_col(lo.bs, 8 * wc, n8);
  // The carried state on the row tile's own steps (t0 = s0), head hh,
  // n-tile nb: hd = exp(cum[t]) dy_t h_in, its carry terms C_t . hd_t into
  // carryp, hd itself into dcacc or, for the second head in par, into xfer.
  auto carry = [&](int hh, int nb, int dyt, int cto, float (&dcacc)[1][4]) {
    const double* cm = cum + hh * MAX_L;
    float hd[1][4] = {};
    const Row dy_row(dyt + hh * p8, wm, xw);
    const Col hc(lo.hs + hh * p8 * n8, 8 * nb, n8);
    mma3<1>(hd, p8, 1, [&](int k0, float(&af)[4]) { dy_row.a(sm, k0, af); },
            [&](int, int k0, float& b0, float& b1) { hc.b(sm, k0, b0, b1); });
    const float ea = sa < ns ? expf((float)cm[s0 + sa]) : 0.f;
    const float eb = sb < ns ? expf((float)cm[s0 + sb]) : 0.f;
    hd[0][0] *= ea;
    hd[0][1] *= ea;
    hd[0][2] *= eb;
    hd[0][3] *= eb;
    const Pair c_pair(cto, wm, n8);
    const float2 ca = c_pair.at(sm, 8 * nb), cb = c_pair.at(sm, 8 * nb, true);
    const float v = quad_rows(fmaf(ca.x, hd[0][0], ca.y * hd[0][1]),
                              fmaf(cb.x, hd[0][2], cb.y * hd[0][3]));
    if (!(lane & 1)) carryp[(hh * 4 + nb) * R + ((lane & 2) ? sb : sa)] = v;
    if (par && hh == 1) {
      *reinterpret_cast<float2*>(xfer + sa * n8 + 8 * nb + 2 * q) = make_float2(hd[0][0], hd[0][1]);
      *reinterpret_cast<float2*>(xfer + sb * n8 + 8 * nb + 2 * q) = make_float2(hd[0][2], hd[0][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dcacc[0][e] += hd[0][e];
    }
  };
  for (int kt = j; kt < k.rt; ++kt) {
    const int t0 = kt * R, nt = imin(R, L - t0), buf = (kt - j) & 1;
    const bool diag = kt == j;
    const int cto = lo.cts + buf * R * n8, dyt = lo.dys + buf * R * xw;
    if (bulk)
      bar_wait(&bars[1 + buf], ((kt - j) >> 1) & 1);
    else
      cp_wait_all();
    __syncthreads();  // dy and C of this tile in; the other buffers and K free
    if (kt + 1 < k.rt) issue(kt + 1);
    float gr[2][4] = {}, qs[2][4] = {}, dcacc[1][4] = {};
    {  // G = C B^T, once for the block's heads
      const Pair c_pair(cto, wm, n8);
      const Pair bp[2] = {Pair(lo.bs, 16 * wc, n8), Pair(lo.bs, 16 * wc + 8, n8)};
      mma3<2>(gr, n8, 2, [&](int k0, float(&af)[4]) { c_pair.a(sm, k0, af); },
              [&](int jj, int k0, float& b0, float& b1) { bp[jj].b(sm, k0, b0, b1); });
    }
    if (diag && p_on) carry(ph, pn, dyt, cto, dcacc);  // both heads at once
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const int head = h_first + hh;
      const bool live_h = head < H;
      const double* cm = cum + hh * MAX_L;
      const float* dtv = dts + hh * MAX_L;
      const int dyo = dyt + hh * p8;
      if (hh > 0) __syncthreads();  // the last head's K has been read
      if (diag && !par && n_on) carry(hh, wc, dyt, cto, dcacc);
      // M = dy x^T, then E, K, Q and W in its accumulators
      float m[2][4] = {};
      {
        const Pair dy_pair(dyo, wm, xw);
        const int xo = lo.xs + hh * p8;
        const Pair xp[2] = {Pair(xo, 16 * wc, xw), Pair(xo, 16 * wc + 8, xw)};
        mma3<2>(m, p8, 2, [&](int k0, float(&af)[4]) { dy_pair.a(sm, k0, af); },
                [&](int jj, int k0, float& b0, float& b1) { xp[jj].b(sm, k0, b0, b1); });
      }
      const double cta = cm[imin(t0 + sa, L - 1)], ctb = cm[imin(t0 + sb, L - 1)];
      float ra = 0.f, rb = 0.f, cw[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int sl = 16 * wc + 8 * jj + 2 * q;
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int s = sl + e1, sg = s0 + s;
          const double cs = cm[imin(sg, L - 1)];
          const float dts_ = dtv[imin(sg, L - 1)];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int e = 2 * e2 + e1, tl = e2 ? sb : sa, tg = t0 + tl;
            const bool keep = tl < nt && s < ns && sg <= tg;  // masked before the exp
            const float ee =
                __expf(keep ? (float)((e2 ? ctb : cta) - cs) : __int_as_float(0xff800000));
            const float qv = ee * dts_ * m[jj][e];
            const float wv = sg < tg ? gr[jj][e] * qv : 0.f;  // the diagonal enters neither side
            m[jj][e] = gr[jj][e] * ee;                         // K
            qs[jj][e] += qv;
            if (e2) {
              rb += wv;
              cw[2 * jj + e1] += wv;
            } else {
              ra += wv;
              cw[2 * jj + e1] = wv;
            }
          }
        }
        *reinterpret_cast<float2*>(sm + lo.ks + sa * TS + sl) = make_float2(m[jj][0], m[jj][1]);
        *reinterpret_cast<float2*>(sm + lo.ks + sb * TS + sl) = make_float2(m[jj][2], m[jj][3]);
      }
      {  // W's rows over the quad, its columns over the 8 rows of lanes (a fixed tree)
        const float v = quad_rows(ra, rb);
        if (!(lane & 1)) rowpart[wc * R + ((lane & 2) ? sb : sa)] = v;
        const bool b4 = lane & 16, b3 = lane & 8;
        float k0v = b4 ? cw[2] : cw[0], k1v = b4 ? cw[3] : cw[1];
        k0v += __shfl_xor_sync(FULL, b4 ? cw[0] : cw[2], 16);
        k1v += __shfl_xor_sync(FULL, b4 ? cw[1] : cw[3], 16);
        float cv = b3 ? k1v : k0v;
        cv += __shfl_xor_sync(FULL, b3 ? k0v : k1v, 8);
        cv += __shfl_xor_sync(FULL, cv, 4);
        if (!(lane & 4)) colacc[((warp & 3) * HG + hh) * R + my_col] += cv;
      }
      __syncthreads();  // K, the row sums and the carry terms in
      {  // r += K^T dy (both down their rows t)
        const Col dyc[2] = {Col(dyo, 16 * wc, xw), Col(dyo, 16 * wc + 8, xw)};
        mma3<2>(r[hh], up(nt, 8), np_on, [&](int k0, float(&af)[4]) { k_col.a(sm, k0, af); },
                [&](int jj, int k0, float& b0, float& b1) { dyc[jj].b(sm, k0, b0, b1); });
      }
      if (tid < nt && live_h) {  // the tile's row of dcum (on its own steps: finished at the end)
        float v = rowpart[tid] + rowpart[R + tid] + rowpart[2 * R + tid] + rowpart[3 * R + tid];
        if (diag)
          for (int u = 0; u < n8 / 8; ++u) v += carryp[(hh * 4 + u) * R + tid];
        if (t0 + tid == L - 1) v += vsum[hh];
        if (diag)
          rdiag[hh * R + tid] = v;
        else
          k.rowp[(((int64_t)bc * k.rt + j) * H + head) * L + t0 + tid] = v;
      }
    }
    // the tile's dC and dB, once for the heads: from their sum of Q
    __syncthreads();  // every warp's K has been read
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int sl = 16 * wc + 8 * jj + 2 * q;
      *reinterpret_cast<float2*>(sm + lo.ks + sa * TS + sl) = make_float2(qs[jj][0], qs[jj][1]);
      *reinterpret_cast<float2*>(sm + lo.ks + sb * TS + sl) = make_float2(qs[jj][2], qs[jj][3]);
    }
    __syncthreads();
    if (n_on) {
      if (diag && par) {  // the second head's carry
        const float2 u = *reinterpret_cast<const float2*>(xfer + sa * n8 + 8 * wc + 2 * q);
        const float2 v = *reinterpret_cast<const float2*>(xfer + sb * n8 + 8 * wc + 2 * q);
        dcacc[0][0] += u.x;
        dcacc[0][1] += u.y;
        dcacc[0][2] += v.x;
        dcacc[0][3] += v.y;
      }
      mma3<1>(dcacc, up(ns, 8), 1, [&](int k0, float(&af)[4]) { q_row.a(sm, k0, af); },
              [&](int, int k0, float& b0, float& b1) { b_col.b(sm, k0, b0, b1); });
      float* out = k.dcp + ((((int64_t)bc * k.rt + j) * k.groups + grp) * L + t0) * N;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = (e >> 1) ? sb : sa, n = 8 * wc + 2 * q + (e & 1);
        if (tl < nt && n < N) out[tl * N + n] = dcacc[0][e];
      }
      float dbt[1][4] = {{db[0], db[1], db[2], db[3]}};
      const Col c_col(cto, 8 * wc, n8);
      mma3<1>(dbt, up(nt, 8), 1, [&](int k0, float(&af)[4]) { k_col.a(sm, k0, af); },
              [&](int, int k0, float& b0, float& b1) { c_col.b(sm, k0, b0, b1); });
#pragma unroll
      for (int e = 0; e < 4; ++e) db[e] = dbt[0][e];
    }
  }

  // dx, the direct part of ddt (x_s . r_s) and the tile's own rows of dcum
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    const int head = h_first + hh;
    const Pair xp(lo.xs + hh * p8, wm, xw);
    const float* dtv = dts + hh * MAX_L + s0;
    float va = 0.f, vb = 0.f;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int p = 16 * wc + 8 * jj + 2 * q;
      if (jj < np_on) {
        const float2 xa = xp.at(sm, 16 * wc + 8 * jj), xb = xp.at(sm, 16 * wc + 8 * jj, true);
        va = fmaf(xa.x, r[hh][jj][0], fmaf(xa.y, r[hh][jj][1], va));
        vb = fmaf(xb.x, r[hh][jj][2], fmaf(xb.y, r[hh][jj][3], vb));
        if (head < H) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int sl = h2 ? sb : sa;
            if (sl >= ns || p >= P) continue;
            float* out = k.dx + ((row0 + s0 + sl) * H + head) * P + p;
            const float d0 = dtv[sl] * r[hh][jj][2 * h2], d1 = dtv[sl] * r[hh][jj][2 * h2 + 1];
            if ((P & 1) == 0)
              *reinterpret_cast<float2*>(out) = make_float2(d0, d1);
            else {
              out[0] = d0;
              if (p + 1 < P) out[1] = d1;
            }
          }
        }
      }
    }
    const float v = quad_rows(va, vb);
    if (!(lane & 1)) part[(wc * HG + hh) * R + ((lane & 2) ? sb : sa)] = v;
  }
  if (n_on) {  // the tile's dB, summed over the group's heads
    float* out = k.dbp + ((int64_t)grp * k.B * k.S + row0 + s0) * N;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int sl = (e >> 1) ? sb : sa, n = 8 * wc + 2 * q + (e & 1);
      if (sl < ns && n < N) out[sl * N + n] = db[e];
    }
  }
  __syncthreads();
  for (int e = tid; e < HG * R; e += CHUNK_THREADS) {
    const int hh = e / R, s = e % R, head = h_first + hh;
    if (head < H && s < ns) {
      const float cv = colacc[(0 * HG + hh) * R + s] + colacc[(1 * HG + hh) * R + s] +
                       colacc[(2 * HG + hh) * R + s] + colacc[(3 * HG + hh) * R + s];
      k.rowp[(((int64_t)bc * k.rt + j) * H + head) * L + s0 + s] = rdiag[e] - cv - vs[e];
      k.ddt[(row0 + s0 + s) * H + head] = part[(0 * HG + hh) * R + s] +
                                          part[(1 * HG + hh) * R + s] +
                                          part[(2 * HG + hh) * R + s] +
                                          part[(3 * HG + hh) * R + s];
    }
  }
}

// ---------------------------------------------------------------------------
// launch 3: the reduce
// ---------------------------------------------------------------------------

// Blocks [0, H): ddt and da of one head, a warp a (batch row, chunk).  The
// rest: 32 elements of dB and dC each, 8 threads an element.  Loads are
// unrolled so that several are in flight; the sums keep their order.
__global__ void __launch_bounds__(REDUCE_THREADS) bwd_reduce(Bwd k) {
  constexpr int WARPS = REDUCE_THREADS / 32, RT = MAX_L / R;
  __shared__ double sda[WARPS];
  __shared__ float sdb[WARPS][32], sdc[WARPS][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, L = k.L, H = k.H;
  if (blockIdx.x < H) {
    const int head = blockIdx.x, per = (L + 31) / 32;  // steps a lane: lane * per ..
    const float ah = k.a[head];
    double da = 0.0;
    for (int bc = warp; bc < k.B * k.nc; bc += WARPS) {
      const int64_t row0 = (int64_t)(bc / k.nc) * k.S + (int64_t)(bc % k.nc) * L;
      const float* rows = k.rowp + ((int64_t)bc * k.rt * H + head) * L;
      float dcum[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = lane * per + i;
        dcum[i] = 0.f;
        if (i < per && t < L) {
#pragma unroll
          for (int jj = 0; jj < RT; ++jj)
            if (jj <= t / R) dcum[i] += rows[(int64_t)jj * H * L + t];
          if (t == L - 1) dcum[i] += k.dterm[(int64_t)bc * H + head];
        }
      }
      double v[8];
      double tot = 0.0;
#pragma unroll
      for (int i = 7; i >= 0; --i) {  // the lane's steps, reverse inclusive sums
        tot += dcum[i];
        v[i] = tot;
      }
      double after = tot;  // the sum over this lane's steps and every later lane's
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_down_sync(FULL, after, off);
        if (lane + off < 32) after += o;
      }
      after = __shfl_down_sync(FULL, after, 1);
      if (lane == 31) after = 0.0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = lane * per + i;
        if (i < per && t < L) {
          const double dla = v[i] + after;
          const int64_t at = (row0 + t) * H + head;
          k.ddt[at] += (float)dla * ah;
          da += dla * (double)k.dt[at];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) da += __shfl_xor_sync(FULL, da, off);
    if (lane == 0) sda[warp] = da;
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      for (int w = 0; w < WARPS; ++w) s += sda[w];
      k.da[head] = (float)s;
    }
    return;
  }
  const int64_t total = (int64_t)k.B * k.S * k.N, e = (int64_t)(blockIdx.x - H) * 32 + lane;
  float db = 0.f, dc = 0.f;
  if (e < total) {
    const int64_t step = e / k.N, b = step / k.S;
    const int n = (int)(e % k.N), s = (int)(step % k.S), t = s % L;
    const int64_t bc = b * k.nc + s / L, gstride = (int64_t)L * k.N;
#pragma unroll 8
    for (int g = warp; g < k.groups; g += WARPS) db += k.dbp[g * total + e];
    for (int jj = 0; jj <= t / R; ++jj) {
      const float* src = k.dcp + ((bc * k.rt + jj) * k.groups * L + t) * k.N + n;
#pragma unroll 8
      for (int g = warp; g < k.groups; g += WARPS) dc += src[g * gstride];
    }
  }
  sdb[warp][lane] = db;
  sdc[warp][lane] = dc;
  __syncthreads();
  if (tid < 32 && e < total) {
    float sb = 0.f, sc = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      sb += sdb[w][tid];
      sc += sdc[w][tid];
    }
    k.dbm[e] = sb;
    k.dc[e] = sc;
  }
}

}  // namespace

// hg (heads a chunk block, 1 or 2) comes from the host (kernels/_lib.py
// mamba_bwd_plan); dho, cumw, dtw, dterm, rowp, dbp and dcp are the
// launcher's workspaces, sized as the Bwd struct says.  dht may be null (zeros).
extern "C" int mamba_scan_bwd(const float* x, const float* dt, const float* a, const float* bm,
                              const float* c, const float* hin, const float* dy, const float* dht,
                              float* dx, float* ddt, float* da, float* dbm, float* dc, float* dh0,
                              float* dho, double* cumw, float* dtw, float* dterm, float* rowp,
                              float* dbp, float* dcp, int B, int S, int H, int P, int N, int L,
                              int hg, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > MAX_L || S < L || S % L || P < 1 || P > MAX_P || N < 1 ||
      N > MAX_N || (hg != 1 && hg != 2))
    return (int)cudaErrorInvalidValue;
  const int nc = S / L, rt = (L + R - 1) / R, groups = (H + hg - 1) / hg;
  // the TMA copies whole 16-byte rows from 16-byte aligned addresses: P and
  // N multiples of 8 (no zero columns), aligned tensors
  const int bulk = P % 8 == 0 && N % 8 == 0 &&
                   ((uintptr_t)x | (uintptr_t)bm | (uintptr_t)c | (uintptr_t)hin |
                    (uintptr_t)dy | (uintptr_t)dho) % 16 == 0;
  Bwd k{x,   dt,    a,    bm,   c,   hin, dy, dht, dx, ddt, da, dbm, dc,       dh0,      dho,
        cumw, dtw, dterm, rowp, dbp, dcp, B,  S,   H,  P,   N,  L,   nc,  rt, groups, up(P, 8),
        up(N, 8), bulk};
  const int smem = 4 * layout(hg, k.p8, k.n8).total;
  void (*chunk)(Bwd) = hg == 1 ? bwd_chunk<1> : bwd_chunk<2>;
  static int granted[2] = {48 * 1024, 48 * 1024};  // by hg: 1, 2
  int& have = granted[hg - 1];
  if (smem > have) {
    const cudaError_t err =
        cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    have = smem;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t elems = (int64_t)B * S * N;
  bwd_state<<<B * ((H + SH - 1) / SH), STATE_THREADS, 0, st>>>(k);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    chunk<<<rt * B * nc * groups, CHUNK_THREADS, smem, st>>>(k);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    bwd_reduce<<<H + (int)((elems + 31) / 32), REDUCE_THREADS, 0, st>>>(k);
    err = cudaGetLastError();
  }
  return (int)err;
}
