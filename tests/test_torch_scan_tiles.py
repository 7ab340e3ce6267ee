"""The algorithms of the port's Mamba scan and monitor kernels, on the CPU.

The CUDA kernels (``csrc/mamba_scan.cu``, ``csrc/rolling_stats.cu``) run only
on the card, where ``chip_smoke.py`` holds them against their plain versions.
Here emulations of their algorithms, kept in this file, are held against the
port's plain versions (``repro_torch.kernels.ref``) and the JAX package, on
inputs made by numpy from a seed:

(a) the chunk-parallel SSD scan: the launch plan (``_lib.mamba_plan``) is
    checked to cover every (batch row, chunk, head, step) exactly once from
    host ints alone; the emulation runs the kernel's three stages over the
    planned blocks -- chunk states with float64 prefix sums, the pass over
    the chunks, and per row tile a G = C B^T built once and shared by the
    block's heads, key tiles past the tile's end never visited, s > t masked
    before the exp; one launch when the prompt is one chunk -- and is held
    against ``mamba_scan_ref`` and the JAX ``ssd_chunked``, with and without
    an initial state;
(b) the segmented monitor: a stream's ticks in super-tiles of 32 segments
    (``rolling_stats.monitor_plan``), the running stats entering each
    segment from a warp scan of Chan's merge (the kernel's shuffle tree),
    carried from lane 31 into the next super-tile, and the window sums
    recomputed at each segment's start from a halo of earlier ticks; held
    against ``rolling_stats_ref`` and the JAX ``rolling_stats_ref``.

Tolerances: the scan ``SCAN_TOL`` atol 5e-4, rtol 5e-3, as the JAX package
holds its own kernel to its oracle (exp of differences of prefix sums summed
in another order); the monitor ``STATS_TOL``: scores atol = rtol = 5e-4 and
the moving average 5e-5, the JAX package's kernel tolerances (incremental
window sums drift from recomputed ones); on episode streams, whose torque
power spikes to ~1e6 at contacts, the moving average's error is held to
5e-5 of its stream's peak, as ``chip_smoke.py`` holds the kernel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.core import kinematics as tkin  # noqa: E402
from repro_torch.core.trigger import TriggerConfig  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.rolling_stats import monitor_plan  # noqa: E402
from repro_torch.robotics.episodes import generate_episode  # noqa: E402

SCAN_TOL = dict(atol=5e-4, rtol=5e-3)
STATS_TOL = (5e-4, 5e-4, 5e-5)
TS = 32  # key steps a weight tile of the scan kernel holds
FLOORS = dict(sigma_floor_acc=1.0, sigma_floor_tau=0.05)


# ---------------------------------------------------------------------------
# (a) the Mamba scan
# ---------------------------------------------------------------------------


def scan_block(plan, i, h):
    """Scan block ``i``: (b * chunks + c, heads, rows [t0, t1)) -- a mirror
    of ``scan_block`` in csrc/mamba_scan.cu."""

    r = plan.row_tiles - 1 - i % plan.row_tiles
    rest = i // plan.row_tiles
    g, bc = rest % plan.groups, rest // plan.groups
    heads = range(g * plan.heads, min(h, (g + 1) * plan.heads))
    return bc, heads, (r * plan.rows, min(plan.chunk, (r + 1) * plan.rows))


def state_block(plan, j, h):
    g, bc = j % plan.groups, j // plan.groups
    return bc, range(g * plan.heads, min(h, (g + 1) * plan.heads))


PLAN_CASES = [  # b, s, h, p, n, chunk
    (1, 14, 256, 64, 16, 256),    # Jamba's served prompt
    (2, 512, 256, 64, 16, 256),
    (1, 4096, 256, 64, 16, 256),
    (1, 128, 2, 16, 4, 64),
    (2, 64, 3, 8, 32, 16),
    (1, 14, 270, 4, 4, 256),      # H not a multiple of the heads a block
    (2, 64, 134, 4, 4, 16),
    (1, 96, 7, 1, 1, 32),
    (3, 200, 5, 2, 3, 100),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", PLAN_CASES)
def test_mamba_plan_covers_every_step_once(b, s, h, p, n, chunk):
    plan = _lib.mamba_plan(b, s, h, p, n, chunk)
    L, nc = plan.chunk, plan.chunks
    assert L == min(chunk, s) and nc * L == s and plan.fused == (nc == 1)
    assert plan.rows in (16, 32, 64) and plan.rows >= min(L, 64)
    assert plan.rows == 64 or plan.row_tiles == 1
    # every (b, c, head, t) exactly once in the scan blocks, (b, c, head) in the state blocks
    i = np.arange(plan.scan_blocks)
    r = plan.row_tiles - 1 - i % plan.row_tiles
    g, bc = (i // plan.row_tiles) % plan.groups, i // plan.row_tiles // plan.groups
    head = g[:, None, None] * plan.heads + np.arange(plan.heads)[None, :, None]
    t = r[:, None, None] * plan.rows + np.arange(plan.rows)[None, None, :]
    keep = (head < h) & (t < L)
    idx = ((bc[:, None, None] * h + head) * L + t)[keep]
    assert np.array_equal(np.bincount(idx, minlength=b * nc * h * L), np.ones(b * nc * h * L))
    j = np.arange(plan.state_blocks)
    head = (j % plan.groups)[:, None] * plan.heads + np.arange(plan.heads)[None, :]
    idx = ((j // plan.groups)[:, None] * h + head)[head < h]
    assert np.array_equal(np.bincount(idx, minlength=b * nc * h), np.ones(b * nc * h))
    # threads: a power of two in [32, 256] covering one head's 4 x 4 tiles
    p4, n4 = -(-p // 4) * 4, -(-n // 4) * 4
    assert plan.threads in (32, 64, 128, 256)
    assert plan.threads >= max(plan.rows // 4 * p4 // 4, p4 // 4 * n4 // 4)
    blocks = plan.scan_blocks + (plan.state_blocks if plan.fused else 0)
    assert plan.heads == 1 or blocks >= _lib.SMS


def test_mamba_plan_takes_host_ints_only():
    with pytest.raises(TypeError, match="host ints"):
        _lib.mamba_plan(1, torch.tensor(14), 256, 64, 16, 256)
    with pytest.raises(ValueError, match="bad shape"):
        _lib.mamba_plan(1, 0, 256, 64, 16, 256)


def _cum(dt, a):
    """Inclusive float64 prefix sum of the float32 products dt * a."""

    return torch.cumsum((dt * a).double(), 0)


def emulate_mamba_scan(x, dt, a, bm, c, h0=None, chunk=256):
    """The kernel's algorithm over its planned blocks, in float32 with
    float64 prefix sums."""

    b, s, h, p = x.shape
    n = bm.shape[-1]
    plan = _lib.mamba_plan(b, s, h, p, n, chunk)
    L, nc = plan.chunk, plan.chunks
    y = torch.full_like(x, float("nan"))
    h_t = torch.full((b, h, p, n), float("nan"))
    sc, dec = torch.zeros((b, nc, h, p, n)), torch.zeros((b, nc, h))

    # stage 1: chunk states (for one chunk, hT itself)
    for j in range(plan.state_blocks):
        bc, heads = state_block(plan, j, h)
        bb, cc = divmod(bc, nc)
        steps = slice(cc * L, (cc + 1) * L)
        for hd in heads:
            cum = _cum(dt[bb, steps, hd], a[hd])
            u = torch.exp((cum[-1] - cum).float()) * dt[bb, steps, hd]
            s_c = torch.zeros((p, n))
            for s0 in range(0, L, TS):
                tile = slice(s0, min(s0 + TS, L))
                s_c += (x[bb, steps, hd][tile] * u[tile, None]).T @ bm[bb, steps][tile]
            d = torch.exp(cum[-1].float())
            if plan.fused:
                h_t[bb, hd] = s_c if h0 is None else h0[bb, hd] * d + s_c
            else:
                sc[bb, cc, hd], dec[bb, cc, hd] = s_c, d

    # stage 2: the pass over the chunks
    h_in = None
    if not plan.fused:
        h_in = torch.zeros((b, nc, h, p, n))
        hc = torch.zeros((b, h, p, n)) if h0 is None else h0.clone()
        for cc in range(nc):
            h_in[:, cc] = hc
            hc = hc * dec[:, cc, :, None, None] + sc[:, cc]
        h_t = hc

    # stage 3: the intra-chunk scan, G once a block; key tiles wholly before
    # the rows take their decay as exp(cum[t] - cum[t0]) exp(cum[t0] - cum[s])
    # where no head of the pass has a rising cum (G, and x scaled by the
    # second factor; the sum scaled by the first at the diagonal tile)
    p4 = -(-p // 4) * 4
    hc = min(plan.heads, plan.threads // (plan.rows // 4 * p4 // 4))  # heads at once
    for i in range(plan.scan_blocks):
        bc, heads, (t0, t1) = scan_block(plan, i, h)
        bb, cc = divmod(bc, nc)
        s_end = t1  # key steps past the tile's last row are never visited
        base = cc * L
        g = c[bb, base + t0 : base + t1] @ bm[bb, base : base + s_end].T  # [rows, s_end]
        tt = torch.arange(t0, t1)
        cums = {hd: _cum(dt[bb, base : base + s_end, hd], a[hd]) for hd in heads}
        for k0 in range(0, len(heads), hc):
            falling = all(bool((dt[bb, base : base + s_end, hd] * a[hd] <= 0).all())
                          for hd in heads[k0 : k0 + hc])
            for hd in heads[k0 : k0 + hc]:
                cum = cums[hd]
                acc = torch.zeros((t1 - t0, p))
                for s0 in range(0, s_end, TS):
                    ss = torch.arange(s0, min(s0 + TS, s_end))
                    xs = x[bb, base + ss, hd]
                    if falling and s0 + TS <= t0:
                        beta = torch.exp((cum[t0] - cum[ss]).float()) * dt[bb, base + ss, hd]
                        acc += g[:, ss] @ (xs * beta[:, None])
                        continue
                    if falling and s0 == t0 and t0 > 0:
                        acc *= torch.exp((cum[tt] - cum[t0]).float())[:, None]
                    keep = ss[None, :] <= tt[:, None]
                    diff = torch.where(keep, cum[tt][:, None] - cum[ss][None, :],
                                       torch.full((len(tt), len(ss)), -1e30,
                                                  dtype=torch.float64))
                    w = torch.where(keep, g[:, ss] * torch.exp(diff.float())
                                    * dt[bb, base + ss, hd], torch.zeros(()))
                    acc += w @ xs
                state = h0[bb, hd] if plan.fused and h0 is not None else (
                    None if plan.fused or (cc == 0 and h0 is None) else h_in[bb, cc, hd])
                if state is not None:
                    acc += torch.exp(cum[tt].float())[:, None] * (c[bb, base + tt] @ state.T)
                y[bb, base + tt, hd] = acc
    return y, h_t


SCAN_CASES = [  # b, s, h, p, n, chunk
    (1, 14, 270, 4, 4, 256),   # L = 14, one chunk (one launch), 4 heads a block, H % 4 = 2
    (1, 16, 6, 8, 4, 16),      # L = 16, one chunk
    (2, 64, 134, 4, 4, 16),    # L = 16, four chunks, 4 heads a block, H % 4 = 2
    (1, 42, 5, 1, 3, 14),      # L = 14, three chunks, P = 1
    (1, 128, 3, 16, 8, 64),    # L = 64, two chunks
    (1, 64, 2, 16, 32, 64),    # L = 64, one chunk, N = 32
    (1, 256, 3, 2, 5, 256),    # L = 256, one chunk: four row tiles
    (1, 512, 2, 8, 4, 256),    # L = 256, two chunks
    (1, 512, 3, 4, 4, 256),    # the same with a head whose decay rises (a > 0)
]


def _scan_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    c = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, c, h0


@pytest.mark.parametrize("oracle", ["torch", "jax"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SCAN_CASES)
def test_mamba_scan_emulation_matches_oracles(b, s, h, p, n, chunk, with_h0, oracle):
    x, dt, a, bm, c, h0 = _scan_inputs(b, s, h, p, n, seed=s + 7 * h + p)
    if (b, s, h, p) == (1, 512, 3, 4):
        a[1] = 0.004  # cum rises on head 1: its tiles keep the one-factor weights
    h0 = h0 if with_h0 else None
    args = [torch.as_tensor(v) for v in (x, dt, a, bm, c)]
    h0_t = None if h0 is None else torch.as_tensor(h0)
    y, h_t = emulate_mamba_scan(*args, h0=h0_t, chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(h_t).all()
    if oracle == "torch":
        want_y, want_h = tref.mamba_scan_ref(*args, h0=h0_t, chunk=chunk)
    else:
        jfn = jax.jit(lambda *v: jssm.ssd_chunked(*v[:5], chunk=chunk, h0=v[5]))
        want_y, want_h = jfn(*map(jnp.asarray, (x, dt, a, bm, c)),
                             None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(want_h), **SCAN_TOL)


# ---------------------------------------------------------------------------
# (b) the segmented monitor
# ---------------------------------------------------------------------------


def _merge(a, b):
    """Chan's merge of Welford triples (n: a host float shared by the
    streams; mean, m2: [N])."""

    if b[0] == 0:
        return a
    if a[0] == 0:
        return b
    n = a[0] + b[0]
    d, f = b[1] - a[1], torch.tensor(b[0] / n, dtype=torch.float32)
    return n, a[1] + d * f, a[2] + b[2] + d * d * a[0] * f


def _welford(st, v, r):
    n, mean, m2 = st
    d = v - mean
    mean = mean + d * r
    return n + 1, mean, m2 + d * (v - mean)


def emulate_rolling_stats(m_acc, tau_pow, *, window_acc, window_tau, sigma_floor_acc,
                          sigma_floor_tau, eps=1e-6):
    """The kernel's algorithm, vectorised over the streams, one loop per lane."""

    num, t_len = m_acc.shape
    wa, wt = window_acc, window_tau
    seg, halo = monitor_plan(t_len, wa, wt)
    span = 32 * seg
    outs = [torch.full((num, t_len), float("nan")) for _ in range(3)]
    zero = torch.zeros(num)
    none = (0, zero, zero)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    carry_a, carry_m = none, none
    for tb in range(0, t_len, span):
        length = min(span, t_len - tb)
        # the staged window: ticks [tb - halo, tb + length)
        assert tb == 0 or halo >= max(wa, wt)
        sl = -(-length // 32)
        lanes = [(min(l * sl, length), min(min(l * sl, length) + sl, length)) for l in range(32)]
        # pass A: m_tau over each segment (the torque window recomputed at
        # its start), and the segment's stats of m_acc and m_tau
        part_a, part_m = [], []
        for k0, k1 in lanes:
            ts = tb + k0
            sa_, sm_ = none, none
            if k0 < k1:
                tsum = zero
                for t in range(max(0, ts - wt), ts):
                    tsum = tsum + tau_pow[:, t]
                for t in range(ts, tb + k1):
                    old = tau_pow[:, t - wt] if t >= wt else zero
                    tsum = tsum + (tau_pow[:, t] - old)
                    m_tau = tsum * (f32(1.0 / wt) if t + 1 >= wt else 1 / f32(t + 1))
                    outs[2][:, t] = m_tau
                    r = 1 / f32(sa_[0] + 1)
                    sa_ = _welford(sa_, m_acc[:, t], r)
                    sm_ = _welford(sm_, m_tau, r)
            part_a.append(sa_)
            part_m.append(sm_)
        # the warp's inclusive shuffle scan, then exclusive
        for off in (1, 2, 4, 8, 16):
            part_a = [_merge(part_a[l - off], part_a[l]) if l >= off else part_a[l]
                      for l in range(32)]
            part_m = [_merge(part_m[l - off], part_m[l]) if l >= off else part_m[l]
                      for l in range(32)]
        enter_a = [_merge(carry_a, part_a[l - 1] if l else none) for l in range(32)]
        enter_m = [_merge(carry_m, part_m[l - 1] if l else none) for l in range(32)]
        carry_a, carry_m = _merge(carry_a, part_a[31]), _merge(carry_m, part_m[31])
        # pass B: the acceleration window recomputed at the segment's start,
        # the running stats from the segment's entry, and the scores
        for (k0, k1), ra, rm in zip(lanes, enter_a, enter_m):
            ts = tb + k0
            if k0 >= k1:
                continue
            assert ra[0] == ts and rm[0] == ts
            asum, asq = zero, zero
            for t in range(max(0, ts - wa), ts):
                asum = asum + m_acc[:, t]
                asq = asq + m_acc[:, t] * m_acc[:, t]
            for t in range(ts, tb + k1):
                ma, m_tau = m_acc[:, t], outs[2][:, t]
                old = m_acc[:, t - wa] if t >= wa else zero
                asum = asum + (ma - old)
                asq = asq + (ma * ma - old * old)
                r = 1 / f32(t + 1)
                ic = f32(1.0 / wa) if t + 1 >= wa else r
                mean_a = asum * ic
                var_a = torch.clamp(asq * ic - mean_a * mean_a, min=0)
                ra = _welford(ra, ma, r)
                rm = _welford(rm, m_tau, r)
                sig_a = torch.clamp(torch.sqrt(torch.maximum(var_a, ra[2] * r)),
                                    min=sigma_floor_acc)
                sig_t = torch.clamp(torch.sqrt(torch.clamp(rm[2] * r, min=0)),
                                    min=sigma_floor_tau)
                outs[0][:, t] = (ma - mean_a) / (sig_a + eps)
                outs[1][:, t] = (m_tau - rm[1]) / (sig_t + eps)
    return tuple(outs)


def _random_streams(n, t, seed):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal((n, t))).astype(np.float32) * 2,
            np.abs(rng.standard_normal((n, t))).astype(np.float32))


def _episode_streams(n_robots, episodes):
    """m_acc, tau_pow [R, T]: each robot runs ``episodes`` tasks back to back
    (tasks in turn), the streams cut to the shortest robot's length."""

    tasks = ("pick_place", "drawer_open", "peg_insertion")
    qd, tau = [], []
    for r in range(n_robots):
        eps_ = [generate_episode(tasks[(r + k) % 3], seed=r * 10 + k) for k in range(episodes)]
        qd.append(np.concatenate([e.qd for e in eps_]))
        tau.append(np.concatenate([e.tau for e in eps_]))
    t_len = min(len(v) for v in qd)
    qd = torch.as_tensor(np.stack([v[:t_len] for v in qd], axis=1))
    tau = torch.as_tensor(np.stack([v[:t_len] for v in tau], axis=1))
    cfg = TriggerConfig()
    w = tkin.end_joint_weights(qd.shape[-1], cfg.end_joint_emphasis, "cpu")
    prev = lambda v: torch.cat([torch.zeros_like(v[:1]), v[:-1]])  # noqa: E731
    m_acc = tkin.accel_magnitude(tkin.finite_diff_accel(qd, prev(qd), cfg.dt), w)
    tau_pow = tkin.torque_power(tkin.torque_variation(tau, prev(tau)), w)
    return m_acc.T.contiguous().numpy(), tau_pow.T.contiguous().numpy()


MONITOR_CASES = [  # name, streams, window_acc, window_tau, peak-relative m_tau
    ("T=20 < 32", lambda: _random_streams(4, 20, 1), 16, 4, False),
    ("T=200 windows 64/16 > segment", lambda: _random_streams(3, 200, 2), 64, 16, False),
    ("T=96 windows 32/8", lambda: _random_streams(5, 96, 3), 32, 8, False),
    ("T=1100 two super-tiles", lambda: _random_streams(3, 1100, 4), 64, 16, False),
    ("T=2500 windows 150/40", lambda: _random_streams(2, 2500, 5), 150, 40, False),
    ("fleet episodes T=600", lambda: _episode_streams(4, 1), 64, 16, True),
    ("episodes back to back, two super-tiles", lambda: _episode_streams(3, 2), 64, 16, True),
]


def _check(got, want, peak_relative):
    tols = [STATS_TOL[:2] + (0.0,), STATS_TOL[:2] + (0.0,),
            (STATS_TOL[2], STATS_TOL[2], STATS_TOL[2] if peak_relative else 0.0)]
    for name, g, w, (atol, rtol, peak) in zip(("score_acc", "score_tau", "m_tau"), got, want,
                                              tols):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        lim = atol + rtol * np.abs(w) + peak * np.abs(w).max(axis=-1, keepdims=True)
        assert np.isfinite(g).all(), name
        assert (np.abs(g - w) <= lim).all(), (name, float(np.abs(g - w).max()))


@pytest.mark.parametrize("oracle", ["torch", "jax"])
@pytest.mark.parametrize("name,streams,wa,wt,peak", MONITOR_CASES,
                         ids=[c[0] for c in MONITOR_CASES])
def test_rolling_stats_emulation_matches_oracles(name, streams, wa, wt, peak, oracle):
    ma, tp = streams()
    got = emulate_rolling_stats(torch.as_tensor(ma), torch.as_tensor(tp), window_acc=wa,
                                window_tau=wt, **FLOORS)
    if oracle == "torch":
        want = tref.rolling_stats_ref(torch.as_tensor(ma), torch.as_tensor(tp), window_acc=wa,
                                      window_tau=wt, **FLOORS)
    else:
        want = jax.jit(lambda u, v: jref.rolling_stats_ref(
            u, v, window_acc=wa, window_tau=wt, **FLOORS))(jnp.asarray(ma), jnp.asarray(tp))
    _check(got, want, peak)


@pytest.mark.parametrize("t,wa,wt,want", [
    (20, 16, 4, (1, 0)), (600, 64, 16, (19, 0)), (1024, 64, 16, (32, 0)),
    (1025, 64, 16, (32, 64)), (2500, 150, 40, (32, 150)),
])
def test_monitor_plan(t, wa, wt, want):
    assert monitor_plan(t, wa, wt) == want
