"""The algorithm of the port's Mamba scan backward kernel, on the CPU.

The CUDA kernel (``csrc/mamba_scan_bwd.cu``) runs only on the card, where
``chip_smoke.py`` holds it against its plain version.  Here its launch plan
(``_lib.mamba_bwd_plan``) is checked from host ints alone -- every (batch
row, head) once in the state blocks (pairs of heads), every (batch row,
chunk, step, head) once in the chunk blocks, every causal pair (t >= s) of
a chunk once in their t tiles, every partial the reduce reads written by
exactly one block, and every element of dB / dC once in the reduce --; the
fragment reads of the kernel's shared tiles (row strides padded to 8 mod
32 floats) are checked for bank conflicts and for reading each element of
depth once a step; and an emulation of its three launches, kept in this
file, is held against
``ref.mamba_scan_bwd_ref`` and the JAX package's ``jax.vjp`` of
``ssd_chunked``: the state blocks (the chunks in reverse: dS, dh_out, the
decay terms, dh0), the chunk blocks (the state terms first, then the t
tiles with G = C B^T built once for the block's heads, s > t masked before
the exp, the carried state on the tile's own steps, Q summed over the
block's heads before dC += Qsum B and dB += Qsum^T C; dx, the direct part of
ddt, and per-block partials of dB, dC and the rows of dcum -- pair terms on
both sides of the diagonal only, so that the large diagonal terms, which
cancel, never enter it in float32 --, in workspaces filled with NaN so
that a read of an unwritten partial shows), and the reduce (the rows
summed, the reverse prefix sum in float64, ddt finished, da summed over
batch rows and chunks; dB over head groups, dC over head groups and row
tiles).  Every product is emulated as the kernel's 3xTF32 ``mma``: each
operand rounded to TF32 by masking its low 13 mantissa bits, the float32
residual masked the same way (the tensor core reads only its TF32 bits),
and hi.hi + hi.lo + lo.hi summed in float32.  Prefix sums of dt * a in
float64, as the kernel keeps them; the oracles run in float64.

Tolerances: dx, ddt and dh0 ``SCAN_TOL`` (atol 5e-4, rtol 5e-3, the JAX
package's for its own scan kernel; exps of differences of prefix sums
summed in another order); dB, dC and da are sums over heads (dB, dC) or over
batch rows and steps (da) of terms up to ~1e3 at a large dt, so their atol
is 5e-4 times the largest |value| of the output (their rtol stays 5e-3).
The card's limit, ``chip_smoke.MAMBA_BWD_TOL`` (2^-14 of each element's
sum of absolute terms), is held to the 3xTF32 emulation at a large dt, and
one TF32 product a term must miss it there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

SCAN_TOL = dict(atol=5e-4, rtol=5e-3)
SUM_ATOL, SUM_RTOL = 5e-4, 5e-3  # dB, dC, da: atol x the output's largest |value|
CARD_TOL = (1e-30, 2.0**-14)     # chip_smoke.MAMBA_BWD_TOL
R = _lib.BWD_ROWS
RS = 32                          # steps a tile of the state blocks
NAMES = ("dx", "ddt", "da", "dbm", "dc", "dh0")


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def chunk_block(plan, i, b, h):
    """Chunk block ``i`` -> (b * chunks + c, group, heads, s tile j) -- a
    mirror of ``bwd_chunk``'s indexing in csrc/mamba_scan_bwd.cu."""

    nbc = b * plan.chunks
    j, rest = divmod(i, nbc * plan.groups)
    g, bc = rest % plan.groups, rest // plan.groups
    return bc, g, range(g * plan.heads, min(h, (g + 1) * plan.heads)), j


PLAN_CASES = [  # b, s, h, p, n, chunk
    (2, 1024, 256, 64, 16, 256),  # Jamba's training shape
    (1, 256, 256, 64, 16, 256),   # one chunk
    (2, 512, 8, 64, 16, 256),     # jamba-smoke's
    (1, 14, 270, 4, 4, 256),      # L < 64; H not a multiple of the heads a block
    (2, 64, 3, 8, 32, 16),
    (3, 200, 5, 2, 3, 100),       # L = 100: a ragged second row tile
    (1, 96, 7, 1, 1, 32),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", PLAN_CASES)
def test_mamba_bwd_plan_covers_every_step_and_pair_once(b, s, h, p, n, chunk):
    plan = _lib.mamba_bwd_plan(b, s, h, p, n, chunk)
    L, nc, rt = plan.chunk, plan.chunks, plan.row_tiles
    assert L == min(chunk, s) and nc * L == s and rt * R >= L > (rt - 1) * R
    assert plan.heads in (1, 2) and plan.groups * plan.heads >= h
    assert plan.heads == 1 or plan.chunk_blocks >= _lib.SMS
    # the state blocks: every (batch row, head) once, a pair of heads a block,
    # each over all its chunks
    pairs = -(-h // 2)
    assert plan.state_blocks == b * pairs
    seen = np.zeros(b * h, int)
    for blk in range(plan.state_blocks):
        bb, pair = divmod(blk, pairs)
        for head in range(2 * pair, min(h, 2 * pair + 2)):
            seen[bb * h + head] += 1
    assert (seen == 1).all()
    # the chunk blocks: every (bc, head, s) once; every causal pair (t >= s) once a head
    steps = np.zeros((b * nc, h, L), int)
    pairs = np.zeros((L, L), int)
    rows_written = np.zeros((b * nc, rt, h, L), int)
    dc_written = np.zeros((b * nc, rt, plan.groups, L), int)
    db_written = np.zeros((plan.groups, b * s), int)
    for i in range(plan.chunk_blocks):
        bc, g, heads, jj = chunk_block(plan, i, b, h)
        s0, s1 = jj * R, min(L, (jj + 1) * R)
        for head in heads:
            steps[bc, head, s0:s1] += 1
        db_written[g, bc * L + s0:bc * L + s1] += 1
        for kt in range(jj, rt):  # t tiles from the row tile's own on
            t0, t1 = kt * R, min(L, (kt + 1) * R)
            if bc == 0 and g == 0:
                tt, ss = np.meshgrid(np.arange(t0, t1), np.arange(s0, s1), indexing="ij")
                np.add.at(pairs, (tt[tt >= ss], ss[tt >= ss]), 1)
            for head in heads:
                rows_written[bc, jj, head, t0:t1] += 1
            dc_written[bc, jj, g, t0:t1] += 1
    assert (steps == 1).all() and (db_written == 1).all()
    assert np.array_equal(pairs, np.tril(np.ones((L, L), int)))
    # the reduce reads partials of row tiles jj <= the step's: each written once
    t_tile = np.arange(L) // R
    read = np.arange(rt)[:, None] <= t_tile[None, :]  # [rt, L]
    for written in (rows_written, dc_written):  # [bc, rt, heads or groups, L]
        by_tile = written.transpose(0, 2, 1, 3)
        assert (by_tile[:, :, read] == 1).all() and (by_tile[:, :, ~read] == 0).all()
    # the reduce: a block a head, then 32 elements of dB / dC a block, each once
    elems = b * s * n
    assert plan.reduce_blocks == h + -(-elems // _lib.BWD_REDUCE_ELEMS)
    e = (np.arange(plan.reduce_blocks - h)[:, None] * _lib.BWD_REDUCE_ELEMS
         + np.arange(_lib.BWD_REDUCE_ELEMS)[None, :]).ravel()
    assert np.array_equal(np.bincount(e[e < elems], minlength=elems), np.ones(elems))


def test_mamba_bwd_plan_takes_host_ints_only():
    with pytest.raises(TypeError, match="host ints"):
        _lib.mamba_bwd_plan(2, torch.tensor(1024), 256, 64, 16, 256)
    with pytest.raises(ValueError, match="bad shape"):
        _lib.mamba_bwd_plan(2, 0, 256, 64, 16, 256)


# ---------------------------------------------------------------------------
# the fragment reads of the shared tiles (a mirror of the kernel's)
# ---------------------------------------------------------------------------


def fragment_reads(order, st, r0, k0):
    """The float offsets each lane reads, by instruction, for one 8-deep
    step of ``mma3`` from a tile of row stride ``st``: "pair" (``Pair``: a
    float2 along rows r0 + g and r0 + g + 8 at depth k0 + 2 tig), "row"
    (``Row``: single floats along the same rows at depth k0 + tig and + 4),
    "col" (``Col``: single floats down columns r0 + g and + 8 at depth rows
    k0 + tig and + 4).  A float2 read lists its first float."""

    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    if order == "pair":
        return [(r0 + g + 8 * i) * st + k0 + 2 * q for i in (0, 1)]
    if order == "row":
        return [(r0 + g + 8 * i) * st + k0 + q + 4 * e for i in (0, 1) for e in (0, 1)]
    return [(k0 + q + 4 * e) * st + r0 + g + 8 * i for i in (0, 1) for e in (0, 1)]


def conflicts(order, addr):
    """The most distinct words one bank serves in one instruction's reads
    (a float2 read goes in two half-warp phases of 16 lanes)."""

    if order == "pair":
        return max(max(np.bincount(np.unique(addr[half] // 2) % 16).max() for half in
                       (slice(0, 16), slice(16, 32))), 1)
    return int(np.bincount(np.unique(addr) % 32).max())


# tile strides: 72 (K / Qsum; x and dy with one head), 136 (x and dy with two
# heads; the state blocks' dy), 16 (B, C and the states, unpadded at N = 16)
@pytest.mark.parametrize("order,st,most", [
    ("pair", 72, 1), ("pair", 136, 1), ("col", 72, 1), ("col", 136, 1),
    ("row", 72, 2), ("row", 136, 2), ("pair", 16, 2), ("col", 16, 2),
])
def test_fragment_reads_bank_conflicts(order, st, most):
    """The big products (M: pair x pair; r, dS, dB: col x col) read their
    padded tiles without bank conflicts; Row's reads (the carry, the state
    dB and dC, once a head or tile) and the unpadded [steps x N] tiles have
    at most two-way conflicts."""

    worst = 0
    for r0 in range(0, 64 - 15 if order != "col" else st - 15, 8):
        for k0 in range(0, 64, 8):
            for addr in fragment_reads(order, st, r0, k0):
                worst = max(worst, conflicts(order, addr))
    assert worst == most


@pytest.mark.parametrize("order", ["pair", "row", "col"])
def test_fragment_reads_cover_the_depth_once(order):
    """One 8-deep step of each order reads, for each row (column) of the
    fragment, each of its 8 depth indices exactly once -- so A and B, read
    in the same order, pair up every term of the product."""

    st, r0, k0 = 72, 16, 24
    per = {}
    for addr in fragment_reads(order, st, r0, k0):
        words = [a + e for a in addr for e in ((0, 1) if order == "pair" else (0,))]
        for w in words:
            row, col = divmod(w, st)
            key, depth = (row, col) if order != "col" else (col, row)
            per.setdefault(key, []).append(depth)
    assert len(per) == 16
    assert all(sorted(d) == list(range(k0, k0 + 8)) for d in per.values())


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def tf32(v):
    """``v`` with its low 13 mantissa bits masked off (float32)."""

    return (v.contiguous().view(torch.int32) & -8192).view(torch.float32)


def mm3(a, b):
    """The kernel's 3xTF32 product: hi.hi + hi.lo + lo.hi in float32."""

    a, b = a.float(), b.float()
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """One TF32 product (what the card's limit must tell apart)."""

    return tf32(a.float()) @ tf32(b.float())


def _cum(dt, a):
    """Inclusive float64 prefix sum of the float32 products dt * a."""

    return torch.cumsum((dt * a).double(), 0)


def emulate_mamba_scan_bwd(x, dt, a, bm, c, h_in, dy, dh_t=None, chunk=256, mm=mm3):
    """The kernel's three launches over its planned blocks, their products
    by ``mm`` (3xTF32), float64 prefix sums -> (dx, ddt, da, dbm, dc, dh0)."""

    b, s, h, p = x.shape
    n = bm.shape[-1]
    plan = _lib.mamba_bwd_plan(b, s, h, p, n, chunk)
    L, nc, rt, groups = plan.chunk, plan.chunks, plan.row_tiles, plan.groups
    nan = float("nan")

    def cum_of(bb, cc, head):
        return _cum(dt[bb, cc * L:(cc + 1) * L, head], a[head])

    # 1. the state blocks, a (batch row, pair of heads), over the chunks in reverse:
    # dS by tiles of 32 steps into one accumulator, dh_out, the decay term
    dh_out, dterm = torch.full((b, nc, h, p, n), nan), torch.full((b, nc, h), nan)
    dh0 = torch.full((b, h, p, n), nan)
    pairs = -(-h // 2)
    for blk, head in ((blk, head) for blk in range(plan.state_blocks)
                      for head in range(blk % pairs * 2, min(h, blk % pairs * 2 + 2))):
        bb = blk // pairs
        d = torch.zeros((p, n)) if dh_t is None else dh_t[bb, head]
        for cc in reversed(range(nc)):
            cm = cum_of(bb, cc, head)
            ef, dec = torch.exp(cm.float()), torch.exp(cm[-1].float())
            ds = torch.zeros((p, n))
            for t0 in range(0, L, RS):
                steps = slice(cc * L + t0, cc * L + min(L, t0 + RS))
                ds += mm(dy[bb, steps, head].T, c[bb, steps] * ef[t0:t0 + RS, None])
            dterm[bb, cc, head] = dec * (d * h_in[bb, cc, head]).sum()
            dh_out[bb, cc, head] = d
            d = d * dec + ds
        dh0[bb, head] = d

    # 2. the chunk blocks; partials in NaN-filled workspaces
    rowp = torch.full((b * nc, rt, h, L), nan)
    dbp = torch.full((groups, b * s, n), nan)
    dcp = torch.full((b * nc, rt, groups, L, n), nan)
    dx, ddt = torch.full_like(x, nan), torch.full_like(dt, nan)
    for i in range(plan.chunk_blocks):
        bc, g, heads, j = chunk_block(plan, i, b, h)
        bb, cc = divmod(bc, nc)
        base, s0 = cc * L, j * R
        sl = torch.arange(s0, min(L, s0 + R))
        bs = bm[bb, base + sl]
        cums = {head: cum_of(bb, cc, head) for head in heads}
        r, v, vsum, col, rdiag = {}, {}, {}, {}, {}
        db = torch.zeros((len(sl), n))
        for head in heads:  # the state terms, before the t tiles
            cm, xs, dts = cums[head], x[bb, base + sl, head], dt[bb, base + sl, head]
            es = torch.exp((cm[L - 1] - cm[sl]).float())
            r[head] = es[:, None] * mm(bs, dh_out[bb, cc, head].T)
            v[head] = (xs * r[head]).sum(1) * dts  # V_s
            vsum[head] = v[head].sum()
            col[head] = torch.zeros(len(sl))
            db += (es * dts)[:, None] * mm(xs, dh_out[bb, cc, head])
        for kt in range(j, rt):
            tl = torch.arange(kt * R, min(L, (kt + 1) * R))
            ct = c[bb, base + tl]
            g_tile = mm(ct, bs.T)  # G = C B^T, once for the block's heads
            dcr = torch.zeros((len(tl), n))
            qsum = torch.zeros((len(tl), len(sl)))
            for head in heads:
                cm, xs, dts = cums[head], x[bb, base + sl, head], dt[bb, base + sl, head]
                dyt = dy[bb, base + tl, head]
                extra = torch.zeros(len(tl))
                if kt == j:  # the carried state on the tile's own steps
                    hd = torch.exp(cm[tl].float())[:, None] * mm(dyt, h_in[bb, cc, head])
                    dcr += hd
                    extra += (ct * hd).sum(1)
                keep = sl[None, :] <= tl[:, None]
                diff = torch.where(keep, cm[tl][:, None] - cm[sl][None, :],
                                   torch.full((len(tl), len(sl)), -1e30, dtype=torch.float64))
                e = torch.where(keep, torch.exp(diff.float()), torch.zeros(()))
                k_tile = g_tile * e
                q_tile = e * dts[None, :] * mm(dyt, xs.T)
                qsum += q_tile
                # the pair terms of dcum, the diagonal left out of both sides
                w = torch.where(sl[None, :] < tl[:, None], g_tile * q_tile, torch.zeros(()))
                row = w.sum(1) + extra
                col[head] += w.sum(0)
                if tl[-1] == L - 1:
                    row[-1] += vsum[head]
                if kt == j:  # the tile's own steps: written with their columns below
                    rdiag[head] = row
                else:
                    rowp[bc, j, head, tl] = row
                r[head] += mm(k_tile.T, dyt)
            # dC and dB of the tile, once for the heads: from their sum of Q
            dcp[bc, j, g, tl] = dcr + mm(qsum, bs)
            db += mm(qsum.T, ct)
        for head in heads:
            xs, dts = x[bb, base + sl, head], dt[bb, base + sl, head]
            dx[bb, base + sl, head] = dts[:, None] * r[head]
            ddt[bb, base + sl, head] = (xs * r[head]).sum(1)
            rowp[bc, j, head, sl] = rdiag[head] - col[head] - v[head]
        dbp[g, bb * s + base + sl] = db

    # 3. the reduce: a block a head for ddt and da, the rest for dB and dC
    da = torch.zeros(h)
    for head in range(h):
        acc = torch.zeros((), dtype=torch.float64)
        for bc in range(b * nc):
            bb, cc = divmod(bc, nc)
            steps = slice(cc * L, (cc + 1) * L)
            dcum = torch.stack([rowp[bc, :u // R + 1, head, u].sum() for u in range(L)])
            ddir, dtu = ddt[bb, steps, head].clone(), dt[bb, steps, head]
            dcum[L - 1] += dterm[bb, cc, head]
            dla = torch.flip(torch.cumsum(torch.flip(dcum.double(), [0]), 0), [0])
            ddt[bb, steps, head] = ddir + dla.float() * a[head]
            acc += (dla * dtu.double()).sum()
        da[head] = acc.float()
    dbm = dbp.sum(0).reshape(b, s, n)
    t = torch.arange(L)
    dc = torch.stack([torch.stack([dcp[bc, :u // R + 1, :, u].sum((0, 1)) for u in t])
                      for bc in range(b * nc)]).reshape(b, s, n)
    return dx, ddt, da, dbm, dc, dh0


CASES = [  # b, s, h, p, n, chunk
    (1, 14, 6, 4, 4, 256),     # L = 14 < a row tile, one chunk; H % 4 = 2
    (2, 64, 3, 8, 4, 16),      # L = 16, four chunks
    (1, 128, 3, 16, 8, 64),    # L = 64, two chunks
    (1, 160, 2, 8, 5, 160),    # L = 160: three row tiles, the last ragged; N = 5
    (1, 256, 2, 4, 32, 128),   # L = 128, two row tiles, two chunks, N = 32
    (2, 96, 5, 6, 3, 32),      # P = 6 (not a multiple of 4)
]


def _inputs(b, s, h, p, n, seed, big_dt=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    if big_dt:  # decays near 0 within a few steps: the masked corner matters
        dt *= 30.0
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    c = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dh_t = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, c, h0, dy, dh_t


def check_grads(got, want, what=""):
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().double().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.detach().double().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert np.isfinite(g).all(), f"{what} {name} not finite"
        if name in ("da", "dbm", "dc"):
            tol = dict(atol=SUM_ATOL * float(np.abs(w).max()), rtol=SUM_RTOL)
        else:
            tol = SCAN_TOL
        np.testing.assert_allclose(g, w, err_msg=f"{what} {name}", **tol)


@pytest.mark.parametrize("oracle", ["torch", "jax"])
@pytest.mark.parametrize("mode", ["plain", "h0+dh_t", "big_dt"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_mamba_bwd_emulation_matches_oracles(b, s, h, p, n, chunk, mode, oracle):
    x, dt, a, bm, c, h0, dy, dh_t = _inputs(b, s, h, p, n, seed=s + 7 * h + p,
                                            big_dt=mode == "big_dt")
    h0 = h0 if mode == "h0+dh_t" else None
    dh_t = dh_t if mode == "h0+dh_t" else None
    args = [torch.as_tensor(v) for v in (x, dt, a, bm, c)]
    h0_t = None if h0 is None else torch.as_tensor(h0)
    dh_t_t = None if dh_t is None else torch.as_tensor(dh_t)
    _, _, h_in = tref.mamba_scan_ref(*args, h0=h0_t, chunk=chunk, with_states=True)
    got = emulate_mamba_scan_bwd(*args, h_in, torch.as_tensor(dy), dh_t_t, chunk=chunk)
    # the oracles in float64, as the kernel keeps its prefix sums (at a large
    # dt a float32 prefix sum reaches ~-3e3 and puts ~2e-4 on every decay)
    wide = [v.astype(np.float64) for v in (x, dt, a, bm, c, dy)]
    h0_w = None if h0 is None else h0.astype(np.float64)
    dh_t_w = None if dh_t is None else dh_t.astype(np.float64)
    if oracle == "torch":
        tw = [torch.as_tensor(v) for v in wide]
        h0_tw = None if h0_w is None else torch.as_tensor(h0_w)
        _, _, h_in_w = tref.mamba_scan_ref(*tw[:5], h0=h0_tw, chunk=chunk, with_states=True)
        want = tref.mamba_scan_bwd_ref(*tw[:5], h_in_w, tw[5],
                                       None if dh_t_w is None else torch.as_tensor(dh_t_w),
                                       chunk=chunk)
    else:
        with jax.enable_x64(True):
            zeros = np.zeros((b, h, p, n))
            (_, h_t), vjp = jax.vjp(
                lambda *v: jssm.ssd_chunked(*v[:5], chunk=chunk, h0=v[5]),
                *map(jnp.asarray, (*wide[:5], zeros if h0_w is None else h0_w)))
            want = [np.asarray(w) for w in vjp(
                (jnp.asarray(wide[5]), jnp.zeros_like(h_t) if dh_t_w is None
                 else jnp.asarray(dh_t_w)))]
    check_grads(got, want, f"{oracle} {mode}")


def abs_terms(x, dt, a, bm, c, h_in, dy, dh_t, chunk):
    """Each output element's sum of absolute terms, float64 (a twin of
    ``chip_smoke.mamba_bwd_abs_terms``, which the card's limit scales)."""

    x, bm, c, h_in, dy, dh_t = (None if t is None else t.double().abs()
                                for t in (x, bm, c, h_in, dy, dh_t))
    t = tref.mamba_bwd_terms(x, dt.double(), a.double(), bm, c, h_in, dy, dh_t, chunk)
    return tref.mamba_bwd_finish(t, t["row"] + t["col"] + t["carry"] + t["v"], a.double().abs())


@pytest.mark.parametrize("b,s,h,p,n,chunk", [CASES[2], CASES[4], CASES[5]])
def test_mamba_bwd_3xtf32_meets_the_card_limit_where_1xtf32_misses(b, s, h, p, n, chunk):
    """At a large dt (the x30 case of the card's check), the 3xTF32
    emulation keeps every gradient within ``CARD_TOL`` of the float64 plain
    version, as the kernel must; one TF32 product a term does not."""

    x, dt, a, bm, c, h0, dy, dh_t = _inputs(b, s, h, p, n, seed=s + 7 * h + p, big_dt=True)
    args = [torch.as_tensor(v) for v in (x, dt, a, bm, c)]
    _, _, h_in = tref.mamba_scan_ref(*args, chunk=chunk, with_states=True)
    dy_t = torch.as_tensor(dy)
    want = tref.mamba_scan_bwd_ref(*(t.double() for t in args), h_in.double(), dy_t.double(),
                                   chunk=chunk)
    terms = abs_terms(*args, h_in, dy_t, None, chunk)
    atol, share = CARD_TOL
    worst = {}
    for mm in (mm3, mm1):
        got = emulate_mamba_scan_bwd(*args, h_in, dy_t, chunk=chunk, mm=mm)
        worst[mm.__name__] = max(
            float(((g.double() - w).abs() - atol).div(t + 1e-300).max())
            for g, w, t in zip(got, want, terms))
    assert worst["mm3"] <= share, f"3xTF32 at {worst['mm3']:.3g} of its terms"
    assert worst["mm1"] > share, f"1xTF32 within the limit ({worst['mm1']:.3g})"
