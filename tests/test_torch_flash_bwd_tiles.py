"""The flash backward kernel's plan and tiled algorithm, on the CPU.

The CUDA kernel (``csrc/flash_attention_bwd.cu``) takes its plan from
``_lib.flash_bwd_plan`` and runs delta = rowsum(dout * out), then the dk /
dv blocks, one per (batch row, KV head, key tile, split of the G query
heads) walking the packed query rows of its heads that can see its keys,
``k_tile`` at a time (packed row R of a split of Gs heads is position R
// Gs of head kvh * G + split * Gs + R % Gs), and the dq blocks, one per
(batch row, KV head, query tile of packed rows over all G heads) walking
the key tiles its rows can see (in bf16 both kinds in one launch), then,
with splits > 1, a reduce pass summing the splits' float32 partials in
split order.  ``dkdv_block`` /
``dq_block`` below mirror the blocks' index arithmetic on the host.  The
kernel runs only on the card (``chip_smoke.py`` holds it against the plain
version); here

(a) the plan's grids are checked from host ints, and the blocks' ranges to
    cover every visible (query head, query, key) pair exactly once in each
    of the two kernels, each dk / dv element to be written once by each
    split (so the reduce sums every split's partial once), and no tile to
    be walked that no row or key of the block can see;
(b) an emulation of the tiled algorithm (the lse recompute of P, delta,
    the dq sum across key tiles, the GQA sum of dk / dv over the packed
    rows of a split and the splits' sum), kept in this file, runs over the
    planned blocks and is held against ``ref.flash_attention_bwd_ref`` on
    numpy inputs.

Tolerance: float32, 1e-5 of each output's largest |value| (the same sums
in another order).  bf16: the emulation rounds P and dS to bf16 before
their products, as the tensor-core kernel does, and rounds its outputs
once; the plain version keeps P and dS in float32.  So per element
|got - want| <= 1e-5 max|want| + 2^-7 |want| + 2 * 2^-8 * A, where A is the
element's sum of absolute terms (sum p |dout| for dv, sum |ds| |q| for dk,
sum |ds| |k| for dq): rounding an operand to bf16 moves it by at most 2^-8
of itself, so a sum moves by at most 2^-8 A (doubled for the float32
differences between the two sides' p and ds), and the two outputs, each
rounded once, differ by at most one bf16 step, 2^-7 of the value.  The same
bound is ``chip_smoke.py``'s ``BWD_TOL`` for the kernel.
"""

from typing import NamedTuple, Tuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

TOL = 1e-5
BF16_SHARE, BF16_RTOL, BF16_TERMS = 1e-5, 2.0**-7, 2.0  # the bf16 bound above
F32, BF16 = torch.float32, torch.bfloat16


class Block(NamedTuple):
    b: int
    kvh: int
    heads: Tuple[int, int]           # its query heads: h0, Gs (packed rows over Gs heads)
    split: int
    rows: Tuple[int, int]            # packed rows [r0, r1)
    keys: Tuple[int, int]            # keys [k0, k1)
    tiles: Tuple[Tuple[int, int], ...]  # the tiles it walks (rows for dk/dv, keys for dq)


def dkdv_block(plan, index, b, s, kv, causal, window) -> Block:
    """Block ``index`` of the dk / dv launch (``bwd_dkdv_tc`` / ``bwd_dkdv``)."""

    g, units = plan.group, b * kv * plan.splits
    gs = g // plan.splits
    unit, k0 = index % units, (index // units) * plan.k_tile
    pair, sp = unit // plan.splits, unit % plan.splits
    kn = min(plan.k_tile, s - k0)
    p_lo = k0 if causal else 0
    p_hi = min(s, k0 + kn - 1 + window) if window > 0 else s
    r_lo, r_hi = p_lo * gs, p_hi * gs
    tiles = tuple((r0, min(r0 + plan.k_tile, r_hi)) for r0 in range(r_lo, r_hi, plan.k_tile))
    return Block(pair // kv, pair % kv, ((pair % kv) * g + sp * gs, gs), sp, (r_lo, r_hi),
                 (k0, k0 + kn), tiles)


def dq_block(plan, index, b, s, kv, causal, window) -> Block:
    """Block ``index`` of the dq launch (``bwd_dq_tc`` / ``bwd_dq``): tiles
    longest first."""

    g, pairs = plan.group, b * kv
    pair, tile = index % pairs, plan.q_tiles - 1 - index // pairs
    r0 = tile * plan.q_tile
    r_hi = min(r0 + plan.q_tile, s * g)
    p_first, p_last = r0 // g, (r_hi - 1) // g
    k_hi = p_last + 1 if causal else s
    k_lo = max(0, p_first - window + 1) if window > 0 else 0
    tiles = tuple((k0, min(k0 + plan.k_tile, k_hi)) for k0 in range(k_lo, k_hi, plan.k_tile))
    return Block(pair // kv, pair % kv, ((pair % kv) * g, g), 0, (r0, r_hi), (k_lo, k_hi), tiles)


def visible(pos, key, s, causal, window):
    return pos < s and key < s and (not causal or pos >= key) and (window <= 0 or
                                                                    pos - key < window)


def pairs_of(block: Block, s, causal, window, dkdv: bool):
    """The visible (b, head, pos, key) pairs one block computes."""

    h0, gs = block.heads
    out = []
    if dkdv:
        k0, k1 = block.keys
        tiles = [(rt, (k0, k1)) for rt in block.tiles]
    else:
        tiles = [(block.rows, kt) for kt in block.tiles]
    for (r0, r1), (k0, k1) in tiles:
        for r in range(r0, r1):
            for key in range(k0, k1):
                if visible(r // gs, key, s, causal, window):
                    out.append((block.b, h0 + r % gs, r // gs, key))
    return out


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,s,h,kv,causal,window", [
    (2, 70, 4, 2, True, 0), (1, 100, 8, 2, True, 17), (1, 65, 2, 2, False, 0),
    (2, 33, 16, 1, True, 40), (1, 96, 4, 4, False, 0), (1, 129, 4, 1, True, 1),
])
def test_both_launches_cover_each_visible_pair_once(b, s, h, kv, causal, window, dtype):
    plan = _lib.flash_bwd_plan(b, s, h, kv, 64, dtype)
    want = sorted((bb, hh, p, k) for bb in range(b) for hh in range(h) for p in range(s)
                  for k in range(s) if visible(p, k, s, causal, window))
    for dkdv, grid, block_fn in ((True, plan.grid_dkdv, dkdv_block),
                                 (False, plan.grid_dq, dq_block)):
        got, written = [], {}
        for i in range(grid):
            blk = block_fn(plan, i, b, s, kv, causal, window)
            got += pairs_of(blk, s, causal, window, dkdv)
            if dkdv:  # the dk / dv rows this block writes, as its split's partial
                for key in range(*blk.keys):
                    written.setdefault((blk.b, blk.kvh, key), []).append(blk.split)
            # no tile walked in vain
            for t in blk.tiles:
                sub = blk._replace(tiles=(t,))
                assert pairs_of(sub, s, causal, window, dkdv), (dkdv, i, t)
        assert sorted(got) == want, dkdv
        if dkdv:
            assert sorted(written) == [(bb, kk, key) for bb in range(b) for kk in range(kv)
                                       for key in range(s)]
            assert all(sorted(v) == list(range(plan.splits)) for v in written.values())


@pytest.mark.parametrize("b,s,h,kv,d,dtype,want", [
    # openvla-7b's training shape: 4 key tiles x 128 pairs, unsplit; 4 row tiles x 128
    (4, 256, 32, 32, 128, BF16, (True, 64, 64, 1, 4, 4, 512, 512, 1)),
    # qwen3-moe's heads, G = 16: 4 key tiles x 4 pairs = 16 blocks, split 16 ways -> 256
    (1, 256, 64, 4, 128, BF16, (True, 64, 64, 16, 64, 4, 256, 256, 16)),
    # gemma2-9b's heads, D = 256, G = 2: 32-key tiles, 256 blocks unsplit
    (1, 1024, 16, 8, 256, BF16, (True, 64, 32, 1, 32, 32, 256, 256, 2)),
    # ragged S = 300, G = 1: 80 blocks, nothing to split
    (1, 300, 16, 16, 64, BF16, (True, 64, 64, 1, 5, 5, 80, 80, 1)),
    # float32: the scalar kernels' 32 x 32 tiles
    (4, 256, 32, 32, 128, F32, (False, 32, 32, 1, 8, 8, 1024, 1024, 1)),
])
def test_plan_at_the_train_shapes(b, s, h, kv, d, dtype, want):
    plan = _lib.flash_bwd_plan(b, s, h, kv, d, dtype)
    assert tuple(plan) == want
    assert plan.grid_dkdv >= _lib.SMS or plan.splits == plan.group or not plan.tensor_cores


@pytest.mark.parametrize("bad", [(1.0, 8, 2, 2, 64, BF16), (1, np.int64(8), 2, 2, 64, BF16),
                                 (1, 8, 3, 2, 64, BF16), (0, 8, 2, 2, 64, F32),
                                 (1, 8, 2, 2, 64, torch.float16)])
def test_plan_takes_positive_host_integers_only(bad):
    with pytest.raises((TypeError, ValueError)):
        _lib.flash_bwd_plan(*bad)


def emulate(q, k, v, out, lse, dout, *, causal, window, cap):
    """The launches over the planned blocks: float32 sums, and for bf16
    inputs P and dS rounded to bf16 before their products and the outputs
    rounded once, as the tensor-core kernels do."""

    b, s, h, d = q.shape
    kv = k.shape[2]
    plan = _lib.flash_bwd_plan(b, s, h, kv, d, q.dtype)
    g, scale = plan.group, d**-0.5
    rnd = (lambda x: x.to(BF16).float()) if q.dtype == BF16 else (lambda x: x)
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, out, dout))
    delta = torch.einsum("bshd,bshd->bhs", gf, of)  # the delta launch

    def tile(bb, kvh, h0, gs, r0, r1, k0, k1):
        """p and ds of packed rows [r0, r1) (of heads h0 + r % gs) x keys [k0, k1)."""

        rows = torch.arange(r0, r1)
        pos, head = rows // gs, h0 + rows % gs
        keys = torch.arange(k0, k1)
        qt, gt = qf[bb, pos, head], gf[bb, pos, head]          # [n, D]
        kt, vt = kf[bb, keys, kvh], vf[bb, keys, kvh]          # [m, D]
        x = (qt @ kt.T) * scale
        sc = cap * torch.tanh(x / cap) if cap else x
        vis = torch.tensor([[visible(int(p), int(c), s, causal, window) for c in keys]
                            for p in pos])
        p = torch.where(vis, torch.exp(sc - lse[bb, head, pos][:, None]), 0.0)
        ds = p * (gt @ vt.T - delta[bb, head, pos][:, None])
        if cap:
            ds = ds * (1 - (sc / cap) ** 2)
        return p, ds * scale, qt, gt, kt

    part_k = torch.zeros((plan.splits,) + kf.shape)  # the splits' partials
    part_v = torch.zeros_like(part_k)
    for i in range(plan.grid_dkdv):  # the dk / dv launch
        blk = dkdv_block(plan, i, b, s, kv, causal, window)
        acc_k = torch.zeros((blk.keys[1] - blk.keys[0], d))
        acc_v = torch.zeros_like(acc_k)
        for r0, r1 in blk.tiles:
            p, ds, qt, gt, _ = tile(blk.b, blk.kvh, *blk.heads, r0, r1, *blk.keys)
            acc_v += rnd(p).T @ gt
            acc_k += rnd(ds).T @ qt
        part_k[blk.split, blk.b, blk.keys[0]:blk.keys[1], blk.kvh] = acc_k
        part_v[blk.split, blk.b, blk.keys[0]:blk.keys[1], blk.kvh] = acc_v
    dk, dv = part_k[0], part_v[0]
    for sp in range(1, plan.splits):  # the reduce pass, in split order
        dk, dv = dk + part_k[sp], dv + part_v[sp]
    dq = torch.zeros_like(qf)
    for i in range(plan.grid_dq):  # the dq launch
        blk = dq_block(plan, i, b, s, kv, causal, window)
        r0, r1 = blk.rows
        acc = torch.zeros((r1 - r0, d))
        for k0, k1 in blk.tiles:
            _, ds, _, _, kt = tile(blk.b, blk.kvh, *blk.heads, r0, r1, k0, k1)
            acc += rnd(ds) @ kt
        rows = torch.arange(r0, r1)
        dq[blk.b, rows // g, blk.kvh * g + rows % g] = acc
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def abs_terms(q, k, v, out, lse, dout, *, causal, window, cap):
    """Each output element's sum of absolute terms, the plain arithmetic on
    absolute values: (sum |ds| |k|, sum |ds| |q|, sum p |dout|) -> like
    (dq, dk, dv), float32."""

    b, s, h, d = q.shape
    kv = k.shape[2]
    g, scale = h // kv, d**-0.5
    qf, gf = (x.float().reshape(b, s, kv, g, d) for x in (q, dout))
    kf, vf = k.float(), v.float()
    x = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    sc = cap * torch.tanh(x / cap) if cap else x
    pos = torch.arange(s)
    vis = torch.ones((s, s), dtype=torch.bool)
    if causal:
        vis &= pos[:, None] >= pos[None, :]
    if window:
        vis &= pos[:, None] - pos[None, :] < window
    p = torch.where(vis, torch.exp(sc - lse.float().reshape(b, kv, g, s)[..., None]), 0.0)
    delta = (gf * out.float().reshape(b, s, kv, g, d)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bqkgd,bskd->bkgqs", gf, vf) - delta[..., None])
    if cap:
        ds = ds * (1 - (sc / cap) ** 2)
    ds = (ds * scale).abs()
    return (torch.einsum("bkgqs,bskd->bqkgd", ds, kf.abs()).reshape(b, s, h, d),
            torch.einsum("bkgqs,bqkgd->bskd", ds, qf.abs()),
            torch.einsum("bkgqs,bqkgd->bskd", p, gf.abs()))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,s,h,kv,causal,window,cap", [
    (2, 45, 4, 2, True, 0, 0.0),
    (1, 70, 8, 2, True, 20, 5.0),
    (1, 40, 2, 2, False, 0, 3.0),
    (1, 37, 16, 1, True, 9, 0.0),
])
def test_tiled_emulation_matches_the_plain_backward(b, s, h, kv, causal, window, cap, dtype):
    rng = np.random.default_rng(1)
    d = 16
    q, dout = (torch.as_tensor(rng.standard_normal((b, s, h, d)).astype(np.float32)).to(dtype)
               for _ in range(2))
    k, v = (torch.as_tensor(rng.standard_normal((b, s, kv, d)).astype(np.float32)).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    out, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    got = emulate(q, k, v, out, lse, dout, causal=causal, window=window, cap=cap)
    if dtype == F32:
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            err = float((a - w).abs().max())
            assert err <= TOL * float(w.abs().max()), (name, err)
        return
    terms = abs_terms(q, k, v, out, lse, dout, causal=causal, window=window, cap=cap)
    plan = _lib.flash_bwd_plan(b, s, h, kv, d, dtype)
    assert plan.splits == (h // kv if b * kv < _lib.SMS else 1)  # the split path is emulated
    needs_terms = []
    for name, a, w, t in zip(("dq", "dk", "dv"), got, want, terms):
        a, w = a.double(), w.double()
        err = (a - w).abs()
        base = BF16_SHARE * float(w.abs().max()) + BF16_RTOL * w.abs()
        lim = base + BF16_TERMS * 2.0**-8 * t.double()
        assert bool((err <= lim).all()), (name, float((err - lim).max()))
        needs_terms.append(not bool((err <= base).all()))
    # the rounding of P and dS is what the A term bounds: without it the
    # float32 limit (an output rounding a side) misses
    assert any(needs_terms)
