"""The flash backward kernel's plan and tiled algorithm, on the CPU.

The CUDA kernel (``csrc/flash_attention_bwd.cu``) takes its plan from
``_lib.flash_bwd_plan`` and runs three launches: delta = rowsum(dout *
out); dk / dv, one block per (batch row, KV head, key tile) walking the
tiles of packed query rows that can see its keys (packed row R is position
R // G of head kvh * G + R % G); dq, one block per (batch row, KV head,
packed query tile) walking the key tiles its rows can see, dq summed in
float32 across them and cast at the end.  ``dkdv_block`` / ``dq_block``
below mirror the blocks' index arithmetic on the host.  The kernel runs
only on the card (``chip_smoke.py`` holds it against the plain version);
here

(a) the plan's grids are checked from host ints, and the blocks' ranges to
    cover every visible (query, key) pair exactly once in each of the two
    kernels, skipping only tiles that no row or key of the block can see;
(b) an emulation of the tiled algorithm (the lse recompute of P, delta,
    the dq sum across key tiles, the GQA sum of dk / dv over the packed
    rows), kept in this file, runs over the planned blocks and is held
    against ``ref.flash_attention_bwd_ref`` on numpy inputs.

Tolerance: float32, 1e-5 of each output's largest |value| (the same sums
in another order).
"""

from typing import NamedTuple, Tuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

TOL = 1e-5


class Block(NamedTuple):
    b: int
    kvh: int
    rows: Tuple[int, int]            # packed rows [r0, r1)
    keys: Tuple[int, int]            # keys [k0, k1)
    tiles: Tuple[Tuple[int, int], ...]  # the tiles it walks (rows for dk/dv, keys for dq)


def dkdv_block(plan, index, b, s, kv, causal, window) -> Block:
    """Block ``index`` of the dk / dv launch (``bwd_dkdv``)."""

    g, pairs = plan.group, b * kv
    pair, k0 = index % pairs, (index // pairs) * plan.k_tile
    kn = min(plan.k_tile, s - k0)
    p_lo = k0 if causal else 0
    p_hi = min(s, k0 + kn - 1 + window) if window > 0 else s
    r_lo, r_hi = p_lo * g, p_hi * g
    tiles = tuple((r0, min(r0 + plan.q_tile, r_hi)) for r0 in range(r_lo, r_hi, plan.q_tile))
    return Block(pair // kv, pair % kv, (r_lo, r_hi), (k0, k0 + kn), tiles)


def dq_block(plan, index, b, s, kv, causal, window) -> Block:
    """Block ``index`` of the dq launch (``bwd_dq``): tiles longest first."""

    g, pairs = plan.group, b * kv
    pair, tile = index % pairs, plan.q_tiles - 1 - index // pairs
    r0 = tile * plan.q_tile
    r_hi = min(r0 + plan.q_tile, s * g)
    p_first, p_last = r0 // g, (r_hi - 1) // g
    k_hi = p_last + 1 if causal else s
    k_lo = max(0, p_first - window + 1) if window > 0 else 0
    tiles = tuple((k0, min(k0 + plan.k_tile, k_hi)) for k0 in range(k_lo, k_hi, plan.k_tile))
    return Block(pair // kv, pair % kv, (r0, r_hi), (k_lo, k_hi), tiles)


def visible(pos, key, s, causal, window):
    return pos < s and key < s and (not causal or pos >= key) and (window <= 0 or
                                                                    pos - key < window)


def pairs_of(block: Block, g, s, causal, window, dkdv: bool):
    """The visible (b, head, pos, key) pairs one block computes."""

    out = []
    if dkdv:
        k0, k1 = block.keys
        tiles = [(rt, (k0, k1)) for rt in block.tiles]
    else:
        tiles = [(block.rows, kt) for kt in block.tiles]
    for (r0, r1), (k0, k1) in tiles:
        for r in range(r0, r1):
            for key in range(k0, k1):
                if visible(r // g, key, s, causal, window):
                    out.append((block.b, block.kvh * g + r % g, r // g, key))
    return out


@pytest.mark.parametrize("b,s,h,kv,causal,window", [
    (2, 70, 4, 2, True, 0), (1, 100, 8, 2, True, 17), (1, 65, 2, 2, False, 0),
    (2, 33, 16, 1, True, 40), (1, 96, 4, 4, False, 0), (1, 129, 4, 1, True, 1),
])
def test_both_launches_cover_each_visible_pair_once(b, s, h, kv, causal, window):
    plan = _lib.flash_bwd_plan(b, s, h, kv, 64)
    g = h // kv
    want = sorted((bb, hh, p, k) for bb in range(b) for hh in range(h) for p in range(s)
                  for k in range(s) if visible(p, k, s, causal, window))
    for dkdv, grid, block_fn in ((True, plan.grid_dkdv, dkdv_block),
                                 (False, plan.grid_dq, dq_block)):
        got = []
        for i in range(grid):
            blk = block_fn(plan, i, b, s, kv, causal, window)
            mine = pairs_of(blk, g, s, causal, window, dkdv)
            got += mine
            # no tile walked in vain
            for t in blk.tiles:
                sub = blk._replace(tiles=(t,))
                assert pairs_of(sub, g, s, causal, window, dkdv), (dkdv, i, t)
        assert sorted(got) == want, dkdv


@pytest.mark.parametrize("b,s,h,kv,d,want", [
    # openvla-7b's training shape: 8 key tiles x 128 pairs; 8 row tiles x 128
    (4, 256, 32, 32, 128, (32, 32, 8, 8, 1024, 1024, 1)),
    # qwen3-moe's heads, G = 16: 128 packed row tiles a pair
    (1, 256, 64, 4, 128, (32, 32, 128, 8, 512, 32, 16)),
    # ragged S = 300
    (1, 300, 16, 16, 64, (32, 32, 10, 10, 160, 160, 1)),
])
def test_plan_at_the_train_shapes(b, s, h, kv, d, want):
    assert tuple(_lib.flash_bwd_plan(b, s, h, kv, d)) == want


@pytest.mark.parametrize("bad", [(1.0, 8, 2, 2, 64), (1, np.int64(8), 2, 2, 64),
                                 (1, 8, 3, 2, 64), (0, 8, 2, 2, 64)])
def test_plan_takes_positive_host_integers_only(bad):
    with pytest.raises((TypeError, ValueError)):
        _lib.flash_bwd_plan(*bad)


def emulate(q, k, v, out, lse, dout, *, causal, window, cap):
    """The three launches over the planned blocks, float32 throughout."""

    b, s, h, d = q.shape
    kv = k.shape[2]
    plan = _lib.flash_bwd_plan(b, s, h, kv, d)
    g, scale = plan.group, d**-0.5
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, out, dout))
    delta = torch.einsum("bshd,bshd->bhs", gf, of)  # launch 1

    def tile(bb, kvh, r0, r1, k0, k1):
        """p and ds of packed rows [r0, r1) x keys [k0, k1) (tile_p_ds)."""

        rows = torch.arange(r0, r1)
        pos, head = rows // g, kvh * g + rows % g
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

    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i in range(plan.grid_dkdv):  # launch 2
        blk = dkdv_block(plan, i, b, s, kv, causal, window)
        acc_k = torch.zeros((blk.keys[1] - blk.keys[0], d))
        acc_v = torch.zeros_like(acc_k)
        for r0, r1 in blk.tiles:
            p, ds, qt, gt, _ = tile(blk.b, blk.kvh, r0, r1, *blk.keys)
            acc_v += p.T @ gt
            acc_k += ds.T @ qt
        dk[blk.b, blk.keys[0]:blk.keys[1], blk.kvh] = acc_k
        dv[blk.b, blk.keys[0]:blk.keys[1], blk.kvh] = acc_v
    dq = torch.zeros_like(qf)
    for i in range(plan.grid_dq):  # launch 3
        blk = dq_block(plan, i, b, s, kv, causal, window)
        r0, r1 = blk.rows
        acc = torch.zeros((r1 - r0, d))
        for k0, k1 in blk.tiles:
            _, ds, _, _, kt = tile(blk.b, blk.kvh, r0, r1, k0, k1)
            acc += ds @ kt
        rows = torch.arange(r0, r1)
        dq[blk.b, rows // g, blk.kvh * g + rows % g] = acc
    return dq, dk, dv


@pytest.mark.parametrize("b,s,h,kv,causal,window,cap", [
    (2, 45, 4, 2, True, 0, 0.0),
    (1, 70, 8, 2, True, 20, 5.0),
    (1, 40, 2, 2, False, 0, 3.0),
    (1, 37, 16, 1, True, 9, 0.0),
])
def test_tiled_emulation_matches_the_plain_backward(b, s, h, kv, causal, window, cap):
    rng = np.random.default_rng(1)
    d = 16
    q, dout = (torch.as_tensor(rng.standard_normal((b, s, h, d)).astype(np.float32))
               for _ in range(2))
    k, v = (torch.as_tensor(rng.standard_normal((b, s, kv, d)).astype(np.float32))
            for _ in range(2))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    out, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    got = emulate(q, k, v, out, lse, dout, causal=causal, window=window, cap=cap)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = float((a - w).abs().max())
        assert err <= TOL * float(w.abs().max()), (name, err)
