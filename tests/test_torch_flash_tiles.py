"""The tile plan of the port's prefill (flash) kernel, and its algorithm, on the CPU.

The CUDA kernel (``csrc/flash_attention.cu``) takes its launch plan from
``_lib.flash_plan``: in bf16 a block owns ``rows`` packed rows of one
(batch row, KV head) pair (packed row r is position r // G of query head
kvh * G + r % G) and visits key tiles from its window's lower bound up to
its last row's causal limit; ``flash_block`` below mirrors that block
arithmetic on the host.  The kernel runs only on the card (``chip_smoke.py``
holds it against the plain version); here

(a) the plan is checked to cover every visible (query, key) pair exactly
    once and to skip only key tiles that no row of their block can see;
(b) an emulation of the kernel's algorithm, kept in this file, runs over
    the planned blocks and tiles -- f32 scores, the online softmax rescaled
    once a tile, P rounded to bf16 before P.V in bf16 runs -- and is held
    against the port's plain version (``repro_torch.kernels.ref``) and the
    JAX oracle (``repro.kernels.ref``), on inputs made by numpy from a seed.

Tolerances: float32 atol = rtol = 1e-5 (the same math summed in another
order); bf16 atol = rtol = 2e-2 (one bf16 output step, plus P's bf16
rounding, at most 2^-9 * max|v|), as in ``tests/test_torch_kernels.py``.
"""

import functools
from typing import NamedTuple, Tuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NEG_INF = -1e30
KV = 2  # KV heads of the planner cases: H = G * KV


# ---------------------------------------------------------------------------
# the kernel's block arithmetic, on the host
# ---------------------------------------------------------------------------


class FlashBlock(NamedTuple):
    b: int
    head0: int                  # packed row r is query head head0 + r % group
    group: int
    rows: Tuple[int, int]       # packed rows [r0, r1); position of r is r // group
    keys: Tuple[Tuple[int, int], ...]  # the key tiles [k0, k1) it visits, in order


def flash_block(plan, index: int, b: int, s: int, kv: int, *, causal: bool = True,
                window: int = 0) -> FlashBlock:
    """What block ``index`` (linear, x fastest) of ``plan`` computes: a
    mirror of the kernel's block arithmetic (``flash_tc`` and ``flash_simt``
    in csrc/flash_attention.cu).  A tile's keys are clipped to the block's
    causal limit."""

    if plan.packed:
        pairs = b * kv
        pair, tile = index % pairs, plan.tiles - 1 - index // pairs
        bb, kvh = divmod(pair, kv)
        grp, head0 = plan.group, kvh * plan.group
        r0, r1 = tile * plan.rows, min((tile + 1) * plan.rows, s * grp)
        k_lo = max(0, r0 // grp - window + 1) if window > 0 else 0
    else:
        gx, gy = plan.grid[0], plan.grid[1]
        tile, head0, bb = index % gx, index // gx % gy, index // (gx * gy)
        grp, r0, r1 = 1, tile * plan.rows, min((tile + 1) * plan.rows, s)
        k_lo = max(0, r0 - window + 1) if window > 0 else 0
        k_lo -= k_lo % plan.key_tile  # the SIMT kernel's tiles start on multiples
    k_hi = (r1 - 1) // grp + 1 if causal else s
    keys = tuple((k0, min(k0 + plan.key_tile, k_hi)) for k0 in range(k_lo, k_hi, plan.key_tile))
    return FlashBlock(bb, head0, grp, (r0, r1), keys)


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------


def check_cover(plan, b, s, h, kv, window, causal=True):
    """Every (row, query head, position) in exactly one block; each block's
    key tiles disjoint, in order, covering every key its rows can see, and
    none of them a tile that no row of the block can see."""

    g = h // kv
    owner = np.zeros((b, h, s), np.int64)
    n_blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    for idx in range(n_blocks):
        blk = flash_block(plan, idx, b, s, kv, causal=causal, window=window)
        r0, r1 = blk.rows
        assert 0 <= r0 < r1 <= s * blk.group
        rows = np.arange(r0, r1)
        np.add.at(owner, (blk.b, blk.head0 + rows % blk.group, rows // blk.group), 1)
        assert blk.head0 // g == (blk.head0 + blk.group - 1) // g, "one KV head a block"
        p_first, p_last = r0 // blk.group, (r1 - 1) // blk.group
        vis_lo = max(0, p_first - window + 1) if window else 0
        vis_hi = p_last + 1 if causal else s
        keys = blk.keys
        assert keys, "a block with rows visits at least one tile"
        assert keys[0][0] <= vis_lo and keys[-1][1] >= vis_hi, "every visible key covered"
        for (a0, a1), (c0, _) in zip(keys, keys[1:]):
            assert a1 == c0, "tiles abut, so none is visited twice"
        for k0, k1 in keys:
            assert 0 <= k0 < k1 <= s and k1 - k0 <= plan.key_tile
            # some row p of the block sees some key of [k0, k1)
            hi_p = min(p_last, k1 - 2 + window) if window else p_last
            lo_p = max(p_first, k0) if causal else p_first
            if not causal:
                assert not window or k1 - 1 > p_first - window
            else:
                assert lo_p <= hi_p, f"tile [{k0}, {k1}) is masked for every row"
    assert (owner == 1).all(), "every row in exactly one block"


@pytest.mark.parametrize("s", [1, 14, 15, 16, 17, 64, 300, 4096])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("b", [1, 8])
def test_plan_covers_each_visible_pair_once(s, g, window, b):
    plan = _lib.flash_plan(b, s, g * KV, KV, 128, torch.bfloat16)
    assert plan.packed and plan.rows % (16 * plan.warps) == 0
    mt = plan.rows // (16 * plan.warps)
    assert mt in (1, 2) and 1 <= plan.warps <= 4
    assert plan.tiles * plan.rows >= s * g > (plan.tiles - 1) * plan.rows
    assert plan.rows - 16 * mt < s * g, "no warp of a block idle"
    check_cover(plan, b, s, g * KV, KV, window)


@pytest.mark.parametrize("s,window,causal", [(1, 0, True), (17, 0, True), (300, 64, True),
                                             (33, 0, False), (100, 8, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_covers_each_visible_pair_once_other_modes(s, window, causal, dtype):
    """The float32 (SIMT) plan, and non-causal attention, cover alike."""

    plan = _lib.flash_plan(2, s, 4 * KV, KV, 64, dtype)
    assert plan.packed == (dtype == torch.bfloat16)
    check_cover(plan, 2, s, 4 * KV, KV, window, causal=causal)


@pytest.mark.parametrize("b,s,h,kv,d,want", [
    # (rows a block, warps, key tile, blocks): openvla's 14-token prompt,
    # one warp a block, 32 blocks
    (1, 14, 32, 32, 128, (16, 1, 64, 32)),
    # Jamba (G = 8): 112 packed rows a KV head, 56 one-warp blocks
    (1, 14, 64, 8, 128, (16, 1, 64, 56)),
    # a prompt with its image: 4 warps of one m-tile, 160 blocks
    (1, 300, 32, 32, 128, (64, 4, 64, 160)),
    # a long prompt: 4 warps of two m-tiles, 1024 blocks
    (1, 4096, 32, 32, 128, (128, 4, 64, 1024)),
    # a batched prefill
    (8, 14, 32, 32, 128, (16, 1, 64, 256)),
    # D > 128: one m-tile, 32-key tiles
    (1, 4096, 32, 32, 256, (64, 4, 32, 2048)),
])
def test_plan_at_the_main_shapes(b, s, h, kv, d, want):
    plan = _lib.flash_plan(b, s, h, kv, d, torch.bfloat16)
    assert (plan.rows, plan.warps, plan.key_tile, plan.grid[0]) == want
    assert plan.grid[1:] == (1, 1)


@pytest.mark.parametrize("bad", [np.int64(8), torch.tensor(8), 8.0])
def test_plan_takes_host_integers_only(bad):
    """A shape read from the device would need a device-to-host copy (a sync
    a CUDA graph cannot capture): the planner refuses anything but an int."""

    with pytest.raises(TypeError):
        _lib.flash_plan(bad, 14, 32, 32, 128, torch.bfloat16)
    with pytest.raises(TypeError):
        _lib.flash_plan(1, bad, 32, 32, 128, torch.bfloat16)
    with pytest.raises(TypeError):
        _lib.flash_plan(1, 14, 32, 32, 128, torch.float16)


# ---------------------------------------------------------------------------
# (b) the algorithm over the planned tiles
# ---------------------------------------------------------------------------


def emulate(q, k, v, plan, *, causal=True, window=0, cap=0.0):
    """The kernel's arithmetic, block by block and tile by tile: scores in
    float32 kept unscaled (a softcap maps s to (cap / scale) tanh(s scale /
    cap)), exponents 2^(s scale log2 e - m) with the running max m in log2
    units, O and l rescaled once a tile, P rounded to bf16 for P.V in bf16
    runs (l sums the unrounded P)."""

    b, s, h, d = q.shape
    kv = k.shape[2]
    scale = d**-0.5
    scale_log2 = scale * np.log2(np.e)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(b, s, h, d)
    n_blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    for idx in range(n_blocks):
        blk = flash_block(plan, idx, b, s, kv, causal=causal, window=window)
        rows = torch.arange(*blk.rows)
        pos, heads = rows // blk.group, blk.head0 + rows % blk.group
        kvh = int(heads[0]) // (h // kv)
        qr = qf[blk.b, pos, heads]                       # [rows, D]
        m = torch.full((len(rows),), NEG_INF)
        l = torch.zeros(len(rows))
        o = torch.zeros(len(rows), d)
        for k0, k1 in blk.keys:
            sc = qr @ kf[blk.b, k0:k1, kvh].T             # [rows, keys]
            if cap:
                sc = (cap / scale) * torch.tanh(sc * (scale / cap))
            key = torch.arange(k0, k1)[None, :]
            vis = torch.ones_like(sc, dtype=torch.bool)
            if causal:
                vis &= key <= pos[:, None]
            if window:
                vis &= pos[:, None] - key < window
            sc = torch.where(vis, sc, torch.full_like(sc, NEG_INF))
            mx = sc.max(dim=1).values
            t = torch.where(mx == NEG_INF, mx, mx * scale_log2)
            m_new = torch.maximum(m, t)
            mu = torch.where(m_new == NEG_INF, torch.zeros_like(m_new), m_new)
            alpha = torch.exp2(m - mu)
            p = torch.exp2(sc * scale_log2 - mu[:, None])
            l = l * alpha + p.sum(dim=1)
            if q.dtype == torch.bfloat16:
                p = p.to(torch.bfloat16).float()
            o = o * alpha[:, None] + p @ vf[blk.b, k0:k1, kvh]
            m = m_new
        out[blk.b, pos, heads] = o / torch.clamp(l, min=1e-30)[:, None]
    return out.to(q.dtype)


def forced_plan(b, s, h, kv, d, mt, warps):
    """The bf16 plan with a given (m-tiles a warp, warps): the kernel takes
    any of them; the planner picks one by the shape."""

    rows = 16 * mt * warps
    tiles = -(-s * (h // kv) // rows)
    base = _lib.flash_plan(b, s, h, kv, d, torch.bfloat16)
    return base._replace(rows=rows, warps=warps, tiles=tiles, grid=(tiles * b * kv, 1, 1))


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.as_tensor(x).to(getattr(torch, dtype))


@functools.lru_cache(maxsize=None)
def _jax_ref(causal, window, cap):
    return jax.jit(functools.partial(jref.flash_attention_ref, causal=causal, window=window,
                                     logit_cap=cap))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


EMULATION_CASES = [
    # b, s, h, kv, d, causal, window, cap, dtype
    (1, 37, 4, 4, 32, True, 0, 0.0, "float32"),      # ragged S, MHA
    (2, 70, 8, 2, 64, True, 0, 0.0, "bfloat16"),     # GQA (G = 4), B > 1
    (1, 150, 4, 1, 40, True, 24, 30.0, "float32"),   # MQA, window + softcap, D padded to 48
    (1, 300, 4, 1, 16, True, 64, 50.0, "bfloat16"),  # window 64 + cap 50 over 5 key tiles
    (3, 17, 2, 2, 8, True, 0, 0.0, "bfloat16"),      # D = 8, S one past a tile of 16
    (1, 33, 2, 1, 32, False, 0, 0.0, "float32"),     # non-causal
    (2, 20, 16, 2, 16, True, 0, 20.0, "float32"),    # G = 8 (Jamba's packing), softcap
]


# bf16 cases also run under the plans the kernel takes besides its own
# choice; float32 runs the scalar body, whose plan is fixed
SHAPED_CASES = [case + (shape,) for case in EMULATION_CASES
                for shape in (("planned", "two m-tiles, 4 warps", "one warp")
                              if case[-1] == "bfloat16" else ("planned",))]


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,cap,dtype,shape", SHAPED_CASES)
def test_tiled_emulation_matches_plain_and_jax(b, s, h, kv, d, causal, window, cap, dtype,
                                               shape):
    rng = np.random.default_rng(s * 13 + h + d)
    (jq, tq), (jk, tk), (jv, tv) = (_rand(rng, sh, dtype) for sh in
                                    [(b, s, h, d), (b, s, kv, d), (b, s, kv, d)])
    if shape == "planned":
        plan = _lib.flash_plan(b, s, h, kv, d, getattr(torch, dtype))
    elif shape == "one warp":
        plan = forced_plan(b, s, h, kv, d, 1, 1)
    else:
        plan = forced_plan(b, s, h, kv, d, 2, 4)
    got = emulate(tq, tk, tv, plan, causal=causal, window=window, cap=cap)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    _close(got, tref.flash_attention_ref(tq, tk, tv, **kw).float(), dtype)
    _close(got, _jax_ref(causal, window, cap)(jq, jk, jv), dtype)
