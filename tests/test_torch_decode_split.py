"""The split-KV (flash-decoding) plan of the port's decode kernels, on the CPU.

The CUDA kernels cut each row's KV length into ``_lib.decode_splits``
ranges, attend each range on its own (a partial: running max m, softmax sum
l, unnormalised output o) and merge the partials in split order
(``decode_combine`` in ``csrc/attention_common.cuh``).  The kernels run only
on the card (``chip_smoke.py`` holds them against the plain versions);
here an emulation of that algorithm in torch, kept in this file, runs over
the planned ranges and is held against the port's plain versions
(``repro_torch.kernels.ref``) and the JAX oracles (``repro.kernels.ref``).

Tolerances: float32 atol = rtol = 1e-5 (the same math summed in another
order), bf16 atol = rtol = 2e-2 (outputs rounded to bf16; the JAX paged
oracle also rounds its probabilities to bf16), as in
``tests/test_torch_kernels.py``.  Paged outputs are compared with the JAX
oracle only on rows of length >= 1: for a length-0 row it returns the
uniform mean where the kernels and the port's plain version return 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# (a) the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pairs,group", [(1, 1), (8, 8), (32, 1), (256, 1), (4096, 16)])
@pytest.mark.parametrize("max_len", [0, 1, 31, 70, 1000, 4096, 100_000])
@pytest.mark.parametrize("gran", [1, 16, 128])
def test_splits_cover_the_length_once(pairs, group, max_len, gran):
    n, span = _lib.decode_splits(pairs, group, max_len, gran)
    assert n >= 1 and span >= 1
    assert span % gran == 0, "ranges start on page boundaries"
    # [i * span, (i + 1) * span) for i < n covers [0, max_len) exactly once,
    # with no range wholly past the end
    assert n * span >= max_len and (n - 1) * span < max(max_len, 1)
    covered = np.zeros(max_len, np.int64)
    for i in range(n):
        covered[i * span:(i + 1) * span] += 1
    assert (covered == 1).all()
    # a block's page-table entries fit its shared memory
    assert span <= -(-_lib.MAX_SPLIT // gran) * gran


@pytest.mark.parametrize("pairs,group,max_len,gran,want", [
    (32, 1, 70, 16, (1, 80)),       # openvla serving, len 70: one range, no merge
    (8, 8, 70, 16, (5, 16)),        # Jamba (8 KV heads of 8 query heads): 40 blocks
    (32, 1, 4096, 16, (32, 128)),   # S = 4096: 1024 blocks instead of 32
    (8, 8, 4096, 16, (16, 256)),    # Jamba S = 4096: 128 blocks instead of 8
    (256, 1, 1008, 16, (5, 208)),   # the ragged paged batch: B = 8, MAXP = 63
    (32, 1, 80, 128, (1, 128)),     # a row shorter than one page of 128
])
def test_splits_at_the_main_shapes(pairs, group, max_len, gran, want):
    assert _lib.decode_splits(pairs, group, max_len, gran) == want


@pytest.mark.parametrize("bad", [np.int64(8), torch.tensor(8), 8.0])
def test_splits_take_host_integers_only(bad):
    """A device length would need a device-to-host read (a sync that a CUDA
    graph cannot capture): the planner refuses anything but an int."""

    with pytest.raises(TypeError):
        _lib.decode_splits(bad, 1, 70, 16)
    with pytest.raises(TypeError):
        _lib.decode_splits(32, 1, bad, 16)


# ---------------------------------------------------------------------------
# (b) the algorithm: partials per planned range, merged in split order
# ---------------------------------------------------------------------------


def emulate(q, k, v, lens, window, cap, plan):
    """q [B,H,D]; k/v [B,T,KV,D] (a dense or gathered paged cache); lens
    [B] ints; ``plan`` = (n_split, split_len).  Each (row, KV head, split)
    attends the live tokens of its range [max(lo, i*L), min(hi, (i+1)*L))
    in float32 and keeps (m, l, o); the merge is decode_combine's."""

    b, h, d = q.shape
    t_cap, kv = k.shape[1], k.shape[2]
    g = h // kv
    n_split, span = plan
    qf = q.float().reshape(b, kv, g, d)
    out = torch.zeros(b, kv, g, d)
    for r in range(b):
        n = int(lens[r])
        hi, lo = max(0, min(n, t_cap)), (max(0, n - window) if window else 0)
        for j in range(kv):
            ms, ls, os_ = [], [], []
            for i in range(n_split):
                a, e = max(lo, i * span), min(hi, (i + 1) * span)
                if a >= e:  # an empty range
                    ms.append(torch.full((g,), NEG_INF))
                    ls.append(torch.zeros(g))
                    os_.append(torch.zeros(g, d))
                    continue
                s = qf[r, j] @ k[r, a:e, j].float().T * d**-0.5
                if cap:
                    s = cap * torch.tanh(s / cap)
                m = s.max(dim=1).values
                p = torch.exp(s - m[:, None])
                ms.append(m)
                ls.append(p.sum(dim=1))
                os_.append(p @ v[r, a:e, j].float())
            m, l, o = torch.stack(ms), torch.stack(ls), torch.stack(os_)
            w = torch.exp(m - m.max(dim=0).values)
            out[r, j] = (w[:, :, None] * o).sum(0) / torch.clamp((w * l).sum(0), min=1e-30)[:, None]
    return out.reshape(b, h, d).to(q.dtype)


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.as_tensor(x).to(getattr(torch, dtype))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


DENSE_CASES = [
    # b, s, h, kv, d, lens, window, cap, dtype
    (4, 200, 4, 4, 32, (0, 1, 37, 200), 0, 0.0, "float32"),   # ragged, lengths 0 and 1
    (1, 1024, 4, 1, 32, (1000,), 500, 0.0, "float32"),        # a window over 5 of 8 splits
    (2, 160, 16, 2, 32, (160, 90), 0, 30.0, "float32"),       # G = 8, softcap
    (2, 300, 2, 2, 64, (300, 1), 100, 50.0, "bfloat16"),      # window + cap in bf16
    (1, 300, 8, 1, 16, (300,), 0, 0.0, "bfloat16"),           # G = 8 (MQA) in bf16
]


@pytest.mark.parametrize("b,s,h,kv,d,lens,window,cap,dtype", DENSE_CASES)
def test_dense_split_emulation_matches_plain_and_jax(b, s, h, kv, d, lens, window, cap, dtype):
    rng = np.random.default_rng(s * 7 + h)
    (jq, tq), (jk, tk), (jv, tv) = (_rand(rng, sh, dtype) for sh in
                                    [(b, h, d), (b, s, kv, d), (b, s, kv, d)])
    # a [B] length tensor: the planner takes S, as the launcher does
    plan = _lib.decode_splits(b * kv, h // kv, s)
    assert plan[0] > 1, "the case must exercise the merge"
    got = emulate(tq, tk, tv, lens, window, cap, plan)
    plain = tref.decode_attention_ref(tq, tk, tv, cache_len=torch.tensor(lens, dtype=torch.int32),
                                      window=window, logit_cap=cap)
    _close(got, plain.float(), dtype)
    for r, n in enumerate(lens):
        want = jref.decode_attention_ref(jq[r:r + 1], jk[r:r + 1], jv[r:r + 1], cache_len=n,
                                         window=window, logit_cap=cap)
        if n:
            _close(got[r:r + 1], want, dtype)
        else:
            assert not got[r].any(), "a length-0 row gives zeros"


PAGED_CASES = [
    # b, h, kv, d, page, maxp, lens, window, cap, dtype
    (4, 4, 4, 32, 16, 20, (0, 1, 150, 320), 0, 0.0, "float32"),    # page 16, G = 1
    (3, 16, 2, 32, 16, 16, (256, 1, 77), 90, 0.0, "float32"),       # G = 8, window
    (2, 8, 8, 32, 128, 4, (500, 129), 0, 30.0, "float32"),          # page 128, softcap
    (3, 16, 2, 64, 16, 12, (190, 0, 33), 0, 20.0, "bfloat16"),      # G = 8 in bf16
    (2, 4, 4, 32, 128, 3, (384, 2), 200, 0.0, "bfloat16"),          # page 128, window, bf16
]


@pytest.mark.parametrize("b,h,kv,d,page,maxp,lens,window,cap,dtype", PAGED_CASES)
def test_paged_split_emulation_matches_plain_and_jax(b, h, kv, d, page, maxp, lens, window,
                                                     cap, dtype):
    rng = np.random.default_rng(page + maxp + h)
    pool = b * maxp + 2
    (jq, tq), (jk, tk), (jv, tv) = (_rand(rng, sh, dtype) for sh in
                                    [(b, h, d), (pool, page, kv, d), (pool, page, kv, d)])
    table = rng.permutation(pool)[: b * maxp].reshape(b, maxp).astype(np.int32)
    tl = torch.as_tensor(np.asarray(lens, np.int32))
    plan = _lib.decode_splits(b * kv, h // kv, maxp * page, page)
    assert plan[0] > 1 and plan[1] % page == 0
    idx = torch.as_tensor(table).long()
    gathered_k = tk[idx].reshape(b, maxp * page, kv, d)
    gathered_v = tv[idx].reshape(b, maxp * page, kv, d)
    got = emulate(tq, gathered_k, gathered_v, lens, window, cap, plan)
    plain = tref.paged_decode_attention_ref(tq, tk, tv, torch.as_tensor(table), tl,
                                            window=window, logit_cap=cap)
    _close(got, plain.float(), dtype)
    want = np.asarray(jref.paged_decode_attention_ref(jq, jk, jv, jnp.asarray(table),
                                                      jnp.asarray(np.asarray(lens, np.int32)),
                                                      window=window, logit_cap=cap), np.float32)
    live = np.asarray(lens) >= 1
    _close(got[torch.as_tensor(live)], want[live], dtype)
    assert not got[torch.as_tensor(~live)].any(), "a length-0 row gives zeros"
