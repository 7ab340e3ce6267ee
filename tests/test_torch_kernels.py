"""The port's plain attention versions against the JAX oracles and Pallas
kernels, and the device dispatch of ``repro_torch.kernels.ops``.

Inputs are numpy arrays from a seed, handed to both frameworks.  Tolerance:
float32 atol = rtol = 1e-5 (the same math summed in another order); bf16
atol = rtol = 2e-2 (outputs rounded to bf16, whose step near 1 is 2^-7;
the JAX paged oracle also rounds its probabilities to bf16).  Pallas
kernels run with ``interpret=True``, as the JAX package's own tests run them
here, at small shapes.  The CUDA kernels themselves are held against these
plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.paged_attention import paged_decode_attention as pallas_paged  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _jit(fn, **static):
    """A JAX oracle compiled once (faster here than op-by-op dispatch)."""

    return jax.jit(functools.partial(fn, **static))


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.as_tensor(x).to(getattr(torch, dtype))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # b, s, h, kv, d, causal, window, cap, dtype
    (2, 37, 4, 2, 32, True, 0, 0.0, "float32"),    # ragged S, GQA
    (1, 64, 8, 2, 64, True, 16, 30.0, "float32"),  # window + softcap
    (1, 20, 4, 4, 16, False, 0, 0.0, "float32"),   # non-causal MHA
    (1, 14, 4, 4, 64, True, 0, 0.0, "float32"),    # the serving prompt length
    (1, 33, 4, 1, 32, True, 0, 20.0, "bfloat16"),  # MQA in bf16
]


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,cap,dtype", FLASH_CASES)
def test_flash_plain_matches_jax_oracle(b, s, h, kv, d, causal, window, cap, dtype):
    rng = np.random.default_rng(s * 10 + h)
    (jq, tq), (jk, tk), (jv, tv) = (_rand(rng, sh, dtype) for sh in
                                    [(b, s, h, d), (b, s, kv, d), (b, s, kv, d)])
    kw = dict(causal=causal, window=window, logit_cap=cap)
    got = ops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, _jit(jref.flash_attention_ref, **kw)(jq, jk, jv), dtype)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 30.0)])
def test_flash_plain_matches_pallas_interpret(window, cap):
    rng = np.random.default_rng(5)
    b, s, h, kv, d = 1, 64, 4, 2, 32
    (jq, tq), (jk, tk), (jv, tv) = (_rand(rng, sh, "float32") for sh in
                                    [(b, s, h, d), (b, s, kv, d), (b, s, kv, d)])
    want = pallas_flash(jq, jk, jv, causal=True, window=window, logit_cap=cap,
                        blk_q=32, blk_k=32, interpret=True)
    _close(ops.flash_attention(tq, tk, tv, window=window, logit_cap=cap), want, "float32")


# ---------------------------------------------------------------------------
# dense decode attention
# ---------------------------------------------------------------------------

DECODE_CASES = [
    # b, s, h, kv, d, cache_len, window, cap, dtype
    (2, 70, 8, 2, 32, 70, 0, 0.0, "float32"),
    (1, 130, 4, 4, 64, 101, 32, 30.0, "float32"),
    (3, 40, 16, 1, 16, 1, 0, 0.0, "float32"),   # single-token cache, MQA
    (2, 70, 4, 4, 32, 45, 0, 0.0, "bfloat16"),
]


@pytest.mark.parametrize("b,s,h,kv,d,clen,window,cap,dtype", DECODE_CASES)
def test_decode_plain_matches_jax_oracle(b, s, h, kv, d, clen, window, cap, dtype):
    rng = np.random.default_rng(s + h)
    (jq, tq), (jk, tk), (jv, tv) = (_rand(rng, sh, dtype) for sh in
                                    [(b, h, d), (b, s, kv, d), (b, s, kv, d)])
    kw = dict(window=window, logit_cap=cap)
    got = ops.decode_attention(tq, tk, tv, cache_len=clen, **kw)
    _close(got, _jit(jref.decode_attention_ref, cache_len=clen, **kw)(jq, jk, jv), dtype)


def test_decode_plain_per_row_lengths():
    """A [B] length tensor equals the scalar oracle applied row by row."""

    rng = np.random.default_rng(11)
    b, s, h, kv, d = 3, 50, 8, 2, 32
    (jq, tq), (jk, tk), (jv, tv) = (_rand(rng, sh, "float32") for sh in
                                    [(b, h, d), (b, s, kv, d), (b, s, kv, d)])
    lens = [50, 7, 23]
    got = ops.decode_attention(tq, tk, tv, cache_len=torch.tensor(lens, dtype=torch.int32),
                               window=16, logit_cap=0.0)
    for r, n in enumerate(lens):
        want = _jit(jref.decode_attention_ref, cache_len=n, window=16)(
            jq[r:r + 1], jk[r:r + 1], jv[r:r + 1]
        )
        _close(got[r:r + 1], want, "float32")


def test_decode_plain_matches_pallas_interpret():
    rng = np.random.default_rng(6)
    b, s, h, kv, d = 2, 64, 4, 2, 32
    (jq, tq), (jk, tk), (jv, tv) = (_rand(rng, sh, "float32") for sh in
                                    [(b, h, d), (b, s, kv, d), (b, s, kv, d)])
    want = pallas_decode(jq, jk, jv, cache_len=50, window=20, logit_cap=30.0,
                         blk_s=32, interpret=True)
    got = ops.decode_attention(tq, tk, tv, cache_len=50, window=20, logit_cap=30.0)
    _close(got, want, "float32")


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

PAGED_CASES = [
    # b, h, kv, d, page, pool, maxp, lens, window, cap, dtype
    (3, 8, 2, 32, 16, 24, 6, (1, 70, 95), 0, 0.0, "float32"),
    (2, 4, 4, 32, 16, 12, 5, (16, 7), 0, 0.0, "float32"),          # page-aligned length
    (4, 8, 1, 16, 8, 40, 8, (64, 13, 0, 33), 0, 0.0, "float32"),   # MQA, a length-0 row
    (2, 8, 2, 32, 16, 16, 4, (50, 49), 24, 0.0, "float32"),        # sliding window
    (3, 8, 4, 32, 16, 24, 5, (70, 1, 37), 16, 50.0, "float32"),    # window + cap
    (2, 8, 8, 64, 128, 6, 2, (200, 3), 0, 0.0, "bfloat16"),        # page 128, bf16
]


def _paged_inputs(b, h, kv, d, page, pool, maxp, lens, dtype, seed):
    rng = np.random.default_rng(seed)
    q = _rand(rng, (b, h, d), dtype)
    kp = _rand(rng, (pool, page, kv, d), dtype)
    vp = _rand(rng, (pool, page, kv, d), dtype)
    table = rng.permutation(pool)[: b * maxp].reshape(b, maxp).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    return q, kp, vp, table, lens


@pytest.mark.parametrize("b,h,kv,d,page,pool,maxp,lens,window,cap,dtype", PAGED_CASES)
def test_paged_plain_matches_jax_oracle(b, h, kv, d, page, pool, maxp, lens, window, cap,
                                        dtype):
    (jq, tq), (jk, tk), (jv, tv), table, lens = _paged_inputs(
        b, h, kv, d, page, pool, maxp, lens, dtype, seed=b * 100 + h
    )
    kw = dict(window=window, logit_cap=cap)
    got = ops.paged_decode_attention(tq, tk, tv, torch.as_tensor(table),
                                     torch.as_tensor(lens), **kw)
    want = _jit(jref.paged_decode_attention_ref, **kw)(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(lens)
    )
    live = lens >= 1  # the JAX oracle returns the uniform mean for length 0
    _close(got[torch.as_tensor(live)], np.asarray(want, np.float32)[live], dtype)
    assert not got[torch.as_tensor(~live)].any(), "a length-0 row must give zeros"


@pytest.mark.parametrize("window,cap", [(0, 0.0), (20, 30.0)])
def test_paged_plain_matches_pallas_interpret(window, cap):
    (jq, tq), (jk, tk), (jv, tv), table, lens = _paged_inputs(
        2, 4, 2, 32, 16, 10, 4, (37, 0), "float32", seed=9
    )
    want = np.asarray(pallas_paged(jq, jk, jv, jnp.asarray(table), jnp.asarray(lens),
                                   window=window, logit_cap=cap, interpret=True))
    got = ops.paged_decode_attention(tq, tk, tv, torch.as_tensor(table),
                                     torch.as_tensor(lens), window=window, logit_cap=cap)
    # both the Pallas kernel and the port give 0 for the length-0 row
    _close(got, want, "float32")


# ---------------------------------------------------------------------------
# dispatch: the tensor's device decides
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((1, 5, 2, 8)), dtype=torch.float32)
    out = ops.flash_attention(q, q, q)
    torch.testing.assert_close(out, tref.flash_attention_ref(q, q, q), rtol=0, atol=0)
    assert all(n == 0 for n in ops.LAUNCHES.values())


def test_launchers_refuse_non_cuda_tensors():
    """The kernel launchers never fall back: a CPU tensor raises before any
    build or launch, and another device raises in the dispatch."""

    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention(q[:, 0], q, q, cache_len=4)
    i32 = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention(q[:, 0], q, q, i32, i32[:, 0])
    meta = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no attention path"):
        ops.flash_attention(meta, meta, meta)
    assert all(n == 0 for n in ops.LAUNCHES.values())
