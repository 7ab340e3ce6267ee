"""The training attention's plain versions against the JAX package.

``ref.flash_attention_lse_ref`` (out and the per-row log-sum-exp) and
``ref.flash_attention_bwd_ref`` (dq, dk, dv) against the reference's
``flash_attention_jnp`` forward and its ``jax.vjp`` (the custom-VJP strip
a block of 128 query rows at a time; the exact softmax where S % 128 != 0),
on the same numpy inputs: GQA G = 1 and 4, a window, a softcap, non-causal,
S = 128, 256 and 300.  ``ops.flash_attention_train`` is checked with
``torch.autograd.gradcheck`` in float64.

Tolerances, as a share of the largest |value| of the output compared:
float32 2e-5 (the same sums in another order; the gradients add up to S
rows); bfloat16 inputs 2^-7 on the blockwise shapes (both sides compute in
float32 and round the result to bf16 once: a step of 2^-8 at the largest
value, two where a value rounds the other way) and 2^-5 at S = 300, where
the reference's exact softmax takes its score product in bf16 and rounds
its probabilities to bf16 (repro/models/attention.py:95-112) while the
plain version keeps both in float32.  The lse against a float64 logsumexp
of the same scores: 1e-5 absolute (lse is O(1-10)).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import flash_attention_jnp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

B, KV, D = 2, 2, 32
F32_TOL, BF16_TOL, BF16_RAGGED_TOL = 2e-5, 2.0**-7, 2.0**-5

# (G, S, causal, window, cap, dtype)
CASES = [
    (1, 128, True, 0, 0.0, "float32"),
    (4, 256, True, 0, 0.0, "float32"),
    (4, 256, True, 64, 0.0, "float32"),
    (1, 256, True, 0, 30.0, "float32"),
    (4, 300, True, 100, 30.0, "float32"),
    (1, 300, False, 0, 0.0, "float32"),
    (4, 256, False, 0, 50.0, "float32"),
    (1, 128, True, 0, 0.0, "bfloat16"),
    (4, 256, True, 64, 30.0, "bfloat16"),
    (1, 300, False, 0, 0.0, "bfloat16"),
]


def _inputs(g, s, seed=0):
    rng = np.random.default_rng(seed)
    h = KV * g
    q = rng.standard_normal((B, s, h, D)).astype(np.float32) * 2.0
    k = rng.standard_normal((B, s, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, s, KV, D)).astype(np.float32)
    dout = rng.standard_normal((B, s, h, D)).astype(np.float32)
    return q, k, v, dout


def _jax_fwd_vjp(q, k, v, dout, causal, window, cap, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    s = q.shape[1]
    pos = jnp.broadcast_to(jnp.arange(s)[None], (B, s))

    def f(q, k, v):
        return flash_attention_jnp(q, k, v, pos, pos, causal=causal, window=window,
                                   logit_cap=cap)

    out, vjp = jax.vjp(f, *(jnp.asarray(x, jd) for x in (q, k, v)))
    grads = vjp(jnp.asarray(dout, jd))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3g} > {rel:g} x max|want| {scale:.3g}"


def _lse64(q, k, causal, window, cap):
    """float64 log-sum-exp of each row's visible softcapped scores, [B,H,S]."""

    b, s, h, d = q.shape
    g = h // k.shape[2]
    qd = torch.as_tensor(q, dtype=torch.float64)
    kd = torch.as_tensor(k, dtype=torch.float64).repeat_interleave(g, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * d**-0.5
    if cap:
        sc = cap * torch.tanh(sc / cap)
    qp, kp = torch.arange(s)[:, None], torch.arange(s)[None, :]
    vis = torch.ones((s, s), dtype=torch.bool)
    if causal:
        vis &= qp >= kp
    if window:
        vis &= (qp - kp) < window
    return torch.logsumexp(sc.masked_fill(~vis, -torch.inf), dim=-1).numpy()


@pytest.mark.parametrize("g,s,causal,window,cap,dtype", CASES)
def test_plain_forward_and_backward_match_the_reference_vjp(g, s, causal, window, cap, dtype):
    q, k, v, dout = _inputs(g, s)
    want = _jax_fwd_vjp(q, k, v, dout, causal, window, cap, dtype)
    td = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.as_tensor(x).to(td) for x in (q, k, v, dout))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    out, lse = ref.flash_attention_lse_ref(tq, tk, tv, **kw)
    assert out.dtype == td and lse.dtype == torch.float32 and lse.shape == (B, KV * g, s)
    grads = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, **kw)
    rel = F32_TOL if dtype == "float32" else BF16_TOL if s % 128 == 0 else BF16_RAGGED_TOL
    for name, got, w in zip(("out", "dq", "dk", "dv"), (out, *grads), want):
        assert got.dtype == td
        _close(got, w, rel, name)
    lse_want = _lse64(tq.float().numpy(), tk.float().numpy(), causal, window, cap)
    np.testing.assert_allclose(lse.numpy(), lse_want, atol=1e-5, rtol=0)


def test_the_blocks_do_not_change_the_result():
    """Blocks of 16 rows give the 128-row blocks' results (each query row's
    math is its own; dk and dv add the blocks in order)."""

    q, k, v, dout = (torch.as_tensor(x) for x in _inputs(4, 300, seed=3))
    kw = dict(causal=True, window=50, logit_cap=20.0)
    out, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    out16, lse16 = ref.flash_attention_lse_ref(q, k, v, blk_q=16, **kw)
    torch.testing.assert_close(out16, out, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse16, lse, atol=1e-6, rtol=0)
    g = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    g16 = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, blk_q=16, **kw)
    for a, b in zip(g16, g):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0), (True, 3, 2.0), (False, 0, 1.5)])
def test_flash_attention_train_gradcheck_float64(causal, window, cap):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 6, 4, 8), dtype=torch.float64, generator=gen, requires_grad=True)
    k = torch.randn((1, 6, 2, 8), dtype=torch.float64, generator=gen, requires_grad=True)
    v = torch.randn((1, 6, 2, 8), dtype=torch.float64, generator=gen, requires_grad=True)
    fn = lambda q, k, v: ops.flash_attention_train(  # noqa: E731
        q, k, v, causal=causal, window=window, logit_cap=cap)
    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6, rtol=1e-5)
    # the forward is the serving path's function (which computes in float32)
    want = ref.flash_attention_ref(q.detach(), k.detach(), v.detach(), causal=causal,
                                   window=window, logit_cap=cap)
    torch.testing.assert_close(fn(q, k, v).detach(), want, atol=1e-6, rtol=0)


def test_train_attention_on_cpu_launches_no_kernel():
    q, k, v, _ = (torch.as_tensor(x).requires_grad_() for x in _inputs(1, 64))
    ops.reset_launch_counts()
    ops.flash_attention_train(q, k, v).sum().backward()
    assert all(n == 0 for n in ops.LAUNCHES.values())
    assert q.grad is not None and k.grad is not None and v.grad is not None
