"""The Mamba scan's gradients and Jamba's training path, on the CPU.

``ref.mamba_scan_bwd_ref`` (the plain version of the hand-written backward,
``csrc/mamba_scan_bwd.cu``) against the JAX package's ``jax.vjp`` of
``repro.models.ssm.ssd_chunked`` and against torch autograd through
``ref.mamba_scan_ref``, on the same numpy-seeded inputs and cotangents: one
chunk and several, with and without h0, dh_t zero (None) and nonzero, and a
large dt (decays near 0 within a few steps: the masked corner of the
pairs; compared in float64 on both sides, since in float32 a chunk's
prefix sums reach ~-1e4 there and each side's rounding of them moves the
decays by ~1e-3, a difference of the two float32 versions and not of the
math).  ``ops.mamba_scan`` under autograd (``_MambaScanTrain``) is checked
with ``torch.autograd.gradcheck`` in float64, launches nothing on the CPU,
and leaves the no-grad path (serving) as it was.  jamba-smoke's
``loss_fn`` and every gradient against the reference at S = 512 (two
chunks of 256), and ``launch.train.main`` for Jamba on the CPU.

Tolerances: dx, ddt and dh0 ``SCAN_TOL`` (atol 5e-4, rtol 5e-3, the JAX
package's for its own scan kernel: the same sums in another order, exps of
differences of float32 prefix sums); da, dB and dC are sums over every step
and batch row (da) or over the heads (dB, dC) of terms that reach ~1e3 at a
large dt, so their atol is 5e-4 of the output's largest |value| (rtol
5e-3).  Against torch autograd (the same float32 arithmetic, summed by
autograd's transposes) the same.  gradcheck: its defaults in float64 (eps
1e-6, atol 1e-5, rtol 1e-3).  jamba-smoke: ``tests/test_torch_train.py``'s
loss rtol 1e-5 and leaf tolerance 1e-4 of each leaf's largest |value|
(2^-7 for the bf16 embedding table).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import mamba_scan_bwd as kmsb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from test_torch_train import (  # noqa: E402
    LOSS_RTOL,
    _batch,
    _check_grads,
    _port_loss_and_grads,
    _stacks,
)

torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

SCAN_TOL = dict(atol=5e-4, rtol=5e-3)
SUM_ATOL, SUM_RTOL = 5e-4, 5e-3
NAMES = ("dx", "ddt", "da", "dbm", "dc", "dh0")
JAMBA = "jamba-1.5-large-398b"

CASES = [  # b, s, h, p, n, chunk
    (2, 32, 3, 8, 4, 32),     # one chunk
    (2, 64, 3, 8, 4, 16),     # four chunks
    (1, 96, 2, 4, 5, 32),     # three chunks, N = 5
    (1, 512, 4, 16, 16, 256),  # Jamba's chunk of 256, two chunks
]
MODES = ["zero", "h0", "dh_t", "h0+dh_t", "big_dt"]


def _inputs(b, s, h, p, n, seed, big_dt=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    if big_dt:
        dt *= 30.0
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    c = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dh_t = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, c, h0, dy, dh_t


def _case(b, s, h, p, n, mode):
    x, dt, a, bm, c, h0, dy, dh_t = _inputs(b, s, h, p, n, seed=3 * s + h + p,
                                            big_dt=mode == "big_dt")
    return (x, dt, a, bm, c, h0 if "h0" in mode else None, dy,
            dh_t if "dh_t" in mode else None)


def _wide(mode, *arrays):
    """float64 for the large-dt mode, else as they are (float32)."""

    if mode != "big_dt":
        return arrays
    return tuple(None if v is None else v.astype(np.float64) for v in arrays)


def _plain_grads(x, dt, a, bm, c, h0, dy, dh_t, chunk):
    t = torch.as_tensor
    args = [t(v) for v in (x, dt, a, bm, c)]
    _, _, h_in = ref.mamba_scan_ref(*args, h0=None if h0 is None else t(h0), chunk=chunk,
                                    with_states=True)
    return ref.mamba_scan_bwd_ref(*args, h_in, t(dy), None if dh_t is None else t(dh_t),
                                  chunk=chunk)


def _check(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.shape == w.shape, (what, name)
        assert np.isfinite(g).all(), f"{what} {name} not finite"
        tol = SCAN_TOL
        if name in ("da", "dbm", "dc"):
            tol = dict(atol=SUM_ATOL * float(np.abs(w).max()), rtol=SUM_RTOL)
        np.testing.assert_allclose(g, w, err_msg=f"{what} {name}", **tol)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_plain_backward_matches_jax_vjp_of_ssd_chunked(b, s, h, p, n, chunk, mode):
    x, dt, a, bm, c, h0, dy, dh_t = _wide(mode, *_case(b, s, h, p, n, mode))
    got = _plain_grads(x, dt, a, bm, c, h0, dy, dh_t, chunk)
    with jax.enable_x64(mode == "big_dt"):
        zeros = np.zeros((b, h, p, n), x.dtype)
        (_, h_t), vjp = jax.vjp(
            lambda *v: jssm.ssd_chunked(*v[:5], chunk=chunk, h0=v[5]),
            *map(jnp.asarray, (x, dt, a, bm, c, zeros if h0 is None else h0)))
        want = [np.asarray(w) for w in vjp(
            (jnp.asarray(dy), jnp.zeros_like(h_t) if dh_t is None else jnp.asarray(dh_t)))]
    _check(got, want, f"jax {mode}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES[:3])
def test_plain_backward_matches_torch_autograd(b, s, h, p, n, chunk, mode):
    x, dt, a, bm, c, h0, dy, dh_t = _case(b, s, h, p, n, mode)
    got = _plain_grads(x, dt, a, bm, c, h0, dy, dh_t, chunk)
    leaves = [torch.tensor(v, requires_grad=True)
              for v in (x, dt, a, bm, c, h0 if h0 is not None else np.zeros((b, h, p, n),
                                                                            np.float32))]
    y, h_t = ref.mamba_scan_ref(*leaves[:5], h0=leaves[5], chunk=chunk)
    outs, cots = [y], [torch.as_tensor(dy)]
    if dh_t is not None:
        outs.append(h_t)
        cots.append(torch.as_tensor(dh_t))
    want = torch.autograd.grad(outs, leaves, cots)
    _check(got, want, f"autograd {mode}")


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("s,chunk", [(6, 6), (8, 4)], ids=["one chunk", "two chunks"])
def test_mamba_scan_train_gradcheck_float64(s, chunk, with_h0):
    rng = np.random.default_rng(s + chunk)
    b, h, p, n = 1, 2, 3, 2

    def leaf(shape, f=lambda v: v):
        return torch.tensor(f(rng.standard_normal(shape)), dtype=torch.float64,
                            requires_grad=True)

    x, bm, c = leaf((b, s, h, p)), leaf((b, s, n)), leaf((b, s, n))
    dt = leaf((b, s, h), lambda v: np.log1p(np.exp(v)))
    a = leaf((h,), lambda v: -np.exp(v))
    h0 = leaf((b, h, p, n)) if with_h0 else None
    args = (x, dt, a, bm, c) + ((h0,) if with_h0 else ())

    def fn(*t):
        return ops.mamba_scan(*t[:5], h0=t[5] if with_h0 else None, chunk=chunk)

    assert torch.autograd.gradcheck(fn, args)


def test_mamba_scan_train_on_the_cpu_counts_no_launch_and_leaves_serving_alone():
    x, dt, a, bm, c, h0, dy, _ = _inputs(2, 64, 3, 8, 4, seed=1)
    t = [torch.tensor(v) for v in (x, dt, a, bm, c, h0)]
    ops.reset_launch_counts()
    with torch.no_grad():
        y0, h_t0 = ops.mamba_scan(*t[:5], h0=t[5], chunk=16)
    leaves = [v.clone().requires_grad_() for v in t]
    y, h_t = ops.mamba_scan(*leaves[:5], h0=leaves[5], chunk=16)
    assert type(y.grad_fn).__name__ == "_MambaScanTrainBackward"
    assert torch.equal(y.detach(), y0) and torch.equal(h_t.detach(), h_t0)
    (y * torch.as_tensor(dy)).sum().backward()  # hT unused: its cotangent stays None
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in leaves)
    assert all(n == 0 for n in ops.LAUNCHES.values())


def test_mamba_scan_bwd_kernel_refuses_cpu_tensors():
    x, dt, a, bm, c, _, dy, _ = _inputs(1, 32, 2, 8, 4, seed=2)
    t = [torch.tensor(v) for v in (x, dt, a, bm, c)]
    _, _, h_in = ref.mamba_scan_ref(*t, chunk=16, with_states=True)
    with pytest.raises(ValueError, match="CUDA"):
        kmsb.mamba_scan_bwd(*t, h_in, torch.tensor(dy), None, chunk=16)


def test_jamba_smoke_loss_and_every_gradient_match_the_reference_at_two_chunks():
    jmodel, jparams, tmodel = _stacks(JAMBA)
    batch = _batch(jmodel.cfg, b=2, s=512, seed=7)
    (jloss, _), jgrads = jax.jit(
        lambda p, b: jax.value_and_grad(jmodel.loss_fn, has_aux=True)(p, b)
    )(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = _port_loss_and_grads(tmodel, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _check_grads(grads, jgrads)


def test_train_main_trains_jamba_on_the_cpu():
    res = train_main(["--arch", JAMBA, "--smoke", "--steps", "40", "--batch", "2", "--seq",
                      "128", "--data", "episodes", "--log-every", "1000", "--device", "cpu"])
    assert res["final_loss"] < res["first_loss"]
    assert len(res["losses"]) == 40 and np.isfinite(res["losses"]).all()
    assert res["model"].device.type == "cpu"
