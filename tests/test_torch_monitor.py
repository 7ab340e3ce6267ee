"""The port's RAPID monitor statistics against the JAX reference.

``rolling_stats_ref`` (the plain version of the ``rolling_stats`` kernel) is
held against the reference's oracle and its Pallas kernel run with
``interpret=True`` at the JAX package's own test shapes, and against the
port's ``run_trigger`` over a fleet's episode streams; ``run_trigger``
against the reference's.  Inputs are numpy arrays from a seed or the
episodes of ``generate_episode``.  Tolerances are the JAX package's own
(``tests/test_kernels.py``): the plain version recomputes the window sums
each tick, as the oracle does, so it matches the oracle to float32
rounding (1e-5); the Pallas kernel keeps incremental sums that drift from
recomputed ones, so scores agree to 5e-4 and the moving average to 5e-5;
``rolling_stats`` against the trigger's scores to 1e-3, as the JAX package
holds its kernel to its trigger.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import kinematics as jkin  # noqa: E402
from repro.core import trigger as jtrig  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rolling_stats import rolling_stats as pallas_rolling_stats  # noqa: E402
from repro_torch.core import kinematics as tkin  # noqa: E402
from repro_torch.core.trigger import TriggerConfig, run_trigger  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rolling_stats as trs  # noqa: E402
from repro_torch.robotics.episodes import generate_episode  # noqa: E402

CASES = [(4, 200, 64, 16), (130, 96, 32, 8), (1, 50, 16, 4)]  # n, t, window_acc, window_tau
FLOORS = dict(sigma_floor_acc=1.0, sigma_floor_tau=0.05)
TASKS = ("pick_place", "drawer_open", "peg_insertion")


def _streams(n, t, seed):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal((n, t))).astype(np.float32) * 2,
            np.abs(rng.standard_normal((n, t))).astype(np.float32))


@pytest.mark.parametrize("n,t,wa,wt", CASES)
def test_rolling_stats_plain_matches_jax_oracle(n, t, wa, wt):
    ma, tp = _streams(n, t, seed=n + t)
    want = jax.jit(lambda a, b: jref.rolling_stats_ref(
        a, b, window_acc=wa, window_tau=wt, **FLOORS))(jnp.asarray(ma), jnp.asarray(tp))
    got = ops.rolling_stats(torch.as_tensor(ma), torch.as_tensor(tp), window_acc=wa,
                            window_tau=wt, **FLOORS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,t,wa,wt", CASES)
def test_rolling_stats_plain_matches_pallas_interpret(n, t, wa, wt):
    ma, tp = _streams(n, t, seed=2 * n + t)
    sa, st, mt = pallas_rolling_stats(jnp.asarray(ma), jnp.asarray(tp), window_acc=wa,
                                      window_tau=wt, interpret=True)
    got = tref.rolling_stats_ref(torch.as_tensor(ma), torch.as_tensor(tp), window_acc=wa,
                                 window_tau=wt, **FLOORS)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(sa), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(st), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(mt), atol=5e-5, rtol=5e-5)


def _fleet(n_robots, t_len):
    """qd, tau [T, R, 7]: episodes of the tasks in turn, seeds 0..R-1, cut
    to ``t_len`` ticks."""

    eps = [generate_episode(TASKS[r % 3], seed=r) for r in range(n_robots)]
    qd = np.stack([e.qd[:t_len] for e in eps], axis=1)
    tau = np.stack([e.tau[:t_len] for e in eps], axis=1)
    return qd, tau


def _features(qd, tau, cfg):
    """m_acc, tau_pow [R, T] from [T, R, N] streams, as the trigger forms them."""

    qd, tau = torch.as_tensor(qd), torch.as_tensor(tau)
    w = tkin.end_joint_weights(qd.shape[-1], cfg.end_joint_emphasis, "cpu")
    prev = lambda v: torch.cat([torch.zeros_like(v[:1]), v[:-1]])  # noqa: E731
    m_acc = tkin.accel_magnitude(tkin.finite_diff_accel(qd, prev(qd), cfg.dt), w)
    tau_pow = tkin.torque_power(tkin.torque_variation(tau, prev(tau)), w)
    return m_acc.T.contiguous(), tau_pow.T.contiguous()


def test_rolling_stats_matches_run_trigger_on_fleet_episodes():
    """The monitor op over a fleet's bank of streams gives the scores the
    port's own trigger computes tick by tick."""

    cfg = TriggerConfig()
    qd, tau = _fleet(6, 600)
    frames = tkin.KinematicFrame(torch.as_tensor(np.cumsum(qd, 0)), torch.as_tensor(qd),
                                 torch.as_tensor(tau))
    _, out = run_trigger(cfg, frames)
    sa, st, _ = ops.rolling_stats(*_features(qd, tau, cfg), window_acc=cfg.window_acc,
                                  window_tau=cfg.window_tau,
                                  sigma_floor_acc=cfg.sigma_floor_acc,
                                  sigma_floor_tau=cfg.sigma_floor_tau)
    torch.testing.assert_close(sa, out.score_acc.T, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(st, out.score_tau.T, atol=1e-3, rtol=1e-3)


def test_run_trigger_matches_reference():
    cfg = TriggerConfig()
    qd, tau = _fleet(3, 200)
    q = np.cumsum(qd, 0)
    _, want = jax.jit(lambda f: jtrig.run_trigger(jtrig.TriggerConfig(), f))(
        jkin.KinematicFrame(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(tau)))
    state, got = run_trigger(cfg, tkin.KinematicFrame(*map(torch.as_tensor, (q, qd, tau))))
    assert int(state.tick[0]) == 200 and got.score_acc.shape == (200, 3)
    for name in ("score_acc", "score_tau", "importance"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got.dispatch.numpy(), np.asarray(want.dispatch))


def test_rolling_stats_cpu_dispatch_and_launcher_checks():
    ma, tp = map(torch.as_tensor, _streams(3, 40, seed=0))
    ops.reset_launch_counts()
    got = ops.rolling_stats(ma, tp)
    for g, w in zip(got, tref.rolling_stats_ref(ma, tp)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ops.LAUNCHES["rolling_stats"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        trs.rolling_stats(ma, tp)
    meta = torch.empty((3, 40), device="meta")
    with pytest.raises(ValueError, match="no rolling_stats path"):
        ops.rolling_stats(meta, meta)
