"""The port's episodes, RAPID monitor and dispatcher against the reference.

Episodes: the numpy float32 twin agrees with the JAX-built episode to
rtol 1e-5 plus atol 1e-5 on positions, velocities and actions (float32
linspace, cumsum and transcendentals differ in the last bits) and atol
2e-3 on torques, which sum inertia x acceleration terms of O(1e3) whose
last float32 bits are O(1e-4) each.  Decisions are fed the
reference's own episode arrays, so the offload / replay / preempt streams
must be equal and the executed actions equal to 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dispatcher as jdisp  # noqa: E402
from repro.core import kinematics as jkin  # noqa: E402
from repro.robotics import episodes as jeps  # noqa: E402
from repro.runtime import policy as jpolicy  # noqa: E402
from repro_torch.core import dispatcher as tdisp  # noqa: E402
from repro_torch.core.kinematics import KinematicFrame  # noqa: E402
from repro_torch.robotics.episodes import generate_episode  # noqa: E402
from repro_torch.runtime import policy as tpolicy  # noqa: E402

TASKS = ("pick_place", "drawer_open", "peg_insertion")


@pytest.mark.parametrize("task,seed", [(t, 0) for t in TASKS] + [("pick_place", 3)])
def test_generate_episode_matches_reference(task, seed):
    want = jeps.generate_episode(task, seed=seed)
    got = generate_episode(task, seed=seed)
    for name in ("q", "qd", "tau", "tau_ext", "ref_actions"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == np.float32 and a.shape == b.shape, name
        atol = 2e-3 if name == "tau" else 1e-5
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol, err_msg=name)
    np.testing.assert_array_equal(got.critical, want.critical)
    np.testing.assert_array_equal(got.phase_id, want.phase_id)


def _frames(ep, t):
    return KinematicFrame(*(torch.as_tensor(getattr(ep, n)[t]) for n in ("q", "qd", "tau")))


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("edge", [False, True], ids=["cloud", "edge"])
def test_dispatcher_streams_match_reference(task, edge):
    ep = jeps.generate_episode(task, seed=1)
    k = 8
    cloud = jeps.reference_chunks(ep, k)
    edge_chunks = jeps.edge_policy_chunks(ep, k) if edge else None
    frames = jkin.KinematicFrame(jnp.asarray(ep.q), jnp.asarray(ep.qd), jnp.asarray(ep.tau))
    _, want = jax.jit(
        lambda f, c, e: jdisp.run_episode(jdisp.DispatcherConfig(), f, c, edge_chunks=e)
    )(frames, jnp.asarray(cloud), None if edge_chunks is None else jnp.asarray(edge_chunks))

    _, got = tdisp.run_episode(
        tdisp.DispatcherConfig(),
        KinematicFrame(*(torch.as_tensor(getattr(ep, n)) for n in ("q", "qd", "tau"))),
        torch.as_tensor(cloud),
        edge_chunks=None if edge_chunks is None else torch.as_tensor(edge_chunks),
    )
    np.testing.assert_array_equal(got.offloaded.numpy(), np.asarray(want.offloaded))
    np.testing.assert_array_equal(got.edge_refill.numpy(), np.asarray(want.edge_refill))
    np.testing.assert_allclose(got.action.numpy(), np.asarray(want.action), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.trig.importance.numpy(), np.asarray(want.trig.importance),
                               rtol=1e-4, atol=1e-4)


def test_reuse_mode_decisions_match_reference_rollout():
    ep = jeps.generate_episode("peg_insertion", seed=2)
    jcfg = jpolicy.PolicyConfig(on_empty="reuse")
    frames = jkin.KinematicFrame(jnp.asarray(ep.q), jnp.asarray(ep.qd), jnp.asarray(ep.tau))
    _, want = jax.jit(lambda f: jpolicy.rollout(jcfg, f))(frames)

    cfg = tpolicy.PolicyConfig(on_empty="reuse")
    state = tpolicy.trigger_init(cfg, device="cpu")
    got = {"offload": [], "replayed": [], "preempt": [], "slot": []}
    for t in range(ep.q.shape[0]):
        state, dec = tpolicy.trigger_step(state, _frames(ep, t), cfg)
        for name in got:
            got[name].append(int(getattr(dec, name)))
    for name, vals in got.items():
        np.testing.assert_array_equal(vals, np.asarray(getattr(want, name), np.int64), err_msg=name)
