"""The port's ``run_episode`` (Algorithm 1 over an episode) against the
reference's, run under ``jax.jit``.

Both take the same arrays (the reference's episodes and chunks, or the
synthetic frames of ``tests/test_dispatcher.py``).  The offload and
edge-refill streams must be equal, the executed actions equal to 1e-6 and
the trigger's importance to 1e-4 (``tests/test_torch_trigger.py``'s
tolerances).  The reference test module's three behaviours (pop order and
refill, edge refills with no trigger, preemption on a spike) are asserted
on the port's outputs too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dispatcher as jdisp  # noqa: E402
from repro.core import kinematics as jkin  # noqa: E402
from repro.core import trigger as jtrig  # noqa: E402
from repro.robotics import episodes as jeps  # noqa: E402
from repro_torch.core import TriggerConfig, dispatcher_init, run_episode  # noqa: E402
from repro_torch.core.dispatcher import DispatcherConfig  # noqa: E402
from repro_torch.core.kinematics import KinematicFrame  # noqa: E402

TASKS = ("pick_place", "drawer_open", "peg_insertion")
K = 8


def _reference(cfg_kw, trig_kw, frames, cloud, edge):
    cfg = jdisp.DispatcherConfig(trigger=jtrig.TriggerConfig(**trig_kw), **cfg_kw)
    f = jkin.KinematicFrame(*(jnp.asarray(x) for x in frames))
    run = jax.jit(lambda f, c, e: jdisp.run_episode(cfg, f, c, edge_chunks=e))
    _, out = run(f, jnp.asarray(cloud), None if edge is None else jnp.asarray(edge))
    return out


def _port(cfg_kw, trig_kw, frames, cloud, edge, state=None):
    cfg = DispatcherConfig(trigger=TriggerConfig(**trig_kw), **cfg_kw)
    return run_episode(cfg, KinematicFrame(*(torch.as_tensor(x) for x in frames)),
                       torch.as_tensor(cloud), state=state,
                       edge_chunks=None if edge is None else torch.as_tensor(edge))


def _assert_matches(got, want):
    np.testing.assert_array_equal(got.offloaded.numpy(), np.asarray(want.offloaded))
    np.testing.assert_array_equal(got.edge_refill.numpy(), np.asarray(want.edge_refill))
    np.testing.assert_allclose(got.action.numpy(), np.asarray(want.action), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.trig.importance.numpy(), np.asarray(want.trig.importance),
                               rtol=1e-4, atol=1e-4)


def _episode_bank(eps, edge):
    """[T, R, ...] frames and chunks of ``eps``, cut to the shortest."""

    t_len = min(e.q.shape[0] for e in eps)
    frames = tuple(np.stack([getattr(e, n)[:t_len] for e in eps], 1) for n in ("q", "qd", "tau"))
    cloud = np.stack([jeps.reference_chunks(e, K)[:t_len] for e in eps], 1)
    edge_c = np.stack([jeps.edge_policy_chunks(e, K)[:t_len] for e in eps], 1) if edge else None
    return frames, cloud, edge_c


def _episode(task, seed, edge):
    ep = jeps.generate_episode(task, seed=seed)
    frames = (ep.q, ep.qd, ep.tau)
    return frames, jeps.reference_chunks(ep, K), jeps.edge_policy_chunks(ep, K) if edge else None


CASES = [(f"{t}-{m}", t, m) for t in TASKS for m in ("cloud", "edge")]
CASES += [(f"bank4-{m}", "bank", m) for m in ("cloud", "edge")]


@pytest.mark.parametrize("name,task,mode", CASES, ids=[c[0] for c in CASES])
def test_run_episode_matches_reference(name, task, mode):
    edge = mode == "edge"
    if task == "bank":
        eps = [jeps.generate_episode(TASKS[r % 3], seed=10 + r) for r in range(4)]
        frames, cloud, edge_c = _episode_bank(eps, edge)
    else:
        frames, cloud, edge_c = _episode(task, 4, edge)
    want = _reference({}, {}, frames, cloud, edge_c)
    state, got = _port({}, {}, frames, cloud, edge_c)
    batch = frames[0].shape[1:-1]
    assert got.action.shape == frames[0].shape[:1] + batch + (7,)
    assert got.offloaded.shape == got.edge_refill.shape == frames[0].shape[:1] + batch
    assert state.queue.chunk.shape == batch + (K, 7)
    assert got.offloaded.any() and (got.edge_refill.any() == edge)
    _assert_matches(got, want)


@pytest.mark.parametrize("mode", ["cloud", "edge"])
def test_run_episode_in_two_halves_equals_one_run(mode):
    frames, cloud, edge_c = _episode("drawer_open", 5, mode == "edge")
    cut = frames[0].shape[0] // 2 + 3  # not at a chunk boundary
    state, first = _port({}, {}, [f[:cut] for f in frames], cloud[:cut],
                         None if edge_c is None else edge_c[:cut])
    _, second = _port({}, {}, [f[cut:] for f in frames], cloud[cut:],
                      None if edge_c is None else edge_c[cut:], state=state)
    _, whole = _port({}, {}, frames, cloud, edge_c)
    for a, b, c in zip(jax.tree_util.tree_leaves(tuple(first)),
                       jax.tree_util.tree_leaves(tuple(second)),
                       jax.tree_util.tree_leaves(tuple(whole))):
        assert torch.equal(torch.cat([a, b]), c)
    _assert_matches(whole, _reference({}, {}, frames, cloud, edge_c))


def _frames(t_len, n=7, seed=0, spike_at=None):
    """``tests/test_dispatcher.py``'s synthetic frames."""

    rng = np.random.default_rng(seed)
    qd = np.ones((t_len, n), np.float32) * 0.3
    tau = rng.normal(0, 0.02, (t_len, n)).astype(np.float32)
    if spike_at is not None:
        tau[spike_at: spike_at + 10] += 6.0
    q = (np.cumsum(qd, 0) * 0.002).astype(np.float32)
    return q, qd, tau


def _chunks(t_len, k, a, val=1.0):
    # the chunk served at t encodes t, so staleness is observable
    return np.broadcast_to(np.arange(t_len, dtype=np.float32)[:, None, None],
                           (t_len, k, a)) * np.float32(val)


def _pop_order(got):
    off = got.offloaded.numpy()
    assert off.sum() == 32 // 4 and off[::4].all()  # refills exactly at chunk boundaries
    np.testing.assert_array_equal(got.action[:, 0].numpy(), (np.arange(32) // 4) * 4)


def _edge_refill(got):
    assert int(got.offloaded.sum()) == 0
    assert int(got.edge_refill.sum()) == 24 // 4
    assert (got.action <= 0).all()  # every action from the edge chunks


def _preemption(got):
    off = got.offloaded.numpy()
    assert off[100:112].any(), "the spike must dispatch to the cloud"
    t0 = np.flatnonzero(off)[0]
    assert float(got.action[t0, 0]) == float(t0)  # the fresh cloud chunk, at once


BEHAVIOURS = {
    "pop_order_and_refill": (dict(chunk_len=4, action_dim=2), dict(n_joints=2), 32, None, False,
                             _pop_order),
    "edge_refill_without_trigger": (dict(chunk_len=4, action_dim=2), dict(n_joints=2), 24, None,
                                    True, _edge_refill),
    "preemption_on_spike": (dict(chunk_len=8, action_dim=2),
                            dict(n_joints=2, warmup=8, cooldown_steps=4), 200, 100, True,
                            _preemption),
}


@pytest.mark.parametrize("behaviour", sorted(BEHAVIOURS))
def test_dispatcher_behaviours_match_reference(behaviour):
    cfg_kw, trig_kw, t_len, spike_at, edge, check = BEHAVIOURS[behaviour]
    frames = _frames(t_len, 2, spike_at=spike_at)
    cloud = _chunks(t_len, cfg_kw["chunk_len"], 2, 1.0)
    edge_c = _chunks(t_len, cfg_kw["chunk_len"], 2, -1.0) if edge else None
    _, got = _port(cfg_kw, trig_kw, frames, cloud, edge_c)
    check(got)
    _assert_matches(got, _reference(cfg_kw, trig_kw, frames, cloud, edge_c))


@pytest.mark.parametrize("stray", ["cloud", "edge", "state"])
def test_run_episode_refuses_inputs_on_another_device(stray):
    frames, cloud, edge_c = _episode("pick_place", 0, True)
    frames = KinematicFrame(*(torch.as_tensor(f[:4]) for f in frames))
    cloud, edge_c = torch.as_tensor(cloud[:4]), torch.as_tensor(edge_c[:4])
    cfg = DispatcherConfig()
    state = dispatcher_init(cfg, (), device="meta" if stray == "state" else "cpu")
    if stray == "cloud":
        cloud = cloud.to("meta")
    elif stray == "edge":
        edge_c = edge_c.to("meta")
    with pytest.raises(ValueError, match=stray):
        run_episode(cfg, frames, cloud, state=state, edge_chunks=edge_c)
