"""The port's offline decision core and engine against the JAX package.

``rollout`` and ``queue_replay`` (``runtime/policy.py``), ``FleetTelemetry``,
the entropy baseline (``core/baselines.py``, ``robotics/noise.py``), the
episode chunks, ``runtime/latency.py`` and ``runtime/engine.py`` (all six
strategies) are fed the same inputs as the reference's twins.  Decisions
are discrete and must be equal; so must the counters and the latency
model's arithmetic.  Components are fed the reference's own episode arrays
(the port's episodes agree with them to ~1e-5, ``test_torch_trigger.py``);
``evaluate_strategy`` runs each side on its own episodes, and its accuracy
and mean error are held to 1e-6.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core.kinematics import KinematicFrame as JFrame  # noqa: E402
from repro.core.trigger import TriggerConfig as JTriggerConfig  # noqa: E402
from repro.obs import Observability as JObs  # noqa: E402
from repro.robotics import episodes as jeps  # noqa: E402
from repro.robotics import noise as jnoise  # noqa: E402
from repro.runtime import engine as jeng  # noqa: E402
from repro.runtime import latency as jlat  # noqa: E402
from repro.runtime import policy as jpol  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core.kinematics import KinematicFrame  # noqa: E402
from repro_torch.core.trigger import TriggerConfig  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.robotics import episodes as teps  # noqa: E402
from repro_torch.robotics import noise as tnoise  # noqa: E402
from repro_torch.runtime import engine as teng  # noqa: E402
from repro_torch.runtime import latency as tlat  # noqa: E402
from repro_torch.runtime import policy as tpol  # noqa: E402

TASKS = ("pick_place", "drawer_open", "peg_insertion")
COUNTERS = ("n_steps", "n_chunks", "n_offloads", "n_edge_infer", "n_interruptions",
            "n_spurious")


def _port_episode(ep):
    """The reference's episode arrays as the port's ``Episode``."""

    return teps.Episode(*(np.asarray(getattr(ep, f)) for f in teps.Episode._fields[:-2]),
                        task=ep.task, dt=ep.dt)


@pytest.fixture(scope="module")
def episodes():
    return {(t, s): jeps.generate_episode(t, seed=s) for t in TASKS for s in (0, 1)}


def _fleet_frames(episodes, t_len=400):
    eps = [episodes[(t, 0)] for t in TASKS]
    return [np.stack([getattr(ep, n)[:t_len] for ep in eps], 1) for n in ("q", "qd", "tau")]


# ---------------------------------------------------------------------------
# rollout and queue_replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("on_empty,cooldown", [("reuse", 7), ("cloud", 8), ("edge", 8)])
def test_rollout_matches_reference(episodes, on_empty, cooldown):
    arrs = _fleet_frames(episodes)
    jcfg = jpol.PolicyConfig(trigger=JTriggerConfig(cooldown_steps=cooldown), chunk_len=8,
                             on_empty=on_empty)
    _, want = jax.jit(lambda f: jpol.rollout(jcfg, f))(JFrame(*map(jnp.asarray, arrs)))
    tcfg = tpol.PolicyConfig(trigger=TriggerConfig(cooldown_steps=cooldown), chunk_len=8,
                             on_empty=on_empty)
    _, got = tpol.rollout(tcfg, KinematicFrame(*map(torch.as_tensor, arrs)))
    for name in ("offload", "replayed", "preempt", "slot"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.trig.dispatch.numpy(), np.asarray(want.trig.dispatch))
    assert int(got.offload.sum()) > 3 and got.slot.shape == (400, 3)


@pytest.mark.parametrize("on_empty", ["edge", "reuse", "cloud"])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.3])
def test_queue_replay_matches_reference(on_empty, density):
    rng = np.random.default_rng(int(density * 100))
    dispatch = rng.random(300) < density
    want = jpol.queue_replay(dispatch, 8, on_empty=on_empty)
    got = tpol.queue_replay(dispatch, 8, on_empty=on_empty)
    assert isinstance(got, tpol.QueueTrace)
    for name in tpol.QueueTrace._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# FleetTelemetry (twins of tests/test_policy.py's telemetry tests)
# ---------------------------------------------------------------------------


def _decisions(pol, arr, off, rep, pre=None, slot=None):
    off = arr(np.asarray(off))
    z = np.zeros(len(off), bool)
    return pol.TriggerDecision(offload=off, replayed=arr(np.asarray(rep)),
                               preempt=arr(z if pre is None else np.asarray(pre)),
                               slot=arr(np.zeros(len(off), np.int32) if slot is None
                                        else np.asarray(slot, np.int32)),
                               trig=None)


TICKS = [([True, False], [False, True], [False, True], [0, 3]),
         ([True, True], [False, False], None, [1, 0]),
         ([False, True], [True, False], [False, False], [2, 0])]


def _feed(pol, arr, obs=None):
    tel = pol.FleetTelemetry(2, record_streams=True, obs=obs)
    for off, rep, pre, slot in TICKS:
        tel.observe(_decisions(pol, arr, off, rep, pre, slot))
    tel.note_cancel(0)
    tel.note_cancels(np.array([1, 1]))
    tel.note_completion(1)
    tel.note_completions(np.array([0, 1]))
    tel.note_boundary(1.5)
    tel.note_boundary(2.5)
    return tel


def test_telemetry_matches_reference():
    want = _feed(jpol, jnp.asarray)
    got = _feed(tpol, torch.as_tensor)  # the port also takes tensors
    s = got.summary()
    assert json.loads(json.dumps(s)) == s == want.summary()
    np.testing.assert_allclose(got.offload_fractions(), want.offload_fractions())
    assert got.fleet_offload_fraction() == want.fleet_offload_fraction()
    assert got.host_gap_ms() == want.host_gap_ms() == 2.0
    for k, v in want.streams().items():
        np.testing.assert_array_equal(got.streams()[k], v, err_msg=k)
    for r in (0, 1):
        tr, wr = got.robot_trace(r), want.robot_trace(r)
        assert isinstance(tr, tpol.QueueTrace)
        for name in tpol.QueueTrace._fields:
            np.testing.assert_array_equal(getattr(tr, name), getattr(wr, name))


def test_telemetry_zero_boundaries_and_no_recording():
    tel = tpol.FleetTelemetry(1)
    assert tel.host_gap_ms() == 0.0 and tel.scan_windows == 0
    assert tel.summary()["host_gap_ms"] == 0.0
    tel.observe(_decisions(tpol, np.asarray, [True], [False]))
    with pytest.raises(ValueError):
        tel.streams()
    assert tpol.FleetTelemetry(1).obs is None


def test_telemetry_obs_hook_matches_reference():
    wobs = JObs(trace=False)
    want = _feed(jpol, jnp.asarray, wobs)
    tobs = Observability(trace=False)
    got = _feed(tpol, np.asarray, tobs)
    assert tobs.metrics.to_json() == wobs.metrics.to_json()
    m = tobs.metrics
    assert m.get("fleet.ticks").value == got.ticks == 3
    assert m.get("fleet.fires").value == int(got.fires.sum())
    assert m.get("fleet.cancels").value == int(got.cancels.sum()) == 3
    assert m.get("fleet.completions").value == int(got.completions.sum()) == 3
    gap = m.get("serve.host_gap_ms")
    assert gap.count == 2 and gap.vmax == 2.5 and want.scan_windows == got.scan_windows


# ---------------------------------------------------------------------------
# baselines, noise, episode chunks, latency model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("regime", ["standard", "visual_noise", "distraction"])
def test_entropy_stream_and_cooldown_mask_match_reference(episodes, regime):
    ep = episodes[("drawer_open", 1)]
    h = tnoise.entropy_stream(_port_episode(ep), regime, seed=2)
    want = jnoise.entropy_stream(ep, regime, seed=2)
    np.testing.assert_array_equal(h, want)
    cfg = jbase.EntropyTriggerConfig()
    for cooldown in (0, 3, cfg.cooldown_steps):
        trig = want > cfg.threshold
        np.testing.assert_array_equal(
            teng._cooldown_mask(trig, cooldown),
            np.asarray(jeng._cooldown_mask(jnp.asarray(trig), jnp.int32(cooldown))))
    np.testing.assert_array_equal(
        teng.entropy_trigger_stream(_port_episode(ep), regime, tbase.EntropyTriggerConfig(), 2),
        jeng.entropy_trigger_stream(ep, regime, cfg, 2))


def test_entropy_baseline_matches_reference():
    rng = np.random.default_rng(4)
    t_len, b = 120, 3
    ent = (1.5 + rng.random((t_len, b))).astype(np.float32)
    chunks = rng.normal(0, 1, (t_len, b, 8, 7)).astype(np.float32)
    logits = rng.normal(0, 2, (5, 11)).astype(np.float32)
    jcfg, tcfg = jbase.EntropyTriggerConfig(), tbase.EntropyTriggerConfig()
    _, (wa, wd) = jbase.run_entropy_episode(jcfg, jnp.asarray(ent), jnp.asarray(chunks))
    state, (ga, gd) = tbase.run_entropy_episode(tcfg, torch.as_tensor(ent),
                                                torch.as_tensor(chunks))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    assert state.queue.head.dtype == torch.int32 and int(gd.sum()) > t_len // 8
    np.testing.assert_allclose(tbase.action_entropy(torch.as_tensor(logits)).numpy(),
                               np.asarray(jbase.action_entropy(jnp.asarray(logits))),
                               rtol=1e-6, atol=1e-6)
    for n, p in ((64, 8), (50, 7)):
        np.testing.assert_array_equal(tbase.static_offload_mask(n, p, "cpu").numpy(),
                                      np.asarray(jbase.static_offload_mask(n, p)))
        np.testing.assert_array_equal(tbase.cloud_only_mask(n, p, "cpu").numpy(),
                                      np.asarray(jbase.cloud_only_mask(n, p)))
        np.testing.assert_array_equal(tbase.edge_only_mask(n, "cpu").numpy(),
                                      np.asarray(jbase.edge_only_mask(n)))


@pytest.mark.parametrize("task", TASKS)
def test_episode_chunks_match_reference(episodes, task):
    ep = episodes[(task, 1)]
    pep = _port_episode(ep)
    for k in (4, 8):
        np.testing.assert_array_equal(teps.reference_chunks(pep, k), jeps.reference_chunks(ep, k))
        np.testing.assert_array_equal(teps.edge_policy_chunks(pep, k, seed=3),
                                      jeps.edge_policy_chunks(ep, k, seed=3))
    mask = np.arange(ep.critical.shape[0]) % 3 == 0
    np.testing.assert_array_equal(teps.stale_penalty_mask(pep, mask),
                                  jeps.stale_penalty_mask(ep, mask))


def test_latency_model_matches_reference():
    assert tlat.HardwareModel.calibrated() == tlat.HardwareModel(
        **{f: getattr(jlat.HardwareModel.calibrated(), f)
           for f in ("full_model_gb", "chunk_len", "rate_edge_ms_per_gb",
                     "rate_cloud_ms_per_gb", "cloud_a", "cloud_b")})
    for pb in (7.5e9, 14.2e9, 398e9):
        w, g = jlat.arch_hardware_model(int(pb)), tlat.arch_hardware_model(int(pb))
        assert (g.full_model_gb, g.cloud_a, g.cloud_b) == (w.full_model_gb, w.cloud_a, w.cloud_b)
    rng = np.random.default_rng(0)
    hw_j, hw_t = jlat.HardwareModel.calibrated(), tlat.HardwareModel.calibrated()
    for name in tlat.PROFILES:
        for _ in range(4):
            c = dict(zip(COUNTERS, [800, 100, *map(int, rng.integers(0, 60, 4))]))
            w = jlat.evaluate(hw_j, jlat.PROFILES[name], jlat.SimCounters(**c))
            g = tlat.evaluate(hw_t, tlat.PROFILES[name], tlat.SimCounters(**c))
            assert vars(g) == vars(w), name


# ---------------------------------------------------------------------------
# score_trace, simulate_queue, evaluate_strategy
# ---------------------------------------------------------------------------


def _same_result(got, want, tol=1e-6):
    for f in COUNTERS:
        assert getattr(got.counters, f) == getattr(want.counters, f), f
    assert got.accuracy == pytest.approx(want.accuracy, abs=tol)
    assert got.mean_error == pytest.approx(want.mean_error, abs=tol)
    np.testing.assert_array_equal(got.offload_steps, want.offload_steps)


@pytest.mark.parametrize("local_src", ["edge", "reuse"])
@pytest.mark.parametrize("task", TASKS)
def test_score_trace_and_simulate_queue_match_reference(episodes, task, local_src):
    ep = episodes[(task, 0)]
    pep = _port_episode(ep)
    rng = np.random.default_rng(5)
    dispatch = rng.random(ep.critical.shape[0]) < 0.04
    ecfg_j, ecfg_t = jeng.EngineConfig(), teng.EngineConfig()
    edge = jeps.edge_policy_chunks(ep, 8, 0)
    trace = jpol.queue_replay(dispatch, 8, on_empty="edge" if local_src == "edge" else "reuse")
    ttrace = tpol.QueueTrace(*trace)
    _same_result(teng.score_trace(pep, ttrace, ecfg_t, local_src=local_src, edge_chunks=edge),
                 jeng.score_trace(ep, trace, ecfg_j, local_src=local_src, edge_chunks=edge))
    for allowed, exact in ((True, False), (False, False), (True, True)):
        _same_result(
            teng.simulate_queue(pep, dispatch, ecfg_t, allowed, edge, edge_exact=exact),
            jeng.simulate_queue(ep, dispatch, ecfg_j, allowed, edge, edge_exact=exact))


def test_rapid_trigger_stream_matches_reference(episodes):
    ep = episodes[("peg_insertion", 1)]
    for on_empty in ("edge", "cloud"):
        want = jeng.rapid_trigger_stream(ep, JTriggerConfig(), on_empty=on_empty)
        got = teng.rapid_trigger_stream(_port_episode(ep), TriggerConfig(), on_empty=on_empty,
                                        device="cpu")
        np.testing.assert_array_equal(got, want)
        assert got.any()


@pytest.mark.parametrize("strategy,regime", [(s, "standard") for s in teng.STRATEGIES]
                         + [("vision", "distraction")])
def test_evaluate_strategy_matches_reference(strategy, regime):
    want = jeng.evaluate_strategy(strategy, regime=regime)
    got = teng.evaluate_strategy(strategy, regime=regime, device="cpu")
    assert got["strategy"] == strategy and got["regime"] == regime
    # pooled counters equal -> the latency model's report is equal
    assert vars(got["report"]) == vars(want["report"])
    for k in ("total_ms", "total_ms_std", "offload_fraction", "interruptions_per_chunk"):
        assert got[k] == want[k], k
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6)
    assert got["mean_error"] == pytest.approx(want["mean_error"], abs=1e-6)
