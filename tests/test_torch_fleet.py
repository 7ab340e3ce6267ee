"""The port's fleet serving (``launch/serve.py`` ``serve_fleet``,
``runtime/fleet.py``) against the JAX package's on the f32 openvla-smoke
stack (bridged weights, as ``test_torch_scheduler.py`` builds it).

A fleet run is held to the reference's run with the same arguments: the
decision streams, telemetry counters, ``service_rounds``, ``decode_rounds``,
``scan_windows``, ``cancelled``, ``deferred`` and pool stats are equal, the
executed actions are equal, and the channel latencies are within rtol 1e-6
(the jitter bits are equal, ``test_torch_channel.py``; numpy's and XLA's
float32 ``log1p`` may differ in the last bit).  Each side serves its own
episodes; the port's agree with the reference's to ~1e-5
(``test_torch_trigger.py``), and the decisions must come out equal all the
same.  Within the port, the vectorized tick equals the legacy loop bit for
bit, and the live loop's decisions equal the offline ``rollout``'s.

The reference scheduler jits per instance: its compiled admission and
decode functions are shared across the instances ``serve_fleet`` builds
(they close over the same model and token floor).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

import repro.runtime.scheduler as jsched_mod  # noqa: E402
from repro.launch.serve import serve_fleet as jax_serve_fleet  # noqa: E402
from repro.runtime import fleet as jfleet  # noqa: E402
from repro_torch.core.kinematics import KinematicFrame  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import serve_fleet  # noqa: E402
from repro_torch.obs import Observability, validate_chrome_trace  # noqa: E402
from repro_torch.obs.histogram import bucket_index  # noqa: E402
from repro_torch.robotics.episodes import generate_episode  # noqa: E402
from repro_torch.runtime import fleet as tfleet  # noqa: E402
from repro_torch.runtime.policy import fleet_policy_config, rollout  # noqa: E402

from test_torch_scheduler import make_stacks  # noqa: E402

PAGES_PER_REQ = -(-(14 + 56) // 16)
FLEET = dict(n_robots=6, max_steps=300, max_slots=4, seed=3, record_streams=True,
             verbose=False)


@pytest.fixture(scope="module")
def st():
    return make_stacks("openvla-7b")


@pytest.fixture
def shared_jits(st, monkeypatch):
    """The reference's schedulers built inside its serve loops share the
    stack's compiled admission and decode functions."""

    base = jsched_mod.ContinuousBatchingScheduler

    class Shared(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._admit_fns, self._decode_fns = st.admit_fns, st.decode_fns

    monkeypatch.setattr(jsched_mod, "ContinuousBatchingScheduler", Shared)


_RUNS = {}


def _reference(st, **kw):
    key = ("reference",) + tuple(sorted(kw.items()))
    if key not in _RUNS:
        _RUNS[key] = jax_serve_fleet(st.jmodel, st.jparams, st.jtok, **FLEET, **kw)
    return _RUNS[key]


def _port(st, **kw):
    key = ("port",) + tuple(sorted(kw.items()))
    if key not in _RUNS:
        _RUNS[key] = serve_fleet(st.tmodel, st.tok, **FLEET, **kw)
    return _RUNS[key]


def _pool(p):
    return (p.pages_in_use, p.pages_free, p.high_water)


def assert_fleet_equal(got, want, ms_rtol=1e-6):
    np.testing.assert_array_equal(got["actions"], want["actions"])
    np.testing.assert_array_equal(got["offloads"], want["offloads"])
    tg, tw = got["telemetry"], want["telemetry"]
    for f in ("fires", "replays", "preempts", "cancels", "completions"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(tw, f), err_msg=f)
    assert tg.ticks == tw.ticks and got["steps"] == want["steps"]
    if tw.record_streams:
        sg, sw = tg.streams(), tw.streams()
        for k in sw:
            np.testing.assert_array_equal(sg[k], sw[k], err_msg=k)
    for k in ("service_rounds", "decode_rounds", "scan_windows", "cancelled", "deferred",
              "peak_batch", "mixed_rounds", "hetero_rounds", "trigger"):
        assert got[k] == want[k], k
    assert _pool(got["pool"]) == _pool(want["pool"])
    assert got["offload_fraction"] == want["offload_fraction"]
    if ms_rtol is None:
        assert got["offload_ms_by_robot"] == want["offload_ms_by_robot"]
        assert got["offload_ms"] == want["offload_ms"]
    else:
        assert [len(m) for m in got["offload_ms_by_robot"]] == \
            [len(m) for m in want["offload_ms_by_robot"]]
        np.testing.assert_allclose(got["offload_ms"], want["offload_ms"], rtol=ms_rtol, atol=0)


# ---------------------------------------------------------------------------
# arrival traces (numpy, equal to the reference's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arrivals,kw", [
    ("poisson", dict(mean_dwell=80, seed=1)),
    ("poisson", dict(rate=0.5, seed=4)),
    ("bursty", dict(burst_every=50, burst_size=16, seed=2)),
    ("bursty", dict(burst_every=16, mean_dwell=40.0, seed=6)),
])
def test_traces_match_reference(arrivals, kw):
    want = jfleet.make_trace(128, 200, arrivals=arrivals, **kw)
    got = tfleet.make_trace(128, 200, arrivals=arrivals, **kw)
    assert isinstance(got, tfleet.FleetTrace) and got.n_robots == 128
    for f in tfleet.FleetTrace._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == np.int64
    for t in (0, 50, 199):
        np.testing.assert_array_equal(got.active_at(t), want.active_at(t))
    with pytest.raises(ValueError, match="arrivals"):
        tfleet.make_trace(8, 50, arrivals="uniform")


# ---------------------------------------------------------------------------
# serve_fleet against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tick", ["vectorized", "legacy"])
@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("trigger", ["always", "rapid"])
def test_serve_fleet_matches_reference(st, shared_jits, trigger, rounds, tick):
    want = _reference(st, trigger=trigger, scan_rounds=rounds)
    got = _port(st, trigger=trigger, scan_rounds=rounds, tick=tick)
    assert_fleet_equal(got, want)
    assert got["offloads"].sum() > 0 and got["telemetry"].completions.sum() > 0
    if trigger == "rapid":
        assert got["cancelled"] > 0, "no in-flight cancel exercised"
    assert got["core_s"] > 0 and got["engine_s"] > 0
    assert got["core_s"] == pytest.approx(got["core_tick_ms"].sum() / 1e3)
    assert got["engine_s"] == pytest.approx(got["engine_tick_ms"].sum() / 1e3)
    assert got["close_ticks"].sum() == got["scan_windows"]


@pytest.mark.parametrize("tick", ["vectorized", "legacy"])
def test_serve_fleet_defer_hot_matches_reference(st, shared_jits, tick):
    kw = dict(trigger="rapid", scan_rounds=4, defer_hot_admission=0.2)
    got = _port(st, tick=tick, **kw)
    assert_fleet_equal(got, _reference(st, **kw))
    assert got["deferred"] > 0


@pytest.mark.parametrize("trigger", ["always", "rapid"])
def test_vectorized_tick_matches_legacy(st, trigger):
    """Within the port, the array-at-a-time tick reproduces the per-robot
    loop bit for bit, latency draws included."""

    kw = dict(trigger=trigger, scan_rounds=4)
    if trigger == "rapid":
        kw["defer_hot_admission"] = 0.2
    legacy = _port(st, tick="legacy", **kw)
    assert_fleet_equal(_port(st, tick="vectorized", **kw), legacy, ms_rtol=None)
    assert legacy["offloads"].sum() > 0


def test_serve_fleet_rejects_unknown_modes(st):
    with pytest.raises(ValueError, match="tick"):
        serve_fleet(st.tmodel, st.tok, tick="turbo", verbose=False)
    with pytest.raises(ValueError, match="trigger"):
        serve_fleet(st.tmodel, st.tok, trigger="sometimes", verbose=False)


@pytest.mark.parametrize("trigger", ["rapid", "always"])
def test_serve_fleet_matches_offline_rollout(st, trigger):
    """The live loop's recorded decisions equal the offline decision core
    run over the same kinematic streams (twin of the reference's
    acceptance pin)."""

    out = _port(st, trigger=trigger, scan_rounds=1, tick="vectorized")
    streams = out["telemetry"].streams()
    tasks = ["pick_place", "drawer_open", "peg_insertion"]
    eps = [generate_episode(tasks[i % 3], seed=FLEET["seed"] + i)
           for i in range(FLEET["n_robots"])]
    t_len = out["steps"]
    frames = KinematicFrame(*(torch.as_tensor(np.stack([getattr(ep, n)[:t_len] for ep in eps], 1))
                              for n in ("q", "qd", "tau")))
    _, dec = rollout(fleet_policy_config(trigger, 8, 7), frames)
    for name, key in (("offload", "offload"), ("replayed", "replayed"), ("preempt", "preempt"),
                      ("slot", "slot")):
        np.testing.assert_array_equal(streams[key], getattr(dec, name).numpy(), err_msg=name)


# ---------------------------------------------------------------------------
# serve_trace against the reference
# ---------------------------------------------------------------------------


def _trace_pair(st, trace, horizon, **kw):
    want = jfleet.serve_trace(st.jmodel, st.jparams, st.jtok, trace, horizon=horizon,
                              verbose=False, **kw)
    got = tfleet.serve_trace(st.tmodel, st.tok, trace, horizon=horizon, verbose=False, **kw)
    for k in ("joined", "left", "churn_cancels", "peak_active_robots", "completions", "fires",
              "replays", "cancels", "service_rounds", "peak_batch", "decode_rounds",
              "scan_windows", "pending", "in_flight", "ticks", "n_robots"):
        assert got[k] == want[k], k
    for f in ("fires", "replays", "preempts", "cancels", "completions"):
        np.testing.assert_array_equal(getattr(got["telemetry"], f),
                                      getattr(want["telemetry"], f), err_msg=f)
    assert _pool(got["pool"]) == _pool(want["pool"])
    np.testing.assert_allclose(got["offload_ms"], want["offload_ms"], rtol=1e-6, atol=0)
    return got, want


def test_serve_trace_poisson_churn_matches_reference(st, shared_jits):
    tr = tfleet.make_trace(24, 150, arrivals="poisson", mean_dwell=60, seed=4)
    got, _ = _trace_pair(st, tr, 150, max_slots=4, scan_rounds=2, trigger="rapid")
    assert got["joined"] == 24 and got["left"] > 0 and got["completions"] > 0
    # churn reclaims pages without a reset: what is left in the pool is
    # exactly the requests still live, and a drain returns every page
    sched = got["sched"]
    assert got["pool"].pages_in_use == sched.n_active * PAGES_PER_REQ
    sched.drain()
    assert sched.pool_stats().pages_in_use == 0 and sched.allocator.total_frees > 0


def test_serve_trace_churn_reclaims_pages_without_reset(st, shared_jits):
    n = 12
    rng = np.random.default_rng(5)
    tr = tfleet.FleetTrace(
        join_tick=rng.integers(0, 8, n).astype(np.int64),
        leave_tick=rng.integers(230, 260, n).astype(np.int64),
        episode=rng.integers(0, 3, n).astype(np.int64),
        offset=rng.integers(0, 512, n).astype(np.int64),
    )
    got, _ = _trace_pair(st, tr, 280, max_slots=4, scan_rounds=2, trigger="rapid")
    assert got["left"] == n and got["in_flight"] == 0 and got["pending"] == 0
    assert got["pool"].pages_in_use == 0 and got["pool"].high_water > 0
    assert got["churn_cancels"] > 0 and got["sched"].window_closes > 0


def test_serve_trace_bursty_slo_matches_reference(st, shared_jits):
    tr = tfleet.make_trace(16, 120, arrivals="bursty", burst_every=32, mean_dwell=96, seed=7)
    got, _ = _trace_pair(st, tr, 120, max_slots=4, scan_rounds=4, trigger="rapid")
    assert got["completions"] > 0
    obs = Observability(trace=False)
    out = tfleet.serve_trace(st.tmodel, st.tok, tr, horizon=120, max_slots=4, scan_rounds=4,
                             obs=obs, verbose=False)
    assert out["completions"] == got["completions"]
    slo, m = out["slo"], obs.metrics
    assert slo["completions"] == out["completions"] == slo["chunk_latency_ms"]["count"]
    assert m.counter("fleet.joins").value == 16 == out["joined"]
    assert m.counter("fleet.leaves").value == out["left"]
    assert out["ticks_per_s"] > 0


def test_serve_trace_always_backlog_matches_reference(st, shared_jits):
    tr = tfleet.make_trace(16, 60, arrivals="bursty", burst_every=16, seed=6)
    got, _ = _trace_pair(st, tr, 60, max_slots=2, trigger="always")
    assert got["completions"] > 0 and got["pending"] > 0
    assert got["pool"].pages_in_use % PAGES_PER_REQ == 0


# ---------------------------------------------------------------------------
# observability acceptance (twins of tests/test_serving.py:965-1080)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def obs_fleet(st):
    """One fleet (scan_rounds=4, rapid) served twice under identical
    arguments: obs off, then obs on with tracing."""

    kw = dict(n_robots=4, max_steps=300, max_slots=2, scan_rounds=4, trigger="rapid",
              verbose=False)
    off = serve_fleet(st.tmodel, st.tok, **kw)
    obs = Observability(trace=True)
    on = serve_fleet(st.tmodel, st.tok, obs=obs, **kw)
    return off, on, obs


def test_obs_is_transparent_to_serving(obs_fleet):
    off, on, _ = obs_fleet
    np.testing.assert_array_equal(off["actions"], on["actions"])
    assert off["scan_windows"] == on["scan_windows"] > 0
    assert off["decode_rounds"] == on["decode_rounds"]
    assert off["cancelled"] == on["cancelled"] > 0
    assert off["slo"] is None and on["slo"] is not None


def _lifecycle_spans(trace):
    obj = trace.to_chrome()
    tracks = {ev["tid"]: ev["args"]["name"] for ev in obj["traceEvents"]
              if ev.get("ph") == "M" and ev["name"] == "thread_name"}
    return [(tracks[ev["tid"]], ev["name"], ev["ts"], ev["ts"] + ev["dur"], ev.get("args", {}))
            for ev in obj["traceEvents"] if ev.get("ph") == "X"]


def test_trace_spans_nest_and_align_to_window_closes(obs_fleet):
    _, _, obs = obs_fleet
    n, errors = validate_chrome_trace(obs.trace.to_chrome())
    assert errors == [] and n > 0
    spans = _lifecycle_spans(obs.trace)
    closes = [end for track, _, _, end, _ in spans if track == "lane cloud"]
    assert closes
    triples = [spans[i:i + 3] for i, s in enumerate(spans) if s[1] == "chunk"]
    assert triples
    for chunk, queue, decode in triples:
        track = chunk[0]
        assert queue[1] == "queue" and decode[1] == "decode"
        assert queue[0] == track and decode[0] == track
        assert queue[2] == chunk[2]
        assert chunk[2] <= queue[3] <= chunk[3]
        assert abs(decode[2] - queue[3]) < 1.0
        assert abs(decode[3] - chunk[3]) < 1.0
        assert min(abs(decode[3] - w) for w in closes) < 1.0


def test_slo_percentiles_pinned_by_trace_timestamps(obs_fleet):
    _, on, obs = obs_fleet
    durs = sorted((end - ts) / 1e3 for _, name, ts, end, _ in _lifecycle_spans(obs.trace)
                  if name == "chunk")
    hist = obs.metrics.get("serve.chunk_latency_ms")
    assert hist.count == len(durs) > 0
    slo = on["slo"]["chunk_latency_ms"]
    assert slo["count"] == len(durs)
    for q, key in ((0.50, "p50"), (0.99, "p99")):
        exact = durs[max(1, math.ceil(q * len(durs))) - 1]
        est = hist.quantile(q)
        assert bucket_index(est) == bucket_index(exact), (key, est, exact)
        assert slo[key] == pytest.approx(est, abs=1e-4)
    assert hist.mean == pytest.approx(sum(durs) / len(durs), rel=1e-6)
    assert hist.vmax == pytest.approx(durs[-1], rel=1e-6)
    assert on["slo"]["completions"] == len(durs)
    assert on["slo"]["pool_high_water"] > 0
    m = obs.metrics
    assert m.get("fleet.ticks").value == on["steps"]
    assert m.get("serve.host_gap_ms").count == on["scan_windows"]


# ---------------------------------------------------------------------------
# a warm scheduler, the command lines
# ---------------------------------------------------------------------------


def test_serve_fleet_reuses_scheduler(st):
    """``sched=``: a scheduler that already served a fleet is reset and
    serves the next one exactly as a new scheduler would."""

    from repro_torch.runtime.scheduler import ContinuousBatchingScheduler

    sched = ContinuousBatchingScheduler(st.tmodel, st.tok, max_slots=4, scan_rounds=4)
    serve_fleet(st.tmodel, st.tok, n_robots=3, max_steps=60, trigger="always", sched=sched,
                verbose=False)
    assert sched.decode_rounds > 0
    kw = dict(trigger="rapid", scan_rounds=4, tick="vectorized")
    warm = serve_fleet(st.tmodel, st.tok, sched=sched, **FLEET, **kw)
    assert warm["sched"] is sched
    assert_fleet_equal(warm, _port(st, **kw), ms_rtol=None)


def test_fleet_command_lines(tmp_path):
    import json

    out = tserve.main(["--device", "cpu", "--fleet", "3", "--steps", "70", "--trigger", "rapid",
                       "--scan-rounds", "2", "--defer-hot", "0.2",
                       "--trace-out", str(tmp_path / "t.json"),
                       "--metrics-json", str(tmp_path / "m.json"),
                       "--metrics-prom", str(tmp_path / "m.prom")])
    assert out["steps"] == 70 and out["offloads"].sum() >= 3 and out["slo"] is not None
    assert validate_chrome_trace(json.loads((tmp_path / "t.json").read_text()))[1] == []
    assert json.loads((tmp_path / "m.json").read_text())["fleet.ticks"] == 70
    assert "fleet_ticks" in (tmp_path / "m.prom").read_text()
    res = tfleet.main(["--device", "cpu", "--fleet", "12", "--horizon", "40", "--mean-dwell",
                       "20", "--scan-rounds", "2", "--metrics-json", str(tmp_path / "f.json")])
    assert res["joined"] == 12 and res["ticks"] == 40
    assert json.loads((tmp_path / "f.json").read_text())["fleet.joins"] == 12
