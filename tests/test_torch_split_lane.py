"""The port's split lanes (``runtime/scheduler.py`` ``attach_partition``,
``_SplitLane``, the fused window of ``PartitionExecutor.build_fleet_decode``)
and the partitioned ``serve_fleet`` / ``serve_trace`` against the JAX
package's, on the f32 openvla-smoke stack (and jamba-smoke for the
expert-offload lane), weights bridged as in ``test_torch_scheduler.py``.

Each scheduler twin runs one script (submissions, cancels and steps from a
seeded numpy generator) through the reference scheduler and the port's with
the same lanes attached, and requires what ``run_twin`` requires there: the
same log of what the script observed, the same ``ChunkResult``s in the same
order (rounds, kind, cut, ``expert_offload``, ``PoolStats``), equal counters
(``mixed_rounds`` and ``hetero_rounds`` included) and lane rows, and equal
tokens under the greedy-margin rule (1e-4).  Within the port, the pipelined
lanes' tokens equal the serial lanes'.  The fleet twins hold
``serve_fleet`` (both ticks, ``rapid``) and ``serve_trace`` with
``robot_cuts`` to the reference as ``test_torch_fleet.py`` holds the
cloud-only runs; the planning helpers are held to the reference's.

The reference jits per scheduler and per lane: the twins share its compiled
admission, decode and fused-window functions across instances, and build a
reference lane's suffix functions once per executor.  Under jax 0.9 the
reference's pipelined lane cannot admit into a lane that still has live rows
after a harvest: ``harvest`` rebinds the lane's host logits to
``np.asarray`` of a device array, which is read-only, and the next ``flush``
writes into it (ROADMAP §3).  The fixture hands ``flush`` a writable copy;
nothing else of the reference changes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

import repro.launch.serve as jserve  # noqa: E402
import repro.runtime.scheduler as jsched_mod  # noqa: E402
from repro.partition.executor import PartitionExecutor as JaxExecutor  # noqa: E402
from repro.runtime import fleet as jfleet  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.partition import PartitionExecutor  # noqa: E402
from repro_torch.runtime import fleet as tfleet  # noqa: E402
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler  # noqa: E402

from test_torch_fleet import FLEET, assert_fleet_equal  # noqa: E402
from test_torch_scheduler import (  # noqa: E402
    PAGES,
    R14,
    _obs,
    _obs_tokens,
    _result,
    _snapshot,
    assert_tokens_match,
    make_stacks,
)

_STACKS = {}


def stacks(arch="openvla-7b"):
    if arch not in _STACKS:
        st = make_stacks(arch)
        st.fleet_fns, st.jex = {}, {}
        _STACKS[arch] = st
    return _STACKS[arch]


@pytest.fixture(autouse=True)
def shared_reference_jits(monkeypatch):
    """Reference schedulers share their stack's compiled functions; a
    reference executor builds its suffix functions once."""

    base = jsched_mod.ContinuousBatchingScheduler
    build = JaxExecutor.build_suffix_fns

    class Shared(base):
        def __init__(self, model, *a, **kw):
            super().__init__(model, *a, **kw)
            st = next(s for s in _STACKS.values() if s.jmodel is model)
            self._admit_fns, self._decode_fns = st.admit_fns, st.decode_fns
            self._fleet_fns = st.fleet_fns

    def build_once(self, spec, extra):
        if getattr(self, "_suffix_step_j", None) is None:
            build(self, spec, extra)
        self._suffix_spec = spec

    flush = jsched_mod._SplitLane.flush

    def writable_flush(self, new):
        if self._logits is not None and not self._logits.flags.writeable:
            self._logits = np.array(self._logits)
        flush(self, new)

    monkeypatch.setattr(jsched_mod, "ContinuousBatchingScheduler", Shared)
    monkeypatch.setattr(JaxExecutor, "build_suffix_fns", build_once)
    monkeypatch.setattr(jsched_mod._SplitLane, "flush", writable_flush)


def jax_lane(st, key):
    """The reference executor of lane ``key`` (a cut or (cut, offload)),
    one per stack and key."""

    if key not in st.jex:
        cut, off = (key, ()) if isinstance(key, int) else key
        base = st.jex.setdefault("base", JaxExecutor(st.jmodel, st.jparams, 0))
        st.jex[key] = base.with_cut(cut, expert_offload=off)
    return st.jex[key]


def port_lane(st, key):
    cut, off = (key, ()) if isinstance(key, int) else key
    return PartitionExecutor(st.tmodel, cut, expert_offload=off)


def run_split_twin(st, script, lanes, seed=0, pipelined=True, rows=2, **kw):
    """``script(sched, rng, log, obs_of)`` through the reference and the
    port with the split ``lanes`` (lane keys) attached; checks logs,
    results, counters, lane rows and tokens; returns (port scheduler, port
    results)."""

    out = []
    for side in ("reference", "port"):
        if side == "reference":
            s = jsched_mod.ContinuousBatchingScheduler(st.jmodel, st.jparams, st.jtok, **kw)
            for key in lanes:
                s.attach_partition(jax_lane(st, key), rows=rows, pipelined=pipelined)
        else:
            s = ContinuousBatchingScheduler(st.tmodel, st.tok, **kw)
            for key in lanes:
                s.attach_partition(port_lane(st, key), rows=rows, pipelined=pipelined)
        log, obs_of = [], {}
        results = script(s, np.random.default_rng(seed), log, obs_of)
        out.append((s, log, results, obs_of))
    (js, jlog, jres, _), (ts, tlog, tres, tobs_of) = out
    assert tlog == jlog
    assert [_result(r) + (r.expert_offload,) for r in tres] == \
        [_result(r) + (r.expert_offload,) for r in jres]
    assert _snapshot(ts) == _snapshot(js)
    assert {k: l.rows for k, l in ts._lanes.items()} == {k: l.rows for k, l in js._lanes.items()}
    for w, g in zip(jres, tres):
        assert_tokens_match(st, _obs_tokens(st.tok, *tobs_of[g.robot_id]), w.tokens, g.tokens,
                            f"robot {g.robot_id}")
    return ts, tres


def _log(s, log):
    log.append((s.round, s.n_active, s.n_pending, s.allocator.num_in_use,
                tuple(s.active_cuts), tuple(map(str, s.active_lanes))))


def mixed_fleet(route, n=6):
    """Three requests at once, then one every 2 rounds; robot r goes to
    lane ``route[r]`` (absent: cloud-only)."""

    def script(s, rng, log, obs_of):
        reqs = [(r, *_obs(rng)) for r in range(n)]

        def submit(r, qd, tau):
            obs_of[r] = (qd, tau)
            s.submit(r, qd, tau, partitioned=r in route, cut=route.get(r))

        for req in reqs[:3]:
            submit(*req)
        results, nxt = [], 3
        while len(results) < n:
            results += s.step()
            _log(s, log)
            if nxt < n and s.round % 2 == 0:
                submit(*reqs[nxt])
                nxt += 1
        return results

    return script


@pytest.mark.parametrize("rounds", R14)
def test_shared_pool_cloud_and_split(rounds):
    st = stacks()
    route = {1: 1, 3: 1, 5: 1}
    ts, res = run_split_twin(st, mixed_fleet(route), [1], max_slots=4, scan_rounds=rounds)
    assert ts.mixed_rounds > 0 and ts.hetero_rounds == 0
    assert {r.robot_id for r in res if r.kind == "split"} == {1, 3, 5}
    assert ts.allocator.num_in_use == 0


@pytest.mark.parametrize("rounds", R14)
def test_heterogeneous_cuts(rounds):
    st = stacks()
    route = {0: 0, 1: 1, 2: 2, 4: 1, 5: 0}
    ts, res = run_split_twin(st, mixed_fleet(route), [0, 1, 2], seed=3, max_slots=4,
                             scan_rounds=rounds)
    assert ts.hetero_rounds > 0 and ts.mixed_rounds > 0
    assert {r.cut for r in res if r.kind == "split"} == {0, 1, 2}
    # the pools went with the last lane; the edge-only lane (cut 2 of 2
    # layers: an empty suffix) reads no pool, the cut-0 lane one a layer
    assert not ts._suffix_pools and not any(l.has_buffers for l in ts._lanes.values())
    ts._lanes[2]._ensure_buffers()
    assert not ts._suffix_pools
    ts._lanes[0]._ensure_buffers()
    assert set(ts._suffix_pools) == {0, 1}


def test_serial_lanes_match_reference_and_pipelined():
    st = stacks()
    route = {0: 0, 1: 1, 3: 2, 4: 1}
    script = mixed_fleet(route)
    ts, res = run_split_twin(st, script, [0, 1, 2], seed=5, pipelined=False, max_slots=4,
                             scan_rounds=4)
    serial = {r.robot_id: r.tokens for r in res}
    pipe = ContinuousBatchingScheduler(st.tmodel, st.tok, max_slots=4, scan_rounds=4)
    for key in (0, 1, 2):
        pipe.attach_partition(port_lane(st, key))
    got = {r.robot_id: r.tokens for r in script(pipe, np.random.default_rng(5), [], {})}
    assert got.keys() == serial.keys()
    for r in got:
        np.testing.assert_array_equal(got[r], serial[r], err_msg=f"robot {r}")


def cancels(route):
    def script(s, rng, log, obs_of):
        for r in range(6):
            qd, tau = _obs(rng)
            obs_of[r] = (qd, tau)
            s.submit(r, qd, tau, partitioned=r in route, cut=route.get(r))
        s.step()
        _log(s, log)
        # a split robot decoding in the window, one queued, a cloud robot
        log.append(s.cancel_batch([1, 5, 0]).tolist())
        _log(s, log)
        results = []
        for _ in range(3):
            results += s.step()
            _log(s, log)
        log.append(s.cancel_batch([2, 9]).tolist())
        results += s.drain()
        _log(s, log)
        return results

    return script


@pytest.mark.parametrize("rounds", R14)
def test_cancels_mid_window(rounds):
    st = stacks()
    route = {1: 1, 2: 0, 4: 1, 5: 0}
    ts, res = run_split_twin(st, cancels(route), [0, 1], seed=7, max_slots=4,
                             num_pages=3 * PAGES, scan_rounds=rounds)
    assert ts.cancelled >= 3 and ts.allocator.num_in_use == 0
    assert {r.robot_id for r in res}.isdisjoint({0, 1, 5})


def row_release(s, rng, log, obs_of):
    """Four split robots at once on a 1-row lane (rows double twice), then
    three more after they finish (recycled rows)."""

    results = []
    for wave in (range(4), range(4, 7)):
        for r in wave:
            qd, tau = _obs(rng)
            obs_of[r] = (qd, tau)
            s.submit(r, qd, tau, partitioned=True)
        results += s.drain()
        _log(s, log)
        log.append({k: (l.rows, sorted(l._free_rows)) for k, l in s._lanes.items()})
    return results


def test_row_release_and_growth():
    st = stacks()
    ts, res = run_split_twin(st, row_release, [1], seed=9, rows=1, max_slots=2,
                             num_pages=4 * PAGES, scan_rounds=4)
    assert ts._lanes[1].rows == 4 and len(res) == 7
    # each wave's last completion freed the lane's buffers (and the pools)
    assert not ts._lanes[1].has_buffers and not ts._lanes[1].seqs
    assert ts._lanes[1].drops == 2 and ts._lanes[1].peak_bytes > 0
    assert not ts._suffix_pools and ts.allocator.num_in_use == 0


def test_hetero_lanes_no_leak_and_release_row_arrays():
    """The twin of ``tests/test_serving.py:367``: cancelling a lane's only
    member frees the lane's buffers, not just its row, and the fused graphs
    captured over them (on the CPU, stand-in entries of the graph table);
    across two concurrent lanes the shared pool drains to no page in use;
    completion frees the last lane's buffers and the shared suffix pools."""

    st = stacks()
    logs, res = {}, {}
    for side in ("reference", "port"):
        if side == "reference":
            s = jsched_mod.ContinuousBatchingScheduler(st.jmodel, st.jparams, st.jtok, max_slots=6)
            lanes = (jax_lane(st, 1), jax_lane(st, 2))
        else:
            s = ContinuousBatchingScheduler(st.tmodel, st.tok, max_slots=6)
            lanes = (port_lane(st, 1), port_lane(st, 2))
        for ex in lanes:
            s.attach_partition(ex)
        rng = np.random.default_rng(42)
        obs = [_obs(rng) for _ in range(3)]
        s.submit(0, *obs[0])
        s.submit(1, *obs[1], partitioned=True, cut=1)
        s.submit(2, *obs[2], partitioned=True, cut=2)
        s.step()  # all admitted, both lanes mid-decode
        log = [list(s.active_cuts), [s._lanes[k].has_buffers for k in (1, 2)]]
        if side == "port":
            both, one = ((1, 2), 7, (2, 2)), ((1,), 7, (2,))
            s._fleet_graphs.update({both: object(), one: object()})
        log.append(bool(s.cancel(2)))
        log += [s._lanes[2].has_buffers, s._lanes[1].has_buffers,
                s.allocator.num_in_use == 2 * s.pages_per_req]
        if side == "port":
            assert set(s._fleet_graphs) == {one}, "the emptied lane's fused graphs stayed"
            assert s._suffix_pools, "a lane with members keeps the shared pools"
            s._fleet_graphs.clear()
        done = s.drain()
        log += [sorted(r.robot_id for r in done), s.pool_stats().pages_in_use,
                s.allocator.num_free == s.allocator.num_pages,
                [s._lanes[k].has_buffers for k in (1, 2)]]
        logs[side], res[side] = log, {r.robot_id: r for r in done}
        if side == "port":
            assert not s._suffix_pools, "the shared suffix pools outlived the last lane"
            assert [s._lanes[k].drops for k in (1, 2)] == [1, 1]
            assert all(s._lanes[k].buffer_bytes == 0 < s._lanes[k].peak_bytes for k in (1, 2))
    assert logs["port"] == logs["reference"] == [
        [1, 2], [True, True], True, False, True, True, [0, 1], 0, True, [False, False]]
    for r in (0, 1):
        assert_tokens_match(st, _obs_tokens(st.tok, *obs[r]), res["reference"][r].tokens,
                            res["port"][r].tokens, f"robot {r}")


@pytest.mark.parametrize("pipelined", (True, False))
def test_jamba_expert_offload_and_plain_lanes(pipelined):
    st = stacks("jamba-1.5-large-398b")
    route = {1: (2, (1,)), 2: 2, 4: (2, (1,)), 5: 1}
    ts, res = run_split_twin(st, mixed_fleet(route), [1, 2, (2, (1,))], seed=11,
                             pipelined=pipelined, max_slots=4, scan_rounds=4)
    assert ts.hetero_rounds > 0 and ts.mixed_rounds > 0
    assert {r.expert_offload for r in res if r.kind == "split"} == {(), (1,)}
    assert ts.active_lanes == []


def test_lane_routing_errors():
    st = stacks()
    s = ContinuousBatchingScheduler(st.tmodel, st.tok)
    qd, tau = _obs(np.random.default_rng(0))
    with pytest.raises(ValueError, match="no PartitionExecutor"):
        s.submit(0, qd, tau, partitioned=True)
    s.attach_partition(port_lane(st, 0))
    s.attach_partition(port_lane(st, 1))
    with pytest.raises(ValueError, match="already attached"):
        s.attach_partition(port_lane(st, 1))
    with pytest.raises(ValueError, match="pass cut"):
        s.submit(0, qd, tau, partitioned=True)
    with pytest.raises(ValueError, match="no lane for 2"):
        s.submit_batch([0], qd, tau, partitioned=[True], cuts=[2])
    other = type(st.tmodel)(st.tmodel.cfg, device="cpu")
    with pytest.raises(ValueError, match="this scheduler's model"):
        s.attach_partition(PartitionExecutor(other, 2))


# ---------------------------------------------------------------------------
# partitioned serve_fleet / serve_trace against the reference
# ---------------------------------------------------------------------------

CUTS = {1: 0, 2: 1, 4: 2, 5: 1}


def test_serve_fleet_robot_cuts_matches_reference():
    st = stacks()
    kw = dict(FLEET, scan_rounds=4, trigger="rapid", robot_cuts=CUTS)
    want = jserve.serve_fleet(st.jmodel, st.jparams, st.jtok,
                              partition_executor=jax_lane(st, 0), **kw)
    got = {tick: tserve.serve_fleet(st.tmodel, st.tok, tick=tick,
                                    partition_executor=PartitionExecutor(st.tmodel, 0), **kw)
           for tick in ("vectorized", "legacy")}
    for tick, out in got.items():
        assert_fleet_equal(out, want)
        assert out["robot_cuts"] == want["robot_cuts"] and out["active_cuts"] == [0, 1, 2]
        assert out["split_robots"] == want["split_robots"] == [1, 2, 4, 5]
    assert got["vectorized"]["hetero_rounds"] > 0 and got["vectorized"]["cancelled"] > 0
    sched = got["vectorized"]["sched"]
    sched.drain()
    assert sched.pool_stats().pages_in_use == 0


def test_serve_fleet_split_robots_always_matches_reference():
    st = stacks()
    kw = dict(FLEET, max_steps=64, scan_rounds=1, trigger="always", split_robots=[0, 3])
    want = jserve.serve_fleet(st.jmodel, st.jparams, st.jtok,
                              partition_executor=jax_lane(st, 1), **kw)
    got = tserve.serve_fleet(st.tmodel, st.tok, partition_executor=PartitionExecutor(st.tmodel, 1),
                             **kw)
    assert_fleet_equal(got, want)
    assert got["robot_cuts"] == {0: 1, 3: 1} and got["mixed_rounds"] > 0


def test_serve_trace_robot_cuts_matches_reference():
    st = stacks()
    trace = tfleet.make_trace(16, 160, arrivals="poisson", mean_dwell=60, seed=2)
    jtrace = jfleet.make_trace(16, 160, arrivals="poisson", mean_dwell=60, seed=2)
    cuts = {r: r % 3 for r in range(0, 16, 2)}
    kw = dict(horizon=160, max_slots=8, scan_rounds=4, robot_cuts=cuts, verbose=False)
    want = jfleet.serve_trace(st.jmodel, st.jparams, st.jtok, jtrace,
                              partition_executor=jax_lane(st, 0), **kw)
    got = tfleet.serve_trace(st.tmodel, st.tok, trace,
                             partition_executor=PartitionExecutor(st.tmodel, 0), **kw)
    for k in ("joined", "left", "churn_cancels", "completions", "fires", "replays", "cancels",
              "service_rounds", "peak_batch", "decode_rounds", "scan_windows", "pending",
              "in_flight"):
        assert got[k] == want[k], k
    assert (got["pool"].pages_in_use, got["pool"].high_water) == \
        (want["pool"].pages_in_use, want["pool"].high_water)
    np.testing.assert_allclose(got["offload_ms"], want["offload_ms"], rtol=1e-6)
    assert got["sched"].hetero_rounds == want["sched"].hetero_rounds > 0
    got["sched"].drain()
    assert got["sched"].pool_stats().pages_in_use == 0


# ---------------------------------------------------------------------------
# the planning helpers and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,network,plan_2d", [
    ("openvla-7b", "lan", False), ("openvla-7b", "wan", False),
    ("jamba-1.5-large-398b", "wan", True), ("gemma2-9b", "congested", True)])
def test_plan_fleet_partition_matches_reference(arch, network, plan_2d):
    st = stacks("jamba-1.5-large-398b" if arch.startswith("jamba") else "openvla-7b")
    ex, plan = tserve.plan_fleet_partition(st.tmodel, arch, network, verbose=False,
                                           plan_2d=plan_2d)
    jex, jplan = jserve.plan_fleet_partition(st.jmodel, st.jparams, arch, network,
                                             verbose=False, plan_2d=plan_2d)
    assert plan.to_json() == jplan.to_json()
    assert (ex is None) == (jex is None)
    if ex is not None:
        assert ex.lane_key == jex.lane_key and vars(ex.channel) == vars(jex.channel)


def test_plan_expert_lane_and_build_policy_match_reference():
    st = stacks("jamba-1.5-large-398b")
    arch = "jamba-1.5-large-398b"
    for network in ("lan", "wan"):
        lane = tserve.plan_expert_lane(st.tmodel, arch, network, verbose=False)
        jlane = jserve.plan_expert_lane(st.jmodel, st.jparams, arch, network, verbose=False)
        assert (lane is None) == (jlane is None)
        if lane is not None:
            assert lane.lane_key == jlane.lane_key
    for partition in ("none", "auto", "1"):
        pol, plan = tserve.build_policy(st.tmodel, st.tok, arch, partition, "lan", verbose=False)
        jpol, jplan = jserve.build_policy(st.jmodel, st.jparams, st.jtok, arch, partition,
                                          "lan", verbose=False)
        assert type(pol).__name__ == type(jpol).__name__
        assert (plan is None and jplan is None) or plan.to_json() == jplan.to_json()
        if hasattr(pol, "executor"):
            assert pol.executor.lane_key == jpol.executor.lane_key


@pytest.mark.parametrize("arch", ("openvla-7b", "jamba-1.5-large-398b", "gemma2-9b"))
def test_assign_fleet_cuts_and_replan_match_reference(arch):
    st = stacks("jamba-1.5-large-398b" if arch.startswith("jamba") else "openvla-7b")
    fractions = [0.0, 0.05, 0.2, 0.31, 0.5, 0.9, 1.0, 0.12]
    for network in ("lan", "wan"):
        ex, cuts, a = tserve.assign_fleet_cuts(st.tmodel, arch, fractions, network,
                                               verbose=False)
        jex, jcuts, ja = jserve.assign_fleet_cuts(st.jmodel, st.jparams, arch, fractions,
                                                  network, verbose=False)
        assert cuts == jcuts and a.to_json() == ja.to_json()
        assert (ex is None) == (jex is None)
        if ex is not None:
            assert ex.cut_layer == jex.cut_layer
        for pipelined in (False, True):
            got = tserve.replan_from_telemetry(arch, 0.17, network, pipelined, verbose=False)
            want = jserve.replan_from_telemetry(arch, 0.17, network, pipelined, verbose=False)
            assert got[0].to_json() == want[0].to_json()
            assert got[1].to_json() == want[1].to_json()
            assert vars(got[2]) == vars(want[2])


def test_serve_cli_partitioned_on_cpu(capsys):
    out = tserve.main(["--partition", "1", "--device", "cpu", "--steps", "40"])
    assert out["offloads"] > 0 and np.isfinite(out["actions"]).all()
    text = capsys.readouterr().out
    assert "split execution: 1/2 layers on the edge" in text
    out = tserve.main(["--fleet", "4", "--partition", "auto", "--network", "lan",
                       "--trigger", "rapid", "--scan-rounds", "4", "--steps", "48",
                       "--device", "cpu"])
    assert out["split_robots"] == [1, 3] and out["robot_cuts"] == {1: 0, 3: 0}
    assert "replan @ realized" in capsys.readouterr().out
    out = tserve.main(["--fleet", "4", "--partition", "1", "--assign-cuts", "--max-cuts", "2",
                       "--steps", "48", "--device", "cpu"])
    assert "cut assignment [wan]" in capsys.readouterr().out
    out = tfleet.main(["--fleet", "8", "--horizon", "40", "--partition", "1",
                       "--scan-rounds", "4", "--device", "cpu"])
    assert out["sched"]._lanes and out["completions"] > 0
