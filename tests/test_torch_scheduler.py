"""The port's continuous-batching scheduler (cloud lane) against the JAX
package's ``ContinuousBatchingScheduler`` on the f32 openvla-smoke stack.

Each twin runs the same script (the same submissions, cancels and steps,
from a seeded numpy generator) through both schedulers built with the same
arguments, and requires: the same log of what the script observed
(``n_active``, ``n_pending``, pages in use, ``cancel``'s answers...), the
same ``ChunkResult`` robot ids in the same order with equal
``submitted_round``, ``admitted_round``, ``completed_round`` and
``PoolStats``, equal counters (``peak_active``, ``windows``,
``window_closes``, ``cancelled``, ``deferred``, ``decode_rounds``, rows,
allocator counts), and equal tokens under the greedy-margin rule: two
chunks may differ only where the port's top-two logit gap over the action
bins, teacher-forced on the reference's tokens, is within ``MARGIN`` (the
float32 logit tolerance of the port's model tests).  The twins of
``tests/test_serving.py`` run at ``scan_rounds`` 1 and 4.  The reference
fixture is float32 because its bf16 stack disagrees with itself on this
host (ROADMAP queue 3).

The reference scheduler jits per instance; the twins share its compiled
admission and decode functions across instances (they close over the same
model and token floor), which keeps the file within its time budget.
"""

import gc
import weakref
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# The tests run under pytest-xdist, whose workers each import every test
# module before running any: one intra-op thread a worker keeps the workers'
# torch thread pools from oversubscribing the cores (8 threads a worker made
# the torch test files 20-40x slower than alone).
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.checkpoint.npz import _flatten  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.pipeline import EpisodeTokenizer as JaxTokenizer  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.obs import Observability as JaxObservability  # noqa: E402
from repro.runtime.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro_torch.checkpoint.bridge import load_reference_params  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import EpisodeTokenizer  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.launch.serve import CloudPolicy  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.obs import Observability, validate_chrome_trace  # noqa: E402
from repro_torch.obs.histogram import bucket_index  # noqa: E402
from repro_torch.runtime import graphs  # noqa: E402
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler, _bucket  # noqa: E402

JAX_F32 = dict(dtype="float32", param_dtype="float32")
MARGIN = 1e-4
PAGES = -(-(14 + 56) // 16)  # pages a request holds at page 16
R14 = [1, 4]


def make_stacks(arch):
    jcfg = jax_smoke(arch).replace(**JAX_F32)
    jmodel = JaxModel(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = Model(get_smoke_config(arch).replace(dtype="float32"), device="cpu")
    load_reference_params(tmodel, _flatten(jparams))
    return SimpleNamespace(jmodel=jmodel, jparams=jparams, jtok=JaxTokenizer(jcfg.vocab_size),
                           tmodel=tmodel, tok=EpisodeTokenizer(tmodel.cfg.vocab_size),
                           admit_fns={}, decode_fns={})


@pytest.fixture(scope="module")
def st():
    return make_stacks("openvla-7b")


def _obs(rng, b=1):
    qd = rng.normal(0, 0.5, (b, 7)).astype(np.float32)
    tau = rng.normal(0, 0.5, (b, 7)).astype(np.float32)
    return qd, tau


def top2_gap(model, tok, obs_tokens, toks, step):
    """The port's top-two logit gap over the action bins at decode step
    ``step``, teacher-forced with ``toks``."""

    logits, cache = model.prefill({"tokens": torch.as_tensor(obs_tokens[None])}, extra=step + 1)
    for j in range(step):
        logits, cache = model.decode_step(torch.as_tensor(toks[None, j:j + 1]), cache)
    top = logits[0, -1, tok.action_base:].topk(2).values
    return float(top[0] - top[1])


def assert_tokens_match(st, obs_tokens, want, got, what=""):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, what
    diff = np.flatnonzero(want != got)
    if diff.size:
        gap = top2_gap(st.tmodel, st.tok, obs_tokens, want, int(diff[0]))
        assert gap <= MARGIN, f"{what}: token {diff[0]} differs where the gap is {gap:.3g}"


def _obs_tokens(tok, qd, tau):
    return np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)[0]


def _snapshot(s):
    a = s.allocator
    return dict(round=s.round, rows=s.rows, peak_active=s.peak_active, windows=s.windows,
                window_closes=s.window_closes, cancelled=s.cancelled, deferred=s.deferred,
                decode_rounds=s.decode_rounds, mixed_rounds=s.mixed_rounds,
                hetero_rounds=s.hetero_rounds, n_active=s.n_active, n_pending=s.n_pending,
                pool=(a.num_in_use, a.num_free, a.high_water, a.total_allocs, a.total_frees))


def _result(r):
    p = r.pool
    return (r.robot_id, r.submitted_round, r.admitted_round, r.completed_round, r.kind, r.cut,
            None if p is None else (p.pages_in_use, p.pages_free, p.high_water,
                                    p.shard_in_use, p.shard_high_water))


def run_twin(st, script, seed=0, obs=False, **kw):
    """``script(sched, rng, log, obs_of) -> results`` through the reference
    and the port; checks the logs, results, counters and tokens, and
    returns (reference scheduler, port scheduler, port results)."""

    out = []
    for side in ("reference", "port"):
        if side == "reference":
            s = JaxScheduler(st.jmodel, st.jparams, st.jtok,
                             obs=JaxObservability() if obs else None, **kw)
            s._admit_fns, s._decode_fns = st.admit_fns, st.decode_fns
        else:
            s = ContinuousBatchingScheduler(st.tmodel, st.tok,
                                            obs=Observability() if obs else None, **kw)
        log, obs_of = [], {}
        results = script(s, np.random.default_rng(seed), log, obs_of)
        out.append((s, log, results, obs_of))
    (js, jlog, jres, jobs_of), (ts, tlog, tres, tobs_of) = out
    assert tlog == jlog
    assert [_result(r) for r in tres] == [_result(r) for r in jres]
    assert _snapshot(ts) == _snapshot(js)
    for w, g in zip(jres, tres):
        assert_tokens_match(st, _obs_tokens(st.tok, *tobs_of[g.robot_id]), w.tokens, g.tokens,
                            f"robot {g.robot_id}")
    return js, ts, tres


def _submit(s, obs_of, r, qd, tau, **kw):
    obs_of[r] = (qd, tau)
    s.submit(r, qd, tau, **kw)


# ---------------------------------------------------------------------------
# twins of tests/test_serving.py
# ---------------------------------------------------------------------------


def staggered(s, rng, log, obs_of, n=6):
    """Three at once, then one every 2 rounds, joining mid-decode."""

    reqs = [(r, *_obs(rng)) for r in range(n)]
    for req in reqs[:3]:
        _submit(s, obs_of, *req)
    results, nxt = [], 3
    while len(results) < n:
        results += s.step()
        log.append((s.round, s.n_active, s.n_pending, s.allocator.num_in_use))
        if nxt < n and s.round % 2 == 0:
            _submit(s, obs_of, *reqs[nxt])
            nxt += 1
    return results


@pytest.mark.parametrize("rounds", R14)
def test_staggered_matches_reference_and_cloud_policy(st, rounds):
    _, ts, res = run_twin(st, staggered, max_slots=4, scan_rounds=rounds)
    assert ts.peak_active > 1, "requests never overlapped"
    assert ts.allocator.num_free == ts.allocator.num_pages
    # and each chunk is the port's own isolated CloudPolicy chunk
    policy = CloudPolicy(st.tmodel, st.tok, paged=True)
    rng = np.random.default_rng(0)
    reqs = {r: _obs(rng) for r in range(6)}
    for r in res:
        qd, tau = reqs[r.robot_id]
        assert_tokens_match(st, _obs_tokens(st.tok, qd, tau), policy.chunk_tokens(qd, tau)[0],
                            r.tokens, f"robot {r.robot_id} vs CloudPolicy")


def test_scan_window_r4_matches_r1(st):
    """scan_rounds=4 emits the per-round path's chunks (port against port)."""

    got = {}
    for rounds in (1, 4):
        s = ContinuousBatchingScheduler(st.tmodel, st.tok, max_slots=4, scan_rounds=rounds)
        got[rounds] = {r.robot_id: r for r in staggered(s, np.random.default_rng(71), [], {})}
        if rounds == 4:
            assert s.windows > 0 and s.decode_rounds >= 4 * s.windows - 3
    rng = np.random.default_rng(71)
    reqs = {r: _obs(rng) for r in range(6)}
    for r, res in got[1].items():
        assert_tokens_match(st, _obs_tokens(st.tok, *reqs[r]), res.tokens, got[4][r].tokens,
                            f"robot {r}")


def pool_exhausted(s, rng, log, obs_of):
    for r in range(4):
        _submit(s, obs_of, r, *_obs(rng))
    s.step()
    log.append((s.n_active, s.n_pending))
    return s.drain()


@pytest.mark.parametrize("rounds", R14)
def test_defers_when_pool_exhausted(st, rounds):
    _, ts, res = run_twin(st, pool_exhausted, seed=1, max_slots=4, num_pages=2 * PAGES,
                          scan_rounds=rounds)
    assert ts.n_active == 0 and {r.robot_id for r in res} == {0, 1, 2, 3}
    assert ts.allocator.num_free == ts.allocator.num_pages


def one_request(s, rng, log, obs_of):
    _submit(s, obs_of, 0, *_obs(rng))
    return s.drain()


@pytest.mark.parametrize("rounds", R14)
def test_releases_pages(st, rounds):
    _, ts, res = run_twin(st, one_request, seed=2, max_slots=2, scan_rounds=rounds)
    assert len(res) == 1 and res[0].tokens.shape == (56,)
    assert ts.allocator.num_free == ts.allocator.num_pages


def beyond_rows(s, rng, log, obs_of):
    for r in range(5):
        _submit(s, obs_of, r, *_obs(rng))
    s.step()
    log.append((s.n_active, s.rows))
    return s.drain()


@pytest.mark.parametrize("rounds", R14)
def test_admits_beyond_initial_rows(st, rounds):
    _, ts, res = run_twin(st, beyond_rows, seed=8, max_slots=2, num_pages=5 * PAGES,
                          scan_rounds=rounds)
    assert ts.rows >= 5 and len(res) == 5


def two_requests(s, rng, log, obs_of):
    _submit(s, obs_of, 0, *_obs(rng))
    _submit(s, obs_of, 1, *_obs(rng))
    return s.drain()


@pytest.mark.parametrize("rounds", R14)
def test_pool_utilization(st, rounds):
    _, ts, res = run_twin(st, two_requests, seed=12, max_slots=2, scan_rounds=rounds)
    assert res[0].pool.high_water == 2 * ts.pages_per_req
    assert ts.pool_stats().pages_in_use == 0


def deferred(s, rng, log, obs_of):
    _submit(s, obs_of, 0, *_obs(rng), defer_rounds=1)
    s.step()
    log.append((s.n_active, s.n_pending, s.allocator.num_in_use))
    s.step()
    log.append((s.n_active, s.deferred))
    results = s.drain()
    _submit(s, obs_of, 1, *_obs(rng), defer_rounds=1)
    s.step()
    log.append((s.cancel(1), s.n_pending, s.allocator.num_in_use))
    results += s.drain()
    return results


@pytest.mark.parametrize("rounds", R14)
def test_deferred_admission(st, rounds):
    _, ts, res = run_twin(st, deferred, seed=43, max_slots=2, scan_rounds=rounds)
    assert [r.robot_id for r in res] == [0] and ts.deferred == 2


def cancel_mid_flight(s, rng, log, obs_of):
    for r in range(2):
        _submit(s, obs_of, r, *_obs(rng))
    s.step()
    log.append((s.cancel(0), s.allocator.num_in_use, s.cancelled))
    return s.drain()


@pytest.mark.parametrize("rounds", R14)
def test_cancel_mid_flight(st, rounds):
    """R = 1: freed at once; R = 4: the cancel lands mid-window, the row is
    marked dead and the boundary frees it."""

    js, ts, res = run_twin(st, cancel_mid_flight, seed=31, max_slots=4, scan_rounds=rounds)
    assert [r.robot_id for r in res] == [1] and ts.pool_stats().pages_in_use == 0


def cancel_queued(s, rng, log, obs_of):
    _submit(s, obs_of, 0, *_obs(rng))
    _submit(s, obs_of, 1, *_obs(rng))
    s.step()
    log.append((s.n_pending, s.cancel(1), s.n_pending))
    return s.drain()


@pytest.mark.parametrize("rounds", R14)
def test_cancel_queued_request(st, rounds):
    _, ts, res = run_twin(st, cancel_queued, seed=32, max_slots=4, num_pages=PAGES,
                          scan_rounds=rounds)
    assert [r.robot_id for r in res] == [0] and ts.pool_stats().pages_in_use == 0


def cancel_racing(s, rng, log, obs_of):
    _submit(s, obs_of, 0, *_obs(rng))
    s.step()
    while s._seqs and next(iter(s._seqs.values())).remaining > s.decode_block:
        s.step()
    log.append((s.n_active, s.cancel(0)))
    results = s.drain()
    log.append(len(results))
    _submit(s, obs_of, 0, *_obs(rng))
    results += s.drain()
    log.append((s.cancel(0), s.allocator.num_in_use))
    _submit(s, obs_of, 0, *_obs(rng))
    results += s.drain()
    return results


@pytest.mark.parametrize("rounds", R14)
def test_cancel_racing_final_step(st, rounds):
    _, ts, _ = run_twin(st, cancel_racing, seed=33, max_slots=2, scan_rounds=rounds)
    assert ts.allocator.num_free == ts.allocator.num_pages


def test_adaptive_block_schedule_matches_reference(st):
    for kw in (dict(adaptive_block=True), dict(adaptive_block=True, max_block=14), {}):
        js = JaxScheduler(st.jmodel, st.jparams, st.jtok, max_slots=4, **kw)
        ts = ContinuousBatchingScheduler(st.tmodel, st.tok, max_slots=4, **kw)
        blocks = [ts._block_for_depth(d) for d in range(64)]
        assert blocks == [js._block_for_depth(d) for d in range(64)]
        assert all(a <= b for a, b in zip(blocks, blocks[1:]))
        assert ts.max_block == js.max_block
    assert [_bucket(n) for n in range(1, 18)] == [1, 2, 4, 4] + [8] * 4 + [16] * 8 + [32]


def deep_queue(s, rng, log, obs_of):
    for r in range(8):
        _submit(s, obs_of, r, *_obs(rng))
    results = []
    while s.n_pending or s.n_active:
        results += s.step()
        log.append((s.round, s.n_active, s.n_pending))
    return results


@pytest.mark.parametrize("rounds", R14)
def test_adaptive_block_deep_queue(st, rounds):
    """A backlog of 6 over 2 rows doubles the block (7 -> 28 tokens)."""

    _, ts, res = run_twin(st, deep_queue, seed=4, max_slots=2, num_pages=2 * PAGES,
                          adaptive_block=True, scan_rounds=rounds)
    assert len(res) == 8


def cancel_mid_window(s, rng, log, obs_of):
    _submit(s, obs_of, 0, *_obs(rng))
    _submit(s, obs_of, 1, *_obs(rng))
    log.append((s.step(), s._window is not None, s.allocator.num_in_use))
    log.append((s.cancel(0), s.allocator.num_in_use, s.cancelled))
    return s.drain()


def test_cancel_mid_window_defers_page_release(st):
    _, ts, res = run_twin(st, cancel_mid_window, seed=73, max_slots=2, scan_rounds=4)
    assert [r.robot_id for r in res] == [1]
    assert ts.allocator.num_free == ts.allocator.num_pages


def round_boundary(s, rng, log, obs_of):
    _submit(s, obs_of, 0, *_obs(rng))
    s.step()
    log.append(s.allocator.num_in_use)
    _submit(s, obs_of, 1, *_obs(rng), defer_rounds=1)
    log.append((s.n_pending, s.deferred))
    s.step()
    log.append((s.allocator.num_in_use, s.cancel(1), s.n_pending, s.allocator.num_in_use))
    return s.drain()


@pytest.mark.parametrize("rounds", [1, 3, 4])
def test_round_boundary_admission(st, rounds):
    _, ts, res = run_twin(st, round_boundary, seed=75, max_slots=2, scan_rounds=rounds)
    assert [r.robot_id for r in res] == [0]


def reset_episodes(s, rng, log, obs_of):
    results = two_requests(s, rng, log, obs_of)
    a = s.allocator
    log.append((a.high_water, a.total_allocs, a.total_frees))
    s.reset()
    log.append((a.high_water, a.num_in_use, a.total_allocs, s.round, s.windows))
    _submit(s, obs_of, 2, *_obs(rng))
    results += s.drain()
    log.append((a.high_water, a.total_allocs))
    return results


@pytest.mark.parametrize("rounds", R14)
def test_reset_gives_per_episode_high_water(st, rounds):
    _, ts, _ = run_twin(st, reset_episodes, seed=21, max_slots=2, scan_rounds=rounds)
    assert 0 < ts.allocator.high_water < ts.allocator.total_allocs


def batch_entry_points(s, rng, log, obs_of):
    qd, tau = _obs(rng, 5)
    for r in range(5):
        obs_of[r] = (qd[r:r + 1], tau[r:r + 1])
    s.submit_batch(np.arange(5), qd, tau, defer_rounds=[0, 1, 0, 0, 2])
    results = s.step()
    log.append((s.n_active, s.n_pending, s.deferred))
    log.append(s.cancel_batch([3, 9, 1]).tolist())
    results += s.drain()
    return results


@pytest.mark.parametrize("rounds", R14)
def test_submit_batch_and_cancel_batch(st, rounds):
    _, ts, res = run_twin(st, batch_entry_points, seed=9, max_slots=2, num_pages=3 * PAGES,
                          scan_rounds=rounds)
    assert sorted(r.robot_id for r in res) == [0, 2, 4]


# ---------------------------------------------------------------------------
# observability hooks
# ---------------------------------------------------------------------------


def with_cancels(s, rng, log, obs_of):
    results = staggered(s, rng, log, obs_of, n=4)
    _submit(s, obs_of, 10, *_obs(rng))
    _submit(s, obs_of, 11, *_obs(rng))
    s.step()
    log.append((s.cancel(10), s.cancel(11)))
    return results + s.drain()


def _metric_values(reg):
    out = {}
    for key, m in reg.items():
        if hasattr(m, "counts"):
            out[key] = m.count  # histograms: counts only (timestamps differ)
        elif hasattr(m, "high"):
            out[key] = (m.value, m.high)
        else:
            out[key] = m.value
    return out


@pytest.mark.parametrize("rounds", R14)
def test_obs_counters_and_histograms_match_reference(st, rounds):
    js, ts, res = run_twin(st, with_cancels, seed=3, obs=True, max_slots=2, scan_rounds=rounds)
    assert _metric_values(ts.obs.metrics) == _metric_values(js.obs.metrics)
    assert ts.obs.metrics.get("serve.chunk_latency_ms").count == len(res) > 0
    n, errors = validate_chrome_trace(ts.obs.trace.to_chrome())
    assert errors == [] and n == js.obs.trace.n_events == ts.obs.trace.n_events


def test_obs_is_transparent_and_spans_nest(st):
    """Tokens and windows with obs on equal obs off; each chunk's spans
    nest (queue inside the lifetime, decode ending it at a window close);
    the SLO p50/p99 sit in the bucket of the exact trace percentiles."""

    runs = {}
    for on in (False, True):
        s = ContinuousBatchingScheduler(st.tmodel, st.tok, max_slots=2, scan_rounds=4,
                                        obs=Observability() if on else None)
        runs[on] = (s, staggered(s, np.random.default_rng(5), [], {}))
    (s_off, off), (s_on, on) = runs[False], runs[True]
    assert [r.tokens.tolist() for r in off] == [r.tokens.tolist() for r in on]
    assert s_off.windows == s_on.windows > 0
    obj = s_on.obs.trace.to_chrome()
    tracks = {ev["tid"]: ev["args"]["name"] for ev in obj["traceEvents"]
              if ev.get("ph") == "M" and ev["name"] == "thread_name"}
    spans = [(tracks[ev["tid"]], ev["name"], ev["ts"], ev["ts"] + ev["dur"])
             for ev in obj["traceEvents"] if ev.get("ph") == "X"]
    closes = [end for track, _, _, end in spans if track == "lane cloud"]
    triples = [spans[i:i + 3] for i, sp in enumerate(spans) if sp[1] == "chunk"]
    assert len(triples) == len(on)
    for chunk, queue, decode in triples:
        assert (queue[1], decode[1]) == ("queue", "decode")
        assert queue[2] == chunk[2] and chunk[2] <= queue[3] <= chunk[3]
        assert abs(decode[2] - queue[3]) < 1.0 and abs(decode[3] - chunk[3]) < 1.0
        assert min(abs(decode[3] - w) for w in closes) < 1.0
    durs = sorted((c[3] - c[2]) / 1e3 for c, _, _ in triples)
    hist = s_on.obs.metrics.get("serve.chunk_latency_ms")
    slo = s_on.obs.slo_report().chunk_latency_ms
    for q, key in ((0.5, "p50"), (0.99, "p99")):
        exact = durs[max(1, int(np.ceil(q * len(durs)))) - 1]
        assert bucket_index(hist.quantile(q)) == bucket_index(exact)
        assert slo[key] == hist.quantile(q)


# ---------------------------------------------------------------------------
# CUDA-graph bookkeeping (the graph itself runs only on the card)
# ---------------------------------------------------------------------------


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: replay re-runs the captured
    function (the tests below capture pure functions)."""

    current = None

    def __init__(self):
        self.fn = None

    def replay(self):
        self.fn()


class _fake_capture:
    def __init__(self, graph):
        self.graph = graph

    def __enter__(self):
        _FakeGraph.current = self.graph

    def __exit__(self, *exc):
        _FakeGraph.current = None


def test_graphed_call_counts_launches_at_replay(monkeypatch):
    """The first call runs eagerly (its launches count), the capture's own
    counts are taken back, and each replay adds the captured counts."""

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(_lib, "LAUNCHES", {name: 0 for name in _lib.KERNELS})
    calls = []

    def fn():
        calls.append(1)
        _lib.LAUNCHES["paged_attention"] += 2
        _lib.LAUNCHES["flash_attention"] += 1
        if _FakeGraph.current is not None:
            _FakeGraph.current.fn = lambda: calls.append(1)
        return "out"

    call = graphs.GraphedCall(fn)
    assert call() == "out" and call.graph is not None
    assert _lib.LAUNCHES["paged_attention"] == 2 and _lib.LAUNCHES["flash_attention"] == 1
    assert call.launches == {"paged_attention": 2, "flash_attention": 1}
    for _ in range(3):
        assert call() == "out"
    assert _lib.LAUNCHES["paged_attention"] == 8 and _lib.LAUNCHES["flash_attention"] == 4
    assert len(calls) == 5 and call.replays == 3 and call.capture_s >= 0.0


@pytest.mark.parametrize("owner", ["policy", "scheduler"])
def test_dropped_owner_frees_its_graphs_by_refcount(st, monkeypatch, owner):
    """A policy or scheduler that has captured a graph and is then dropped
    frees it at once, by reference count, with the cyclic collector off: a
    graph freed by the collector in the middle of a later capture would
    invalidate that capture on the card.  The model is seen through a
    stand-in whose device reads "cuda" and whose ``graphs`` is set, so the
    graph path runs on the CPU with the fake graph."""

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    model = SimpleNamespace(device=torch.device("cuda"), graphs=True, prefill=st.tmodel.prefill,
                            decode_chunk=st.tmodel.decode_chunk)
    if owner == "policy":
        obj = CloudPolicy(st.tmodel, st.tok, paged=False)
        obj.model = model
        obs = torch.as_tensor(_obs_tokens(st.tok, *_obs(np.random.default_rng(0)))[None])
        obj.chunk(obs)
    else:
        obj = ContinuousBatchingScheduler(st.tmodel, st.tok, max_slots=2, num_pages=2 * PAGES)
        obj.model = model
        obj._decode_round(4)
    calls = [c[1] if owner == "policy" else c for c in obj._graphs.values()]
    assert len(calls) == 1 and calls[0].graph is not None
    graph, alive = weakref.ref(calls[0]), weakref.ref(obj)
    del obj, calls
    enabled = gc.isenabled()
    gc.disable()
    try:
        assert alive() is None and graph() is None
    finally:
        if enabled:
            gc.enable()
