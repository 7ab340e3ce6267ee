"""The port's observability copy (``repro_torch.obs``) against the JAX
package's ``repro.obs`` on the same observations.

Both sides get the same values in the same order; the histogram's
quantiles, its JSON, the registry's JSON and Prometheus text, the Chrome
trace (recorders started at the same ``t0``), the trace validator's
verdicts and the SLO report must be equal, value for value.
"""

import json
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
from repro.obs import histogram as jhist  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.obs import histogram as thist  # noqa: E402


def _samples(kind: str):
    rng = np.random.default_rng(11)
    return {
        "lognormal": rng.lognormal(3.0, 1.5, 400),
        "cluster": np.concatenate([rng.exponential(5, 200), rng.uniform(100.0, 110.0, 50)]),
        "tiny": np.asarray([0.0, 1e-7, 5e-4, 1e-3, 0.0015]),
        "single": np.asarray([42.0]),
        "huge": np.asarray([1e9, 3.5e12, 7.0]),
    }[kind]


@pytest.mark.parametrize("kind", ["lognormal", "cluster", "tiny", "single", "huge"])
def test_histogram_matches_reference(kind):
    vals = _samples(kind)
    want, got = jhist.LatencyHistogram(), thist.LatencyHistogram()
    for v in vals:
        want.observe(float(v))
        got.observe(float(v))
    assert got.counts == want.counts
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q)
    assert got.percentiles() == want.percentiles()
    assert got.to_json() == want.to_json()
    assert got.bucket_of(float(vals[0])) == want.bucket_of(float(vals[0]))
    # the port's quantile lies in the bucket of the exact nearest-rank sample
    srt = np.sort(vals)
    for q in (0.5, 0.99):
        exact = float(srt[max(1, math.ceil(q * len(srt))) - 1])
        assert thist.bucket_index(got.quantile(q)) == thist.bucket_index(exact)


def test_histogram_merge_and_json_roundtrip_match_reference():
    rng = np.random.default_rng(7)
    a_vals, b_vals = rng.exponential(50, 300), rng.exponential(5, 200)
    out = []
    for mod in (jhist, thist):
        a, b = mod.LatencyHistogram(), mod.LatencyHistogram()
        for v in a_vals:
            a.observe(float(v))
        for v in b_vals:
            b.observe(float(v))
        a.merge(b)
        back = mod.LatencyHistogram.from_json(json.loads(json.dumps(a.to_json())))
        out.append((a.to_json(), back.to_json(), back.quantile(0.5)))
    assert out[0] == out[1]
    assert [thist.bucket_bounds(i) for i in range(64)] == [jhist.bucket_bounds(i) for i in range(64)]


def _fill_registry(mod):
    m = mod.MetricsRegistry()
    m.counter("sched.completions").inc(12)
    m.counter("sched.submissions").inc(14)
    m.counter("sched.cancels").inc(2)
    m.counter("fleet.fires").inc(8)
    m.counter("fleet.replays").inc(3)
    m.counter("channel.bytes_up", leg="cut").inc(4096)
    m.gauge("pool.high_water").set(9)
    m.gauge("pool.high_water").set(7)
    m.gauge("pool.page_allocs_total").set(30)
    m.gauge("pool.page_frees_total").set(28)
    m.gauge("serve.wall_s").set(5.0)
    h = m.histogram("serve.chunk_latency_ms", kind="cloud")
    for v in (1.0, 2.0, 150.0, 0.0004):
        h.observe(v)
    for v in (0.2, 3.3):
        m.histogram("serve.queue_wait_ms").observe(v)
    return m


def test_registry_exports_match_reference():
    want, got = _fill_registry(jobs), _fill_registry(tobs)
    assert got.to_json() == want.to_json()
    assert got.to_prometheus() == want.to_prometheus()
    other_w, other_g = _fill_registry(jobs), _fill_registry(tobs)
    assert got.merge(other_g).to_json() == want.merge(other_w).to_json()
    with pytest.raises(TypeError):
        got.gauge("sched.completions")


def test_slo_report_matches_reference():
    want = jobs.build_slo_report(_fill_registry(jobs))
    got = tobs.build_slo_report(_fill_registry(tobs))
    assert got.to_json() == want.to_json()
    assert got.lines() == want.lines()
    empty = tobs.build_slo_report(tobs.MetricsRegistry())
    assert empty.to_json() == jobs.build_slo_report(jobs.MetricsRegistry()).to_json()
    assert empty.lines() == jobs.build_slo_report(jobs.MetricsRegistry()).lines()


def _trace(mod):
    tr = mod.TraceRecorder()
    tr.t0 = 100.0
    tr.complete("robot 0", "chunk", 100.001, 100.005, {"robot": 0})
    tr.complete("robot 0", "queue", 100.001, 100.002)
    tr.complete("lane cloud", "window 1", 100.002, 100.005, {"rows": 2, "rounds": 4})
    tr.instant("robot 1", "cancelled", 100.004, {"queued": True})
    tr.complete("robot 0", "decode", 100.002, 100.005)
    return tr


def test_trace_export_matches_reference(tmp_path):
    want, got = _trace(jobs), _trace(tobs)
    assert got.n_events == want.n_events == 5
    assert got.to_chrome() == want.to_chrome()
    got.write(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        assert tobs.validate_chrome_trace(json.load(f)) == (5, [])


CORRUPT = [
    {},
    {"traceEvents": [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0}]},
    {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 5.0, "dur": -1.0}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 9.0, "dur": 1.0},
                     {"name": "b", "ph": "X", "pid": 1, "tid": 1, "ts": 2.0, "dur": 1.0}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 9.0, "dur": 1.0},
                     {"name": "b", "ph": "X", "pid": 1, "tid": 2, "ts": 2.0, "dur": 1.0}]},
    {"traceEvents": [{"name": "q", "ph": "Q", "pid": 1, "tid": 1, "ts": 1.0},
                     {"name": "n", "ph": "i", "pid": 1, "tid": 1, "ts": float("nan")}]},
]


@pytest.mark.parametrize("i", range(len(CORRUPT)))
def test_trace_validator_matches_reference(i):
    assert tobs.validate_chrome_trace(CORRUPT[i]) == jobs.validate_chrome_trace(CORRUPT[i])


def test_observability_handle_and_clock():
    obs = tobs.Observability()
    assert obs.trace is not None and tobs.Observability(trace=False).trace is None
    obs.metrics.counter("sched.completions").inc(4)
    obs.metrics.gauge("serve.wall_s").set(2.0)
    assert obs.slo_report().goodput_chunks_s == pytest.approx(2.0)
    assert tobs.Observability.clock is tobs.clock
    a, b = tobs.clock(), tobs.clock()
    assert b >= a
