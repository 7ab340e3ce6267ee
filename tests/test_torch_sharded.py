"""The port's sharded and disaggregated serving against the JAX package's
8-device sharded engine and its disaggregated prefill.

A module fixture runs the reference's engine once, in a process of its own
on 8 forced host devices (``tests/torch_sharded_ref.py``, the scenarios of
``tests/test_sharded.py``: cloud-only over an 8-way data mesh, a split lane
at cut 1 sharing the sharded pool, prefill on the last device, and prefill
there with decode over the other 7), and the port's scheduler runs the same
scenarios on the same bridged f32 weights, its shards on the CPU: results,
tokens, every reservation's row and page ids, completion rounds, per-shard
``PoolStats`` and counters must be equal.  In-process twins hold the
disaggregated path (prefill one window ahead of its merge, cancels while
pending, ``reset``) and ``serve_fleet`` to the one-device reference with
``prefill_group=[jax.devices()[0]]``; the refusals and the serve CLI's
``--sharded --disaggregate-prefill`` close the file.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

import jax  # noqa: E402

import repro.runtime.scheduler as jsched_mod  # noqa: E402
from repro.launch.serve import serve_fleet as jax_serve_fleet  # noqa: E402
from repro.runtime.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro_torch.checkpoint.bridge import load_reference_params  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import EpisodeTokenizer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.paged_attention import paged_decode_attention_sharded  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_test_mesh  # noqa: E402
from repro_torch.launch.serve import serve_fleet  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.partition import PartitionExecutor  # noqa: E402
from repro_torch.runtime import scheduler as sched_mod  # noqa: E402
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler  # noqa: E402

from test_torch_fleet import assert_fleet_equal  # noqa: E402
from test_torch_scheduler import (  # noqa: E402
    _obs,
    _obs_tokens,
    _result,
    _snapshot,
    assert_tokens_match,
    make_stacks,
)
from torch_sharded_ref import ENGINE_KW, SCENARIOS, WRAPPER, obs_pair, wrapper_inputs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
REF_TIMEOUT_S = 300
R14 = [1, 4]


# ---------------------------------------------------------------------------
# against the reference's 8-device engine (a process of its own)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's recorded runs (``torch_sharded_ref.py``) -> {key: array}."""

    out = tmp_path_factory.mktemp("sharded_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_sharded_ref.py"), str(out)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port(reference):
    model = Model(get_smoke_config("openvla-7b").replace(dtype="float32"), device="cpu")
    load_reference_params(model, {k[len("params/"):]: v for k, v in reference.items()
                                  if k.startswith("params/")})
    return model, EpisodeTokenizer(model.cfg.vocab_size)


class Recording(ContinuousBatchingScheduler):
    """Logs every reservation (robot, row, pages), cloud and split lanes."""

    def __init__(self, *a, **kw):
        self.reserved = []
        super().__init__(*a, **kw)

    def _reserve(self, req):
        seq = super()._reserve(req)
        self.reserved.append([req.robot_id, seq.row, *seq.pages])
        return seq


@pytest.fixture
def recording_lanes(monkeypatch):
    reserve = sched_mod._SplitLane.reserve

    def recording(self, req):
        seq = reserve(self, req)
        self.sched.reserved.append([req.robot_id, seq.row, *seq.pages])
        return seq

    monkeypatch.setattr(sched_mod._SplitLane, "reserve", recording)


def run_scenario(model, tok, n, seed, data, disagg, cut):
    mesh = make_test_mesh(data=data, devices=[CPU] * data) if data else None
    sched = Recording(model, tok, mesh=mesh, prefill_group=[CPU] if disagg else None,
                      **ENGINE_KW)
    if cut is not None:
        sched.attach_partition(PartitionExecutor(model, cut))
    rng = np.random.default_rng(seed)
    for r in range(n):
        sched.submit(r, *obs_pair(rng), partitioned=cut is not None and r % 2 == 1)
    results = sched.drain()
    st = sched.pool_stats()
    return sched, {
        "results": np.asarray([(r.robot_id, r.submitted_round, r.admitted_round,
                                r.completed_round, int(r.kind == "split")) for r in results]),
        "tokens": np.stack([np.asarray(r.tokens, np.int64) for r in results]),
        "reserved": np.asarray(sched.reserved),
        "pool": np.asarray([st.pages_in_use, st.high_water, *(st.shard_in_use or ()),
                            *(st.shard_high_water or ())]),
        "counters": np.asarray([sched.round, sched.windows, sched.window_closes,
                                sched.mixed_rounds, sched.peak_active, sched.rows,
                                sched.allocator.num_pages]),
    }


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s[0] for s in SCENARIOS])
def test_matches_reference_sharded_engine(reference, port, recording_lanes, scenario):
    """Tokens, reservations (rows, global page ids), completion rounds,
    per-shard pool counts and counters equal to the reference's run."""

    name, n, seed, data, disagg, cut = scenario
    sched, got = run_scenario(*port, n, seed, data, disagg, cut)
    for key, value in got.items():
        np.testing.assert_array_equal(value, reference[f"{name}/{key}"], err_msg=key)
    st = sched.pool_stats()
    assert st.pages_in_use == 0
    if data:
        assert sched.data_shards == data and sched.rows % data == 0
        assert st.shard_in_use == (0,) * data
        assert sum(1 for h in st.shard_high_water if h > 0) >= 2  # steering spread them
        assert sum(st.shard_high_water) == st.high_water
    if cut is not None:
        assert sched.mixed_rounds > 0 and {r[4] for r in got["results"]} == {0, 1}


def test_sharded_wrapper(reference):
    """Row blocks against the whole pool: equal bit for bit to the unsharded
    call on the CPU, and to the reference's ``shard_map`` within float32
    rounding; rows that do not divide raise."""

    q, kp, vp, pt, lens = (torch.as_tensor(a) for a in wrapper_inputs(**WRAPPER))
    mesh = make_test_mesh(data=WRAPPER["b"], devices=[CPU] * WRAPPER["b"])
    got = paged_decode_attention_sharded(q, kp, vp, pt, lens, mesh=mesh)
    assert torch.equal(got, ops.paged_decode_attention(q, kp, vp, pt, lens))
    np.testing.assert_allclose(got.numpy(), reference["wrapper/out"], rtol=1e-5, atol=1e-5)
    four = make_test_mesh(data=4, devices=[CPU] * 4)
    kw = dict(window=9, logit_cap=5.0)
    assert torch.equal(paged_decode_attention_sharded(q, kp, vp, pt, lens, mesh=four, **kw),
                       ops.paged_decode_attention(q, kp, vp, pt, lens, **kw))
    with pytest.raises(ValueError, match="do not divide"):
        paged_decode_attention_sharded(q[:6], kp, vp, pt[:6], lens[:6], mesh=four)


def test_sharded_rows_grow_in_multiples(port):
    """max_slots=3 over a data axis of 2: rows start at 4 and double; the
    tokens equal the unsharded port's bit for bit; every shard drains."""

    model, tok = port
    rng = np.random.default_rng(4)
    reqs = [(r, *_obs(rng)) for r in range(10)]
    out = {}
    for data in (0, 2):
        mesh = make_test_mesh(data=2, devices=[CPU] * 2) if data else None
        s = ContinuousBatchingScheduler(model, tok, max_slots=3, num_pages=60, scan_rounds=2,
                                        mesh=mesh)
        if data:
            assert s.rows == 4 and s.allocator.num_pages == 61
        for r, qd, tau in reqs:
            s.submit(r, qd, tau)
        s.step()
        s.cancel(3)
        out[data] = ({r.robot_id: r.tokens for r in s.drain()}, s)
    (base, _), (shd, s) = out[0], out[2]
    assert s.rows == 16 and s.rows % 2 == 0
    assert base.keys() == shd.keys() and 3 not in shd
    for r in base:
        np.testing.assert_array_equal(base[r], shd[r])
    assert s.pool_stats().shard_in_use == (0, 0)


# ---------------------------------------------------------------------------
# disaggregated prefill against the one-device reference, in process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def st():
    s = make_stacks("openvla-7b")
    s.prefill_fns, s.merge_fns = {}, {}
    return s


def share(st, s):
    """A reference scheduler shares its stack's compiled functions."""

    s._admit_fns, s._decode_fns = st.admit_fns, st.decode_fns
    if getattr(s, "_prefill_device", None) is not None:
        s._prefill_fns, s._merge_fns = st.prefill_fns, st.merge_fns
    return s


def run_disagg_twin(st, script, seed=0, **kw):
    """``script`` through the reference with ``prefill_group=[its device]``
    and the port with ``prefill_group=[cpu]``: equal logs, results (rounds,
    pools), counters and tokens -> (reference, port, port results)."""

    out = []
    for side in ("reference", "port"):
        if side == "reference":
            s = share(st, JaxScheduler(st.jmodel, st.jparams, st.jtok,
                                       prefill_group=[jax.devices()[0]], **kw))
        else:
            s = ContinuousBatchingScheduler(st.tmodel, st.tok, prefill_group=[CPU], **kw)
        log, obs_of = [], {}
        results = script(s, np.random.default_rng(seed), log, obs_of)
        out.append((s, log, results, obs_of))
    (js, jlog, jres, _), (ts, tlog, tres, tobs_of) = out
    assert tlog == jlog
    assert [_result(r) for r in tres] == [_result(r) for r in jres]
    assert _snapshot(ts) == _snapshot(js)
    for w, g in zip(jres, tres):
        assert_tokens_match(st, _obs_tokens(st.tok, *tobs_of[g.robot_id]), w.tokens, g.tokens,
                            f"robot {g.robot_id}")
    return js, ts, tres


def _submit(s, obs_of, r, qd, tau):
    obs_of[r] = (qd, tau)
    s.submit(r, qd, tau)


def _pending(s):
    return sorted(q.robot_id for q in s._seqs.values() if q.pending)


def staggered(s, rng, log, obs_of, n=6):
    reqs = [(r, *_obs(rng)) for r in range(n)]
    for req in reqs[:3]:
        _submit(s, obs_of, *req)
    results, nxt = [], 3
    while len(results) < n:
        results += s.step()
        log.append((s.round, s.n_active, s.n_pending, s.allocator.num_in_use, _pending(s)))
        if nxt < n and s.round % 2 == 0:
            _submit(s, obs_of, *reqs[nxt])
            nxt += 1
    return results


@pytest.mark.parametrize("rounds", R14)
def test_disaggregated_matches_reference(st, rounds):
    """Admissions merge one window after their prefill, as the reference's."""

    _, ts, res = run_disagg_twin(st, staggered, max_slots=4, scan_rounds=rounds)
    assert all(r.completed_round > r.admitted_round for r in res)
    assert ts.pool_stats().pages_in_use == 0 and not ts._pending_admit
    assert len(ts.merge_ms) == len(ts.admit_ms) > 0


def cancel_pending(s, rng, log, obs_of):
    """Four admitted at once; robot 1 cancelled while its prefill is
    pending; robot 4 arrives and takes its row and pages at the next
    boundary."""

    for r in range(4):
        _submit(s, obs_of, r, *_obs(rng))
    results = s.step()
    log.append(("after dispatch", s.round, _pending(s), s.allocator.num_in_use))
    log.append(("cancel", s.cancel(1), s.n_active, s.allocator.num_in_use))
    _submit(s, obs_of, 4, *_obs(rng))
    while s.n_pending or s.n_active:
        results += s.step()
        log.append((s.round, s.n_active, s.n_pending, s.allocator.num_in_use, _pending(s)))
    return results


@pytest.mark.parametrize("rounds", R14)
def test_cancel_while_pending_matches_reference(st, rounds):
    _, ts, res = run_disagg_twin(st, cancel_pending, max_slots=4, scan_rounds=rounds)
    assert sorted(r.robot_id for r in res) == [0, 2, 3, 4] and ts.cancelled == 1


def test_cancel_while_pending_never_writes_freed_pages(st):
    """The merge sends a cancelled pending sequence's prompt K/V to the
    trash page: its freed pages keep what they held."""

    s = ContinuousBatchingScheduler(st.tmodel, st.tok, max_slots=4, scan_rounds=1,
                                    prefill_group=[CPU])
    rng = np.random.default_rng(1)
    for r in range(3):
        s.submit(r, *_obs(rng))
    s.step()
    seq = next(q for q in s._seqs.values() if q.robot_id == 1)
    assert seq.pending and s.cancel(1)
    pages = torch.as_tensor(seq.pages)
    before = [s._pcache[k][:, pages].clone() for k in ("kp", "vp")]
    s.step()  # merges robots 0 and 2, robot 1's row dropped
    assert not _pending(s) and s.n_active == 2
    for k, b in zip(("kp", "vp"), before):
        assert torch.equal(s._pcache[k][:, pages], b)
    assert not torch.equal(s._pcache["kp"][:, torch.as_tensor(s._seqs[0].pages)],
                           torch.zeros_like(before[0]))


def reset_pending(s, rng, log, obs_of):
    """Three prefills dispatched, then ``reset``: they never merge."""

    for r in range(3):
        _submit(s, obs_of, r, *_obs(rng))
    s.step()
    log.append(("dispatched", _pending(s), s.allocator.num_in_use))
    s.reset()
    log.append(("reset", s.n_active, s.n_pending, s.allocator.num_in_use))
    for r in (3, 4):
        _submit(s, obs_of, r, *_obs(rng))
    results = s.drain()
    log.append(("drained", s.round, s.allocator.num_in_use))
    return results


@pytest.mark.parametrize("rounds", R14)
def test_reset_drops_pending_admissions(st, rounds):
    _, ts, res = run_disagg_twin(st, reset_pending, max_slots=4, scan_rounds=rounds)
    assert sorted(r.robot_id for r in res) == [3, 4] and not ts._pending_admit


def test_serve_fleet_disaggregated_matches_reference(st, monkeypatch):
    """``serve_fleet(prefill_group=...)``, rapid trigger with its cancels,
    against the reference's; the port's over a one-device mesh as well."""

    base = jsched_mod.ContinuousBatchingScheduler

    class Shared(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            share(st, self)

    monkeypatch.setattr(jsched_mod, "ContinuousBatchingScheduler", Shared)
    kw = dict(n_robots=6, max_steps=300, max_slots=4, seed=3, record_streams=True,
              verbose=False, trigger="rapid", scan_rounds=2)
    want = jax_serve_fleet(st.jmodel, st.jparams, st.jtok, prefill_group=[jax.devices()[0]],
                           **kw)
    got = serve_fleet(st.tmodel, st.tok, prefill_group=[CPU],
                      mesh=make_test_mesh(data=1, devices=[CPU]), **kw)
    assert got["sched"].prefill_device == CPU and got["cancelled"] > 0
    assert_fleet_equal(got, want)


# ---------------------------------------------------------------------------
# what the port refuses, and the CLI
# ---------------------------------------------------------------------------


def _rank_group():
    """Rank 0 of a model axis of 2 with no process group: what is refused
    is refused before any collective."""

    from repro_torch.launch.dist import ModelGroup

    return ModelGroup(0, 2, "gloo", CPU, (CPU, CPU))


def _scheduler(**kw):
    return lambda st: ContinuousBatchingScheduler(
        st.tmodel, st.tok, **{k: make() for k, make in kw.items()})


def _rank_model(arch):
    return Model(get_smoke_config(arch).replace(dtype="float32"), device="cpu",
                 group=_rank_group())


def _rank_training(arch):
    """A rank's model asked for its loss: no backward over a model axis."""

    tokens = torch.zeros((1, 4), dtype=torch.long)
    return lambda st: _rank_model(arch).loss_fn({"tokens": tokens, "labels": tokens})


def _rank_mesh_on_two_devices(st):
    """A rank mesh whose data shards of rank 0 lie on two devices."""

    g = _rank_group()
    model = Model(st.tmodel.cfg, device="cpu", group=g)
    mesh = Mesh(np.asarray([CPU, CPU, torch.device("meta"), CPU], dtype=object).reshape(2, 2),
                ("data", "model"), group=g)
    return ContinuousBatchingScheduler(model, st.tok, mesh=mesh)


# what is refused -> (how to ask for it, the route or ROADMAP item its
# message names)
RANKS = r"serve distinct devices as ranks \(launch.dist.init_rank_grid, launch.mesh.make_rank_mesh"
REFUSED = {
    "two devices": (_scheduler(mesh=lambda: make_test_mesh(data=2, devices=["cpu", "meta"])),
                    RANKS),
    "model axis on a MoE stack": (_rank_training("qwen3-moe-235b-a22b"), "ROADMAP queue I"),
    "model axis on jamba-smoke": (_rank_training("jamba-1.5-large-398b"), "ROADMAP queue I"),
    "pod axis": (_scheduler(mesh=lambda: Mesh(np.asarray([CPU, torch.device("meta")],
                                                         dtype=object).reshape(2, 1, 1),
                                              ("pod", "data", "model"))), RANKS),
    "rank mesh with data on distinct devices": (_rank_mesh_on_two_devices, RANKS),
    "mesh elsewhere": (_scheduler(mesh=lambda: make_test_mesh(data=2, devices=["meta"] * 2)),
                       RANKS),
    "prefill elsewhere": (_scheduler(prefill_group=lambda: [torch.device("meta")]),
                          r"is a prefill rank \(launch.dist.init_rank_grid\(prefill=1\)"),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_refuses_what_cannot_be_checked(st, what):
    """A one-process mesh over distinct devices (its pods too) or on
    another device, and a prefill device of its own in one process, name
    the ranks that serve them; training over ranks names its ROADMAP
    item."""

    ask, words = REFUSED[what]
    with pytest.raises(NotImplementedError, match=words):
        ask(st)


def test_serve_cli_sharded_disaggregated():
    out = tserve.main(["--device", "cpu", "--fleet", "4", "--steps", "60", "--scan-rounds", "2",
                       "--sharded", "--disaggregate-prefill"])
    sched = out["sched"]
    assert sched.mesh is not None and sched.mesh.shape == {"data": 1, "model": 1}
    assert sched.prefill_device == CPU and sched.merge_ms
    assert out["steps"] == 60 and out["offloads"].sum() >= 4
    assert out["telemetry"].completions.sum() > 0
