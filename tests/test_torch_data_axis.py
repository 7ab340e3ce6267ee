"""The mesh's data axis and the prefill as ``torch.distributed`` ranks,
against the JAX package's multi-device runs.

A module fixture writes the f32 smoke stacks' weights (the port's one-rank
``Model.init``, in the reference's layout), then runs side by side: the
reference in two processes of its own on 8 forced host devices
(``tests/torch_sharded_ref.py --params``: the data-shard ``SCENARIOS``, 8
shards, a mixed fleet, prefill on the last device, 7 + 1 and 7 + 1 with a
split lane; ``--model-axis --part engine,fleet,split,split24 --only ...``:
``tp42``, ``jb42``, ``qm24``, ``pc42``, the rapid fleet on (4, 2), ``sp42``,
``sx24``, ``ss42``, ``sh24`` and ``sj42``; and ``--model-axis --part
pod,split_fleet_p``: the engine on a (pod 2, data 2, model 2) mesh and the
split fleet beside a prefill device), and 8 gloo CPU ranks of
``tests/torch_data_axis_rank.py``, which lay the grids of ``GRIDS`` over
one world in turn: every data shard a rank, the prefill a rank of its own,
a pod a third grid axis.  Each process has a limit of its own and is
killed past it.  The ranks' records are held to:

1. the reference's ``SCENARIOS`` (``cloud8`` and ``mixed8`` on 8 data
   ranks, ``disagg`` on a decode rank and a prefill rank, ``combo7`` and
   ``mixed7p`` on 7 data ranks and a prefill rank): results, tokens, every
   reservation, the final ``PoolStats`` and counters equal;
2. ``tp42``, ``jb42``, ``pc42`` on data 4 x model 2 and ``qm24`` on 2 x 4,
   the rapid fleet on (4, 2), ``pod_tp`` and ``pod_qm`` on pod 2 x data 2 x
   model 2, and the split fleet on data 2 x model 2 beside a prefill rank:
   the same, tokens by the greedy-margin rule;
3. ``sp42``, ``sx24``, ``ss42``, ``sh24`` and ``sj42``: split lanes, each
   data rank holding its block of every lane's rows;
4. every rank's host state equal, the prefill rank's too;
5. the bytes: a rank's expert bytes 1/D of a model-axis rank's (whole
   where E does not divide over D), its rows, its lanes' buffers
   (``ceil(R / N)`` rows of R) and its full-view pool as declared, and the
   data axis's and batch group's collectives of every admission prefill,
   decode round, harvest, handoff, lane edge prefill, flush, fused round
   and serial token exactly ``launch.dist``'s counts, and of every row
   growth the gathers of the buffers it re-cuts (``grow_gathers``); the
   MoE layer over sharded rows, and the capacity layer over padded blocks,
   equal to one process's; rows that change rank at a doubling taking
   their pages and a serial robot's edge caches along;
6. the controls caught: a rank that skips the MoE's data-axis reduction,
   a capacity table built from a rank's own rows, one built with the pad
   rows, a prefill rank that hands off nothing, a prefill rank that takes
   no lane tokens, rows moved without their pages or edge caches.

Then the rank grid, the pod grid, the padded blocks, the expert blocks and
the counts without processes.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

from repro_torch.checkpoint.bridge import load_reference_params, reference_tensors  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import EpisodeTokenizer  # noqa: E402
from repro_torch.launch import dist  # noqa: E402
from repro_torch.launch.mesh import make_rank_mesh  # noqa: E402
from repro_torch.launch.sharding import local_index, logical_to_pspec  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

from test_torch_model_axis import finish, launch, load  # noqa: E402
from test_torch_scheduler import _obs_tokens, assert_tokens_match  # noqa: E402
from torch_data_axis_rank import (CANCEL_SEED, GRID_OF, GRIDS, GROW_GRID,  # noqa: E402
                                  GROW_KW, GROW_SEED, LANE_RUNS, LAYER_CASES, LAYER_ROWS,
                                  PAD_CASE, PREFILL_RUNS, SPLIT_RUN, TP_RUN, cancel_pending,
                                  grow_run, layer_inputs)
from repro_torch.launch.mesh import Mesh, make_test_mesh  # noqa: E402
from repro_torch.launch.sharding import real_rows, sharding_rules  # noqa: E402
from repro_torch.partition import PartitionExecutor  # noqa: E402
from repro_torch.runtime.kv_cache import PagedSpec  # noqa: E402
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler  # noqa: E402
from torch_model_axis_rank import Recording  # noqa: E402
from torch_model_axis_cases import (ENGINE_KW, FLEET_KEYS, POD_SCENARIOS, SCENARIOS,  # noqa: E402
                                    SMOKE_LAYERS, SPLIT_FLEET, SPLIT_FLEET_P, SPLIT_SCENARIOS,
                                    TP_FLEET, TP_SCENARIOS, lane_cut, obs_pair)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
REF_TIMEOUT_S = 300
SPAWN_TIMEOUT_S = 300
WORLD = 8
ATOL = RTOL = 1e-5
ARCHS = ("openvla-7b", "jamba-1.5-large-398b", "qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b")
SCENARIO = {s[0]: s for s in SCENARIOS}
TP = {s[0]: s for s in TP_SCENARIOS if s[0] in TP_RUN}
SPLIT = {s[0]: s for s in SPLIT_SCENARIOS if s[0] in SPLIT_RUN}
POD = {s[0]: s for s in POD_SCENARIOS}
LANES = {s[0]: s for s in LANE_RUNS}
GROW_RUNS = ("grow", "grow_nomove", "grow_serial", "grow_serial_stale")
HOST_KEYS = ("results", "tokens", "reserved", "pool", "counters")
PROMPT = 14  # a request's prompt: qd and tau of 7 joints


def smoke(arch):
    return get_smoke_config(arch).replace(num_layers=SMOKE_LAYERS, dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's records and the weights, "ranks": [the 8
    ranks' records]}."""

    tmp = tmp_path_factory.mktemp("data_axis")
    params_path = tmp / "params.npz"
    weights = {}
    for arch in ARCHS:
        weights.update({f"params/{arch}/{k}": v.numpy() for k, v in
                        reference_tensors(Model(smoke(arch), device="cpu")).items()})
    np.savez(params_path, **weights)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    ref_script = str(ROOT / "tests" / "torch_sharded_ref.py")
    start = time.monotonic()
    refs = {
        "reference scenarios": launch([sys.executable, ref_script, str(tmp / "sharded.npz"),
                                       "--params", str(params_path)], env, tmp / "sharded.log"),
        "reference model axis": launch(
            [sys.executable, ref_script, str(tmp / "axis.npz"), "--model-axis", "--part",
             "engine,fleet,split,split24", "--only", ",".join(TP_RUN + SPLIT_RUN), "--params",
             str(params_path)], env, tmp / "axis.log"),
        "reference pod and split fleet": launch(
            [sys.executable, ref_script, str(tmp / "pod.npz"), "--model-axis", "--part",
             "pod,split_fleet_p", "--params", str(params_path)], env, tmp / "pod.log"),
    }
    out_dir = tmp / "ranks"
    out_dir.mkdir()
    renv = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1", PYTHONFAULTHANDLER="1",
                PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                            os.environ.get("PYTHONPATH", "")]))
    script = ROOT / "tests" / "torch_data_axis_rank.py"
    ranks = {f"rank {r}": launch([sys.executable, str(script), str(r), str(WORLD),
                                  str(out_dir / "store"), str(params_path), str(out_dir)],
                                 renv, out_dir / f"rank{r}.log") for r in range(WORLD)}
    try:
        finish_or_dump(ranks, SPAWN_TIMEOUT_S, start)
        finish(refs, REF_TIMEOUT_S, start)
    finally:
        for proc, _ in (*ranks.values(), *refs.values()):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ref = dict(weights)
    ref.update(load(tmp / "sharded.npz"))
    ref.update(load(tmp / "axis.npz"))
    ref.update(load(tmp / "pod.npz"))
    return {"ref": ref, "ranks": [load(out_dir / f"rank{r}.npz") for r in range(WORLD)]}


def finish_or_dump(ranks, limit_s, start):
    """``finish`` for the rank processes; where one fails or outlasts
    the limit, every rank still alive gets SIGABRT first (the ranks run
    under ``PYTHONFAULTHANDLER``, so each log ends with its threads'
    stacks: the collective each waits in), and the error carries those
    logs' tails."""

    try:
        finish(ranks, limit_s, start)
    except AssertionError as e:
        live = {name: (p, log) for name, (p, log) in ranks.items() if p.poll() is None}
        for p, _ in live.values():
            p.send_signal(signal.SIGABRT)
        for p, _ in live.values():
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        tails = "".join(f"\n--- {name}\n{Path(log).read_text()[-2000:]}"
                        for name, (_, log) in live.items())
        raise AssertionError(f"{e}{tails}") from None


def grid_ranks(runs, gname):
    """The records of the ranks on grid ``gname``, in grid order."""

    return [r for r in runs["ranks"] if f"grid/{gname}" in r]


def grid_of(name):
    """The grid that runs scenario ``name``."""

    if name in GRID_OF:
        return GRID_OF[name]
    if name in {p[0] for p in PREFILL_RUNS} | {"split_fleet_p"}:
        return "d2m2p1"
    if name in POD:
        return "p2d2m2"
    if name in GROW_RUNS:
        return GROW_GRID
    if name in LANES:
        return LANES[name][2]
    s = TP.get(name) or SPLIT[name]
    return next(g for g, d, m, _, pod in GRIDS if (d, m, pod) == (s[2], s[3], 1))


def grid_dims(gname):
    """(data, model, prefill, pod) of grid ``gname``."""

    return next(g[1:] for g in GRIDS if g[0] == gname)


def one_rank(ref, arch, moe_impl="dense"):
    """The one-process port model of ``arch`` on the weights (the
    greedy-margin rule's model)."""

    model = Model(smoke(arch), device="cpu", moe_impl=moe_impl)
    pre = f"params/{arch}/"
    load_reference_params(model, {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    return SimpleNamespace(tmodel=model, tok=EpisodeTokenizer(model.cfg.vocab_size))


def assert_host_state(rec, ref, name):
    for key in ("results", "reserved", "pool", "counters"):
        np.testing.assert_array_equal(rec[f"{name}/{key}"], ref[f"{name}/{key}"],
                                      err_msg=f"{name}/{key}")


# ---------------------------------------------------------------------------
# 1-4: the reference's multi-device runs, on ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIO))
def test_scenarios_match_reference(runs, name):
    """``cloud8`` / ``mixed8`` on 8 data ranks, ``disagg`` on a decode and a
    prefill rank, ``combo7`` on 7 data ranks and a prefill rank: every
    rank's results, tokens, reservations, per-shard pool and counters equal
    to the reference's multi-device run."""

    _, n, seed, data, disagg, cut = SCENARIO[name]
    ref = runs["ref"]
    recs = grid_ranks(runs, GRID_OF[name])
    assert len(recs) == max(data, 1) + disagg
    for rec in recs:
        assert_host_state(rec, ref, name)
        np.testing.assert_array_equal(rec[f"{name}/tokens"], ref[f"{name}/tokens"])
    if cut is not None:
        assert {r[4] for r in ref[f"{name}/results"]} == {0, 1}
    if disagg:
        prefill = recs[-1]
        assert prefill[f"grid/{GRID_OF[name]}"][2] == 1
        assert bytes(prefill[f"{name}/round_mode"]).decode().endswith("(the prefill rank)")


@pytest.mark.parametrize("name", list(TP))
def test_model_axis_scenarios_match_reference(runs, name):
    """``tp42``, ``jb42`` (Mamba state over data 4), ``pc42`` (the capacity
    dispatch, 1 expert a data rank) on data 4 x model 2 ranks and ``qm24``
    (2 experts a data rank) on 2 x 4: host state equal to the reference's
    mesh, tokens by the greedy-margin rule, the rounds eager (gloo)."""

    _, arch, data, model_axis, n, seed, impl = TP[name]
    ref = runs["ref"]
    st = one_rank(ref, arch, impl)
    rng = np.random.default_rng(seed)
    obs = [obs_pair(rng) for _ in range(n)]
    recs = grid_ranks(runs, grid_of(name))
    assert len(recs) == data * model_axis
    for rec in recs:
        assert_host_state(rec, ref, name)
        for row, want, got in zip(ref[f"{name}/results"], ref[f"{name}/tokens"],
                                  rec[f"{name}/tokens"]):
            assert_tokens_match(st, _obs_tokens(st.tok, *obs[row[0]]), want, got,
                                f"robot {row[0]}")
        assert bytes(rec[f"{name}/round_mode"]).decode() == (
            f"eager, {model_axis} ranks over gloo; rows over {data} data ranks")


def test_fleet_matches_reference(runs):
    """The rapid fleet on data 4 x model 2 ranks: every action, offload,
    service round, cancel and round count of the reference's (4, 2) mesh,
    on every rank."""

    ref = runs["ref"]
    recs = grid_ranks(runs, "d4m2")
    assert len(recs) == TP_FLEET["data"] * TP_FLEET["model"]
    for rec in recs:
        for key in FLEET_KEYS:
            np.testing.assert_array_equal(rec[f"fleet42/{key}"], ref[f"fleet42/{key}"],
                                          err_msg=key)
    assert ref["fleet42/cancelled"] > 0


@pytest.mark.parametrize("name", list(POD))
def test_pod_scenarios_match_reference(runs, name):
    """``pod_tp`` and ``pod_qm`` (qwen3-moe-smoke, its experts over the two
    data ranks of each pod) on pod 2 x data 2 x model 2 ranks: host state
    equal to the reference's (pod, data, model) mesh (8 rows, blocked over
    the four (pod, data) ranks; the allocator's 2 data shards), tokens by
    the greedy-margin rule, the rounds eager (gloo)."""

    _, arch, pod, data, model_axis, n, seed, impl = POD[name]
    ref = runs["ref"]
    st = one_rank(ref, arch, impl)
    rng = np.random.default_rng(seed)
    obs = [obs_pair(rng) for _ in range(n)]
    recs = grid_ranks(runs, "p2d2m2")
    assert len(recs) == pod * data * model_axis
    assert ref[f"{name}/counters"][5] == 8 and len(ref[f"{name}/pool"]) == 2 + 2 * data
    for rec in recs:
        assert_host_state(rec, ref, name)
        for row, want, got in zip(ref[f"{name}/results"], ref[f"{name}/tokens"],
                                  rec[f"{name}/tokens"]):
            assert_tokens_match(st, _obs_tokens(st.tok, *obs[row[0]]), want, got,
                                f"robot {row[0]}")
        assert bytes(rec[f"{name}/round_mode"]).decode() == (
            f"eager, {model_axis} ranks over gloo; rows over {pod} x {data} pod and data ranks")
        rows, local = rec[f"{name}/shapes"][:2]
        assert local == -(-rows // (pod * data))
    assert {tuple(r["grid/p2d2m2"][[3, 0, 1]]) for r in recs} == {
        (p, d, m) for p in range(pod) for d in range(data) for m in range(model_axis)}


def test_split_fleet_beside_a_prefill_rank_matches_reference(runs):
    """The rapid fleet with ``SPLIT_FLEET``'s robots split, pipelined, on
    data 2 x model 2 ranks beside a prefill rank: every action, offload,
    service round, cancel and round count of the reference's run with the
    prefill on the fifth device, on every rank, the prefill rank's too."""

    ref = runs["ref"]
    recs = grid_ranks(runs, "d2m2p1")
    assert len(recs) == SPLIT_FLEET_P["data"] * SPLIT_FLEET_P["model"] + 1
    for rec in recs:
        for key in FLEET_KEYS:
            np.testing.assert_array_equal(rec[f"split_fleet_p/{key}"],
                                          ref[f"split_fleet_p/{key}"], err_msg=key)
    assert ref["split_fleet_p/offloads"].sum() > 0


@pytest.mark.parametrize("name", list(SPLIT))
def test_split_scenarios_match_reference(runs, name):
    """``sp42`` (a pipelined lane on openvla-smoke), ``ss42`` (a serial
    lane), ``sh24`` (lanes at cuts 0 and 1), ``sj42`` (jamba-smoke's lane
    state) and ``sx24`` (qwen3-moe-smoke's expert-offload lane, whose
    experts exchange over the data ranks): each data rank holding its
    block of every lane's rows, host state equal, tokens equal (the MoE one
    by the greedy-margin rule), the first lane prefill's logits within
    2e-5."""

    _, arch, data, model_axis, keys, pipelined, n, seed = SPLIT[name]
    ref = runs["ref"]
    st = one_rank(ref, arch)
    rng = np.random.default_rng(seed)
    obs = [obs_pair(rng) for _ in range(n)]
    assert ref[f"{name}/results"][:, 4].sum() == n // 2
    for rec in grid_ranks(runs, grid_of(name)):
        assert_host_state(rec, ref, name)
        for row, want, got in zip(ref[f"{name}/results"], ref[f"{name}/tokens"],
                                  rec[f"{name}/tokens"]):
            assert_tokens_match(st, _obs_tokens(st.tok, *obs[row[0]]), want, got,
                                f"robot {row[0]}")
        np.testing.assert_allclose(rec[f"{name}/first_lane"], ref[f"{name}/first_lane"],
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("gname", [g[0] for g in GRIDS])
def test_every_rank_host_state_equal(runs, gname):
    """Every rank of a grid, the prefill rank too, makes the same
    admissions, reservations, harvests and results, and every rank of the
    fleet the same actions."""

    recs = grid_ranks(runs, gname)
    names = {n for n in (*SCENARIO, *TP, *SPLIT, *POD) if grid_of(n) == gname}
    names |= ({"fleet42"} if gname == "d4m2" else {"disagg_zeros", "cancel_pending"}
              if gname == "d1p1" else set())
    names |= ({p[0] for p in PREFILL_RUNS} | {"split_fleet_p"}) if gname == "d2m2p1" else set()
    # the control's prefill rank takes no lane tokens: its host state alone
    names |= {"mixed7p_nolane"} if gname == "d7p1" else set()
    names |= set(GROW_RUNS) if gname == GROW_GRID else set()
    names |= {n for n, _, g, *_ in LANE_RUNS if g == gname}
    keys = [k for k in recs[0] if k.split("/")[0] in names
            and k.split("/")[-1] in HOST_KEYS + FLEET_KEYS
            and k != "mixed7p_nolane/tokens"]
    assert keys
    for rec in recs[1:]:
        for k in keys:
            np.testing.assert_array_equal(rec[k], recs[0][k], err_msg=k)


@pytest.mark.parametrize("run", PREFILL_RUNS, ids=[p[0] for p in PREFILL_RUNS])
def test_prefill_rank_beside_a_model_axis(runs, run):
    """A prefill rank beside data 2 x model 2 ranks: its whole model's K/V
    (and jamba-smoke's Mamba state) handed off, each decode rank taking its
    KV heads and state blocks: host state equal to one process's with the
    prefill one window ahead (``prefill_group=[cpu]``, a one-device data-2
    mesh), tokens by the greedy-margin rule, on every rank."""

    name, arch, n, seed = run
    st = one_rank(runs["ref"], arch)
    sched = ContinuousBatchingScheduler(st.tmodel, st.tok, prefill_group=[CPU],
                                        mesh=make_test_mesh(data=2, devices=[CPU] * 2),
                                        **ENGINE_KW)
    rng = np.random.default_rng(seed)
    obs = [obs_pair(rng) for _ in range(n)]
    for r, (qd, tau) in enumerate(obs):
        sched.submit(r, qd, tau)
    results = sched.drain()
    st_ = sched.pool_stats()
    want = {"results": [(r.robot_id, r.submitted_round, r.admitted_round, r.completed_round,
                         int(r.kind == "split")) for r in results],
            "pool": [st_.pages_in_use, st_.high_water, *st_.shard_in_use,
                     *st_.shard_high_water]}
    recs = grid_ranks(runs, "d2m2p1")
    assert len(recs) == 5
    for rec in recs:
        for key, value in want.items():
            np.testing.assert_array_equal(rec[f"{name}/{key}"], value, err_msg=key)
        for row, got in zip(rec[f"{name}/results"], rec[f"{name}/tokens"]):
            w = next(r.tokens for r in results if r.robot_id == row[0])
            assert_tokens_match(st, _obs_tokens(st.tok, *obs[row[0]]), w, got, f"robot {row[0]}")
        assert len(rec[f"{name}/events/handoff"]) > 0


def test_cancel_while_pending_on_the_prefill_rank(runs):
    """Robot 1 cancelled while the prefill rank's prefill of it is pending:
    the decode rank drops its row (its K/V to the trash page at length 0),
    robot 4 takes its row and pages at the next boundary; results, tokens,
    reservations and the pool equal to one process's with
    ``prefill_group=[cpu]`` (which ``tests/test_torch_sharded.py`` holds to
    the reference's), on both ranks."""

    st = one_rank(runs["ref"], "openvla-7b")
    sched = Recording(st.tmodel, st.tok, prefill_group=[CPU], max_slots=4, scan_rounds=2)
    results = cancel_pending(sched, np.random.default_rng(CANCEL_SEED))
    assert sorted(r.robot_id for r in results) == [0, 2, 3, 4]
    pool = sched.pool_stats()
    for rec in grid_ranks(runs, "d1p1"):
        np.testing.assert_array_equal(rec["cancel_pending/results"], [
            (r.robot_id, r.submitted_round, r.admitted_round, r.completed_round, 0)
            for r in results])
        np.testing.assert_array_equal(rec["cancel_pending/tokens"],
                                      np.stack([r.tokens for r in results]))
        np.testing.assert_array_equal(rec["cancel_pending/reserved"], sched.reserved)
        np.testing.assert_array_equal(rec["cancel_pending/pool"][:2],
                                      [pool.pages_in_use, pool.high_water])


# ---------------------------------------------------------------------------
# 5: bytes and counts
# ---------------------------------------------------------------------------


def moe_weight_bytes(cfg, ranks):
    """A model-axis rank's expert bytes (every expert's ``d_ff / ranks``
    block)."""

    layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    return layers * 3 * cfg.moe.num_experts * cfg.d_model * cfg.d_ff // ranks * 4


@pytest.mark.parametrize("name", ["jb42", "pc42", "qm24", "layer/d8"])
def test_expert_bytes_over_data(runs, name):
    """A data rank holds 1/D of a model-axis rank's expert bytes where E
    divides over D (jb42, pc42: 1 of 4 experts; qm24: 2 of 4), all of them
    where it does not (phi3.5-moe-smoke's 4 experts over 8 data ranks)."""

    if name == "layer/d8":
        arch, data, model_axis = "phi3.5-moe-42b-a6.6b", 8, 1
        key = f"layer/d8/{arch}/expert_bytes"
    else:
        _, arch, data, model_axis, *_ = TP[name]
        key = f"{name}/expert_bytes"
    cfg = smoke(arch)
    whole = moe_weight_bytes(cfg, model_axis)
    want = whole // data if cfg.moe.num_experts % data == 0 else whole
    assert dist.experts_split(cfg, data) == (want < whole)
    for rec in grid_ranks(runs, "d8" if name == "layer/d8" else grid_of(name)):
        assert int(rec[key]) == want


@pytest.mark.parametrize("name", ["cloud8", "combo7", "tp42", "jb42"])
def test_rank_rows_and_full_view_pool(runs, name):
    """A data rank holds its block of the rows (rows / D: its lengths,
    and its rows of every recurrent state, jb42's Mamba ``h`` and
    ``conv``) and a pool of every global page id ([La, P + 1, page, its KV
    heads, Dh]); a prefill rank holds neither."""

    if name in SCENARIO:
        arch, data, model_axis = "openvla-7b", SCENARIO[name][3], 1
    else:
        _, arch, data, model_axis, *_ = TP[name]
    cfg = smoke(arch)
    for rec in grid_ranks(runs, grid_of(name)):
        rows, local, *pool = rec[f"{name}/shapes"]
        prefill = rec[f"grid/{grid_of(name)}"][2]
        if prefill:
            assert local == 0 and pool == [0] * 5
            continue
        pages = rec[f"{name}/counters"][6]
        assert rows % data == 0 and local == rows // data
        states = rec[f"{name}/state_rows"]
        assert len(states) == (2 if name == "jb42" else 0) and (states == local).all()
        n_attn = sum(b == "attn" for b in cfg.blocks[:SMOKE_LAYERS])
        assert pool == [n_attn, pages + 1, 16, cfg.num_kv_heads // model_axis or 1,
                        cfg.resolved_head_dim]


def _bucket(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def expected_event(cfg, kind, figures, data, prefill, impl, batch=None, offload=None):
    """``launch.dist``'s [calls..., bytes...] of the data axis and the
    batch group (``batch`` ranks, default ``data``) for one event of
    ``kind`` with its ``figures`` (``offload``: a lane cut's offloaded
    layers)."""

    keys = ("all_reduce", "all_gather", "broadcast")
    batch = batch or data
    offload = offload or {}
    lay = cfg.num_layers

    def row(calls, size, times=1):
        return [times * calls[k] for k in keys] + [times * size[k] for k in keys]

    if kind == "round":
        rows, block = figures
        return row(dist.data_collectives(cfg, data, sharded=True, moe_impl=impl),
                   dist.data_collective_bytes(cfg, rows, 1, data, sharded=True, moe_impl=impl,
                                              batch=batch), block)
    if kind == "prefill":
        n, s = figures
        return row(dist.data_collectives(cfg, data, sharded=False, moe_impl=impl),
                   dist.data_collective_bytes(cfg, n, s, data, sharded=False, moe_impl=impl))
    if kind == "harvest":
        size = dist.harvest_bytes(*figures, batch, prefill)
        return [0, int(batch > 1), int(prefill)] + [size[k] for k in keys]
    if kind == "handoff":
        return [0, 0, 1, 0, 0, dist.handoff_bytes(cfg, _bucket(figures[0]), PROMPT)]
    if kind == "edge":
        layers, off = range(figures[0]), offload.get(figures[0], ())
        return row(dist.moe_calls(cfg, layers, data, sharded=False, moe_impl=impl, offload=off),
                   dist.moe_call_bytes(cfg, layers, 1, PROMPT, data, sharded=False,
                                       moe_impl=impl, offload=off))
    if kind == "flush":
        cut, n = figures
        layers = range(cut, lay)
        return row(dist.moe_calls(cfg, layers, data, sharded=False, moe_impl=impl),
                   dist.moe_call_bytes(cfg, layers, _bucket(n), PROMPT, data, sharded=False,
                                       moe_impl=impl))
    if kind == "fused":
        block, *lanes = figures
        cuts = tuple(c for c in lanes[::2] if c >= 0)
        blocks = tuple(b for b in lanes[1::2] if b >= 0)
        offs = tuple(offload.get(c, ()) for c in cuts)
        return row(dist.lane_data_collectives(cfg, data, cuts, offs, impl),
                   dist.lane_data_collective_bytes(cfg, data, cuts, blocks, offs, impl, batch),
                   block)
    if kind == "serial":
        # the suffix step over the rank's block; where the edge layers
        # exchange, the token gather and every active robot's edge step
        cut, rows, active, exchanges = figures
        layers = range(cut, lay)
        calls = dist.moe_calls(cfg, layers, data, sharded=True, moe_impl=impl)
        size = dist.moe_call_bytes(cfg, layers, rows, 1, data, sharded=True, moe_impl=impl,
                                   batch=batch)
        if exchanges:
            edge = dist.moe_calls(cfg, range(cut), data, sharded=False, moe_impl=impl)
            edge_size = dist.moe_call_bytes(cfg, range(cut), 1, 1, data, sharded=False,
                                            moe_impl=impl)
            calls = {k: n + active * edge[k] + (k == "all_gather") for k, n in calls.items()}
            size = {k: n + active * edge_size[k] + (k == "all_gather") * batch * rows * 8
                    for k, n in size.items()}
        return row(calls, size)
    raise ValueError(kind)


def run_dims(name):
    """(arch, moe_impl, data, prefill, pod, lane keys, pipelined) of a
    recorded run."""

    if name in SCENARIO:
        _, _, _, data, disagg, cut = SCENARIO[name]
        return ("openvla-7b", "dense", max(data, 1), int(disagg), 1,
                () if cut is None else (cut,), True)
    if name == "jbp":
        return "jamba-1.5-large-398b", "dense", 2, 1, 1, (), True
    if name in POD:
        _, arch, pod, data, _, _, _, impl = POD[name]
        return arch, impl, data, 0, pod, (), True
    if name in SPLIT:
        _, arch, data, _, keys, pipelined, _, _ = SPLIT[name]
        return arch, "dense", data, 0, 1, keys, pipelined
    if name in GROW_RUNS:
        return "openvla-7b", "dense", grid_dims(GROW_GRID)[0], 0, 1, (1,), name == "grow"
    if name in LANES:
        _, arch, gname, key, pipelined, impl, _, _ = LANES[name]
        return arch, impl, grid_dims(gname)[0], 0, 1, (key,), pipelined
    _, arch, data, _, _, _, impl = TP[name]
    return arch, impl, data, 0, 1, (), True


@pytest.mark.parametrize("name", ["cloud8", "mixed8", "disagg", "combo7", "jb42", "pc42",
                                  "qm24", "jbp", "mixed7p", "sp42", "sx24", "ss42", "sh24",
                                  "sj42", "pod_tp", "pod_qm", "grow", "grow_serial", "sxs",
                                  "spc"])
def test_data_collectives_are_dists_counts(runs, name):
    """Every admission prefill, decode round, window harvest and handoff of
    the run issued exactly the data axis's (and, on a pod grid, the batch
    group's) collectives and bytes that ``launch.dist`` counts for it
    (``data_collectives`` / ``data_collective_bytes``, ``harvest_bytes``,
    ``handoff_bytes``); so did every lane's edge prefill and flush
    (``moe_calls`` over replicated rows), fused round
    (``lane_data_collectives``) and serial token; a row growth gathers each
    buffer it re-cuts once over the ranks, and each pool and edge cache of
    the rows that change rank (the scheduler's and a lane's
    ``grow_gathers``)."""

    arch, impl, data, prefill, pod, keys, pipelined = run_dims(name)
    cfg = smoke(arch)
    offload = {lane_cut(k)[0]: lane_cut(k)[1] for k in keys}
    seen = set()
    for rec in grid_ranks(runs, grid_of(name)):
        is_prefill = rec[f"grid/{grid_of(name)}"][2]
        # the prefill rank is in no data or batch group
        d, batch = (1, 1) if is_prefill else (data, pod * data)
        for kind in ("prefill", "round", "harvest", "handoff", "edge", "flush", "fused",
                     "serial"):
            for ev in rec[f"{name}/events/{kind}"]:
                k = len(ev) - 6
                want = expected_event(cfg, kind, list(ev[:k]), d, prefill, impl, batch, offload)
                assert list(ev[k:]) == want, (kind, list(ev))
                seen.add(kind)
        for kind in ("grow", "lane_grow"):
            for _, moved, gathers, *calls in rec[f"{name}/events/{kind}"]:
                assert calls[:3] == [0, gathers * (batch > 1), 0], (kind, moved)
    assert {"round", "harvest"} <= seen
    assert ("handoff" in seen) == bool(prefill)
    assert ({"edge", "flush"} <= seen) == bool(keys)
    assert ("fused" in seen) == (bool(keys) and pipelined)
    assert ("serial" in seen) == (bool(keys) and not pipelined)


def lane_bytes(cfg, model_axis, m, cut, pipelined, rows):
    """One lane's row buffers' bytes at ``rows`` rows on model-axis rank
    ``m`` (a meta model): its suffix state, its edge rows (pipelined), page
    table, lengths, capacities and float32 logits."""

    g = stub(m, model_axis, "model") if model_axis > 1 else None
    model = Model(cfg, device="meta", group=g)
    ex = PartitionExecutor(model, cut)
    pages = -(-(PROMPT + 8 * 7) // 16)
    spec = PagedSpec(num_pages=ENGINE_KW["num_pages"], page_size=16, max_pages_per_seq=pages)
    ts = [t for c in ex.init_lane_state(spec, rows).values() for t in c.values()]
    if pipelined:
        ts += [t for c in ex.init_edge_rows(rows, PROMPT + 8 * 7).values() for t in c.values()]
    size = sum(t.numel() * t.element_size() for t in ts)
    return size + rows * (pages + 2) * 4 + rows * model.vocab_padded * 4


@pytest.mark.parametrize("name", ["mixed7p", "sp42", "sx24", "ss42", "sh24", "sj42"])
def test_lane_buffers_are_the_ranks_block(runs, name):
    """A rank's lane holds its padded block of the lane's R rows, ``B =
    ceil(R / N)`` over N data ranks: its buffers' bytes are exactly B / R
    of one process's (the same model-axis rank's) at R rows; a prefill
    rank holds none; every rank sees the same rows."""

    arch, _, data, _, _, keys, pipelined = run_dims(name)
    cfg = smoke(arch)
    model_axis = 1 if name in SCENARIO else SPLIT[name][3]
    recs = grid_ranks(runs, grid_of(name))
    for rec in recs:
        lanes = rec[f"{name}/lanes"]
        assert len(lanes) == len(keys)
        for cut, rows, block, peak in lanes:
            assert block == -(-rows // data)
            if rec[f"grid/{grid_of(name)}"][2]:
                assert peak == 0
                continue
            one = lane_bytes(cfg, model_axis, rec[f"grid/{grid_of(name)}"][1], cut, pipelined,
                             rows)
            assert peak * rows == one * block, (cut, rows, block)
        np.testing.assert_array_equal(lanes[:, :3], recs[0][f"{name}/lanes"][:, :3])
    assert any(r[f"{name}/lanes"][:, 2].max() < r[f"{name}/lanes"][:, 1].max() for r in recs)


@pytest.mark.parametrize("case", LAYER_CASES, ids=[f"{g}-{a}" for g, a, _ in LAYER_CASES])
def test_moe_layer_over_sharded_rows(runs, case):
    """The MoE layer over rows sharded over the data ranks (a decode
    round's case): the ranks' blocks put together equal one process's
    layer over every row (the capacity dispatch's drops included), with a
    gather where the experts split or the capacity dispatch needs every
    row, a reduce-scatter where they split, and no collective for the
    dense dispatch over experts that stay whole."""

    gname, arch, impl = case
    one = one_rank(runs["ref"], arch, impl).tmodel
    x = torch.as_tensor(layer_inputs(one.cfg.d_model))
    fn = moe_lib.moe_forward_capacity if impl == "capacity" else moe_lib.moe_forward
    with torch.no_grad():
        want = fn(x, one.layers[1].moe, one.cfg)[0].numpy()
    data = next(d for g, d, *_ in GRIDS if g == gname)
    recs = grid_ranks(runs, gname)
    key = f"layer/{gname}/{arch}"
    by_d = {}
    for rec in recs:
        by_d.setdefault(int(rec[f"grid/{gname}"][0]), rec[key])
        split = dist.experts_split(one.cfg, data)
        calls = list(rec[f"{key}/counts"][:3])
        assert calls == [int(split), int(split or impl == "capacity"), 0]
    got = np.concatenate([by_d[d] for d in range(data)])
    assert got.shape == (LAYER_ROWS, 1, one.cfg.d_model)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# 6: controls that must be caught
# ---------------------------------------------------------------------------


def test_control_skipped_data_reduction_caught(runs):
    """pc42's first prompt on data 4 x model 2 ranks: its logits within
    ``ATOL`` of one process's; a rank that skips the MoE's data-axis sum
    misses it."""

    ref = runs["ref"]
    _, arch, _, _, _, seed, impl = TP["pc42"]
    st = one_rank(ref, arch, impl)
    prompt = np.concatenate([st.tok.encode_state(q)
                             for q in obs_pair(np.random.default_rng(seed))], axis=1)
    with torch.no_grad():
        want = st.tmodel.prefill({"tokens": torch.as_tensor(prompt)})[0][0, -1].numpy()
    for rec in grid_ranks(runs, "d4m2"):
        np.testing.assert_allclose(rec["pc42/logits"], want, atol=ATOL, rtol=RTOL)
        assert not np.allclose(rec["pc42/skip_data"], want, atol=ATOL, rtol=RTOL)


def test_control_own_rows_capacity_table_caught(runs):
    """The capacity dispatch over rows sharded over 8 data ranks with its
    table built from each rank's own row (cap and drops of one row) is
    not one process's layer."""

    arch = "phi3.5-moe-42b-a6.6b"
    one = one_rank(runs["ref"], arch, "capacity").tmodel
    x = torch.as_tensor(layer_inputs(one.cfg.d_model))
    with torch.no_grad():
        want = moe_lib.moe_forward_capacity(x, one.layers[1].moe, one.cfg)[0].numpy()
    by_d = {int(r["grid/d8"][0]): r[f"layer/d8/{arch}/own_table"] for r in grid_ranks(runs, "d8")}
    got = np.concatenate([by_d[d] for d in range(8)])
    assert not np.allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", list(LANES))
def test_lanes_whose_experts_exchange_match_one_process(runs, name):
    """``sxs`` (a serial lane on qwen3-moe-smoke whose edge layer's experts
    spread over the 2 data ranks: each token's tokens gathered, every
    robot's edge stepped on every rank) and ``spc`` (a pipelined lane on
    phi3.5-moe-smoke under the capacity dispatch over 4 data ranks, each
    lane's table over its real rows): results, reservations and pool equal
    to one process's run over a (data D) mesh, tokens by the greedy-margin
    rule."""

    _, arch, gname, key, pipelined, impl, n, seed = LANES[name]
    data = grid_dims(gname)[0]
    st = one_rank(runs["ref"], arch, impl)
    sched = Recording(st.tmodel, st.tok, mesh=make_test_mesh(data=data, devices=[CPU] * data),
                      **ENGINE_KW)
    sched.attach_partition(PartitionExecutor(st.tmodel, key), pipelined=pipelined)
    lane = sched._lanes[key]
    reserve = lane.reserve

    def recorded(req):  # the lane's reservations too, as the ranks record them
        seq = reserve(req)
        sched.reserved.append([req.robot_id, seq.row, *seq.pages])
        return seq

    lane.reserve = recorded
    rng = np.random.default_rng(seed)
    obs = [obs_pair(rng) for _ in range(n)]
    for r, (qd, tau) in enumerate(obs):
        sched.submit(r, qd, tau, partitioned=r % 2 == 1)
    results = sched.drain()
    want = [(r.robot_id, r.submitted_round, r.admitted_round, r.completed_round,
             int(r.kind == "split")) for r in results]
    pool = sched.pool_stats()
    for rec in grid_ranks(runs, gname):
        np.testing.assert_array_equal(rec[f"{name}/results"], want)
        np.testing.assert_array_equal(rec[f"{name}/reserved"], sched.reserved)
        np.testing.assert_array_equal(rec[f"{name}/pool"][:2], [pool.pages_in_use,
                                                               pool.high_water])
        for row, got in zip(want, rec[f"{name}/tokens"]):
            w = next(r.tokens for r in results if r.robot_id == row[0])
            assert_tokens_match(st, _obs_tokens(st.tok, *obs[row[0]]), w, got, f"robot {row[0]}")
        assert rec[f"{name}/lanes"][0, 2] == -(-rec[f"{name}/lanes"][0, 1] // data)


def grow_one_process(runs, pipelined):
    """``grow_run`` in one process over a (data 2) mesh, its lane pipelined
    or serial -> (its results' rows, the results, the scheduler)."""

    st = one_rank(runs["ref"], "openvla-7b")
    sched = Recording(st.tmodel, st.tok, mesh=make_test_mesh(data=2, devices=[CPU] * 2),
                      **GROW_KW)
    sched.attach_partition(PartitionExecutor(st.tmodel, 1), pipelined=pipelined)
    lane = sched._lanes[1]
    reserve = lane.reserve

    def recorded(req):  # the lane's reservations too, as the ranks record them
        seq = reserve(req)
        sched.reserved.append([req.robot_id, seq.row, *seq.pages])
        return seq

    lane.reserve = recorded
    results = grow_run(sched, np.random.default_rng(GROW_SEED))
    want = [(r.robot_id, r.submitted_round, r.admitted_round, r.completed_round,
             int(r.kind == "split")) for r in results]
    assert sched.rows == 4 and sched._lanes[1].rows == 4
    return want, results, sched


def assert_grow_run(runs, name, control):
    """Every rank's ``name`` run equal to one process's, rows of the
    cloud and of the lane changing rank; ``control``'s results equal and
    its tokens not."""

    want, results, sched = grow_one_process(runs, name == "grow")
    pool = sched.pool_stats()
    for rec in grid_ranks(runs, GROW_GRID):
        np.testing.assert_array_equal(rec[f"{name}/results"], want)
        np.testing.assert_array_equal(rec[f"{name}/tokens"],
                                      np.stack([r.tokens for r in results]))
        np.testing.assert_array_equal(rec[f"{name}/reserved"], sched.reserved)
        np.testing.assert_array_equal(rec[f"{name}/pool"][:2],
                                      [pool.pages_in_use, pool.high_water])
        cloud, lane = rec[f"{name}/page_moves"]
        assert cloud > 0 and lane > 0
        np.testing.assert_array_equal(rec[f"{control}/results"], want)
        assert not np.array_equal(rec[f"{control}/tokens"], rec[f"{name}/tokens"])


def test_rows_that_change_rank_take_their_pages(runs):
    """Cloud rows and a lane's rows doubling while their sequences decode
    on data 2 x model 4 ranks: the rows that change rank take their pages'
    K/V along (a gather of the K and V pools' moved pages), so results,
    tokens, reservations and pool equal one process's run over a (data 2)
    mesh; without the pages' moves (a control) the tokens are not."""

    assert_grow_run(runs, "grow", "grow_nomove")


def test_serial_rows_that_change_rank_take_their_edge_caches(runs):
    """The same with a serial lane, whose robots' edge steps run on their
    rows' ranks alone: a robot whose row changes rank takes its edge
    caches to the new owner, so the run equals one process's; without
    that (a control: the new owner steps the caches its reservation left)
    the tokens are not."""

    assert_grow_run(runs, "grow_serial", "grow_serial_stale")


def test_control_prefill_rank_without_lane_tokens_caught(runs):
    """``mixed7p`` with a prefill rank that takes no lane tokens at a
    window's close: the decode ranks' tokens stay the reference's, the
    prefill rank's split robots' do not."""

    ref = runs["ref"]
    split = ref["mixed7p/results"][:, 4] == 1
    for rec in grid_ranks(runs, "d7p1"):
        got = rec["mixed7p_nolane/tokens"]
        np.testing.assert_array_equal(got[~split], ref["mixed7p/tokens"][~split])
        if rec["grid/d7p1"][2]:
            assert not np.array_equal(got[split], ref["mixed7p/tokens"][split])
        else:
            np.testing.assert_array_equal(got, ref["mixed7p/tokens"])


def pad_case_want(runs):
    gname, arch, rows, block = PAD_CASE
    one = one_rank(runs["ref"], arch, "capacity").tmodel
    x = torch.as_tensor(layer_inputs(one.cfg.d_model)[:rows])
    with torch.no_grad():
        return moe_lib.moe_forward_capacity(x, one.layers[1].moe, one.cfg)[0].numpy()


def pad_case_got(runs, key):
    gname, arch, rows, block = PAD_CASE
    by_d = {int(r[f"grid/{gname}"][0]): r[f"pad/{gname}/{arch}{key}"]
            for r in grid_ranks(runs, gname)}
    return np.concatenate([by_d[d] for d in sorted(by_d)])


def test_capacity_layer_over_padded_blocks(runs):
    """phi3.5-moe-smoke's capacity layer over R = 6 rows in blocks of 2 on
    4 data ranks (rank 3's block all padding): the ranks' real rows equal
    one process's layer over the 6 rows (its cap and drops), one gather
    over the batch group and one reduce-scatter of the split experts."""

    gname, arch, rows, block = PAD_CASE
    want = pad_case_want(runs)
    got = pad_case_got(runs, "")
    assert got.shape[0] == 4 * block
    np.testing.assert_allclose(got[:rows], want, atol=ATOL, rtol=RTOL)
    for rec in grid_ranks(runs, gname):
        assert list(rec[f"pad/{gname}/{arch}/counts"][:3]) == [1, 1, 0]


def test_control_pad_rows_in_capacity_table_caught(runs):
    """The same layer with every block's pad rows routed into the table
    (cap and slots of 8 rows) is not one process's layer over the 6."""

    rows = PAD_CASE[2]
    got = pad_case_got(runs, "/with_pad")
    assert not np.allclose(got[:rows], pad_case_want(runs), atol=ATOL, rtol=RTOL)


def test_control_empty_handoff_caught(runs):
    """A prefill rank that hands off zeros: the decode rank's tokens are not
    the reference's."""

    ref = runs["ref"]
    for rec in grid_ranks(runs, "d1p1"):
        assert not np.array_equal(rec["disagg_zeros/tokens"], ref["disagg/tokens"])
        np.testing.assert_array_equal(rec["disagg_zeros/reserved"], ref["disagg/reserved"])


# ---------------------------------------------------------------------------
# without processes: the expert blocks, the mesh, the counts
# ---------------------------------------------------------------------------


def stub(rank, size, axis):
    return dist.ModelGroup(rank, size, "gloo", CPU, (CPU,) * size, axis=axis)


def test_graphed_call_counts_data_collectives_at_replay(monkeypatch):
    """A round captured in a CUDA graph whose MoE layers exchange rows over
    NCCL data ranks: the capture's data-axis collectives and bytes are
    taken back and each replay adds them (the fake graph re-runs
    nothing)."""

    from repro_torch.runtime import graphs
    from test_torch_scheduler import _fake_capture, _FakeGraph

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    for name in ("DATA_CALLS", "DATA_BYTES"):
        monkeypatch.setattr(dist, name, {"all_reduce": 0, "all_gather": 0, "broadcast": 0})

    def fn():
        dist.DATA_CALLS["all_gather"] += 2
        dist.DATA_BYTES["all_gather"] += 64
        if _FakeGraph.current is not None:
            _FakeGraph.current.fn = lambda: None
        return "out"

    call = graphs.GraphedCall(fn)
    assert call() == "out" and call.data_collectives == {"all_gather": 2}
    assert call.data_collective_bytes == {"all_gather": 64} and call.collectives == {}
    for _ in range(3):
        assert call() == "out"
    assert dist.DATA_CALLS["all_gather"] == 8 and dist.DATA_BYTES["all_gather"] == 256


@pytest.mark.parametrize("arch,data,model_axis", [
    ("qwen3-moe-235b-a22b", 2, 1), ("phi3.5-moe-42b-a6.6b", 4, 2),
    ("jamba-1.5-large-398b", 2, 2), ("phi3.5-moe-42b-a6.6b", 8, 1)])
def test_expert_blocks_are_the_one_process_weights(arch, data, model_axis):
    """``Model.init`` on a data rank draws every global expert and keeps its
    own: the D ranks' expert blocks put together (the model axis's too) are
    one process's experts bit for bit; the router and every other
    parameter are the model-axis rank's; where E does not divide over D
    every data rank holds every expert."""

    cfg = smoke(arch)
    one = dict(Model(cfg, device="cpu").named_parameters())
    split = dist.experts_split(cfg, data)
    for m in range(model_axis):
        mg = stub(m, model_axis, "model") if model_axis > 1 else None
        axis = dict(Model(cfg, device="cpu", group=mg).named_parameters())
        ranks = [dict(Model(cfg, device="cpu", group=mg,
                            data_group=stub(d, data, "data")).named_parameters())
                 for d in range(data)]
        for name, p in axis.items():
            blocks = [r[name] for r in ranks]
            if ".moe." in name and not name.endswith("router") and split:
                assert all(b.shape[0] == p.shape[0] // data for b in blocks), name
                assert torch.equal(torch.cat(blocks, 0), p), name
            else:
                assert all(torch.equal(b, p) for b in blocks), name
        if model_axis == 1:
            assert all(torch.equal(axis[k], v) for k, v in one.items())


def test_rank_grid_mesh_and_local_index():
    """A rank grid's mesh: the data axis is ranks (one local shard, the
    rank's data place), the model group its row; the expert dim is cut by
    the data rank where it divides, whole where it does not."""

    devs = (CPU,) * 8
    grid = dist.RankGrid(4, 2, 0, 5, "gloo", CPU, devs, stub(1, 2, "model"), stub(2, 4, "data"),
                         None)
    assert (grid.d, grid.m, grid.is_prefill) == (2, 1, False)
    mesh = make_rank_mesh(4, grid)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.local_shards == 1
    assert (mesh.rank, mesh.data_rank, mesh.prefill_rank) == (1, 2, False)
    spec = logical_to_pspec((8, 16, 32), ("expert", "embed", "mlp"), mesh)
    assert local_index((8, 16, 32), spec, mesh, 1) == (slice(4, 6), slice(None), slice(16, 32))
    spec = logical_to_pspec((6, 16, 32), ("expert", "embed", "mlp"), mesh)
    assert local_index((6, 16, 32), spec, mesh, 1)[0] == slice(None)
    prefill = dist.RankGrid(4, 2, 1, 8, "gloo", CPU, devs + (CPU,), None, None,
                            stub(8, 9, "handoff"))
    pmesh = make_rank_mesh(4, prefill)
    assert pmesh.prefill_rank and pmesh.group is None and pmesh.data_group is None
    with pytest.raises(ValueError, match="data=2 on a grid of 4"):
        make_rank_mesh(2, grid)


def test_handoff_bytes_and_data_counts():
    """The handoff of openvla-7b cut to 4 layers: n x 917,504 B of K/V at
    14 tokens plus n x 2 x ``vocab_padded`` B of bf16 logits; the data
    axis's collectives of an MoE token and prefill from the layer kinds."""

    cfg = get_config("openvla-7b").replace(num_layers=4)
    for n in (1, 2, 4):
        assert dist.handoff_bytes(cfg, n, 14) == n * 917_504 + n * 2 * 32_000
    phi = get_config("phi3.5-moe-42b-a6.6b").replace(num_layers=2)
    assert dist.experts_split(phi, 2) and not dist.experts_split(phi, 3)
    assert dist.data_collectives(phi, 2, sharded=True) == {"all_reduce": 2, "all_gather": 2,
                                                           "broadcast": 0}
    assert dist.data_collectives(phi, 2, sharded=False) == {"all_reduce": 2, "all_gather": 0,
                                                            "broadcast": 0}
    assert dist.data_collectives(phi, 3, sharded=True, moe_impl="capacity")["all_gather"] == 2
    assert dist.data_collectives(phi, 3, sharded=True)["all_gather"] == 0
    assert dist.data_collective_bytes(phi, 2, 1, 2, sharded=True) == {
        "all_reduce": 2 * 4 * 4096 * 4, "all_gather": 2 * 4 * 4096 * 2, "broadcast": 0}
    assert dist.harvest_bytes(8, 14, 2, 1) == {"all_reduce": 0, "all_gather": 8 * 14 * 8,
                                               "broadcast": 8 * 14 * 8}


def test_grid_placement_refusals():
    """A data rank's MoE stack built without the grid's data group, a handoff
    group with no grid, and a grid with a prefill rank served without its
    handoff group are refused; split lanes beside a prefill rank attach."""

    from repro_torch.partition import PartitionExecutor
    from repro_torch.runtime.scheduler import ContinuousBatchingScheduler

    devs = (CPU,) * 3
    dg = stub(0, 2, "data")
    handoff = stub(0, 3, "handoff")
    grid = dist.RankGrid(2, 1, 1, 0, "gloo", CPU, devs, stub(0, 1, "model"), dg, handoff)
    mesh = make_rank_mesh(2, grid)
    cfg = smoke("qwen3-moe-235b-a22b")
    tok = EpisodeTokenizer(cfg.vocab_size)
    with pytest.raises(ValueError, match="data_group=RankGrid.data_group"):
        ContinuousBatchingScheduler(Model(cfg, device="cpu"), tok, mesh=mesh,
                                    prefill_group=handoff)
    model = Model(cfg, device="cpu", data_group=dg)
    with pytest.raises(ValueError, match="prefill_group=RankGrid.handoff"):
        ContinuousBatchingScheduler(model, tok, mesh=mesh)
    with pytest.raises(ValueError, match="make_rank_mesh"):
        ContinuousBatchingScheduler(model, tok, prefill_group=handoff)
    sched = ContinuousBatchingScheduler(model, tok, mesh=mesh, prefill_group=handoff)
    assert sched._local_rows == sched.rows // 2 and sched.prefill_device == CPU
    sched.attach_partition(PartitionExecutor(model, 1))
    assert sched._lanes[1].block == 1 and not sched._lanes[1].has_buffers


def test_pod_grid_mesh_and_groups():
    """A pod grid's rank (p, d, m) is world rank (p D + d) M + m; its mesh
    is (pod, data, model) with the rows blocked over the batch group (one
    local shard), the experts cut over the data group alone."""

    devs = (CPU,) * 8
    grid = dist.RankGrid(2, 2, 0, 5, "gloo", CPU, devs, stub(1, 2, "model"), stub(0, 2, "data"),
                         None, 2, stub(2, 4, "batch"))
    assert (grid.p, grid.d, grid.m, grid.is_prefill, grid.blocks) == (1, 0, 1, False, 4)
    assert grid.batch_group.size == 4 and grid.decode_ranks == 8
    mesh = make_rank_mesh(2, grid)
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2} and mesh.local_shards == 1
    assert mesh.batch_group is grid.batch_group and mesh.data_rank == 0
    spec = logical_to_pspec((8, 16, 32), ("expert", "embed", "mlp"), mesh)
    assert local_index((8, 16, 32), spec, mesh, 1) == (slice(0, 4), slice(None), slice(16, 32))
    flat = dist.RankGrid(4, 2, 0, 5, "gloo", CPU, devs, stub(1, 2, "model"), stub(2, 4, "data"),
                         None)
    assert flat.batch_group is flat.data_group and (flat.p, flat.d, flat.m) == (0, 2, 1)
    assert make_rank_mesh(4, flat).batch_group is flat.data_group
    prefill = dist.RankGrid(2, 2, 1, 8, "gloo", CPU, devs + (CPU,), None, None,
                            stub(8, 9, "handoff"), 2)
    assert prefill.is_prefill and prefill.blocks == 4


@pytest.mark.parametrize("rows,ranks", [(2, 7), (6, 4), (8, 4), (14, 4)])
def test_padded_blocks_and_real_rows(rows, ranks):
    """A buffer of R rows over N ranks: blocks of ceil(R / N), rank k rows
    [k B, (k + 1) B), the rest pad rows; ``real_rows`` lists the real rows'
    places in the ranks' gathered blocks in global order, two buffers
    joined lane after lane (None where nothing is padded or moved)."""

    block = -(-rows // ranks)
    for k in range(ranks):
        sched = SimpleNamespace(_nranks=ranks, _brank=k, is_prefill_rank=False, rows=rows)
        sched._block = lambda n, s=sched: ContinuousBatchingScheduler._block(s, n)
        assert sched._block(rows) == block
        own = [ContinuousBatchingScheduler._own(sched, r, rows) for r in range(rows)]
        assert own == [r - k * block if r // block == k else None for r in range(rows)]
    mesh = Mesh(np.asarray([CPU], dtype=object).reshape(1, 1), ("data", "model"))
    with sharding_rules(mesh, rows=((rows, block),)):
        idx = real_rows(block, ranks)
    want = [r for r in range(ranks * block) if r < rows]
    assert (idx or list(range(ranks * block))) == want
    assert (idx is None) == (rows == ranks * block)
    with sharding_rules(mesh, rows=((rows, block), (2, 1))):
        both = real_rows(block + 1, ranks)
    lane = [k * (block + 1) + block for k in range(ranks) if k < 2]
    assert both == [k * (block + 1) + i for k in range(ranks) for i in range(block)
                    if k * block + i < rows] + lane
    with sharding_rules(mesh, rows=((rows, block), (2, 1))):
        assert real_rows(block, ranks) == idx
        with pytest.raises(ValueError, match="no prefix"):
            real_rows(block + 2, ranks)


def test_one_process_pod_mesh_folds_into_the_data_shards():
    """In one process a (pod 2, data 2, model 1) mesh on the CPU serves as
    its (data 2) mesh: the same results, tokens, reservations and pool."""

    cfg = smoke("openvla-7b")
    model = Model(cfg, device="cpu")
    tok = EpisodeTokenizer(cfg.vocab_size)
    pod = Mesh(np.asarray([CPU] * 4, dtype=object).reshape(2, 2, 1), ("pod", "data", "model"))
    runs = []
    for mesh in (pod, make_test_mesh(data=2, devices=[CPU] * 2)):
        sched = Recording(model, tok, mesh=mesh, **ENGINE_KW)
        rng = np.random.default_rng(0)
        for r in range(6):
            sched.submit(r, *obs_pair(rng))
        res = sched.drain()
        runs.append(([(r.robot_id, r.completed_round, *r.tokens) for r in res], sched.reserved,
                     sched.pool_stats(), sched.rows, sched.local_shards))
    assert runs[0] == runs[1] and runs[0][4] == 2
