"""The mesh's data axis and the prefill as ``torch.distributed`` ranks,
against the JAX package's multi-device runs.

A module fixture writes the f32 smoke stacks' weights (the port's one-rank
``Model.init``, in the reference's layout), then runs side by side: the
reference in two processes of its own on 8 forced host devices
(``tests/torch_sharded_ref.py --params``: the data-shard ``SCENARIOS``, 8
shards, a mixed fleet, prefill on the last device and 7 + 1; and
``--model-axis --part engine,fleet,split,split24 --only ...``: ``tp42``,
``jb42``, ``qm24``, ``pc42``, the rapid fleet on (4, 2), ``sp42`` and
``sx24``), and 8 gloo CPU ranks of ``tests/torch_data_axis_rank.py``, which
lay the grids of ``GRIDS`` over one world in turn: every data shard a rank,
the prefill a rank of its own.  Each process has a limit of its own and is
killed past it.  The ranks' records are held to:

1. the reference's ``SCENARIOS`` (``cloud8`` and ``mixed8`` on 8 data
   ranks, ``disagg`` on a decode rank and a prefill rank, ``combo7`` on 7
   data ranks and a prefill rank): results, tokens, every reservation, the
   final ``PoolStats`` and counters equal;
2. ``tp42``, ``jb42``, ``pc42`` on data 4 x model 2 and ``qm24`` on 2 x 4,
   and the rapid fleet on (4, 2): the same, tokens by the greedy-margin
   rule;
3. ``sp42`` and ``sx24``: split lanes, whole on every data rank;
4. every rank's host state equal, the prefill rank's too;
5. the bytes: a rank's expert bytes 1/D of a model-axis rank's (whole
   where E does not divide over D), its rows and its full-view pool as
   declared, and the data axis's collectives of every admission prefill,
   decode round, harvest, handoff and row growth exactly ``launch.dist``'s
   counts; the MoE layer over sharded rows equal to one process's;
6. three controls caught: a rank that skips the MoE's data-axis reduction,
   a capacity table built from a rank's own rows, a prefill rank that
   hands off nothing.

Then the rank grid, the expert blocks and the counts without processes.
"""

import os
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
from torch_data_axis_rank import (CANCEL_SEED, GRID_OF, GRIDS, LAYER_CASES,  # noqa: E402
                                  LAYER_ROWS, PREFILL_RUNS, SPLIT_RUN, TP_RUN,
                                  cancel_pending, layer_inputs)
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler  # noqa: E402
from torch_model_axis_rank import Recording  # noqa: E402
from torch_model_axis_cases import (ENGINE_KW, FLEET_KEYS, SCENARIOS, SMOKE_LAYERS,  # noqa: E402
                                    SPLIT_SCENARIOS, TP_FLEET, TP_SCENARIOS, obs_pair)

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
    }
    out_dir = tmp / "ranks"
    out_dir.mkdir()
    renv = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                            os.environ.get("PYTHONPATH", "")]))
    script = ROOT / "tests" / "torch_data_axis_rank.py"
    ranks = {f"rank {r}": launch([sys.executable, str(script), str(r), str(WORLD),
                                  str(out_dir / "store"), str(params_path), str(out_dir)],
                                 renv, out_dir / f"rank{r}.log") for r in range(WORLD)}
    try:
        finish(ranks, SPAWN_TIMEOUT_S, start)
        finish(refs, REF_TIMEOUT_S, start)
    finally:
        for proc, _ in (*ranks.values(), *refs.values()):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ref = dict(weights)
    ref.update(load(tmp / "sharded.npz"))
    ref.update(load(tmp / "axis.npz"))
    return {"ref": ref, "ranks": [load(out_dir / f"rank{r}.npz") for r in range(WORLD)]}


def grid_ranks(runs, gname):
    """The records of the ranks on grid ``gname``, in grid order."""

    return [r for r in runs["ranks"] if f"grid/{gname}" in r]


def grid_of(name):
    """The grid that runs scenario ``name``."""

    if name in GRID_OF:
        return GRID_OF[name]
    if name in {p[0] for p in PREFILL_RUNS}:
        return "d2m2p1"
    s = TP.get(name) or SPLIT[name]
    return next(g for g, d, m, _ in GRIDS if (d, m) == (s[2], s[3]))


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


@pytest.mark.parametrize("name", list(SPLIT))
def test_split_scenarios_match_reference(runs, name):
    """``sp42`` (a pipelined lane on openvla-smoke) and ``sx24``
    (qwen3-moe-smoke's expert-offload lane, whose experts all-reduce over
    the data ranks): the lanes whole on every data rank, host state equal,
    tokens equal (the MoE one by the greedy-margin rule), the first lane
    prefill's logits within 2e-5."""

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
    names = {n for n in (*SCENARIO, *TP, *SPLIT) if grid_of(n) == gname}
    names |= ({"fleet42"} if gname == "d4m2" else {"disagg_zeros", "cancel_pending"}
              if gname == "d1p1" else set())
    names |= {p[0] for p in PREFILL_RUNS} if gname == "d2m2p1" else set()
    keys = [k for k in recs[0] if k.split("/")[0] in names
            and k.split("/")[-1] in HOST_KEYS + FLEET_KEYS]
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


def expected_event(cfg, kind, figures, data, prefill, impl):
    """``launch.dist``'s [calls..., bytes...] of the data axis for one
    event of ``kind`` with its ``figures``."""

    keys = ("all_reduce", "all_gather", "broadcast")
    if kind == "round":
        rows, block = figures
        calls = dist.data_collectives(cfg, data, sharded=True, moe_impl=impl)
        size = dist.data_collective_bytes(cfg, rows, 1, data, sharded=True, moe_impl=impl)
        return [block * calls[k] for k in keys] + [block * size[k] for k in keys]
    if kind == "prefill":
        n, s = figures
        calls = dist.data_collectives(cfg, data, sharded=False, moe_impl=impl)
        size = dist.data_collective_bytes(cfg, n, s, data, sharded=False, moe_impl=impl)
        return [calls[k] for k in keys] + [size[k] for k in keys]
    if kind == "harvest":
        size = dist.harvest_bytes(*figures, data, prefill)
        return [0, int(data > 1), int(prefill)] + [size[k] for k in keys]
    if kind == "handoff":
        n = 1 << max(int(figures[0]) - 1, 0).bit_length()
        return [0, 0, 1, 0, 0, dist.handoff_bytes(cfg, n, PROMPT)]
    raise ValueError(kind)


@pytest.mark.parametrize("name", ["cloud8", "mixed8", "disagg", "combo7", "jb42", "pc42",
                                  "qm24", "jbp"])
def test_data_collectives_are_dists_counts(runs, name):
    """Every admission prefill, decode round, window harvest and handoff of
    the run issued exactly the data axis's collectives and bytes that
    ``launch.dist`` counts for it (``data_collectives`` /
    ``data_collective_bytes``, ``harvest_bytes``, ``handoff_bytes``); a row
    growth gathers each row buffer once over the data ranks."""

    if name in SCENARIO:
        arch, impl, data, prefill = "openvla-7b", "dense", max(SCENARIO[name][3], 1), \
            int(SCENARIO[name][4])
    elif name == "jbp":
        arch, impl, data, prefill = "jamba-1.5-large-398b", "dense", 2, 1
    else:
        _, arch, data, _, _, _, impl = TP[name]
        prefill = 0
    cfg = smoke(arch)
    seen = set()
    for rec in grid_ranks(runs, grid_of(name)):
        is_prefill = rec[f"grid/{grid_of(name)}"][2]
        for kind in ("prefill", "round", "harvest", "handoff"):
            for ev in rec[f"{name}/events/{kind}"]:
                k = len(ev) - 6
                d = 1 if is_prefill else data  # the prefill rank is in no data group
                want = expected_event(cfg, kind, list(ev[:k]), d, prefill, impl)
                assert list(ev[k:]) == want, (kind, list(ev))
                seen.add(kind)
        n_state = len(Model(cfg, device="meta").state_names)
        for ev in rec[f"{name}/events/grow"]:
            assert list(ev[1:4]) == [0, (4 + n_state) * (data > 1), 0]
    assert {"round", "harvest"} <= seen
    assert ("handoff" in seen) == bool(prefill)


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
    handoff group are refused; split lanes beside a prefill rank name
    their ROADMAP item."""

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
    with pytest.raises(NotImplementedError, match="ROADMAP queue I, item 12"):
        sched.attach_partition(PartitionExecutor(model, 1))
