"""RAPID's split lanes on the mesh's ``model`` axis: the port's
tensor-parallel ranks serve the edge prefix and the cloud suffix of
``PartitionExecutor``, the scheduler's pipelined, serial, heterogeneous and
expert-offload lanes, the rapid fleet with split robots and a
``PartitionedPolicy`` chunk, against the JAX package's model-axis meshes.

A module fixture writes the f32 smoke stacks' weights (the port's one-rank
``Model.init``, in the reference's layout), then runs side by side: the
reference in three processes of its own on 8 forced host devices
(``tests/torch_sharded_ref.py --model-axis --params``: ``--part split`` and
``--part split24``, its engine with split lanes over the (4, 2) and (2, 4)
meshes of ``SPLIT_SCENARIOS``, the first also its executor's split forward
on one device and one ``PartitionedPolicy`` chunk; ``--part
split_fleet``, its rapid fleet with split robots over (4, 2)), and the
port's ranks: 2 and 4 CPU ranks, each a process of
``tests/torch_model_axis_rank.py ... split`` in a gloo group over a file
store.  The reference's pipelined lane is handed a writable copy of its
logits (a fault of the reference under jax 0.9, ROADMAP §3).  Each process
has a limit of its own (``REF_TIMEOUT_S``, ``SPAWN_TIMEOUT_S``) and is
killed past it.  The ranks' records are held to:

(a) the reference's engine on the same mesh: harvest order, rounds, kinds,
    every reservation (cloud and lane), the final ``PoolStats`` and
    counters equal; tokens equal (the MoE scenario by the greedy-margin
    rule); the first lane prefill's logits within ``LOGIT_ATOL``; the rapid
    fleet's actions, offloads, rounds and cancels equal; the
    ``PartitionedPolicy`` chunk's tokens and actions;
(b) the reference executor's ``split_prefill`` / ``split_decode_step``
    logits, within ``ATOL``, through the rank's split forward and through
    its suffix path (the edge embedding's tp, the suffix pools at the
    rank's KV heads, the lane state at the rank's sizes);
(c) the collectives of a ping-pong token and of a fused window token over
    1 and 2 lanes, exactly ``launch.dist``'s counts, on the ranks and in
    one process;
(d) a control: the edge embedding without its all-reduce is caught;
(e) the channel's bytes and modeled ms of a rank's executor equal the one
    rank's;
(f) every lane's buffers freed on every rank once it empties;
(g) ``dist.BYTES`` after a prefill and a decode token equal
    ``dist.collective_bytes``; every rank's records equal.
"""

import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

from repro_torch.checkpoint.bridge import load_reference_params, reference_tensors  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import EpisodeTokenizer  # noqa: E402
from repro_torch.launch import dist  # noqa: E402
from repro_torch.launch.mesh import make_rank_mesh  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.partition import PartitionExecutor, PartitionedPolicy  # noqa: E402
from repro_torch.partition import executor as executor_lib  # noqa: E402
from repro_torch.runtime import scheduler as sched_lib  # noqa: E402
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler  # noqa: E402

from test_torch_model_axis import ROOT, finish, launch, load, smoke, stub_group  # noqa: E402
from test_torch_scheduler import _obs_tokens, assert_tokens_match  # noqa: E402
from torch_model_axis_cases import (  # noqa: E402
    ENCDEC_PLAN,
    EXEC_CASES,
    FLEET_KEYS,
    POLICY_CASE,
    SPLIT_SCENARIOS,
    exec_inputs,
    obs_pair,
)
from torch_model_axis_rank import BYTES_ARCHS, axis_smoke, fused_calls  # noqa: E402

REF_TIMEOUT_S = 300
SPAWN_TIMEOUT_S = 240
WORLDS = (2, 4)
REF_PARTS = ("split", "split24", "split_fleet")
ATOL = RTOL = 1e-5
LOGIT_ATOL = 2e-5
SCENARIO = {s[0]: s for s in SPLIT_SCENARIOS}
MOE = "qwen3-moe-235b-a22b"
ARCHS = tuple(dict.fromkeys(s[1] for s in SPLIT_SCENARIOS))


# ---------------------------------------------------------------------------
# the weights, then the reference and the ranks side by side
# ---------------------------------------------------------------------------


def start_ranks(world, params_path, out_dir):
    """``world`` gloo ranks of ``torch_model_axis_rank.py``'s ``split``
    part."""

    out_dir.mkdir()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    script = ROOT / "tests" / "torch_model_axis_rank.py"
    return {f"rank {r} of {world}": launch(
        [sys.executable, str(script), str(r), str(world), str(out_dir / "store"),
         str(params_path), str(out_dir), "split"], env, out_dir / f"rank{r}.log")
        for r in range(world)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's records and the weights, 2: [rank records],
    4: [...]}."""

    tmp = tmp_path_factory.mktemp("model_axis_split")
    params_path = tmp / "params.npz"
    weights = {}
    for arch in ARCHS:
        weights.update({f"params/{arch}/{k}": v.numpy() for k, v in
                        reference_tensors(Model(smoke(arch), device="cpu")).items()})
    np.savez(params_path, **weights)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    start = time.monotonic()
    refs = {f"reference {part}": launch(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_ref.py"), str(tmp / f"{part}.npz"),
         "--model-axis", "--part", part, "--params", str(params_path)], env, tmp / f"{part}.log")
        for part in REF_PARTS}
    ranks = {}
    try:
        for world in WORLDS:
            ranks.update(start_ranks(world, params_path, tmp / f"world{world}"))
        finish(ranks, SPAWN_TIMEOUT_S, start)
        finish(refs, REF_TIMEOUT_S, start)
    finally:
        for proc, _ in (*ranks.values(), *refs.values()):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {"ref": dict(weights)}
    for part in REF_PARTS:
        out["ref"].update(load(tmp / f"{part}.npz"))
    for world in WORLDS:
        out[world] = [load(tmp / f"world{world}" / f"rank{r}.npz") for r in range(world)]
    return out


def one_rank(ref, arch):
    """The one-rank port model of ``arch`` on the reference's weights and
    its tokenizer (the greedy-margin rule's model)."""

    model = Model(smoke(arch), device="cpu")
    pre = f"params/{arch}/"
    load_reference_params(model, {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    return SimpleNamespace(tmodel=model, tok=EpisodeTokenizer(model.cfg.vocab_size))


def text(a):
    return json.loads(bytes(a).decode())


# ---------------------------------------------------------------------------
# (a) the engine, the fleet and the policy against the reference's meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIO))
def test_split_engine_matches_reference_mesh(runs, name):
    """(a) sp42 / sp24 (a pipelined lane at cut 1 over 2 and 4 ranks), ss42
    (a serial lane), sh24 (two lanes, cuts 0 and 1), sx24 (qwen3-moe's
    expert-offload lane), sj42 (jamba-smoke), sl42 (xlstm-smoke): on every
    rank, harvest order, rounds, kinds, every reservation, the final pool
    and counters equal to the reference's on the same mesh; tokens equal
    (the MoE scenario by the greedy-margin rule); the first lane prefill's
    logits within 2e-5; the rank's suffix pool at its KV heads."""

    _, arch, data, model_axis, keys, pipelined, n, seed = SCENARIO[name]
    ref = runs["ref"]
    st = one_rank(ref, arch)
    rng = np.random.default_rng(seed)
    obs = [obs_pair(rng) for _ in range(n)]
    results = ref[f"{name}/results"]
    assert results[:, 4].sum() == n // 2  # the odd robots were split
    for rec in runs[model_axis]:
        for k in ("results", "reserved", "pool", "counters"):
            np.testing.assert_array_equal(rec[f"{name}/{k}"], ref[f"{name}/{k}"], err_msg=k)
        if arch == MOE:
            for row, want, got in zip(results, ref[f"{name}/tokens"], rec[f"{name}/tokens"]):
                assert_tokens_match(st, _obs_tokens(st.tok, *obs[row[0]]), want, got,
                                    f"robot {row[0]}")
        else:
            np.testing.assert_array_equal(rec[f"{name}/tokens"], ref[f"{name}/tokens"])
        np.testing.assert_allclose(rec[f"{name}/first_lane"], ref[f"{name}/first_lane"],
                                   atol=LOGIT_ATOL, rtol=0)
        assert bytes(rec[f"{name}/round_mode"]).decode() == f"eager, {model_axis} ranks over gloo"
        cfg = st.tmodel.cfg
        kv = cfg.num_kv_heads // model_axis or 1
        assert tuple(rec[f"{name}/pool_shape"][-2:]) == (kv, cfg.resolved_head_dim)


@pytest.mark.parametrize("name", list(SCENARIO))
def test_lane_buffers_freed_on_every_rank(runs, name):
    """(f) Each lane held buffers and freed them every time it emptied, on
    every rank alike; after the drain no lane holds any, and the shared
    suffix pools and fused graphs are gone."""

    model_axis, keys = SCENARIO[name][3], SCENARIO[name][4]
    ranks = runs[model_axis]
    for rec in ranks:
        lanes = rec[f"{name}/lanes"]
        assert lanes.shape == (len(keys), 3)
        assert (lanes[:, 0] > 0).all() and (lanes[:, 1] == 0).all() and (lanes[:, 2] > 0).all()
        np.testing.assert_array_equal(rec[f"{name}/left"], [0, 0])
        np.testing.assert_array_equal(lanes, ranks[0][f"{name}/lanes"])


def test_split_fleet_matches_reference_mesh(runs):
    """(a) ``serve_fleet(trigger="rapid")`` over (4, 2) with robots 1, 3, 5
    and 7 split at cut 1, on 2 ranks, against the reference's fleet on
    (4, 2): every action, offload, service round, cancel and round count;
    its cancels are exercised."""

    ref = runs["ref"]
    for rec in runs[2]:
        for key in FLEET_KEYS:
            np.testing.assert_array_equal(rec[f"spfleet/{key}"], ref[f"spfleet/{key}"],
                                          err_msg=key)
        assert bytes(rec["spfleet/trigger"]).decode() == "rapid" and rec["spfleet/cancelled"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_policy_chunk_matches_reference(runs, world):
    """(a) One ``PartitionedPolicy`` chunk of openvla-smoke at cut 1 on the
    ranks, eager under gloo (no graph), against the reference's policy on
    one device: the prefill's logits within 2e-5, the 56 tokens and the
    actions equal, the modeled channel ms equal; its collectives exactly a
    prefill's and 56 ping-pong tokens' (each the unsplit decode token's)."""

    ref = runs["ref"]
    arch, cut, seed = POLICY_CASE
    cfg = smoke(arch)
    pre, tok = dist.collectives(cfg, 14), dist.collectives(cfg)
    for rec in runs[world]:
        np.testing.assert_allclose(rec["policy/prefill"], ref["policy/prefill"],
                                   atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_array_equal(rec["policy/tokens"], ref["policy/tokens"])
        np.testing.assert_allclose(rec["policy/actions"], ref["policy/actions"], rtol=0, atol=0)
        np.testing.assert_array_equal(rec["policy/net_ms"], ref["policy/net_ms"])
        assert int(rec["policy/graphs"]) == 0
        np.testing.assert_array_equal(rec["policy/calls"], [pre[k] + 56 * tok[k] for k in pre])


# ---------------------------------------------------------------------------
# (b) the executor on a rank against the reference executor
# ---------------------------------------------------------------------------

EXEC = [(arch, cut, w) for arch, cut, worlds in EXEC_CASES for w in worlds]


@pytest.mark.parametrize("arch,cut,world", EXEC)
def test_executor_matches_reference(runs, arch, cut, world):
    """(b) Two robots' prompts and two decode tokens through a rank's
    ``split_prefill`` / ``split_decode_step`` and through its suffix path
    (``edge_prefill``, ``suffix_prefill`` into pools at the rank's KV heads
    and lane state at its sizes, ``edge_step``, ``suffix_step``): every
    logit within 1e-5 of the reference executor's ``split_prefill`` /
    ``split_decode_step`` on one device."""

    want = runs["ref"][f"exec/{arch}/{cut}"]
    for rec in runs[world]:
        for path in ("split", "suffix"):
            np.testing.assert_allclose(rec[f"exec/{arch}/{cut}/{path}"], want, atol=ATOL,
                                       rtol=RTOL, err_msg=path)


# the axis of a recurrent state tensor that a rank holds its block of
# (Mamba heads of h, channels of conv; mLSTM heads; sLSTM units, h whole)
STATE_AXIS = {"h": 1, "conv": 2, "mC": 1, "mn": 1, "mm": 1, "sc": 1, "sn": 1, "sm": 1}


@pytest.mark.parametrize("arch,cut,world", EXEC)
def test_executor_buffers_at_rank_sizes(runs, arch, cut, world):
    """(b) A rank's suffix pools and its edge rows' dense K/V hold its KV
    heads, its lane state (``init_lane_state``) and its edge rows
    (``init_edge_rows``) its block of every Mamba, mLSTM and sLSTM state
    (the sLSTM's h whole): the one-rank executor's shapes with the rank's
    axis divided."""

    cfg = smoke(arch)
    one = PartitionExecutor(Model(cfg, device="meta"), cut)
    kinds = set()
    for rec in runs[world]:
        shapes = text(rec[f"exec/{arch}/{cut}/shapes"])
        assert shapes
        for key, shape in shapes.items():
            side, layer, name = key.split("/")
            layer = int(layer)
            kinds.add(cfg.blocks[layer])
            if side == "pool":
                kv = cfg.num_kv_heads // world or 1
                assert shape[-2:] == [kv, cfg.resolved_head_dim], key
                continue
            whole = list(one.model._init_block_cache(layer, 2, 14)[name].shape)
            if name in STATE_AXIS:  # (the sLSTM's h, "sh", is whole on a rank)
                whole[STATE_AXIS[name]] //= world
            elif name in ("k", "v"):  # an edge layer's dense K/V: the rank's KV heads
                whole[2] = cfg.num_kv_heads // world or 1
            assert shape == whole, key
    assert kinds == set(cfg.blocks)


# ---------------------------------------------------------------------------
# (c)-(e) the collectives, the control and the channel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_exact_on_ranks(runs, world):
    """(c) On every rank: a ping-pong token of each executor case makes the
    unsplit decode token's collectives, and a fused window token over the
    lanes at cut 1, and at cuts 0 and 1, makes ``dist.lane_collectives``
    (1 lane: the unsplit token's; 2 lanes: a second embedding all-reduce
    and layer 0's two again, for the lane at cut 1)."""

    cfg = smoke("openvla-7b")
    assert dist.lane_collectives(cfg, (1,)) == dist.collectives(cfg) == {
        "all_reduce": 5, "all_gather": 1}
    assert dist.lane_collectives(cfg, (0, 1)) == {"all_reduce": 8, "all_gather": 1}
    for rec in runs[world]:
        for arch, cut, _ in (c for c in EXEC_CASES if world in c[2]):
            np.testing.assert_array_equal(rec[f"exec/{arch}/{cut}/pingpong_calls"],
                                          list(dist.collectives(smoke(arch)).values()))
        for cuts in ((1,), (0, 1)):
            np.testing.assert_array_equal(rec[f"fused_calls/{'_'.join(map(str, cuts))}"],
                                          list(dist.lane_collectives(cfg, cuts).values()))


def _stub_collectives(monkeypatch):
    import torch.distributed as tdist

    monkeypatch.setattr(tdist, "all_reduce", lambda x, group=None: None)
    monkeypatch.setattr(tdist, "all_gather",
                        lambda parts, x, group=None: [t.copy_(x) for t in parts])
    monkeypatch.setattr(dist, "CALLS", {"all_reduce": 0, "all_gather": 0})
    monkeypatch.setattr(dist, "BYTES", {"all_reduce": 0, "all_gather": 0})


# (arch, lane cuts): the fused windows counted in one process
FUSED = [("openvla-7b", (1,)), ("openvla-7b", (0, 1)), ("openvla-7b", (0, 1, 2)),
         ("jamba-1.5-large-398b", (0, 1)), (MOE, (1,)), ("xlstm-125m", (0, 2))]


@pytest.mark.parametrize("arch,cuts", FUSED)
def test_collectives_in_process(monkeypatch, arch, cuts):
    """(c) A rank of 2 in one process (``torch.distributed`` stubbed, the
    collectives counted, not run): a fused window token over lanes at
    ``cuts`` makes ``dist.lane_collectives``, and a ping-pong token of
    each lane's executor the unsplit decode token's ``dist.collectives``."""

    _stub_collectives(monkeypatch)
    cfg = smoke(arch)
    model = Model(cfg, device="cpu", group=stub_group(0, 2))
    want = dist.lane_collectives(cfg, cuts)
    assert want["all_reduce"] == dist.collectives(cfg)["all_reduce"] + sum(
        1 + dist.layer_collectives(cfg, range(c))["all_reduce"] for c in cuts[1:])
    np.testing.assert_array_equal(fused_calls(model, cuts), list(want.values()))
    tokens = torch.zeros((2, 5), dtype=torch.long)
    for cut in cuts:
        ex = PartitionExecutor(model, cut)
        logits, state = ex.split_prefill({"tokens": tokens}, extra=2)
        before = dict(dist.CALLS)
        ex.split_decode_step(logits[:, -1].argmax(-1, keepdim=True), state)
        assert {k: dist.CALLS[k] - before[k] for k in before} == dist.collectives(cfg)


def test_edge_embedding_without_all_reduce_is_caught(runs):
    """(d) On 2 ranks, openvla-smoke's split prefill and decode steps with
    the edge token embedding looked up in the rank's vocab block and not
    summed (``_embed_token`` did so before it passed the tp): the prefill
    still holds, the decode tokens' logits miss the reference executor's."""

    arch, cut, _ = EXEC_CASES[0]
    want = runs["ref"][f"exec/{arch}/{cut}"]
    for rec in runs[2]:
        got = rec["control/no_embed_sum"]
        np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=RTOL)
        assert not np.allclose(got[1:], want[1:], atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_channel_figures_equal_one_rank(runs, world):
    """(e) The cut activation is whole on a rank, so its ``shipped_bytes``,
    ``modeled_net_ms`` and ``record_chunk_bytes`` counters are the one
    rank's: not divided by the ranks, nor counted once a rank (openvla's
    cut 1 and qwen3-moe's expert-offload lane)."""

    ref = runs["ref"]
    for arch, cut, off in (("openvla-7b", 1, ()), (MOE, 1, (0,))):
        ex = PartitionExecutor(one_rank(ref, arch).tmodel, cut, expert_offload=off)
        ex.forward({"tokens": torch.as_tensor(exec_inputs(ex.cfg.vocab_size)[0])})
        ex.obs = Observability()
        ex.record_chunk_bytes(14, 56)
        want = {"shipped": ex.shipped_bytes, "net": ex.modeled_net_ms(14, 56),
                "bytes": {k: v for k, v in ex.obs.metrics.to_json().items()
                          if k.startswith("channel.")}}
        assert want["shipped"] > 0 and want["bytes"]
        for rec in runs[world]:
            assert text(rec[f"channel/{arch}"]) == json.loads(json.dumps(want))


# ---------------------------------------------------------------------------
# (g) the collectives' bytes; every rank equal
# ---------------------------------------------------------------------------


def _bytes_cfg(arch):
    return axis_smoke(arch) if arch in ("xlstm-125m", "seamless-m4t-medium") else smoke(arch)


@pytest.mark.parametrize("arch", BYTES_ARCHS)
def test_collective_bytes_on_ranks(runs, arch):
    """(g) On 2 gloo ranks, ``dist.CALLS`` and ``dist.BYTES`` after a
    prefill (2 rows of 14 tokens; seamless's 4 rows of 14 tokens over 24
    frames) and after one decode token equal ``dist.collectives`` and
    ``dist.collective_bytes``."""

    cfg = _bytes_cfg(arch)
    rows, frames = (ENCDEC_PLAN["b"], ENCDEC_PLAN["frames"]) if cfg.encoder_decoder else (2, None)
    want = []
    for prompt in (14, 1):
        n = dist.collectives(cfg, prompt)
        b = dist.collective_bytes(cfg, rows, prompt, 2, frames=frames)
        want.append([n["all_reduce"], n["all_gather"], b["all_reduce"], b["all_gather"]])
    for rec in runs[2]:
        np.testing.assert_array_equal(rec[f"bytes/{arch}"], want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_collective_bytes_in_process(monkeypatch, arch):
    """(g) A rank of 2 of every f32 smoke stack in one process
    (``torch.distributed`` stubbed): ``dist.CALLS`` and ``dist.BYTES`` of a
    prefill (a VLM's patch positions and an enc-dec stack's frames
    included) and of a decode token equal ``dist.collectives`` and
    ``dist.collective_bytes``, each collective in its dtype; one rank
    issues none."""

    _stub_collectives(monkeypatch)
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = Model(cfg, device="cpu", group=stub_group(1, 2))
    batch = {"tokens": torch.zeros((3, 6), dtype=torch.long)}
    front = 0
    if cfg.encoder_decoder:
        batch["frontend"] = torch.zeros((3, 5, cfg.d_model))
    elif hasattr(model, "mod_proj"):
        front = 4
        batch["frontend"] = torch.zeros((3, front, cfg.d_model))
    logits, cache = model.prefill(batch, extra=1)
    prompt = 6 + front
    assert dist.BYTES == dist.collective_bytes(cfg, 3, prompt, 2, frames=5, frontend=front)
    assert dist.CALLS == dist.collectives(cfg, prompt)
    before = dict(dist.BYTES)
    model.decode_step(logits[:, -1].argmax(-1, keepdim=True), cache)
    want = dist.collective_bytes(cfg, 3, 1, 2)
    assert {k: dist.BYTES[k] - before[k] for k in before} == want
    assert dist.collective_bytes(cfg, 3, 1, 1) == {"all_reduce": 0, "all_gather": 0}


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_equal(runs, world):
    """(g) Every rank records the same outputs, tokens, counts and shapes."""

    ranks = runs[world]
    keys = list(ranks[0])
    assert keys and all(set(r) == set(keys) for r in ranks)
    for r, rec in enumerate(ranks[1:], 1):
        for k in keys:
            np.testing.assert_array_equal(rec[k], ranks[0][k], err_msg=f"{k} rank {r}")


# ---------------------------------------------------------------------------
# the lifted refusals and the graph gate, without processes
# ---------------------------------------------------------------------------


def test_rank_model_splits_and_attaches_lanes():
    """``PartitionExecutor`` over a rank's model and
    ``attach_partition`` on a rank mesh's scheduler no longer raise; the
    lane's pools hold the rank's KV heads, its edge token embedding sums
    over the ranks (its tp)."""

    model = Model(smoke("openvla-7b"), device="cpu", group=stub_group(1, 4))
    sched = ContinuousBatchingScheduler(model, EpisodeTokenizer(model.cfg.vocab_size),
                                        mesh=make_rank_mesh(2, model.group))
    for key in (0, 1, 2):
        sched.attach_partition(PartitionExecutor(model, key), pipelined=key != 2)
    assert sorted(sched._lanes) == [0, 1, 2] and model.embed.tp is model.group
    assert PartitionExecutor(model, 1).init_layer_pool(sched.paged_spec)["kp"].shape[-2] == 1


def test_graphs_follow_the_model(monkeypatch):
    """The fused split round and ``PartitionedPolicy``'s chunk are built as
    graphs where ``Model.graphs`` allows (an NCCL group's card, or one
    rank's) and run eagerly where it does not (a gloo group's ranks stage
    their collectives through the host): a stand-in ``GraphedCall``, which
    runs its function eagerly, counts what would be captured."""

    made = []

    class Recorded:
        def __init__(self, fn):
            made.append(fn)
            self.fn, self.graph, self.capture_s = fn, None, 0.0

        def __call__(self):
            return self.fn()

    monkeypatch.setattr(executor_lib, "GraphedCall", Recorded)
    monkeypatch.setattr(sched_lib, "GraphedCall", Recorded)
    cfg = smoke("openvla-7b")
    model, tok = Model(cfg, device="cpu"), EpisodeTokenizer(cfg.vocab_size)
    qd, tau = obs_pair(np.random.default_rng(3))
    want = None
    for allowed in (False, True):
        monkeypatch.setattr(Model, "graphs", property(lambda self, a=allowed: a))
        del made[:]
        policy = PartitionedPolicy(PartitionExecutor(model, 1), tok)
        got = policy.chunk_tokens(qd, tau)
        assert len(policy._graphs) == len(made) == int(allowed)
        sched = ContinuousBatchingScheduler(model, tok, max_slots=2, num_pages=15)
        sched.attach_partition(PartitionExecutor(model, 1))
        sched.submit(0, qd, tau, partitioned=True)
        (res,) = sched.drain()
        assert (len(made) > 1) == allowed
        np.testing.assert_array_equal(res.tokens, got[0])
        if want is not None:
            np.testing.assert_array_equal(got, want)
        want = got
