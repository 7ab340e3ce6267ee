"""The mesh's ``model`` axis: the port's tensor-parallel ranks against the
JAX package's model-axis meshes.

A module fixture runs the reference once in a process of its own on 8
forced host devices (``tests/torch_sharded_ref.py --model-axis``: its
engine on f32 openvla-smoke over (data 4, model 2), starcoder2-smoke over
(2, 4), gemma2-smoke over (4, 2), and ``serve_fleet(trigger="rapid")`` on
openvla-smoke over (4, 2)), then spawns the port's ranks once: 2 CPU ranks
and 4 CPU ranks, each a process of ``tests/torch_model_axis_rank.py`` in a
gloo group over a file store, each spawn joined with a limit of its own
(``SPAWN_TIMEOUT_S``) and killed past it.  The ranks' records are held
to:

(a) the JAX functions on the same numpy inputs, for a 2-rank f32
    openvla-smoke built by ``Model.init`` (the reference gets the one-rank
    port model's weights): the MLP, prefill attention and its K/V, a paged
    decode step and the pool it writes, ``embed_lookup`` (bit for bit) and
    the logits, at ``ATOL`` = ``RTOL`` = 1e-5; the ranks' parameter blocks
    put together equal the one-rank weights bit for bit;
(b)-(d) the reference's engine on its mesh (``tp42``, ``sc24`` with
    starcoder2's 2 KV heads over 4 ranks, ``gm42`` with gemma2's tied
    table, softcaps and windows): results, rounds, every reservation, the
    final ``PoolStats`` and counters equal; tokens equal or differing only
    past a near-tie (the greedy-margin rule);
(e) the reference's rapid fleet on (4, 2): ``actions``, ``offloads``,
    ``service_rounds``, ``cancelled``, ``trigger`` and the round counts;
(f) every rank's records equal.

Then what the model axis refuses, and the rank mesh and collectives
without processes.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import _path_str  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.runtime.kv_cache import scatter_prompt_into_pool as jax_scatter  # noqa: E402
from repro_torch.checkpoint.bridge import load_reference_params, reference_tensors  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import EpisodeTokenizer  # noqa: E402
from repro_torch.launch import dist  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_rank_mesh  # noqa: E402
from repro_torch.launch.sharding import P, local_slice, logical_to_pspec  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.partition import PartitionExecutor  # noqa: E402
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler  # noqa: E402

from repro_torch.runtime import graphs  # noqa: E402
from test_torch_scheduler import (  # noqa: E402
    _fake_capture,
    _FakeGraph,
    _obs_tokens,
    assert_tokens_match,
)
from torch_model_axis_cases import (  # noqa: E402
    FLEET_KEYS,
    TP_FLEET,
    TP_SCENARIOS,
    obs_pair,
)
from torch_model_axis_rank import PAGED, layer_inputs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
REF_TIMEOUT_S = 300
SPAWN_TIMEOUT_S = 120
WORLDS = (2, 4)
ATOL = RTOL = 1e-5
SCENARIO = {s[0]: s for s in TP_SCENARIOS}


# ---------------------------------------------------------------------------
# the reference once, then the ranks once
# ---------------------------------------------------------------------------


def spawn_ranks(world, ref_path, out_dir):
    """``world`` gloo ranks of ``torch_model_axis_rank.py``, joined within
    ``SPAWN_TIMEOUT_S`` (then killed) -> every rank's records, by rank."""

    out_dir.mkdir()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    script = ROOT / "tests" / "torch_model_axis_rank.py"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world),
                               str(out_dir / "store"), str(ref_path), str(out_dir)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"{world} ranks not done in {SPAWN_TIMEOUT_S} s: killed")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world}: exit {p.returncode}\n{log[-4000:]}"
    out = []
    for r in range(world):
        with np.load(out_dir / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's records, 2: [rank records], 4: [...]}."""

    tmp = tmp_path_factory.mktemp("model_axis")
    ref_path = tmp / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_sharded_ref.py"),
                           str(ref_path), "--model-axis"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(ref_path) as z:
        out = {"ref": {k: z[k] for k in z.files}}
    for world in WORLDS:
        out[world] = spawn_ranks(world, ref_path, tmp / f"world{world}")
    return out


def one_rank(ref, arch):
    """The one-rank port model of ``arch`` on the reference's weights, and
    its tokenizer (the greedy-margin rule's model)."""

    model = Model(get_smoke_config(arch).replace(dtype="float32"), device="cpu")
    pre = f"params/{arch}/"
    load_reference_params(model, {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    return SimpleNamespace(tmodel=model, tok=EpisodeTokenizer(model.cfg.vocab_size))


# ---------------------------------------------------------------------------
# (a) the layers of a 2-rank model built by Model.init
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def twin():
    """The one-rank f32 openvla-smoke of ``Model.init`` and the reference's
    model on its weights -> (port model, jax model, jax params)."""

    tmodel = Model(get_smoke_config("openvla-7b").replace(dtype="float32"), device="cpu")
    jmodel = JaxModel(jax_smoke("openvla-7b").replace(dtype="float32", param_dtype="float32"))
    flat = {k: v.numpy() for k, v in reference_tensors(tmodel).items()}
    template = jmodel.init(jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(flat["/".join(_path_str(q) for q in path)]), template)
    return tmodel, jmodel, jparams


def test_rank_blocks_are_the_one_rank_weights(runs, twin):
    """Each parameter's two blocks put together are the one-rank model's
    tensor bit for bit: cut where the rules cut it (heads, KV heads, mlp,
    vocab), whole on both ranks elsewhere."""

    tmodel, _, _ = twin
    ranks = runs[2]
    cut = 0
    for name, p in tmodel.named_parameters():
        blocks = [torch.as_tensor(r[f"a/param/{name}"]) for r in ranks]
        if blocks[0].shape == p.shape:
            assert all(torch.equal(b, p) for b in blocks), name
            continue
        dim = next(i for i, (a, b) in enumerate(zip(blocks[0].shape, p.shape)) if a != b)
        assert torch.equal(torch.cat(blocks, dim), p), name
        cut += 1
    assert cut == 2 + 7 * tmodel.cfg.num_layers  # table, lm_head; wq wk wv wo up gate down


def _jax_layer(jparams):
    return jax.tree.map(lambda a: a[0], jparams["unit"][0])


def _want(twin, case, inp):
    """The JAX function of ``case`` on ``inp`` -> {record name: array}."""

    tmodel, jmodel, jparams = twin
    cfg = jmodel.cfg
    p0 = _jax_layer(jparams)
    if case == "mlp":
        return {"a/mlp": jlayers.mlp(jnp.asarray(inp["mlp_x"]), p0["mlp"], cfg.mlp_activation,
                                     cfg.gated_mlp)}
    if case == "prefill":
        x = jnp.asarray(inp["attn_x"])
        b, s, _ = x.shape
        pos = jnp.arange(s)[None]
        hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
        k = jattn.rope((x @ p0["attn"]["wk"]).reshape(b, s, kv, hd), pos, cfg.rope_theta)
        v = (x @ p0["attn"]["wv"]).reshape(b, s, kv, hd)
        return {"a/prefill": jattn.attention_forward(x, p0["attn"], cfg, False, pos, 0),
                "a/prefill_k": k, "a/prefill_v": v}
    if case == "paged":
        b, page, maxp = PAGED["b"], PAGED["page"], PAGED["maxp"]
        shape = (b * maxp + 1, page, cfg.num_kv_heads, cfg.resolved_head_dim)
        table = jnp.asarray(inp["table"])
        full = jnp.full((b,), maxp * page, jnp.int32)
        kp, vp = (jax_scatter(jnp.zeros(shape), jnp.asarray(inp[n]), table, full)
                  for n in ("ck", "cv"))
        out, kp, _ = jattn.attention_decode_step_paged(
            jnp.asarray(inp["step_x"]), p0["attn"], cfg, kp, vp, table,
            jnp.asarray(inp["lens"]), full, 0)
        return {"a/paged": out, "a/paged_kp": kp}
    if case == "embed":
        toks = jnp.asarray(inp["tokens"])
        return {f"a/embed_{16 * s}": jlayers.embed_lookup(toks, jparams["embed"], cfg.d_model,
                                                          bool(s)).astype(jnp.float32)
                for s in (0, 1)}
    return {"a/logits": jmodel._logits(jparams, jnp.asarray(inp["logits_x"]))}


# a record's KV-head axis (a rank holds its block of the KV heads there)
KV_AXIS = {"a/prefill_k": 2, "a/prefill_v": 2, "a/paged_kp": 2}


@pytest.mark.parametrize("case", ["mlp", "prefill", "paged", "embed", "logits"])
def test_layers_match_reference(runs, twin, case):
    """(a) Each rank's output of the layer against the JAX function on the
    same numpy inputs, 1e-5; a rank's K/V (prefill) and pool (paged) are
    its block of the reference's KV heads; ``embed_lookup`` bit for bit
    (the ids of one vocab block come from one rank, the other adds zeros)."""

    inp = layer_inputs(twin[0].cfg)
    ranks = runs[2]
    for key, want in _want(twin, case, inp).items():
        want = np.asarray(want)
        for r, rec in enumerate(ranks):
            got = rec[key]
            if key in KV_AXIS:
                n = got.shape[KV_AXIS[key]]
                want_r = np.take(want, range(r * n, (r + 1) * n), axis=KV_AXIS[key])
                np.testing.assert_allclose(got, want_r, atol=ATOL, rtol=RTOL, err_msg=key)
            elif case == "embed":
                np.testing.assert_array_equal(got, want, err_msg=f"{key} rank {r}")
            else:
                np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                           err_msg=f"{key} rank {r}")
    # one all-reduce a layer output and each lookup, one gather for the logits
    for rec in ranks:
        np.testing.assert_array_equal(rec["a/collectives"], [5, 1])


# ---------------------------------------------------------------------------
# (b)-(e) the engine and the fleet against the reference's meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIO))
def test_engine_matches_reference_mesh(runs, name):
    """(b) tp42, (c) sc24 (2 KV heads over 4 ranks: every rank keeps both,
    its pool one), (d) gm42: the ranks' engine against the reference's
    engine on the same (data, model) mesh."""

    _, arch, data, model_axis, n, seed = SCENARIO[name]
    ref = runs["ref"]
    rec = runs[model_axis][0]
    for key in ("results", "reserved", "pool", "counters"):
        np.testing.assert_array_equal(rec[f"{name}/{key}"], ref[f"{name}/{key}"], err_msg=key)
    st = one_rank(ref, arch)
    rng = np.random.default_rng(seed)
    obs = [obs_pair(rng) for _ in range(n)]
    for row, want, got in zip(ref[f"{name}/results"], ref[f"{name}/tokens"],
                              rec[f"{name}/tokens"]):
        assert_tokens_match(st, _obs_tokens(st.tok, *obs[row[0]]), want, got, f"robot {row[0]}")
    cfg = st.tmodel.cfg
    kv = cfg.num_kv_heads // model_axis or 1
    assert tuple(rec[f"{name}/pool_shape"][-2:]) == (kv, cfg.resolved_head_dim)
    assert bytes(rec[f"{name}/round_mode"]).decode() == f"eager, {model_axis} ranks over gloo"
    assert rec[f"{name}/pool"][0] == 0 and len(rec[f"{name}/pool"]) == 2 + 2 * data


def test_fleet_matches_reference_mesh(runs):
    """(e) ``serve_fleet(trigger="rapid")`` on 2 ranks over a (4, 2) rank
    mesh against the reference's fleet on (4, 2): every action, offload,
    service round, cancel and round count; its cancels are exercised."""

    ref = runs["ref"]
    rec = runs[TP_FLEET["model"]][0]
    for key in FLEET_KEYS:
        np.testing.assert_array_equal(rec[f"fleet42/{key}"], ref[f"fleet42/{key}"], err_msg=key)
    assert bytes(rec["fleet42/trigger"]).decode() == "rapid" and rec["fleet42/cancelled"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_equal(runs, world):
    """(f) Every rank records the same outputs, tokens and engine state
    (its parameter blocks aside)."""

    ranks = runs[world]
    keys = [k for k in ranks[0] if not k.startswith("a/param/") and k not in KV_AXIS]
    assert keys and all(set(r) == set(ranks[0]) for r in ranks)
    for r, rec in enumerate(ranks[1:], 1):
        for k in keys:
            np.testing.assert_array_equal(rec[k], ranks[0][k], err_msg=f"{k} rank {r}")


# ---------------------------------------------------------------------------
# what the model axis refuses; the rank mesh and collectives alone
# ---------------------------------------------------------------------------


def stub_group(rank, size):
    """A ``ModelGroup`` with no process group: enough to build a rank's
    model and mesh, and for what is refused before any collective."""

    return dist.ModelGroup(rank, size, "gloo", CPU, (CPU,) * size)


@pytest.mark.parametrize("arch,ranks,item", [
    ("qwen3-moe-235b-a22b", 2, "item 1"), ("phi3.5-moe-42b-a6.6b", 2, "item 1"),
    ("jamba-1.5-large-398b", 2, "item 2"), ("xlstm-125m", 2, "item 3"),
    ("seamless-m4t-medium", 2, "item 3"), ("openvla-7b", 8, "heads"),
    ("starcoder2-3b", 3, "heads"),
])
def test_model_axis_refusals(arch, ranks, item):
    """A stack the ranks cannot run yet raises, naming its ROADMAP queue."""

    cfg = get_smoke_config(arch).replace(dtype="float32")
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue I.*{item}|{item}.*ROADMAP"):
        Model(cfg, device="cpu", group=stub_group(0, ranks))


def test_rank_model_refuses_training_and_split_lanes():
    model = Model(get_smoke_config("openvla-7b").replace(dtype="float32"), device="cpu",
                  group=stub_group(1, 2))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "labels": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="ROADMAP queue I"):
        model.loss_fn(batch)
    with pytest.raises(NotImplementedError, match="ROADMAP queue I"):
        PartitionExecutor(model, 1)
    sched = ContinuousBatchingScheduler(model, EpisodeTokenizer(model.cfg.vocab_size),
                                        mesh=make_rank_mesh(1, model.group))
    assert not model.graphs and sched.round_mode == "eager, 2 ranks over gloo"
    assert sched._vdim == 1024 and sched._pcache["kp"].shape[-2] == 2


def test_rank_mesh_and_local_slice():
    """Column m of a rank mesh is rank m's device once a data shard; a
    rank's block of a tensor by ``logical_to_pspec``, whose guard keeps a
    dim that does not divide whole."""

    g = dist.ModelGroup(1, 2, "nccl", torch.device("cuda", 1),
                        (torch.device("cuda", 0), torch.device("cuda", 1)))
    mesh = make_rank_mesh(3, g)
    assert mesh.shape == {"data": 3, "model": 2} and mesh.group is g and mesh.rank == 1
    assert [str(d) for d in mesh.devices[:, 1]] == ["cuda:1"] * 3
    assert [str(d) for d in mesh.devices[:, 0]] == ["cuda:0"] * 3
    t = torch.arange(6 * 4).reshape(6, 4)
    spec = logical_to_pspec(t.shape, ("vocab", "embed"), mesh)
    assert spec == P("model", None)
    assert torch.equal(local_slice(t, spec, mesh, 1), t[3:])
    odd = torch.arange(5 * 4).reshape(5, 4)
    assert torch.equal(local_slice(odd, logical_to_pspec(odd.shape, ("vocab", "embed"), mesh),
                                   mesh, 1), odd)
    with pytest.raises(ValueError, match="model-axis block only"):
        local_slice(t, P(("data", "model"), None), mesh, 0)


def test_collectives_of_one_rank_are_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    one = dist.init_model_group(0, 1, backend="gloo", device="cpu")
    assert one.pg is None and one.size == 1
    for g in (None, one):
        assert dist.all_reduce_sum(x, g) is x and dist.all_gather_cat(x, -1, g) is x
    with pytest.raises(ValueError, match="backend"):
        dist.init_model_group(0, 2, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="NCCL rank needs a CUDA device"):
        dist.init_model_group(0, 2, backend="nccl", device="cpu")


def test_graphed_call_counts_collectives_at_replay(monkeypatch):
    """An NCCL group's round captured in a CUDA graph: the capture's
    collectives are taken back and each replay adds them, as the kernel
    launches are (the fake graph re-runs nothing)."""

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(dist, "CALLS", {"all_reduce": 0, "all_gather": 0})

    def fn():
        dist.CALLS["all_reduce"] += 17
        dist.CALLS["all_gather"] += 1
        if _FakeGraph.current is not None:
            _FakeGraph.current.fn = lambda: None
        return "out"

    call = graphs.GraphedCall(fn)
    assert call() == "out" and call.collectives == {"all_reduce": 17, "all_gather": 1}
    assert dist.CALLS == {"all_reduce": 17, "all_gather": 1}
    for _ in range(3):
        assert call() == "out"
    assert dist.CALLS == {"all_reduce": 68, "all_gather": 4} and call.launches == {}


def test_mesh_of_one_process_has_no_group():
    mesh = Mesh(np.asarray([CPU, CPU], dtype=object).reshape(2, 1), ("data", "model"))
    assert mesh.group is None and mesh.rank == 0
