"""The mesh's ``model`` axis: the port's tensor-parallel ranks against the
JAX package's model-axis meshes.

A module fixture writes the f32 smoke stacks' weights (the port's one-rank
``Model.init``, in the reference's layout), then runs side by side: the
reference in two processes of its own on 8 forced host devices
(``tests/torch_sharded_ref.py --model-axis --params``: ``--part engine``,
its engine on f32 openvla-smoke over (data 4, model 2), starcoder2-smoke
over (2, 4), gemma2-smoke over (4, 2), jamba-smoke over (4, 2),
qwen3-moe-smoke over (2, 4) and phi3.5-moe-smoke under the capacity
dispatch over (4, 2); ``--part fleet``, ``serve_fleet(trigger="rapid")``
on openvla-smoke over (4, 2)), and the port's ranks: 2 CPU ranks and 4
CPU ranks, each a process of ``tests/torch_model_axis_rank.py`` in a gloo
group over a file store.  Each process has a limit of its own
(``REF_TIMEOUT_S``, ``SPAWN_TIMEOUT_S``) and is killed past it.  The
ranks' records are held to:

(a) the JAX functions on the same numpy inputs, for 2-rank f32
    openvla-smoke and jamba-smoke built by ``Model.init`` (the reference
    gets the one-rank port model's weights): the MLP, prefill attention and
    its K/V, a paged decode step and the pool it writes, ``embed_lookup``
    (bit for bit) and the logits; jamba-smoke's MoE layer under both
    dispatches, a Mamba prefill and a Mamba step with their states (a
    rank's block of the heads and channels); at ``ATOL`` = ``RTOL`` =
    1e-5, each case's collectives exact; the ranks' parameter blocks put
    together (Mamba's ``in_proj`` half by half) equal the one-rank weights
    bit for bit, for those two and the MoE stacks;
(b)-(d) the reference's engine on its mesh (``tp42``, ``sc24`` with
    starcoder2's 2 KV heads over 4 ranks, ``gm42`` with gemma2's tied
    table, softcaps and windows, ``jb42``, ``qm24`` with qwen3-moe's 2 KV
    heads over 4 ranks, ``pc42`` with its capacity drops): results,
    rounds, every reservation, the final ``PoolStats`` and counters equal;
    tokens equal or differing only past a near-tie (the greedy-margin
    rule); ``jb42``'s collectives exact from its layer kinds, and a rank
    that skips the Mamba ``out_proj`` or the MoE all-reduce is caught;
(e) the reference's rapid fleet on (4, 2): ``actions``, ``offloads``,
    ``service_rounds``, ``cancelled``, ``trigger`` and the round counts;
(f) every rank's records equal.

Then what the model axis refuses, what it builds, and the rank mesh and
collectives without processes.
"""

import os
import subprocess
import sys
import time
from functools import lru_cache
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.runtime.kv_cache import scatter_prompt_into_pool as jax_scatter  # noqa: E402
from repro_torch.checkpoint.bridge import load_reference_params, reference_tensors  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
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
    SMOKE_LAYERS,
    TP_FLEET,
    TP_SCENARIOS,
    obs_pair,
)
from torch_model_axis_rank import (  # noqa: E402
    BLOCK_AXIS,
    INIT_ARCHS,
    PAGED,
    hybrid_inputs,
    layer_inputs,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
REF_TIMEOUT_S = 300
SPAWN_TIMEOUT_S = 240
WORLDS = (2, 4)
REF_PARTS = ("engine", "fleet")
ATOL = RTOL = 1e-5
SCENARIO = {s[0]: s for s in TP_SCENARIOS}
JAMBA = "jamba-1.5-large-398b"


def smoke(arch):
    return get_smoke_config(arch).replace(num_layers=SMOKE_LAYERS, dtype="float32")


# ---------------------------------------------------------------------------
# the weights, then the reference and the ranks side by side
# ---------------------------------------------------------------------------


def launch(cmd, env, log_path):
    """``cmd`` in a process of its own, its output to ``log_path``."""

    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    return proc, log_path


def finish(procs, limit_s, start):
    """Wait for ``{name: (process, log path)}`` until ``limit_s`` after
    ``start`` (the fixture kills what is left); a process that fails or
    outlasts it fails the fixture with its log's tail."""

    for name, (proc, log_path) in procs.items():
        try:
            proc.wait(timeout=max(start + limit_s - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{name} not done in {limit_s} s: killed") from None
        log = Path(log_path).read_text()
        assert proc.returncode == 0, f"{name}: exit {proc.returncode}\n{log[-4000:]}"


def start_ranks(world, params_path, out_dir):
    """``world`` gloo ranks of ``torch_model_axis_rank.py``."""

    out_dir.mkdir()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    script = ROOT / "tests" / "torch_model_axis_rank.py"
    return {f"rank {r} of {world}": launch(
        [sys.executable, str(script), str(r), str(world), str(out_dir / "store"),
         str(params_path), str(out_dir)], env, out_dir / f"rank{r}.log")
        for r in range(world)}


def load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's records and the weights, 2: [rank records],
    4: [...]}."""

    tmp = tmp_path_factory.mktemp("model_axis")
    params_path = tmp / "params.npz"
    weights = {}
    for arch in dict.fromkeys(s[1] for s in TP_SCENARIOS):
        weights.update({f"params/{arch}/{k}": v.numpy() for k, v in
                        reference_tensors(Model(smoke(arch), device="cpu")).items()})
    np.savez(params_path, **weights)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
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


def one_rank(ref, arch, moe_impl="dense"):
    """The one-rank port model of ``arch`` on the reference's weights, and
    its tokenizer (the greedy-margin rule's model)."""

    model = Model(smoke(arch), device="cpu", moe_impl=moe_impl)
    pre = f"params/{arch}/"
    load_reference_params(model, {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    return SimpleNamespace(tmodel=model, tok=EpisodeTokenizer(model.cfg.vocab_size))


# ---------------------------------------------------------------------------
# (a) the layers of a 2-rank model built by Model.init
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def twin(arch):
    """The one-rank f32 smoke stack ``arch`` of ``Model.init`` and the
    reference's model on its weights -> (port model, jax model, jax
    params)."""

    tmodel = Model(smoke(arch), device="cpu")
    jmodel = JaxModel(jax_smoke(arch).replace(num_layers=SMOKE_LAYERS, dtype="float32",
                                              param_dtype="float32"))
    flat = {k: v.numpy() for k, v in reference_tensors(tmodel).items()}
    template = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(flat["/".join(_path_str(q) for q in path)]), template)
    return tmodel, jmodel, jparams


def in_proj_halves(blocks):
    """Mamba ``in_proj`` blocks [D, 2 d_in / M] put together: each rank's
    x half, then each rank's z half."""

    halves = [torch.chunk(b, 2, dim=1) for b in blocks]
    return torch.cat([h[0] for h in halves] + [h[1] for h in halves], 1)


# parameters the rules cut over 2 ranks: the vocab's two, then a layer's
# attention (wq wk wv wo) or Mamba (in_proj, conv_w, dt_proj, bc_proj,
# dt_bias, a_log, d_skip, out_proj) and its MLP or experts (up gate down)
CUT = {"openvla-7b": 2 + 2 * (4 + 3), JAMBA: 2 + (8 + 3) + (4 + 3),
       "qwen3-moe-235b-a22b": 2 + 2 * (4 + 3), "phi3.5-moe-42b-a6.6b": 2 + 2 * (4 + 3)}


@pytest.mark.parametrize("arch", INIT_ARCHS)
def test_rank_blocks_are_the_one_rank_weights(runs, arch):
    """Each parameter's two blocks put together are the one-rank model's
    tensor bit for bit: cut where the rules cut it (heads, KV heads, mlp,
    vocab, Mamba's state and heads; every expert's mlp block; ``in_proj``
    half by half), whole on both ranks elsewhere (the router, the norms)."""

    tmodel = twin(arch)[0]
    ranks = runs[2]
    cut = 0
    for name, p in tmodel.named_parameters():
        blocks = [torch.as_tensor(r[f"a/param/{arch}/{name}"]) for r in ranks]
        if blocks[0].shape == p.shape:
            assert all(torch.equal(b, p) for b in blocks), name
            continue
        if name.endswith("mamba.in_proj"):
            whole = in_proj_halves(blocks)
            assert not torch.equal(torch.cat(blocks, 1), p), name
        else:
            dim = next(i for i, (a, b) in enumerate(zip(blocks[0].shape, p.shape)) if a != b)
            whole = torch.cat(blocks, dim)
        assert torch.equal(whole, p), name
        cut += 1
    assert cut == CUT[arch]


def _jax_layer(jparams, unit=0):
    return jax.tree.map(lambda a: a[0], jparams["unit"][unit])


def _want(case, inp):
    """The JAX function of ``case`` on ``inp`` -> {record name: array}."""

    if case in ("moe", "moe_capacity", "mamba_prefill", "mamba_step"):
        return _want_hybrid(case, inp)
    tmodel, jmodel, jparams = twin("openvla-7b")
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


def _want_hybrid(case, inp):
    """jamba-smoke's cases: layer 1's MoE, layer 0's Mamba."""

    _, jmodel, jparams = twin(JAMBA)
    cfg = jmodel.cfg
    if case.startswith("moe"):
        fn = jmoe.moe_forward_capacity if case == "moe_capacity" else jmoe.moe_forward
        out, aux = fn(jnp.asarray(inp["moe_x"]), _jax_layer(jparams, 1)["moe"], cfg)
        return {f"a/{case}": out, f"a/{case}_aux": aux}
    p0 = _jax_layer(jparams)["mamba"]
    if case == "mamba_prefill":
        out, st = jssm.mamba_forward(jnp.asarray(inp["mamba_x"]), p0, cfg)
    else:
        state = {"h": jnp.asarray(inp["h"]), "conv": jnp.asarray(inp["conv"])}
        out, st = jssm.mamba_decode_step(jnp.asarray(inp["step_x"]), p0, cfg, state)
    return {f"a/{case}": out, f"a/{case}_h": st["h"], f"a/{case}_conv": st["conv"]}


# each case's collectives [all-reduce, all-gather]: one all-reduce an MoE
# layer's output, two a Mamba layer (dt / B / C, then out_proj)
CASE_CALLS = {"moe": [1, 0], "moe_capacity": [1, 0], "mamba_prefill": [2, 0],
              "mamba_step": [2, 0]}


@pytest.mark.parametrize("case", ["mlp", "prefill", "paged", "embed", "logits", "moe",
                                  "moe_capacity", "mamba_prefill", "mamba_step"])
def test_layers_match_reference(runs, case):
    """(a) Each rank's output of the layer against the JAX function on the
    same numpy inputs, 1e-5; a rank's K/V (prefill) and pool (paged) are
    its block of the reference's KV heads, and a Mamba layer's state its
    block of the heads (``h``) and channels (``conv``; the step starts from
    the rank's block of a given state); ``embed_lookup`` bit for bit (the
    ids of one vocab block come from one rank, the other adds zeros)."""

    hybrid = case in CASE_CALLS
    inp = hybrid_inputs(smoke(JAMBA)) if hybrid else layer_inputs(smoke("openvla-7b"))
    ranks = runs[2]
    for key, want in _want(case, inp).items():
        want = np.asarray(want)
        for r, rec in enumerate(ranks):
            got = rec[key]
            if key in BLOCK_AXIS:
                n = got.shape[BLOCK_AXIS[key]]
                want_r = np.take(want, range(r * n, (r + 1) * n), axis=BLOCK_AXIS[key])
                np.testing.assert_allclose(got, want_r, atol=ATOL, rtol=RTOL, err_msg=key)
            elif case == "embed":
                np.testing.assert_array_equal(got, want, err_msg=f"{key} rank {r}")
            else:
                np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                           err_msg=f"{key} rank {r}")
    for rec in ranks:
        if hybrid:
            np.testing.assert_array_equal(rec[f"a/calls/{case}"], CASE_CALLS[case])
        else:
            # one all-reduce a layer output and each lookup, one gather for the logits
            np.testing.assert_array_equal(rec["a/collectives"], [5, 1])


# ---------------------------------------------------------------------------
# (b)-(e) the engine and the fleet against the reference's meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIO))
def test_engine_matches_reference_mesh(runs, name):
    """(b) tp42, (c) sc24 (2 KV heads over 4 ranks: every rank keeps both,
    its pool one), (d) gm42, jb42 (Mamba and MoE layers), qm24 (qwen3-moe's
    2 KV heads over 4 ranks), pc42 (the capacity dispatch, whose drops see
    every row): the ranks' engine against the reference's engine on the
    same (data, model) mesh."""

    _, arch, data, model_axis, n, seed, impl = SCENARIO[name]
    ref = runs["ref"]
    rec = runs[model_axis][0]
    for key in ("results", "reserved", "pool", "counters"):
        np.testing.assert_array_equal(rec[f"{name}/{key}"], ref[f"{name}/{key}"], err_msg=key)
    st = one_rank(ref, arch, impl)
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


def per_token_collectives(cfg, prompt: int = 1):
    """[all-reduces, all-gathers] of one decode token (``prompt`` = 1) or a
    prefill of ``prompt`` tokens of a rank of ``cfg``, from its layer kinds
    (``launch.dist.collectives``)."""

    return list(dist.collectives(cfg, prompt).values())


def test_jamba_collectives_per_token(runs):
    """jb42's engine run on 2 ranks: its collectives are exactly
    ``per_token_collectives`` for each admission's prefill and each
    decode token (6 all-reduces and 1 all-gather at 2 layers)."""

    want = per_token_collectives(smoke(JAMBA))
    assert want == [6, 1]
    for rec in runs[2]:
        all_reduce, all_gather, admits, steps = rec["jb42/collectives"]
        assert admits > 0 and steps > 0
        assert [all_reduce, all_gather] == [n * (admits + steps) for n in want]


@pytest.mark.parametrize("control", ["skip_out_proj", "skip_moe"])
def test_skip_collective_controls_caught(runs, control):
    """jb42's first prompt on 2 ranks: its logits within ``ATOL`` of the
    one-rank model's; a rank that skips the Mamba ``out_proj`` all-reduce
    (or the MoE layer's) in every layer misses it."""

    ref = runs["ref"]
    st = one_rank(ref, JAMBA)
    seed = SCENARIO["jb42"][5]
    prompt = np.concatenate([st.tok.encode_state(q)
                             for q in obs_pair(np.random.default_rng(seed))], axis=1)
    with torch.no_grad():
        want = st.tmodel.prefill({"tokens": torch.as_tensor(prompt)})[0][0, -1].numpy()
    for rec in runs[2]:
        np.testing.assert_allclose(rec["jb42/logits"], want, atol=ATOL, rtol=RTOL)
        assert not np.allclose(rec[f"jb42/{control}"], want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_equal(runs, world):
    """(f) Every rank records the same outputs, tokens and engine state
    (its parameter blocks aside)."""

    ranks = runs[world]
    keys = [k for k in ranks[0] if not k.startswith("a/param/") and k not in BLOCK_AXIS]
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


@pytest.mark.parametrize("arch,ranks,item,smoke_cfg", [
    ("xlstm-125m", 3, "heads", False), ("seamless-m4t-medium", 3, "heads", False),
    ("xlstm-125m", 4, "d_up 170", True),
    ("openvla-7b", 8, "heads", True), ("starcoder2-3b", 3, "heads", True),
])
def test_model_axis_refusals(arch, ranks, item, smoke_cfg):
    """A stack the ranks cannot run raises before any collective, naming
    its ROADMAP queue: heads that do not divide (xlstm-125m's 4 and
    seamless-m4t-medium's 16 over 3 ranks), xlstm-smoke's sLSTM GLU width
    (170) over 4 ranks."""

    cfg = (get_smoke_config(arch) if smoke_cfg else get_config(arch)).replace(dtype="float32")
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue I.*{item}|{item}.*ROADMAP"):
        Model(cfg, device="cpu", group=stub_group(0, ranks))


def test_model_axis_refuses_mamba_heads_that_do_not_divide():
    """jamba-smoke at d_model 320 has 10 Mamba heads (d_in 640 / 64): its
    4 attention heads and 2 KV heads divide over 4 ranks, its Mamba heads
    do not."""

    cfg = get_smoke_config(JAMBA).replace(dtype="float32", d_model=320)
    with pytest.raises(NotImplementedError, match="10 Mamba heads.*item 2"):
        Model(cfg, device="cpu", group=stub_group(0, 4))
    Model(cfg, device="cpu", group=stub_group(0, 2))  # 5 a rank


# (arch, ranks, dispatch): each stack the model axis serves since MoE and
# Mamba layers run on it
BUILDS = [(JAMBA, 2, "dense"), ("qwen3-moe-235b-a22b", 4, "dense"),
          ("phi3.5-moe-42b-a6.6b", 2, "capacity")]


@pytest.mark.parametrize("arch,ranks,impl", BUILDS)
def test_rank_model_builds(arch, ranks, impl):
    """A rank of each MoE or Mamba stack builds (its ``check_model_axis``
    passes) with its blocks: every expert's ``d_ff / M`` columns, all E
    experts and the whole router; a Mamba layer's heads and channels, its
    state and caches at the rank's sizes; the scheduler runs over a rank
    mesh (eager, gloo)."""

    cfg = get_smoke_config(arch).replace(dtype="float32")
    group = stub_group(ranks - 1, ranks)
    model = Model(cfg, device="cpu", group=group, moe_impl=impl)
    e, f, d = cfg.moe.num_experts, cfg.d_ff // ranks, cfg.d_model
    d_in = cfg.ssm.expand * d if cfg.ssm else 0
    nh = d_in // 64  # the SSD heads of 64 channels
    for blk in model.layers:
        if hasattr(blk, "moe"):
            assert blk.moe.tp is group and blk.moe.router.shape == (d, e)
            assert blk.moe.up.shape == blk.moe.gate.shape == (e, d, f)
            assert blk.moe.down.shape == (e, f, d)
        if hasattr(blk, "mamba"):
            mb = blk.mamba
            assert mb.tp is group and (mb.n_heads, mb.d_in) == (nh // ranks, d_in // ranks)
            assert mb.in_proj.shape == (d, 2 * mb.d_in) and mb.a_log.shape == (mb.n_heads,)
            assert mb.dt_proj.shape == (mb.d_in, nh) and mb.out_proj.shape == (mb.d_in, d)
    sched = ContinuousBatchingScheduler(model, EpisodeTokenizer(cfg.vocab_size),
                                        mesh=make_rank_mesh(2, group))
    assert sched.round_mode == f"eager, {ranks} ranks over gloo"
    if model.n_mamba:
        h, conv = sched._pcache["h"], sched._pcache["conv"]
        assert h.shape == (model.n_mamba, sched.rows, nh // ranks, 64, cfg.ssm.state_dim)
        assert conv.shape == (model.n_mamba, sched.rows, cfg.ssm.conv_width - 1, d_in // ranks)
        dense = model.init_cache(3, 4)
        assert dense["h"].shape[2:] == h.shape[2:] and dense["conv"].shape[2:] == conv.shape[2:]


@pytest.mark.parametrize("impl", ["dense", "capacity"])
def test_collectives_per_token_from_layer_kinds(monkeypatch, impl):
    """A rank of jamba-smoke (4 layers: mamba + MLP, attn + MoE, twice)
    issues exactly ``per_token_collectives`` (11 all-reduces, 1 all-gather)
    for a prefill and for each decode step, under both dispatches (the
    collectives are counted, not run: ``torch.distributed`` is stubbed)."""

    import torch.distributed as tdist

    monkeypatch.setattr(tdist, "all_reduce", lambda x, group=None: None)
    monkeypatch.setattr(tdist, "all_gather",
                        lambda parts, x, group=None: [t.copy_(x) for t in parts])
    monkeypatch.setattr(dist, "CALLS", {"all_reduce": 0, "all_gather": 0})
    cfg = get_smoke_config(JAMBA).replace(dtype="float32")
    want = per_token_collectives(cfg)
    assert want == [11, 1]
    model = Model(cfg, device="cpu", group=stub_group(0, 2), moe_impl=impl)
    logits, cache = model.prefill({"tokens": torch.zeros((2, 5), dtype=torch.long)}, extra=3)
    assert list(dist.CALLS.values()) == want
    for step in range(1, 4):
        logits, cache = model.decode_step(logits[:, -1].argmax(-1, keepdim=True), cache)
        assert list(dist.CALLS.values()) == [n * (step + 1) for n in want]


def test_rank_model_refuses_training_and_split_lanes():
    """A rank's model refuses training; its split lanes attach (they are
    served over the model axis), the suffix pool at the rank's KV heads."""

    model = Model(get_smoke_config("openvla-7b").replace(dtype="float32"), device="cpu",
                  group=stub_group(1, 2))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "labels": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="ROADMAP queue I"):
        model.loss_fn(batch)
    sched = ContinuousBatchingScheduler(model, EpisodeTokenizer(model.cfg.vocab_size),
                                        mesh=make_rank_mesh(1, model.group))
    assert not model.graphs and sched.round_mode == "eager, 2 ranks over gloo"
    assert sched._vdim == 1024 and sched._pcache["kp"].shape[-2] == 2
    ex = PartitionExecutor(model, 1)
    sched.attach_partition(ex)
    assert sched._lanes[1].ex is ex and ex.init_layer_pool(sched.paged_spec)["kp"].shape[-2] == 2


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
