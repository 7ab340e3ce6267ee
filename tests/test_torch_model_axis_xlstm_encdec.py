"""The mesh's ``model`` axis under the xLSTM and encoder-decoder stacks: the
port's tensor-parallel ranks of f32 xlstm-smoke and seamless-smoke (at
``SMOKE_LAYERS``) against the JAX package's model-axis meshes.

A module fixture writes the stacks' weights (the port's one-rank
``Model.init``, in the reference's layout, ``AXIS_STACKS``), then runs side
by side: the reference in two processes of its own on 8 forced host
devices (``tests/torch_sharded_ref.py --model-axis --params``: ``--part
xlstm``, its engine on xlstm-smoke over (data 4, model 2) and on
xlstm-wide, whose widths divide over 4 ranks, over (2, 4); ``--part
encdec``, seamless-smoke's ``prefill`` and ``decode_chunk`` jitted under
``sharding_rules`` of (4, 2) and (2, 4) meshes in four modes, dense or
paged cache x cross K/V projected each token or cached), and the port's
ranks: 2 and 4 CPU ranks, each a process of
``tests/torch_model_axis_rank.py ... xlstm_encdec`` in a gloo group over a
file store.  Each process has a limit of its own (``REF_TIMEOUT_S``,
``SPAWN_TIMEOUT_S``) and is killed past it.  The ranks' records are held
to:

(a) the JAX layer functions on the same numpy inputs, for 2-rank models
    built by ``Model.init`` (the reference gets the one-rank port model's
    weights): an mLSTM block chunked and stepped, an sLSTM block over a
    prompt and stepped, each with its state (the rank's block of the
    mLSTM heads and of the sLSTM units; the sLSTM's h whole), the
    encoder's attention, the cross-attention over a prompt with its K/V,
    cached and uncached; ``ATOL`` = ``RTOL`` = 1e-5, each case's
    collectives exact;
(b) the ranks' parameter blocks put together, part by part where a
    parameter is fused (``models.model._PARTS``), are the one-rank
    weights bit for bit;
(c) the reference's engine on xlstm-smoke over (4, 2) and xlstm-wide over
    (2, 4): results, rounds, reservations, the final ``PoolStats`` and
    counters equal; tokens equal or differing only past a near-tie (the
    greedy-margin rule); the rank's recurrent state at its sizes;
(d) the reference's seamless-smoke on (4, 2) and (2, 4) in the four
    modes: logits to ``LOGIT_ATOL`` (2e-5, as ``tests/test_torch_encdec.py``
    holds them), greedy tokens equal, the padded vocab masked after the
    logits' blocks are gathered;
(e) the collectives of every prefill and decode token, exactly, from the
    layer kinds;
(f) controls: a rank that skips the sLSTM's h all-gather, and one that
    skips the cross-attention's ``wo`` all-reduce, are caught;
(g) every rank's records equal.
"""

import os
import sys
import time
from functools import lru_cache
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
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.checkpoint.bridge import load_reference_params, reference_tensors  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import EpisodeTokenizer  # noqa: E402
from repro_torch.launch import dist  # noqa: E402
from repro_torch.models.model import _PARTS, Model  # noqa: E402

from test_torch_model_axis import (  # noqa: E402
    ROOT,
    finish,
    launch,
    load,
    per_token_collectives,
    stub_group,
)
from test_torch_scheduler import _obs_tokens, assert_tokens_match  # noqa: E402
from torch_model_axis_cases import (  # noqa: E402
    AXIS_STACKS,
    ENCDEC_MESHES,
    ENCDEC_MODES,
    ENCDEC_PLAN,
    SMOKE_LAYERS,
    XLSTM_SCENARIOS,
    encdec_batch,
    encdec_mode,
    obs_pair,
)
from torch_model_axis_rank import (  # noqa: E402
    BLOCK_AXIS,
    SLSTM_PROMPT,
    XE_INIT,
    axis_smoke,
    encdec_inputs,
    xlstm_inputs,
)

REF_TIMEOUT_S = 300
SPAWN_TIMEOUT_S = 240
WORLDS = (2, 4)
REF_PARTS = ("xlstm", "encdec")
ATOL = RTOL = 1e-5
LOGIT_ATOL = 2e-5
XLSTM, ENCDEC = "xlstm-125m", "seamless-m4t-medium"
XSCENARIO = {s[0]: s for s in XLSTM_SCENARIOS}
EMESH = {s[0]: s for s in ENCDEC_MESHES}


# ---------------------------------------------------------------------------
# the weights, then the reference and the ranks side by side
# ---------------------------------------------------------------------------


def start_ranks(world, params_path, out_dir):
    """``world`` gloo ranks of ``torch_model_axis_rank.py``'s
    ``xlstm_encdec`` part."""

    out_dir.mkdir()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    script = ROOT / "tests" / "torch_model_axis_rank.py"
    return {f"rank {r} of {world}": launch(
        [sys.executable, str(script), str(r), str(world), str(out_dir / "store"),
         str(params_path), str(out_dir), "xlstm_encdec"], env, out_dir / f"rank{r}.log")
        for r in range(world)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's records and the weights, 2: [rank records],
    4: [...]}."""

    tmp = tmp_path_factory.mktemp("model_axis_xe")
    params_path = tmp / "params.npz"
    weights = {}
    for key in AXIS_STACKS:
        weights.update({f"params/{key}/{k}": v.numpy() for k, v in
                        reference_tensors(Model(axis_smoke(key), device="cpu")).items()})
    np.savez(params_path, **weights)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    start = time.monotonic()
    refs = {f"reference {part}": launch(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_ref.py"),
         str(tmp / f"{part}.npz"), "--model-axis", "--part", part, "--params", str(params_path)],
        env, tmp / f"{part}.log") for part in REF_PARTS}
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


def one_rank(ref, key, cached=False):
    """The one-rank port model of stack ``key`` on the reference's weights
    and its tokenizer (the greedy-margin rule's model)."""

    model = Model(axis_smoke(key), device="cpu", cache_cross_kv=cached)
    pre = f"params/{key}/"
    load_reference_params(model, {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    return SimpleNamespace(tmodel=model, tok=EpisodeTokenizer(model.cfg.vocab_size))


# ---------------------------------------------------------------------------
# (a) the layers of a 2-rank model built by Model.init; (b) its blocks
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def twin(key):
    """The one-rank f32 smoke stack ``key`` of ``Model.init`` and the
    reference's model on its weights -> (port model, jax model, jax
    params)."""

    tmodel = Model(axis_smoke(key), device="cpu")
    arch, kw = AXIS_STACKS[key]
    jmodel = JaxModel(jax_smoke(arch).replace(num_layers=SMOKE_LAYERS, dtype="float32",
                                              param_dtype="float32", **kw))
    flat = {k: v.numpy() for k, v in reference_tensors(tmodel).items()}
    template = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(flat["/".join(_path_str(q) for q in path)]), template)
    return tmodel, jmodel, jparams


def whole(blocks, parts, dim):
    """Rank blocks put together along ``dim``, part by part: each rank's
    block of part 0, then each rank's block of part 1, ..."""

    split = [torch.chunk(b, parts, dim=dim) for b in blocks]
    return torch.cat([s[j] for j in range(parts) for s in split], dim)


# parameters a rank cuts: the vocab's two, then xlstm-smoke's mLSTM (7) and
# sLSTM (5) blocks, or seamless-smoke's decoder layers (attention 4, cross
# 4, MLP 2) and encoder layers (attention 4, MLP 2)
CUT = {"xlstm-125m": 2 + 7 + 5, "xlstm-wide": 2 + 7 + 5, ENCDEC: 2 + 2 * 10 + 2 * 6}


@pytest.mark.parametrize("key,world", [(key, w) for w in WORLDS for key in XE_INIT[w]])
def test_rank_blocks_are_the_one_rank_weights(runs, key, world):
    """(b) Each parameter's rank blocks put together are the one-rank
    model's tensor bit for bit: cut by heads (attention, cross-attention,
    mLSTM), units (sLSTM), mlp and vocab, each part of a fused parameter
    apart (``_PARTS``); whole on every rank elsewhere (the norms)."""

    tmodel = twin(key)[0]
    cut = 0
    for name, p in tmodel.named_parameters():
        blocks = [torch.as_tensor(r[f"a/param/{key}/{name}"]) for r in runs[world]]
        if blocks[0].shape == p.shape:
            assert all(torch.equal(b, p) for b in blocks), name
            continue
        dim = next(i for i, (a, b) in enumerate(zip(blocks[0].shape, p.shape)) if a != b)
        parts = _PARTS.get(name.split(".", 2)[-1], ())
        k = parts[dim] if parts else 1
        assert torch.equal(whole(blocks, k, dim), p), name
        if k > 1 and p.unique().numel() > 1:  # (the sLSTM's zero bias reads the same)
            assert not torch.equal(torch.cat(blocks, dim), p), name
        cut += 1
    assert cut == CUT[key]


def _jax_layer(jparams, tree="unit", unit=0, layer=0):
    return jax.tree.map(lambda a: a[layer], jparams[tree][unit])


def _want(case, inp):
    """The JAX function of ``case`` on ``inp`` -> {record name: array}."""

    if case.startswith(("mlstm", "slstm")):
        _, jmodel, jparams = twin(XLSTM)
        cfg = jmodel.cfg
        if case.startswith("mlstm"):
            p, names, x = _jax_layer(jparams, unit=0)["mlstm"], "Cnm", "mlstm"
            state = tuple(jnp.asarray(inp[n]) for n in ("mC", "mn", "mm"))
            fn = jxlstm.mlstm_forward
        else:
            p, names, x = _jax_layer(jparams, unit=1)["slstm"], "cnhm", "slstm"
            state = tuple(jnp.asarray(inp[n]) for n in ("sc", "sn", "sh", "sm"))
            fn = jxlstm.slstm_forward
        step = case.endswith("step")
        out, st = fn(jnp.asarray(inp[f"{x}_step_x" if step else f"{x}_x"]), p, cfg, state=state,
                     step=step)
        return {f"a/{case}": out, **{f"a/{case}_{n}": t for n, t in zip(names, st)}}
    _, jmodel, jparams = twin(ENCDEC)
    cfg = jmodel.cfg
    frames = ENCDEC_PLAN["frames"]
    fpos = jnp.arange(frames)[None]
    if case == "encoder":
        h = jnp.asarray(inp["enc_x"])
        p = _jax_layer(jparams, "enc_unit")["attn"]
        return {"a/encoder": jattn.attention_forward(h, p, cfg, None, fpos, 0,
                                                     kv_override=(h, fpos), chunked=True)}
    enc = jnp.asarray(inp["enc_out"])
    if case == "cross":
        x = jnp.asarray(inp["cross_x"])
        p = _jax_layer(jparams)["xattn"]
        hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
        shape = (enc.shape[0], frames, kv, hd)
        return {"a/cross": jattn.attention_forward(x, p, cfg, None, jnp.arange(x.shape[1])[None],
                                                   0, kv_override=(enc, fpos), chunked=True),
                "a/cross_k": (enc @ p["wk"]).reshape(shape),
                "a/cross_v": (enc @ p["wv"]).reshape(shape)}
    p = _jax_layer(jparams, layer=1)["xattn"]
    x = jnp.asarray(inp["token_x"])
    if case == "cross_cached":
        return {"a/cross_cached": jattn.cross_attention_cached(
            x, p, cfg, jnp.asarray(inp["xk"]), jnp.asarray(inp["xv"]))}
    return {"a/cross_uncached": jattn.attention_forward(
        x, p, cfg, None, jnp.full((x.shape[0], 1), 7), 0, kv_override=(enc, fpos))}


# each case's collectives [all-reduce, all-gather]: an mLSTM block gathers
# xi once, an sLSTM block h once a token; each sums its output once, as the
# encoder's attention and the cross-attention do
CASE_CALLS = {"mlstm_chunk": [1, 1], "mlstm_step": [1, 1], "slstm_prefill": [1, SLSTM_PROMPT],
              "slstm_step": [1, 1], "encoder": [1, 0], "cross": [1, 0], "cross_cached": [1, 0],
              "cross_uncached": [1, 0]}


@pytest.mark.parametrize("case", list(CASE_CALLS))
def test_layers_match_reference(runs, case):
    """(a) Each rank's output of the layer against the JAX function on the
    same numpy inputs, 1e-5; a rank's recurrent state is its block of the
    reference's (mLSTM heads; sLSTM units of c, n and m, h whole), the
    cross-attention's K/V its KV heads; each case's collectives exact."""

    xl = case.startswith(("mlstm", "slstm"))
    inp = (xlstm_inputs if xl else encdec_inputs)(axis_smoke(XLSTM if xl else ENCDEC))
    ranks = runs[2]
    for key, want in _want(case, inp).items():
        want = np.asarray(want)
        for r, rec in enumerate(ranks):
            got = rec[key]
            if key in BLOCK_AXIS:
                n = got.shape[BLOCK_AXIS[key]]
                want_r = np.take(want, range(r * n, (r + 1) * n), axis=BLOCK_AXIS[key])
                np.testing.assert_allclose(got, want_r, atol=ATOL, rtol=RTOL, err_msg=key)
            else:
                np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                           err_msg=f"{key} rank {r}")
    for rec in ranks:
        np.testing.assert_array_equal(rec[f"a/calls/{case}"], CASE_CALLS[case])
    if case == "slstm_prefill":  # h whole on a rank, c / n / m its units
        assert ranks[0]["a/slstm_prefill_h"].shape == (2, 128)
        assert ranks[0]["a/slstm_prefill_c"].shape == (2, 64)


# ---------------------------------------------------------------------------
# (c)-(e) the engine and seamless's prefill + decode_chunk on the meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(XSCENARIO))
def test_xlstm_engine_matches_reference_mesh(runs, name):
    """(c) xl42 (xlstm-smoke over 2 ranks, 4 data shards), xw24
    (xlstm-wide over 4 ranks, 2 data shards): the ranks' engine against
    the reference's engine on the same (data, model) mesh; each row's
    recurrent state at the rank's sizes (mLSTM heads, sLSTM units, h
    whole)."""

    _, key, data, model_axis, n, seed = XSCENARIO[name]
    ref = runs["ref"]
    rec = runs[model_axis][0]
    for k in ("results", "reserved", "pool", "counters"):
        np.testing.assert_array_equal(rec[f"{name}/{k}"], ref[f"{name}/{k}"], err_msg=k)
    st = one_rank(ref, key)
    rng = np.random.default_rng(seed)
    obs = [obs_pair(rng) for _ in range(n)]
    for row, want, got in zip(ref[f"{name}/results"], ref[f"{name}/tokens"],
                              rec[f"{name}/tokens"]):
        assert_tokens_match(st, _obs_tokens(st.tok, *obs[row[0]]), want, got, f"robot {row[0]}")
    cfg = st.tmodel.cfg
    d_in, nh = 2 * cfg.d_model, cfg.num_heads
    rows = rec[f"{name}/counters"][5]
    assert tuple(rec[f"{name}/shape_mC"]) == (1, rows, nh // model_axis, d_in // nh, d_in // nh)
    assert tuple(rec[f"{name}/shape_sc"]) == (1, rows, cfg.d_model // model_axis)
    assert tuple(rec[f"{name}/shape_sh"]) == (1, rows, cfg.d_model)
    assert bytes(rec[f"{name}/round_mode"]).decode() == f"eager, {model_axis} ranks over gloo"
    assert rec[f"{name}/pool"][0] == 0 and len(rec[f"{name}/pool"]) == 2 + 2 * data


ENCDEC_CASES = [(name, mode) for name in EMESH for mode in ENCDEC_MODES]


@pytest.mark.parametrize("name,mode", ENCDEC_CASES,
                         ids=[f"{n}-{encdec_mode(*m)}" for n, m in ENCDEC_CASES])
def test_encdec_matches_reference_mesh(runs, name, mode):
    """(d) seamless-smoke's ``prefill`` (+ ``cache_to_paged``) and a
    12-token ``decode_chunk`` on 2 (ed42) or 4 (ed24) ranks against the
    reference's under ``sharding_rules`` of the same mesh: the prefill's
    and the chunk's last logits to 2e-5, tokens equal; ``enc_out`` whole
    on a rank, the cached cross K/V its KV heads."""

    _, data, model_axis = EMESH[name]
    key = f"{name}/{encdec_mode(*mode)}"
    ref = runs["ref"]
    cfg = axis_smoke(ENCDEC)
    p = ENCDEC_PLAN
    for rec in runs[model_axis]:
        for part in ("prefill", "last"):
            np.testing.assert_allclose(rec[f"{key}/{part}"], ref[f"{key}/{part}"],
                                       atol=LOGIT_ATOL, rtol=0, err_msg=part)
        np.testing.assert_array_equal(rec[f"{key}/tokens"], ref[f"{key}/tokens"])
        assert tuple(rec[f"{key}/enc_out_shape"]) == (p["b"], p["frames"], cfg.d_model)
        if mode[0]:
            assert tuple(rec[f"{key}/xk_shape"]) == (
                cfg.num_layers, p["b"], p["frames"], cfg.num_kv_heads // model_axis,
                cfg.resolved_head_dim)


@pytest.mark.parametrize("name", list(EMESH))
def test_padded_vocab_masked_over_ranks(runs, name):
    """seamless-smoke's vocab of 514 pads to 768, which 2 and 4 ranks cut
    into vocab blocks of 384 and 192 (the padded ids span the last one or
    two): after the blocks are gathered, every padded id of the prefill's
    and the chunk's logits is masked (<= -1e8) on every rank, every valid
    one finite, and the chunk never picks a padded id."""

    cfg = axis_smoke(ENCDEC)
    model_axis = EMESH[name][2]
    for rec in runs[model_axis]:
        for mode in ENCDEC_MODES:
            key = f"{name}/{encdec_mode(*mode)}"
            for part in ("prefill", "last"):
                logits = rec[f"{key}/{part}"]
                assert logits.shape[-1] == 768
                assert (logits[..., cfg.vocab_size:] <= -1e8).all()
                assert np.isfinite(logits[..., :cfg.vocab_size]).all()
            assert (rec[f"{key}/tokens"] < cfg.vocab_size).all()


def test_full_configs_collectives_a_token():
    """A decode token makes 26 collectives on a rank of xlstm-125m (13
    all-reduces, 13 all-gathers) and 38 on seamless-m4t-medium (37, 1)."""

    assert per_token_collectives(get_config(XLSTM)) == [13, 13]
    assert per_token_collectives(get_config(ENCDEC)) == [37, 1]


@pytest.mark.parametrize("name", [*XSCENARIO, *EMESH])
def test_collectives_exact_from_layer_kinds(runs, name):
    """(e) Every rank's collectives, exactly ``per_token_collectives`` for
    each admission's prefill of 14 tokens and each decode token of the
    xLSTM engine runs (3 all-reduces and 16 all-gathers a prefill, 3 and 3
    a token), and for seamless-smoke's prefill (11 all-reduces, 1
    all-gather) and each of its chunk's tokens (7, 1) in every mode."""

    if name in XSCENARIO:
        _, key, _, model_axis, _, _ = XSCENARIO[name]
        cfg = axis_smoke(key)
        pre, tok = per_token_collectives(cfg, 14), per_token_collectives(cfg)
        assert (pre, tok) == ([3, 16], [3, 3])
        for rec in runs[model_axis]:
            all_reduce, all_gather, admits, steps = rec[f"{name}/collectives"]
            assert admits > 0 and steps > 0
            assert [all_reduce, all_gather] == [pre[i] * admits + tok[i] * steps
                                                for i in range(2)]
        return
    model_axis = EMESH[name][2]
    cfg = axis_smoke(ENCDEC)
    pre, tok = per_token_collectives(cfg, ENCDEC_PLAN["prompt"]), per_token_collectives(cfg)
    assert (pre, tok) == ([11, 1], [7, 1])
    want = [*pre, *(n * ENCDEC_PLAN["steps"] for n in tok)]
    for rec in runs[model_axis]:
        for mode in ENCDEC_MODES:
            np.testing.assert_array_equal(rec[f"{name}/{encdec_mode(*mode)}/calls"], want)


@pytest.mark.parametrize("arch", [XLSTM, ENCDEC])
def test_collectives_per_token_in_process(monkeypatch, arch):
    """A rank of xlstm-smoke or seamless-smoke issues exactly
    ``per_token_collectives`` for a prefill and for each decode step (the
    collectives counted, not run: ``torch.distributed`` is stubbed)."""

    import torch.distributed as tdist

    monkeypatch.setattr(tdist, "all_reduce", lambda x, group=None: None)
    monkeypatch.setattr(tdist, "all_gather",
                        lambda parts, x, group=None: [t.copy_(x) for t in parts])
    monkeypatch.setattr(dist, "CALLS", {"all_reduce": 0, "all_gather": 0})
    cfg = axis_smoke(arch)
    model = Model(cfg, device="cpu", group=stub_group(0, 2))
    batch = {"tokens": torch.zeros((2, 5), dtype=torch.long)}
    if cfg.encoder_decoder:
        batch["frontend"] = torch.zeros((2, 6, cfg.d_model))
    logits, cache = model.prefill(batch, extra=3)
    pre, tok = per_token_collectives(cfg, 5), per_token_collectives(cfg)
    assert list(dist.CALLS.values()) == pre
    for step in range(1, 4):
        logits, cache = model.decode_step(logits[:, -1].argmax(-1, keepdim=True), cache)
        assert list(dist.CALLS.values()) == [p + step * t for p, t in zip(pre, tok)]


@pytest.mark.parametrize("control", ["skip_h_gather", "skip_xattn_wo"])
def test_skip_collective_controls_caught(runs, control):
    """(f) On 2 ranks, the first prompt's logits within ``ATOL`` of the
    one-rank model's; a rank whose sLSTM layers skip the h all-gather (its
    own units standing in for the others'), or whose cross-attention skips
    its ``wo`` all-reduce in every layer, misses it."""

    ref = runs["ref"]
    if control == "skip_h_gather":
        name, key, _, _, _, seed = XSCENARIO["xl42"]
        st = one_rank(ref, key)
        prompt = np.concatenate([st.tok.encode_state(q)
                                 for q in obs_pair(np.random.default_rng(seed))], axis=1)
        with torch.no_grad():
            want = st.tmodel.prefill({"tokens": torch.as_tensor(prompt)})[0][0, -1].numpy()
        good = f"{name}/logits"
    else:
        name = "ed42"
        st = one_rank(ref, ENCDEC)
        cfg = st.tmodel.cfg
        batch = {k: torch.as_tensor(v) for k, v in encdec_batch(cfg.vocab_size,
                                                                 cfg.d_model).items()}
        with torch.no_grad():
            want = st.tmodel.prefill(batch)[0].numpy()
        good = f"{name}/uncached_dense/prefill"
    for rec in runs[2]:
        np.testing.assert_allclose(rec[good], want, atol=LOGIT_ATOL, rtol=0)
        assert not np.allclose(rec[f"{name}/{control}"], want, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_equal(runs, world):
    """(g) Every rank records the same outputs, tokens, counts and shapes
    (its parameter blocks and its blocks of the state aside)."""

    ranks = runs[world]
    keys = [k for k in ranks[0] if not k.startswith("a/param/") and k not in BLOCK_AXIS]
    assert keys and all(set(r) == set(ranks[0]) for r in ranks)
    for r, rec in enumerate(ranks[1:], 1):
        for k in keys:
            np.testing.assert_array_equal(rec[k], ranks[0][k], err_msg=f"{k} rank {r}")


# ---------------------------------------------------------------------------
# the full-width stacks on a rank, without processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,ranks", [(a, m) for a in (XLSTM, ENCDEC) for m in WORLDS])
def test_full_width_rank_model_builds(arch, ranks):
    """xlstm-125m (on the CPU, bf16) and seamless-m4t-medium (laid out on
    the meta device: ~0.9 B parameters) build as the last rank of 2 and 4:
    every module runs its share (mLSTM heads and channels, sLSTM units,
    the self-, encoder and cross-attention's heads, the MLPs' columns) and
    the caches hold the rank's sizes; ``param_logical`` and
    ``abstract_params`` keep the global layout."""

    cfg = get_config(arch)
    group = stub_group(ranks - 1, ranks)
    device = "cpu" if arch == XLSTM else "meta"
    model = Model(cfg, device=device, group=group, cache_cross_kv=True)
    one = Model(cfg, device="meta")
    assert model.param_logical() == one.param_logical()
    assert model.abstract_params() == one.abstract_params()
    d = cfg.d_model
    cache = model.init_cache(2, 8)
    if arch == XLSTM:
        d_in, nh = 2 * d, cfg.num_heads
        for blk in model.layers:
            if hasattr(blk, "mlstm"):
                ml = blk.mlstm
                assert (ml.d_in, ml.nh, ml.tp) == (d_in // ranks, nh // ranks, group)
                assert ml.up_proj.shape == (d, 2 * d_in // ranks)
                assert ml.wq.shape == (d_in, d_in // ranks)
                assert ml.w_if.shape == (d_in, 2 * nh // ranks)
                assert ml.out_proj.shape == (d_in // ranks, d)
            else:
                sl = blk.slstm
                assert (sl.units, sl.tp) == (d // ranks, group)
                assert sl.w_in.shape == sl.w_rec.shape == (d, 4 * d // ranks)
                assert sl.up.shape == (d, 2 * 1024 // ranks)  # d_up 1024
                assert sl.down.shape == (1024 // ranks, d)
        dh = d_in // nh
        assert cache["mC"].shape == (6, 2, nh // ranks, dh, dh)
        assert cache["mm"].shape == (6, 2, nh // ranks)
        assert cache["sc"].shape == (6, 2, d // ranks) and cache["sh"].shape == (6, 2, d)
        assert np.isfinite(model.layers[0].mlstm.wq.float().numpy()).all()
        return
    h, hd = cfg.num_heads // ranks, cfg.resolved_head_dim
    for blk in (*model.layers, *model.enc_layers):
        for a in (blk.attn, getattr(blk, "xattn", blk.attn)):
            assert (a.n_heads, a.n_kv, a.tp) == (h, h, group)
            assert a.wq.shape == (d, h * hd) and a.wo.shape == (h * hd, d)
        assert blk.mlp.tp is group and blk.mlp.up.w.shape == (d, cfg.d_ff // ranks)
    assert model.lm_head.w.shape == (d, 256256 // ranks) and model.vocab_padded == 256256
    assert cache["k"].shape == (12, 2, 8, h, hd)
