"""The port's five other dense attention archs against the JAX reference.

gemma-7b (GeGLU, tied and scaled embeddings), gemma2-9b (local and global
layers alternating, attention and final softcaps), h2o-danube3 (a window
on every layer), starcoder2 (a plain GELU MLP, G = 2 at smoke size) and
phi-3-vision (a stub vision frontend), each on its f32 smoke stack with the
weights bridged from the reference's ``Model.init``; inputs are numpy
arrays from a seed.  Tolerance: f32 logits agree to 1e-4 absolute, as in
``test_torch_model.py`` (the two frameworks sum in different orders), and
greedy tokens must be equal.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import _flatten  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.layers import embed_lookup as jax_embed_lookup  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.runtime.kv_cache import PagedSpec as JaxPagedSpec  # noqa: E402
from repro.runtime.kv_cache import scatter_prompt_into_pool as jax_scatter  # noqa: E402
from repro_torch.checkpoint.bridge import load_reference_params, reference_key  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import EpisodeTokenizer  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.layers import embed_lookup, embed_scale  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime.kv_cache import PagedSpec, scatter_prompt_into_pool  # noqa: E402

# the reference also has a parameter dtype; the port keeps parameters in cfg.dtype
JAX_F32 = dict(dtype="float32", param_dtype="float32")
ATOL = 1e-4
PROMPT, N_STEPS = 14, 12
ARCHS = ("gemma-7b", "gemma2-9b", "h2o-danube-3-4b", "starcoder2-3b", "phi-3-vision-4.2b")


@functools.lru_cache(maxsize=None)
def stacks(arch, **over):
    jmodel = JaxModel(jax_smoke(arch).replace(**JAX_F32, **over))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = Model(get_smoke_config(arch).replace(dtype="float32", **over), device="cpu")
    load_reference_params(tmodel, _flatten(jparams))
    return jmodel, jparams, tmodel


def _tokens(cfg, b=2, seed=0):
    tok = EpisodeTokenizer(cfg.vocab_size)
    return np.random.default_rng(seed).integers(tok.state_base, tok.action_base, (b, PROMPT))


def _same_fields(port, ref, where):
    """Every field of the port's (dataclass) config equals the reference's."""

    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):
            _same_fields(got, want, f"{where}.{f.name}")
        else:
            assert got == want, f"{where}.{f.name}: {got!r} != {want!r}"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_copy_the_reference(arch):
    _same_fields(get_config(arch), jax_config(arch), arch)
    _same_fields(get_smoke_config(arch), jax_smoke(arch), f"{arch} smoke")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_the_model(arch):
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = Model(cfg, device="cpu")
    assert cfg.param_count() == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_key_mapping(arch):
    """Each port parameter reads one reference key and every key is read:
    gemma2's unit is two layers (local, global); a tied stack has no
    ``lm_head``; a plain MLP has no ``gate``."""

    jmodel, jparams, tmodel = stacks(arch)
    cfg = tmodel.cfg
    assert tmodel.period == jmodel.period == (2 if cfg.local_global_alternating else 1)
    if arch == "gemma2-9b":
        assert [s[2] for s in tmodel.specs] == [True, False]
        assert reference_key("layers.1.attn.wq", 2) == ("unit/1/attn/wq", 0)
    names = dict(tmodel.named_parameters())
    assert ("lm_head.w" in names) == (not cfg.tie_embeddings)
    assert ("layers.0.mlp.gate.w" in names) == cfg.gated_mlp
    flat = _flatten(jparams)
    used = {reference_key(n, tmodel.period)[0] for n in names}
    assert used == set(flat)
    for name, p in names.items():
        key, idx = reference_key(name, tmodel.period)
        np.testing.assert_array_equal(p.numpy(), flat[key][idx] if idx >= 0 else flat[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_logits(arch):
    jmodel, jparams, tmodel = stacks(arch)
    toks = _tokens(tmodel.cfg)
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, extra=4))(
        jparams, {"tokens": jnp.asarray(toks)})
    tl, tcache = tmodel.prefill({"tokens": torch.as_tensor(toks)}, extra=4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)

    nxt = toks[:, :1] + 1
    jl2, _ = jax.jit(jmodel.decode_step)(jparams, jnp.asarray(nxt), jcache)
    tl2, _ = tmodel.decode_step(torch.as_tensor(nxt), tcache)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL, rtol=0)


def _paged_plan(b):
    maxp = -(-(PROMPT + N_STEPS) // 16)
    pt = np.arange(b * maxp, dtype=np.int32).reshape(b, maxp)[::-1].copy()
    return maxp, pt, np.full((b,), maxp * 16, np.int32)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chunk_tokens_equal(arch, paged):
    """Greedy chunk tokens over the action bins, through dense slabs and
    through a reversed page table, equal the reference's."""

    jmodel, jparams, tmodel = stacks(arch)
    floor = EpisodeTokenizer(tmodel.cfg.vocab_size).action_base
    toks = _tokens(tmodel.cfg, seed=1)
    b = toks.shape[0]
    maxp, pt, caps = _paged_plan(b)

    def run(p, tokens):
        logits, cache = jmodel.prefill(p, {"tokens": tokens}, extra=0 if paged else N_STEPS)
        if paged:
            spec = JaxPagedSpec(num_pages=b * maxp, page_size=16, max_pages_per_seq=maxp)
            cache = jmodel.cache_to_paged(cache, jmodel.init_paged_cache(b, spec),
                                          jnp.asarray(pt), jnp.asarray(caps))
        return jmodel.decode_chunk(p, logits, cache, N_STEPS, floor)[0]

    want = np.asarray(jax.jit(run)(jparams, jnp.asarray(toks)))
    logits, cache = tmodel.prefill({"tokens": torch.as_tensor(toks)},
                                   extra=0 if paged else N_STEPS)
    if paged:
        spec = PagedSpec(num_pages=b * maxp, page_size=16, max_pages_per_seq=maxp)
        cache = tmodel.cache_to_paged(cache, tmodel.init_paged_cache(b, spec), pt, caps)
    got, _, _ = tmodel.decode_chunk(logits, cache, N_STEPS, floor)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [0, 8])
def test_paged_step_ragged_gemma2(window):
    """One paged decode step of gemma2's first attention layer at mixed
    depths (lens 0, 5, 17: each row attends len + 1 >= 1 tokens), through a
    shuffled page table, against the reference's paged and dense steps
    (tests/test_paged_model.py:93-140)."""

    jmodel, jparams, tmodel = stacks("gemma2-9b")
    cfg = tmodel.cfg
    p0 = jax.tree.map(lambda a: a[0], jparams["unit"][0])["attn"]
    b, page, maxp = 3, 8, 4
    s_cache, hd, nkv = maxp * page, cfg.resolved_head_dim, cfg.num_kv_heads
    rng = np.random.default_rng(3)
    lens = np.asarray([0, 5, 17], np.int32)
    ck = rng.normal(0, 1, (b, s_cache, nkv, hd)).astype(np.float32)
    cv = rng.normal(0, 1, (b, s_cache, nkv, hd)).astype(np.float32)
    x = rng.normal(0, 1, (b, 1, cfg.d_model)).astype(np.float32)
    table = rng.permutation(b * maxp).reshape(b, maxp).astype(np.int32)
    full = np.full((b,), s_cache, np.int32)

    out_d, _, _ = jattn.attention_decode_step(
        jnp.asarray(x), p0, jmodel.cfg, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(lens),
        window)
    jkp = jax_scatter(jnp.zeros((b * maxp + 1, page, nkv, hd)), jnp.asarray(ck),
                      jnp.asarray(table), jnp.asarray(full))
    jvp = jax_scatter(jnp.zeros((b * maxp + 1, page, nkv, hd)), jnp.asarray(cv),
                      jnp.asarray(table), jnp.asarray(full))
    out_p, _, _ = jattn.attention_decode_step_paged(
        jnp.asarray(x), p0, jmodel.cfg, jkp, jvp, jnp.asarray(table), jnp.asarray(lens),
        jnp.asarray(full), window)

    kp = torch.zeros((b * maxp + 1, page, nkv, hd))
    vp = torch.zeros_like(kp)
    scatter_prompt_into_pool(kp, torch.as_tensor(ck), torch.as_tensor(table), torch.as_tensor(full))
    scatter_prompt_into_pool(vp, torch.as_tensor(cv), torch.as_tensor(table), torch.as_tensor(full))
    kp0 = kp.clone()
    got = tattn.attention_decode_step_paged(
        torch.as_tensor(x), tmodel.layers[0].attn, cfg, kp, vp, torch.as_tensor(table),
        torch.as_tensor(lens), torch.as_tensor(full), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(out_p), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(out_d), atol=1e-5, rtol=0)
    for i, n in enumerate(lens):  # each row's new K at its own slot of its own page
        pg, off = table[i, n // page], n % page
        assert not torch.equal(kp[pg, off], kp0[pg, off]), f"row {i} missing write"


def test_phi3_vision_prefill_with_frontend():
    jmodel, jparams, tmodel = stacks("phi-3-vision-4.2b")
    cfg = tmodel.cfg
    rng = np.random.default_rng(3)
    toks = _tokens(cfg, b=1)
    fe = rng.normal(0, 0.02, (1, cfg.num_modality_tokens, cfg.d_model)).astype(np.float32)
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b))(
        jparams, {"tokens": jnp.asarray(toks), "frontend": jnp.asarray(fe)})
    tl, tcache = tmodel.prefill({"tokens": torch.as_tensor(toks), "frontend": torch.as_tensor(fe)})
    assert tcache["len"] == int(jcache["len"]) == cfg.num_modality_tokens + PROMPT
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_gemma2_logits_bounded_by_final_softcap():
    """The final softcap bounds every real logit (tests/test_models.py:108-116),
    the padded ids stay -1e9, and the port's logits equal the reference's
    (tied head, softcap, then the mask) on the same hidden states."""

    jmodel, jparams, tmodel = stacks("gemma2-9b")
    cfg = tmodel.cfg
    x = np.random.default_rng(5).normal(0, 3, (2, 16, cfg.d_model)).astype(np.float32)
    got = tmodel._logits(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel._logits(jparams, jnp.asarray(x))),
                               atol=ATOL, rtol=0)
    assert np.abs(got[..., : cfg.vocab_size]).max() <= cfg.final_logit_softcap + 1e-3
    assert (got[..., cfg.vocab_size:] <= -1e8).all()
    tl, _ = tmodel.prefill({"tokens": torch.as_tensor(_tokens(cfg))})
    assert np.abs(tl.numpy()).max() <= cfg.final_logit_softcap + 1e-3


RING = dict(sliding_window=8, subquadratic_decode=True, long_context_window=8)


@pytest.mark.parametrize("arch,over", [("h2o-danube-3-4b", RING),
                                       ("gemma2-9b", dict(sliding_window=8))])
def test_ring_cache_matches_reference(arch, over):
    """``Model(windowed_cache=True)`` steps 24 tokens from an empty cache
    against the reference's ring twin (tests/test_perf_variants.py:17-40)
    and against the port's full cache: windowed layers hold rings of 8
    slots, gemma2's global layers (no long-context cap) their whole length."""

    jmodel, jparams, tfull = stacks(arch, **over)
    jring = JaxModel(jmodel.cfg, windowed_cache=True)
    tring = Model(tfull.cfg, device="cpu", windowed_cache=True)
    tring.load_state_dict(tfull.state_dict())
    t_len = 24
    toks = np.random.default_rng(1).integers(0, tfull.cfg.vocab_size, (1, t_len))
    jc, tc, fc = jring.init_cache(1, t_len), tring.init_cache(1, t_len), tfull.init_cache(1, t_len)
    assert [c.shape[1] for c in tc["k"]] == [
        8 if s[2] else t_len for s in tring.specs if s[0] == "attn"]
    assert jc["unit"][0]["k"].shape[2] == 8
    step = jax.jit(jring.decode_step)
    for t in range(t_len):
        jl, jc = step(jparams, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tring.decode_step(torch.as_tensor(toks[:, t:t + 1]), tc)
        fl, fc = tfull.decode_step(torch.as_tensor(toks[:, t:t + 1]), fc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(tl.numpy(), fl.numpy(), atol=2e-5, rtol=2e-5)


def test_ring_cache_ragged_rows():
    """Per-row lengths ([B] int32) through the rings: rows at different
    depths, one past the ring's size, against the full cache."""

    _, _, tfull = stacks("h2o-danube-3-4b", **RING)
    tring = Model(tfull.cfg, device="cpu", windowed_cache=True)
    tring.load_state_dict(tfull.state_dict())
    toks = np.random.default_rng(2).integers(0, tfull.cfg.vocab_size, (2, 20))
    tc, fc = tring.init_cache(2, 20), tfull.init_cache(2, 20)
    for t in range(20):
        lens = torch.tensor([t, max(t - 7, 0)], dtype=torch.int32)
        tl, _ = tring.decode_step(torch.as_tensor(toks[:, t:t + 1]), dict(tc, len=lens))
        fl, _ = tfull.decode_step(torch.as_tensor(toks[:, t:t + 1]), dict(fc, len=lens))
        np.testing.assert_allclose(tl.numpy(), fl.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d_model,scale", [(3072, 55.5), (3584, 59.75)])
def test_embed_lookup_scaled_bit_equal(d_model, scale):
    """The gemma embedding at the published widths: sqrt(d_model) rounded to
    bf16 and a bf16 product, bit for bit the reference's ``embed_lookup``
    (the smoke stacks' sqrt(256) = 16 is exact and cannot show this)."""

    assert embed_scale(d_model) == scale
    rng = np.random.default_rng(d_model)
    table = rng.normal(0, 1, (64, d_model)).astype(np.float32)
    tokens = rng.integers(0, 64, (3, 9))
    want = jax_embed_lookup(jnp.asarray(tokens), {"table": jnp.asarray(table)}, d_model, True)
    got = embed_lookup(torch.as_tensor(tokens), torch.as_tensor(table), embed_scale(d_model))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
