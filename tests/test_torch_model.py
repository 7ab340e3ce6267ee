"""The port's Model against the JAX reference on the f32 openvla-smoke stack.

Weights come from the reference's ``Model.init`` flattened with
``checkpoint/npz.py``'s ``_flatten`` and bridged into the port; inputs are
numpy arrays from a seed.  Tolerance: f32 logits agree to 1e-4 absolute
(the two frameworks sum in different orders; logits are O(1)), and greedy
tokens must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import _flatten  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.runtime.kv_cache import PagedSpec as JaxPagedSpec  # noqa: E402
from repro_torch.checkpoint.bridge import load_reference_params, reference_key  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime.kv_cache import PagedSpec  # noqa: E402

# the reference also has a parameter dtype; the port keeps parameters in cfg.dtype
JAX_F32 = dict(dtype="float32", param_dtype="float32")
ATOL = 1e-4
PROMPT, N_STEPS, FLOOR = 14, 12, 768


def _stacks(**over):
    jcfg = jax_smoke("openvla-7b").replace(**JAX_F32, **over)
    jmodel = JaxModel(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = Model(get_smoke_config("openvla-7b").replace(dtype="float32", **over), device="cpu")
    load_reference_params(tmodel, _flatten(jparams))
    return jmodel, jparams, tmodel


@pytest.fixture(scope="module")
def stacks():
    return _stacks()


def _tokens(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(640, 768, (b, PROMPT))


def test_bridge_layer_mapping_one_layer_unit():
    """Identical layers give the reference a one-layer repeating unit, so
    port layer i reads unit/0/...[i]; a windowed, softcapped stack too."""

    assert reference_key("layers.5.attn.wq") == ("unit/0/attn/wq", 5)
    assert reference_key("layers.4.mlp.down.w") == ("unit/0/mlp/down/w", 4)
    assert reference_key("lm_head.w") == ("lm_head/w", -1)
    over = dict(num_layers=4, sliding_window=4, attn_logit_softcap=5.0)
    jmodel, jparams, tmodel = _stacks(**over)
    assert jmodel.period == 1
    flat = _flatten(jparams)
    for i in range(4):
        for name in ("attn/wq", "mlp/gate/w"):
            mod, _, leaf = name.partition("/")
            got = getattr(tmodel.layers[i], mod).get_parameter(leaf.replace("/", ".")).numpy()
            np.testing.assert_array_equal(got, flat[f"unit/0/{name}"][i])
    # the windowed stack (windows 4 < prompt 14) also agrees end to end
    toks = _tokens()
    want, _ = jax.jit(lambda p, b: jmodel.prefill(p, b))(jparams, {"tokens": jnp.asarray(toks)})
    got, _ = tmodel.prefill({"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_prefill_and_decode_step_logits(stacks):
    jmodel, jparams, tmodel = stacks
    toks = _tokens()
    batch = {"tokens": jnp.asarray(toks)}
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, extra=4))(jparams, batch)
    tl, tcache = tmodel.prefill({"tokens": torch.as_tensor(toks)}, extra=4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)

    nxt = np.array([[800], [900]])
    jl2, _ = jax.jit(jmodel.decode_step)(jparams, jnp.asarray(nxt), jcache)
    tl2, tcache2 = tmodel.decode_step(torch.as_tensor(nxt), tcache)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL, rtol=0)
    assert tcache2["len"] == PROMPT + 1


def test_prefill_with_frontend(stacks):
    jmodel, jparams, tmodel = stacks
    rng = np.random.default_rng(3)
    toks = _tokens(b=1)
    fe = rng.normal(0, 0.02, (1, 16, 256)).astype(np.float32)
    jl, _ = jax.jit(lambda p, b: jmodel.prefill(p, b))(
        jparams, {"tokens": jnp.asarray(toks), "frontend": jnp.asarray(fe)}
    )
    tl, _ = tmodel.prefill({"tokens": torch.as_tensor(toks), "frontend": torch.as_tensor(fe)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def _jax_chunk(jmodel, jparams, toks, paged):
    def run(p, tokens):
        logits, cache = jmodel.prefill(p, {"tokens": tokens}, extra=0 if paged else N_STEPS)
        if paged:
            b = tokens.shape[0]
            maxp = -(-(PROMPT + N_STEPS) // 16)
            spec = JaxPagedSpec(num_pages=b * maxp, page_size=16, max_pages_per_seq=maxp)
            pt = jnp.arange(b * maxp, dtype=jnp.int32).reshape(b, maxp)[::-1]
            cache = jmodel.cache_to_paged(
                cache, jmodel.init_paged_cache(b, spec), pt, jnp.full((b,), maxp * 16)
            )
        return jmodel.decode_chunk(p, logits, cache, N_STEPS, FLOOR)[0]

    return np.asarray(jax.jit(run)(jparams, jnp.asarray(toks)))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_chunk_tokens_equal(stacks, paged):
    """Greedy chunk tokens through dense slabs and through a (reversed, so
    not identity) page table equal the reference's."""

    jmodel, jparams, tmodel = stacks
    toks = _tokens(seed=1)
    want = _jax_chunk(jmodel, jparams, toks, paged)
    logits, cache = tmodel.prefill({"tokens": torch.as_tensor(toks)}, extra=0 if paged else N_STEPS)
    if paged:
        b = toks.shape[0]
        maxp = -(-(PROMPT + N_STEPS) // 16)
        spec = PagedSpec(num_pages=b * maxp, page_size=16, max_pages_per_seq=maxp)
        pt = np.arange(b * maxp, dtype=np.int32).reshape(b, maxp)[::-1].copy()
        cache = tmodel.cache_to_paged(cache, tmodel.init_paged_cache(b, spec), pt,
                                      np.full((b,), maxp * 16))
    got, _, _ = tmodel.decode_chunk(logits, cache, N_STEPS, FLOOR)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_decode_step_matches_reference(stacks):
    """Per-row cache lengths (dense slabs, [B] len) against the reference."""

    jmodel, jparams, tmodel = stacks
    toks = _tokens(seed=2)
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, extra=4))(
        jparams, {"tokens": jnp.asarray(toks)}
    )
    _, tcache = tmodel.prefill({"tokens": torch.as_tensor(toks)}, extra=4)
    lens = np.array([PROMPT, PROMPT - 5], np.int32)
    jcache = dict(jcache, len=jnp.asarray(lens))
    tcache = dict(tcache, len=torch.as_tensor(lens))
    nxt = np.array([[801], [950]])
    jl2, _ = jax.jit(jmodel.decode_step)(jparams, jnp.asarray(nxt), jcache)
    tl2, _ = tmodel.decode_step(torch.as_tensor(nxt), tcache)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL, rtol=0)
