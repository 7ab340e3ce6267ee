"""The port's hybrid Model (Mamba + attention, MLP + MoE) against the JAX
reference on the f32 jamba-smoke stack, and the closed loop that serves it.

Weights come from the reference's ``Model.init`` flattened with
``checkpoint/npz.py``'s ``_flatten`` and bridged into the port (a period-2
unit: mamba, attn); inputs are numpy arrays from a seed.  Tolerance: f32
logits agree to 1e-4 absolute (logits are O(1); the chunked scan and the
attention sum in another order than the reference's), and greedy tokens and
served actions must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import _flatten  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.pipeline import EpisodeTokenizer as JaxTokenizer  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.runtime.kv_cache import PagedSpec as JaxPagedSpec  # noqa: E402
from repro_torch.checkpoint.bridge import load_reference_params, reference_key  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import EpisodeTokenizer  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import Model, layer_specs, unit_period  # noqa: E402
from repro_torch.runtime.kv_cache import PagedSpec  # noqa: E402

ARCH = "jamba-1.5-large-398b"
JAX_F32 = dict(dtype="float32", param_dtype="float32")
ATOL = 1e-4
PROMPT, N_STEPS, FLOOR, PAGE = 14, 12, 256, 8


@pytest.fixture(scope="module")
def stacks():
    jcfg = jax_smoke(ARCH).replace(**JAX_F32)
    jmodel = JaxModel(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = Model(get_smoke_config(ARCH).replace(dtype="float32"), device="cpu")
    load_reference_params(tmodel, _flatten(jparams))
    return jmodel, jparams, tmodel


def _tokens(b=2, seed=0):
    return np.random.default_rng(seed).integers(128, 256, (b, PROMPT))


def test_bridge_maps_a_period_two_unit(stacks):
    """jamba-smoke repeats (mamba, attn): port layer i reads
    unit/{i % 2}/...[i // 2]; MoE sits on the odd layers."""

    jmodel, jparams, tmodel = stacks
    assert jmodel.period == tmodel.period == 2
    assert [s[:2] for s in layer_specs(tmodel.cfg)] == [
        ("mamba", False), ("attn", True), ("mamba", False), ("attn", True)]
    assert reference_key("layers.3.moe.up", 2) == ("unit/1/moe/up", 1)
    assert reference_key("layers.2.mamba.a_log", 2) == ("unit/0/mamba/a_log", 1)
    flat = _flatten(jparams)
    for i, name in [(0, "mamba/in_proj"), (2, "mamba/dt_bias"), (1, "moe/gate"),
                    (3, "attn/wq"), (2, "mlp/down/w")]:
        mod, _, leaf = name.partition("/")
        got = getattr(tmodel.layers[i], mod).get_parameter(leaf.replace("/", ".")).numpy()
        np.testing.assert_array_equal(got, flat[f"unit/{i % 2}/{name}"][i // 2])
    assert not hasattr(tmodel, "mod_proj"), "a text stack has no frontend projector"


def test_full_width_config_cut_to_four_layers():
    """The card's cell: Jamba's published widths, the first 4 layers of the
    real pattern (one unit of 4 layers), ~23.0 B parameters."""

    cfg = get_config(ARCH).replace(num_layers=4)
    assert [s[:2] for s in layer_specs(cfg)] == [
        ("mamba", False), ("mamba", True), ("mamba", False), ("attn", True)]
    assert unit_period(layer_specs(cfg)) == 4
    assert cfg.param_count() == 22_982_699_264
    smoke = get_smoke_config(ARCH)
    assert smoke.param_count() == sum(p.numel() for p in Model(smoke, device="cpu").parameters())


def test_prefill_and_decode_step_logits(stacks):
    jmodel, jparams, tmodel = stacks
    toks = _tokens()
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, extra=4))(
        jparams, {"tokens": jnp.asarray(toks)})
    tl, tcache = tmodel.prefill({"tokens": torch.as_tensor(toks)}, extra=4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    # the Mamba state the prefill leaves: h and the conv carry of layers 0, 2
    for j, (entry, r) in enumerate([(0, 0), (0, 1)]):
        np.testing.assert_allclose(tcache["h"][j].numpy(),
                                   np.asarray(jcache["unit"][entry]["h"][r]),
                                   atol=5e-4, rtol=5e-3)

    nxt = np.array([[200], [240]])
    jl2, _ = jax.jit(jmodel.decode_step)(jparams, jnp.asarray(nxt), jcache)
    tl2, tcache2 = tmodel.decode_step(torch.as_tensor(nxt), tcache)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL, rtol=0)
    assert tcache2["len"] == PROMPT + 1


def _paged_geometry(b):
    maxp = -(-(PROMPT + N_STEPS) // PAGE)
    pt = np.arange(b * maxp, dtype=np.int32).reshape(b, maxp)[::-1].copy()
    return maxp, pt, np.full((b,), maxp * PAGE, np.int32)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_chunk_tokens_equal(stacks, paged):
    """Greedy chunk tokens through dense slabs and through a reversed page
    table (the Mamba state stays dense) equal the reference's."""

    jmodel, jparams, tmodel = stacks
    toks = _tokens(seed=1)
    b = toks.shape[0]
    maxp, pt, caps = _paged_geometry(b)

    def run(p, tokens):
        logits, cache = jmodel.prefill(p, {"tokens": tokens}, extra=0 if paged else N_STEPS)
        if paged:
            spec = JaxPagedSpec(num_pages=b * maxp, page_size=PAGE, max_pages_per_seq=maxp)
            cache = jmodel.cache_to_paged(cache, jmodel.init_paged_cache(b, spec),
                                          jnp.asarray(pt), jnp.asarray(caps))
        return jmodel.decode_chunk(p, logits, cache, N_STEPS, FLOOR)[0]

    want = np.asarray(jax.jit(run)(jparams, jnp.asarray(toks)))
    logits, cache = tmodel.prefill({"tokens": torch.as_tensor(toks)},
                                   extra=0 if paged else N_STEPS)
    if paged:
        spec = PagedSpec(num_pages=b * maxp, page_size=PAGE, max_pages_per_seq=maxp)
        cache = tmodel.cache_to_paged(cache, tmodel.init_paged_cache(b, spec), pt, caps)
        assert cache["h"].shape[:2] == (2, b) and cache["kp"].shape[0] == 2
    got, _, _ = tmodel.decode_chunk(logits, cache, N_STEPS, FLOOR)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serve_episode_matches_reference(stacks, paged):
    """The closed loop on jamba-smoke: offloads equal, actions equal."""

    jmodel, jparams, tmodel = stacks
    steps = 72
    want = jserve.serve_episode(
        jserve.CloudPolicy(jmodel, jparams, JaxTokenizer(jmodel.cfg.vocab_size), paged=paged),
        task="peg_insertion", max_steps=steps, verbose=False,
    )
    policy = tserve.CloudPolicy(tmodel, EpisodeTokenizer(tmodel.cfg.vocab_size), paged=paged)
    got = tserve.serve_episode(policy, task="peg_insertion", max_steps=steps, verbose=False,
                               device="cpu")
    assert got["offloads"] == want["offloads"] > 0
    np.testing.assert_allclose(got["actions"], want["actions"], rtol=0, atol=1e-6)


def test_serve_main_takes_the_jamba_arch():
    out = tserve.main(["--arch", ARCH, "--steps", "70", "--device", "cpu", "--paged"])
    assert out["steps"] == 70 and out["offloads"] >= 1
    assert np.isfinite(out["actions"]).all()
