"""The port's MoE stacks and dispatches against the JAX package.

qwen3-moe-smoke (4 experts top-2 on every layer, G = 4) and
phi3.5-moe-smoke (the same routing, G = 2), float32, weights bridged from
the reference's ``init``; inputs are numpy arrays from a seed.

* ``moe_forward_capacity`` at capacity factors 4.0 (no drop: it equals the
  dense path as well), 1.25 and 0.25 (drops): the output to 1e-5, the aux
  loss, and which (token, expert) slots are kept, against the reference's
  own expressions (``repro/models/moe.py:137-140``).  Routing near a tie
  can flip between two libraries' softmax: the routed sets must be equal on
  every token whose k-th and (k+1)-th probabilities are more than 1e-6
  apart; the test reports how many fall inside and compares the rest.
* padding rows route and take capacity as in the reference.
* the dense mixture's batched expert groups against the one-expert-at-a-
  time loop (the reference's order), float32, to 1e-5.
* whole-model prefill and decode logits to 1e-4 under ``moe_impl`` dense
  and capacity, each against its own reference twin.
* the bridge's keys at period 1; ``Model(moe_impl="bogus")`` raises.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # as test_torch_scheduler.py: xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.checkpoint.npz import _flatten  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.checkpoint.bridge import load_reference_params, reference_key  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import EpisodeTokenizer  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

JAX_F32 = dict(dtype="float32", param_dtype="float32")
MOE_ARCHS = ("qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b")
IMPLS = ("dense", "capacity")
OUT_TOL = 1e-5     # one MoE layer's output, float32
LOGIT_TOL = 1e-4   # whole-model logits, float32 (as test_torch_model.py)
TIE_GAP = 1e-6     # top-k boundary gap below which routing may flip


@functools.lru_cache(maxsize=None)
def moe_block(arch):
    """(reference cfg, reference params, port cfg, port MoE) of one layer."""

    jcfg = jax_smoke(arch).replace(**JAX_F32)
    tcfg = get_smoke_config(arch).replace(dtype="float32")
    params, _ = jmoe.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    block = tmoe.MoE(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        for name in ("router", "up", "gate", "down"):
            getattr(block, name).copy_(torch.from_numpy(np.array(params[name])))
    return jcfg, params, tcfg, block


@functools.lru_cache(maxsize=None)
def stacks(arch, moe_impl):
    jmodel = JaxModel(jax_smoke(arch).replace(**JAX_F32), moe_impl=moe_impl)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = Model(get_smoke_config(arch).replace(dtype="float32"), device="cpu",
                   moe_impl=moe_impl)
    load_reference_params(tmodel, _flatten(jparams))
    return jmodel, jparams, tmodel


def _reference_keep(combine, cap):
    """The reference's kept (token, expert) pairs, by its own expressions."""

    flat = combine.reshape(-1, combine.shape[-1])
    selected = flat > 0
    pos_in_e = jnp.cumsum(selected.astype(jnp.int32), axis=0) - 1
    return np.asarray(selected & (pos_in_e < cap))


def _tie_tokens(x, router, k):
    """Tokens whose k-th and (k+1)-th router probabilities (the reference's)
    are within TIE_GAP."""

    probs = np.asarray(jax.nn.softmax(jnp.asarray(x).reshape(-1, x.shape[-1]) @ router, -1))
    top = -np.sort(-probs, axis=-1)
    return np.flatnonzero(top[:, k - 1] - top[:, k] <= TIE_GAP)


def _check_capacity(arch, x, cf):
    """Both sides' capacity dispatch of ``x`` [B, S, D] at ``cf``: the routed
    sets equal on every token clear of a tie, then on those tokens the kept
    slots and the output; the aux loss where no token is near a tie ->
    the port's kept pairs [B*S, E]."""

    jcfg, params, tcfg, block = moe_block(arch)
    k, e = jcfg.moe.num_experts_per_tok, jcfg.moe.num_experts
    t = x.shape[0] * x.shape[1]
    cap = max(int(t * k * cf / e), 1)
    want, want_aux = jax.jit(lambda p, v: jmoe.moe_forward_capacity(v, p, jcfg, cf))(
        params, jnp.asarray(x))
    got, aux = tmoe.moe_forward_capacity(torch.as_tensor(x), block, tcfg, cf)
    jcomb, _ = jmoe.router_probs(jnp.asarray(x), params["router"], k)
    tcomb, _ = tmoe.router_probs(torch.as_tensor(x), block.router, k)
    selected = tcomb.reshape(t, e) > 0
    keep = tmoe.capacity_slots(selected, cap)[0].numpy()
    ties = _tie_tokens(x, np.asarray(params["router"]), k)
    clear = np.setdiff1d(np.arange(t), ties)
    print(f"{arch} cf {cf} cap {cap}: {len(ties)} of {t} tokens within {TIE_GAP} of a "
          f"routing tie; {int(selected.sum()) - int(keep.sum())} token slots dropped")
    np.testing.assert_array_equal(selected.numpy()[clear],
                                  np.asarray(jcomb).reshape(t, e)[clear] > 0)
    np.testing.assert_array_equal(keep[clear], _reference_keep(jcomb, cap)[clear])
    np.testing.assert_allclose(got.numpy().reshape(t, -1)[clear],
                               np.asarray(want).reshape(t, -1)[clear], rtol=0, atol=OUT_TOL)
    if not len(ties):
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=OUT_TOL)
    return keep


@pytest.mark.parametrize("cf", [4.0, 1.25, 0.25])
def test_capacity_dispatch_matches_reference(cf):
    arch = "qwen3-moe-235b-a22b"
    jcfg = moe_block(arch)[0]
    x = np.random.default_rng(3).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    keep = _check_capacity(arch, x, cf)
    selected = 2 * 9 * jcfg.moe.num_experts_per_tok
    dropped = selected - int(keep.sum())
    if cf == 4.0:  # cap >= tokens: nothing drops, and the dense path agrees
        assert dropped == 0
        _, _, tcfg, block = moe_block(arch)
        dense, _ = tmoe.moe_forward(torch.as_tensor(x), block, tcfg)
        got, _ = tmoe.moe_forward_capacity(torch.as_tensor(x), block, tcfg, cf)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=OUT_TOL)
    if cf == 0.25:
        assert dropped > selected // 2


def test_padding_rows_take_capacity():
    """Two padding rows (the same embedding repeated, as an idle scheduler
    row's token) ahead of two real rows at cf 1.25: the pad rows route, fill
    their experts' first slots, and the real rows' drops follow from them
    exactly as in the reference; without the pad rows the real rows'
    output differs."""

    arch = "phi3.5-moe-42b-a6.6b"
    jcfg, _, tcfg, block = moe_block(arch)
    rng = np.random.default_rng(4)
    real = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    pad = np.broadcast_to(rng.standard_normal(jcfg.d_model).astype(np.float32),
                          (2, 7, jcfg.d_model))
    x = np.concatenate([pad, real])
    keep = _check_capacity(arch, x, 1.25)
    assert keep[:2 * 7].sum() > 0, "pad rows took no slot"
    alone, _ = tmoe.moe_forward_capacity(torch.as_tensor(real), block, tcfg, 1.25)
    with_pad, _ = tmoe.moe_forward_capacity(torch.as_tensor(x), block, tcfg, 1.25)
    assert not torch.allclose(with_pad[2:], alone, atol=OUT_TOL)


def _loop_mixture(x, combine, p):
    """The dense mixture one expert at a time, the reference's scan order
    (``repro/models/moe.py:61-95``)."""

    acc = torch.zeros_like(x)
    for e in range(p.up.shape[0]):
        h = F.silu(x @ p.gate[e]) * (x @ p.up[e])
        acc = acc + (h * combine[..., e, None]) @ p.down[e]
    return acc


@pytest.mark.parametrize("group_elems", [tmoe.GROUP_ELEMS, 1], ids=["one group", "per expert"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dense_mixture_groups_equal_the_loop(arch, group_elems, monkeypatch):
    """The batched dense mixture, in one group and in groups of one expert
    (a long prefill's path), against the loop; the sum over experts runs
    in another order, so float32 within 1e-5."""

    jcfg, _, tcfg, block = moe_block(arch)
    monkeypatch.setattr(tmoe, "GROUP_ELEMS", group_elems)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((3, 5, jcfg.d_model)),
                        dtype=torch.float32)
    combine, _ = tmoe.router_probs(x, block.router, jcfg.moe.num_experts_per_tok)
    got = tmoe.moe_apply_experts(x, combine, block)
    torch.testing.assert_close(got, _loop_mixture(x, combine, block), rtol=0, atol=OUT_TOL)


def _tokens(cfg, b=2, s=14, seed=0):
    tok = EpisodeTokenizer(cfg.vocab_size)
    return np.random.default_rng(seed).integers(tok.state_base, tok.action_base, (b, s))


@pytest.mark.parametrize("moe_impl", IMPLS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_logits(arch, moe_impl):
    """Two rows of a 14-token prompt (28 tokens routed at prefill, 2 at
    decode), then three decode steps; each impl against its reference
    twin, logits to 1e-4."""

    jmodel, jparams, tmodel = stacks(arch, moe_impl)
    assert tmodel.moe_impl == jmodel.moe_impl == moe_impl
    toks = _tokens(tmodel.cfg)
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, extra=4))(
        jparams, {"tokens": jnp.asarray(toks)})
    tl, tcache = tmodel.prefill({"tokens": torch.as_tensor(toks)}, extra=4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_TOL)
    step = jax.jit(jmodel.decode_step)
    nxt = toks[:, :1] + 1
    for _ in range(3):
        jl, jcache = step(jparams, jnp.asarray(nxt), jcache)
        tl, tcache = tmodel.decode_step(torch.as_tensor(nxt), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_TOL)
        nxt = np.asarray(jl).argmax(-1)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_keys_at_period_one(arch):
    """Every layer is MoE: the unit is one layer, layer i reads
    ``unit/0/moe/<w>[i]``, and every reference key is read."""

    jmodel, jparams, tmodel = stacks(arch, "dense")
    assert tmodel.period == jmodel.period == 1
    assert reference_key("layers.1.moe.up", 1) == ("unit/0/moe/up", 1)
    names = dict(tmodel.named_parameters())
    assert "layers.1.moe.router" in names and not any(".mlp." in n for n in names)
    flat = _flatten(jparams)
    assert {reference_key(n, 1)[0] for n in names} == set(flat)
    for name, p in names.items():
        key, idx = reference_key(name, 1)
        np.testing.assert_array_equal(p.numpy(), flat[key][idx] if idx >= 0 else flat[key])


def test_unknown_moe_impl_raises():
    with pytest.raises(ValueError, match="moe_impl"):
        Model(get_smoke_config("phi3.5-moe-42b-a6.6b").replace(dtype="float32"),
              device="cpu", moe_impl="bogus")
