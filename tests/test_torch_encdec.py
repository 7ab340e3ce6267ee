"""The port's encoder-decoder stack (seamless-m4t: ``Model._encode``, the
cross-attention of ``models/attention.py``, ``Model(cache_cross_kv=...)``)
against the JAX package's, on the f32 seamless-smoke stack (2 + 2 layers,
vocab 514 padded to 768) with the weights bridged from the reference's
``Model.init``; inputs are numpy arrays from a seed.

Tolerances: atol = rtol = 1e-5 for the encoder and the attention
functions; the stack's logits to 2e-5, as ``tests/test_perf_variants.py``
holds the reference's cached cross K/V against its baseline; greedy tokens
equal.  The sinusoidal positions at full width (300 frames, d 1024) to 4e-5:
XLA's and torch's float32 ``exp`` differ by one ulp on some frequencies,
which angles of up to 300 radians carry into the sines (at smoke width
they agree to 1e-6).  The port refuses where the reference refuses or
fails: the scheduler and the split executor on an enc-dec stack, and
``CloudPolicy``, whose prompts carry no frames.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import _flatten  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.layers import sinusoidal_positions as jax_sinusoidal  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.partition.executor import PartitionExecutor as JaxExecutor  # noqa: E402
from repro.runtime.kv_cache import PagedSpec as JaxPagedSpec  # noqa: E402
from repro.runtime.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro_torch.checkpoint.bridge import reference_key  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.layers import sinusoidal_positions  # noqa: E402
from repro_torch.partition import PartitionExecutor  # noqa: E402
from repro_torch.runtime.kv_cache import PagedSpec  # noqa: E402
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler  # noqa: E402

from test_torch_scheduler import make_stacks  # noqa: E402

ARCH = "seamless-m4t-medium"
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_ATOL = 2e-5
PROMPT, FRAMES, N_STEPS = 14, 24, 12
_ST = {}


def _st():
    if not _ST:
        st = make_stacks(ARCH)
        # the cached-cross-K/V twins share every weight with the baseline
        st.jcached = JaxModel(st.jmodel.cfg, cache_cross_kv=True)
        st.tcached = copy.copy(st.tmodel)
        st.tcached.cache_cross_kv = True
        _ST["st"] = st
    return _ST["st"]


def _models(st, cached):
    return (st.jcached, st.tcached) if cached else (st.jmodel, st.tmodel)


def _batch(cfg, seed=0, b=2, frames=FRAMES):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, PROMPT)),
            "frontend": (rng.normal(0, 1, (b, frames, cfg.d_model))).astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("seq,d,atol", [(FRAMES, 256, 1e-5), (300, 1024, 4e-5)])
def test_sinusoidal_positions_match_reference(seq, d, atol):
    got = sinusoidal_positions(seq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_sinusoidal(seq, d)), atol=atol, rtol=0)
    assert sinusoidal_positions(seq, d, torch.bfloat16).dtype == torch.bfloat16


def test_bridge_maps_the_encoder_and_the_cross_blocks():
    st = _st()
    names = dict(st.tmodel.named_parameters())
    assert "mod_proj.w" not in names, "an enc-dec stack has no stub projector"
    assert "layers.0.xattn.wq" in names and "enc_layers.1.mlp.up.w" in names
    assert "enc_layers.0.xattn.wq" not in names and "enc_layers.0.mlp.gate.w" not in names
    assert reference_key("enc_layers.1.attn.wq") == ("enc_unit/0/attn/wq", 1)
    assert reference_key("enc_norm.scale") == ("enc_norm/scale", -1)
    flat = _flatten(st.jparams)
    used = {reference_key(n, st.tmodel.period)[0] for n in names}
    assert used == set(flat)
    for name, p in names.items():
        key, idx = reference_key(name, st.tmodel.period)
        np.testing.assert_array_equal(p.numpy(), flat[key][idx] if idx >= 0 else flat[key])


def test_encoder_matches_reference():
    st = _st()
    frames = _batch(st.tmodel.cfg)["frontend"]
    got = st.tmodel._encode(torch.as_tensor(frames))
    want, _ = st.jmodel._encode(st.jparams, jnp.asarray(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _layer_params(st, layer=0, kind="xattn"):
    jp = {k: v[layer] for k, v in st.jparams["unit"][0][kind].items()}
    return jp, getattr(st.tmodel.layers[layer], kind)


def _xs(cfg, s, seed=1, b=2):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("chunked", [False, True], ids=["flash_jnp", "chunked"])
def test_cross_attention_prefill_matches_reference(chunked):
    """The prefill's cross-attention (no RoPE, non-causal, q of the prompt's
    length, k of the frames') against both of the reference's paths (the
    prefill's blockwise ``_sdpa_chunked``, the forward's flash), and its K/V
    against the encoder output's projections."""

    st = _st()
    cfg = st.tmodel.cfg
    jp, tp = _layer_params(st)
    x, enc = _xs(cfg, PROMPT), _xs(cfg, FRAMES, seed=2)
    out, k, v = tattn.cross_attention_forward(torch.as_tensor(x), tp, cfg, torch.as_tensor(enc))
    pos = jnp.arange(PROMPT)[None]
    want = jattn.attention_forward(jnp.asarray(x), jp, cfg, None, pos, 0,
                                   kv_override=(jnp.asarray(enc), jnp.arange(FRAMES)[None]),
                                   chunked=chunked)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    hd, nkv = cfg.resolved_head_dim, cfg.num_kv_heads
    wk = (enc @ np.asarray(jp["wk"])).reshape(2, FRAMES, nkv, hd)
    np.testing.assert_allclose(k.numpy(), wk, **TOL)
    assert v.shape == k.shape


def test_encoder_attention_matches_reference():
    st = _st()
    cfg = st.tmodel.cfg
    jp = {k: v[0] for k, v in st.jparams["enc_unit"][0]["attn"].items()}
    h = _xs(cfg, FRAMES, seed=3)
    got = tattn.encoder_attention(torch.as_tensor(h), st.tmodel.enc_layers[0].attn, cfg)
    pos = jnp.arange(FRAMES)[None]
    want = jattn.attention_forward(jnp.asarray(h), jp, cfg, None, pos, 0,
                                   kv_override=(jnp.asarray(h), pos), chunked=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_attention_decode_matches_reference():
    """One token's cross-attention: ``cross_attention_cached`` over cached
    K/V against the reference's, and the uncached baseline (K/V projected
    from ``enc_out``) against the reference's ``kv_override`` path."""

    st = _st()
    cfg = st.tmodel.cfg
    jp, tp = _layer_params(st, layer=1)
    x, enc = _xs(cfg, 1, seed=4), _xs(cfg, FRAMES, seed=5)
    hd, nkv = cfg.resolved_head_dim, cfg.num_kv_heads
    xk = (enc @ np.asarray(jp["wk"])).reshape(2, FRAMES, nkv, hd)
    xv = (enc @ np.asarray(jp["wv"])).reshape(2, FRAMES, nkv, hd)
    got = tattn.cross_attention_cached(torch.as_tensor(x), tp, cfg, torch.as_tensor(xk),
                                       torch.as_tensor(xv))
    want = jattn.cross_attention_cached(jnp.asarray(x), jp, cfg, jnp.asarray(xk), jnp.asarray(xv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = tattn.cross_attention_decode(torch.as_tensor(x), tp, cfg, torch.as_tensor(enc))
    want = jattn.attention_forward(jnp.asarray(x), jp, cfg, None, jnp.full((2, 1), 7), 0,
                                   kv_override=(jnp.asarray(enc), jnp.arange(FRAMES)[None]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _paged_plan(b):
    maxp = -(-(PROMPT + N_STEPS) // 16)
    pt = np.arange(b * maxp, dtype=np.int32).reshape(b, maxp)[::-1].copy()
    return maxp, pt, np.full((b,), maxp * 16, np.int32)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached-xkv"])
def test_prefill_decode_step_and_chunk_match_reference(cached, paged):
    """``prefill`` (the encoder, the decoder, the cross K/V cached or not),
    one ``decode_step`` and a ``decode_chunk`` of 12 tokens over the action
    bins, through dense slabs or a reversed page table: logits to 2e-5,
    tokens equal to the reference's."""

    st = _st()
    jm, tm = _models(st, cached)
    cfg = tm.cfg
    batch = _batch(cfg, seed=6)
    b = batch["tokens"].shape[0]
    jl, jc = jm.prefill(st.jparams, _j(batch), extra=0 if paged else N_STEPS)
    tl, tc = tm.prefill(_t(batch), extra=0 if paged else N_STEPS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    assert ("xk" in tc) == cached and tc["enc_out"].shape == (b, FRAMES, cfg.d_model)
    if paged:
        maxp, pt, caps = _paged_plan(b)
        jspec = JaxPagedSpec(num_pages=b * maxp, page_size=16, max_pages_per_seq=maxp)
        jc = jm.cache_to_paged(jc, jm.init_paged_cache(b, jspec), jnp.asarray(pt),
                               jnp.asarray(caps))
        spec = PagedSpec(num_pages=b * maxp, page_size=16, max_pages_per_seq=maxp)
        tc = tm.cache_to_paged(tc, tm.init_paged_cache(b, spec), pt, caps)
        assert tc["enc_out"] is not None and ("xk" in tc) == cached
    floor = st.tok.action_base
    nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None]
    jl1, _ = jm.decode_step(st.jparams, jnp.asarray(nxt), jc)
    t_step = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in tc.items()}
    tl1, _ = tm.decode_step(torch.as_tensor(nxt), t_step)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), atol=LOGIT_ATOL, rtol=0)
    jt, jl2, _ = jm.decode_chunk(st.jparams, jl, jc, N_STEPS, floor)
    tt, tl2, _ = tm.decode_chunk(tl, tc, N_STEPS, floor)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=LOGIT_ATOL, rtol=0)


def test_cached_cross_kv_matches_baseline_decode():
    """The twin of ``tests/test_perf_variants.py:58-78`` (B = 2, S = 32, 32
    frames): the port's cached and uncached stacks agree to 2e-5, as the
    reference's do, and both agree with the reference's."""

    st = _st()
    cfg = st.tmodel.cfg
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32)),
             "frontend": (rng.normal(0, 1, (2, 32, cfg.d_model)) * 0.02).astype(np.float32)}
    l0, c0 = st.tmodel.prefill(_t(batch), extra=4)
    l1, c1 = st.tcached.prefill(_t(batch), extra=4)
    np.testing.assert_allclose(l0.numpy(), l1.numpy(), atol=1e-5, rtol=0)
    assert "xk" in c1 and "xk" not in c0
    nxt = l0[:, -1].argmax(-1)[:, None]
    d0, _ = st.tmodel.decode_step(nxt, c0)
    d1, _ = st.tcached.decode_step(nxt, c1)
    np.testing.assert_allclose(d0.numpy(), d1.numpy(), atol=LOGIT_ATOL, rtol=0)
    jl, jc = st.jcached.prefill(st.jparams, _j(batch), extra=4)
    jd, _ = st.jcached.decode_step(st.jparams, jnp.asarray(nxt.numpy()), jc)
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd), atol=LOGIT_ATOL, rtol=0)


def test_vocab_padding_masks_invalid_ids():
    """The twin of ``tests/test_models.py:143-154``: vocab 514 pads to 768,
    and the padded logits are <= -1e8."""

    st = _st()
    cfg = st.tmodel.cfg
    logits = st.tmodel._logits(st.tmodel.forward(_t(_batch(cfg, seed=9))))
    assert logits.shape[-1] == 768 and logits.shape[-1] % 256 == 0
    assert (logits[..., cfg.vocab_size:] <= -1e8).all()
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()


def test_refusals_match_the_reference():
    """Where the reference refuses (the scheduler, the split executor) the
    port refuses alike; where the reference fails (``CloudPolicy`` on
    observation tokens: ``KeyError: 'frontend'``; a prefill without
    frames) the port refuses up front; the planning helpers answer
    "serving unpartitioned" as the reference's do."""

    st = _st()
    with pytest.raises(NotImplementedError):
        JaxScheduler(st.jmodel, st.jparams, st.jtok)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ContinuousBatchingScheduler(st.tmodel, st.tok)
    with pytest.raises(NotImplementedError):
        JaxExecutor(st.jmodel, st.jparams, 1)
    with pytest.raises(NotImplementedError):
        PartitionExecutor(st.tmodel, 1)
    rng = np.random.default_rng(10)
    qd, tau = rng.normal(0, 0.5, (1, 7)), rng.normal(0, 0.5, (1, 7))
    with pytest.raises(KeyError, match="frontend"):
        jserve.CloudPolicy(st.jmodel, st.jparams, st.jtok)(qd, tau)
    for paged in (False, True):
        with pytest.raises(NotImplementedError, match="frontend"):
            tserve.CloudPolicy(st.tmodel, st.tok, paged=paged)
    with pytest.raises(ValueError, match="frontend"):
        st.tmodel.prefill({"tokens": torch.zeros((1, PROMPT), dtype=torch.long)})
    ex, _ = tserve.plan_fleet_partition(st.tmodel, ARCH, verbose=False)
    jex, _ = jserve.plan_fleet_partition(st.jmodel, st.jparams, ARCH, verbose=False)
    assert ex is None and jex is None
    ex, cuts, _ = tserve.assign_fleet_cuts(st.tmodel, ARCH, [0.02] * 4, network="congested",
                                           verbose=False)
    jex, jcuts, _ = jserve.assign_fleet_cuts(st.jmodel, st.jparams, ARCH, [0.02] * 4,
                                             network="congested", verbose=False)
    assert ex is None and jex is None and cuts == jcuts == {}
