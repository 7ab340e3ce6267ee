"""The port's page allocator, per-layer paged KV cache and admission merge
against the JAX package's (``repro/runtime/kv_cache.py``,
``Model.merge_prefill_into_paged``).

Allocator: the same alloc/free sequences (seeded) through both, in
single-shard and shard-aware modes; the page ids handed out, the
``OutOfPages`` and double-free errors, the in-use / free / high-water counts
and the lifetime counters must be equal.  Paged cache: the same prompts and
decode appends; equal page tables and lengths, and ``attend`` within 1e-5
of the reference's (float32, the same sums in another order).  Merge: the
f32 openvla-smoke and jamba-smoke stacks (weights bridged from the
reference's ``Model.init``), live state filled with the same random
values; pools and Mamba state within 1e-4 (each side's own prefill K/V,
held to 1e-4 by ``test_torch_model.py``), ``len``/``pt``/``cap`` equal, and
the padding row leaves every live row untouched.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# The tests run under pytest-xdist, whose workers each import every test
# module before running any: one intra-op thread a worker keeps the workers'
# torch thread pools from oversubscribing the cores (8 threads a worker made
# the torch test files 20-40x slower than alone).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import _flatten  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.runtime import kv_cache as jkv  # noqa: E402
from repro_torch.checkpoint.bridge import load_reference_params  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime import kv_cache as tkv  # noqa: E402

JAX_F32 = dict(dtype="float32", param_dtype="float32")

# (num_pages, num_shards, pages_per_shard)
MODES = [(24, 1, None), (24, 2, None), (23, 3, None), (15, 2, 8), (40, 4, 10)]


def _alloc_log(mod, num_pages, num_shards, pages_per_shard, seed):
    """A seeded run of allocs (some pinned to a shard), frees, high-water
    resets and a reclaim -> everything the allocator showed."""

    a = mod.PageAllocator(num_pages, num_shards=num_shards, pages_per_shard=pages_per_shard)
    rng = np.random.default_rng(seed)
    held, log = [], []
    for i in range(120):
        op = rng.random()
        if op < 0.55:
            n = int(rng.integers(1, 7))
            shard = int(rng.integers(0, num_shards)) if num_shards > 1 and rng.random() < 0.3 else None
            try:
                pages = a.alloc(n, shard=shard)
                held.append(pages)
                log.append(("alloc", n, shard, pages))
            except mod.OutOfPages:
                log.append(("out", n, a.num_free))
        elif op < 0.9 and held:
            pages = held.pop(int(rng.integers(0, len(held))))
            a.free(pages)
            log.append(("free", pages))
            if rng.random() < 0.2:
                with pytest.raises(ValueError):
                    a.free(pages[:1])
                log.append(("double free refused", pages[0]))
        elif op < 0.95:
            a.reset_high_water()
            log.append(("reset high water",))
        elif i > 60:
            a.reclaim_all()
            held.clear()
            log.append(("reclaim",))
        log.append((a.num_free, a.num_in_use, a.high_water, a.total_allocs, a.total_frees,
                     a.shard_in_use, a.shard_free, a.shard_high_water, a._free))
    with pytest.raises(ValueError):
        a.free([num_pages])
    return log


@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"pages{m[0]}-shards{m[1]}-pps{m[2]}")
@pytest.mark.parametrize("seed", [0, 1])
def test_page_allocator_matches_reference(mode, seed):
    assert _alloc_log(tkv, *mode, seed) == _alloc_log(jkv, *mode, seed)


def test_page_allocator_argument_errors_match_reference():
    for args, kw in (((0,), {}), ((4,), {"num_shards": 0}), ((10,), {"num_shards": 2, "pages_per_shard": 4})):
        with pytest.raises(ValueError):
            jkv.PageAllocator(*args, **kw)
        with pytest.raises(ValueError):
            tkv.PageAllocator(*args, **kw)


def _cache_run(mod, to_array, seed=1):
    """Prompts of 5, 33 and 16 tokens, 20 decode appends crossing page
    boundaries, a free and a reuse -> (tables, lengths, attend output)."""

    kvh, d = 2, 32
    kw = dict(num_pages=24, page_size=16, num_kv_heads=kvh, head_dim=d, max_pages_per_seq=8)
    cache = mod.PagedKVCache(**kw, **({"device": "cpu"} if mod is tkv else {}))
    rng = np.random.default_rng(seed)
    out = []
    for sid, plen in [(0, 5), (1, 33), (2, 16)]:
        cache.add_seq(sid)
        cache.write_prompt(sid, to_array(rng.normal(size=(plen, kvh, d))),
                           to_array(rng.normal(size=(plen, kvh, d))))
    for _ in range(20):
        ids = cache.seq_ids
        cache.append(ids, to_array(rng.normal(size=(len(ids), kvh, d))),
                     to_array(rng.normal(size=(len(ids), kvh, d))))
    out.append((cache.page_table(), cache.lengths(), cache.can_admit(70), cache.can_admit(200)))
    q = to_array(rng.normal(size=(3, 8, d)))
    att = np.asarray(cache.attend(q))
    cache.free_seq(1)
    cache.add_seq(7)
    cache.write_prompt(7, to_array(np.ones((20, kvh, d))), to_array(np.ones((20, kvh, d))))
    out.append((cache.page_table(), cache.lengths(), cache.seq_len(7), cache.allocator.num_free))
    return out, att


def test_paged_cache_append_attend_matches_reference():
    want, want_att = _cache_run(jkv, lambda a: jnp.asarray(a, jnp.float32))
    got, got_att = _cache_run(tkv, lambda a: torch.as_tensor(np.asarray(a, np.float32)))
    for w, g in zip(want, got):
        for x, y in zip(w, g):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    np.testing.assert_allclose(got_att, want_att, atol=1e-5, rtol=1e-5)


def test_paged_cache_out_of_pages_matches_reference():
    for mod, zeros in ((jkv, lambda s: jnp.zeros(s)), (tkv, lambda s: torch.zeros(s))):
        extra = {"device": "cpu"} if mod is tkv else {}
        cache = mod.PagedKVCache(num_pages=2, page_size=4, num_kv_heads=1, head_dim=8,
                                 max_pages_per_seq=4, **extra)
        cache.add_seq(0)
        assert not cache.can_admit(12)
        with pytest.raises(mod.OutOfPages):
            cache.write_prompt(0, zeros((12, 1, 8)), zeros((12, 1, 8)))
        big = mod.PagedKVCache(num_pages=16, page_size=4, num_kv_heads=1, head_dim=8,
                               max_pages_per_seq=2, **extra)
        big.add_seq(0)
        with pytest.raises(mod.OutOfPages):
            big.write_prompt(0, zeros((12, 1, 8)), zeros((12, 1, 8)))
        with pytest.raises(ValueError):
            big.add_seq(0)


# ---------------------------------------------------------------------------
# merge_prefill_into_paged
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["openvla-7b", "jamba-1.5-large-398b"])
def stacks(request):
    jcfg = jax_smoke(request.param).replace(**JAX_F32)
    jmodel = JaxModel(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = Model(get_smoke_config(request.param).replace(dtype="float32"), device="cpu")
    load_reference_params(tmodel, _flatten(jparams))
    return jmodel, jparams, tmodel


PROMPT, PAGE, MAXP, ROWS, POOL = 14, 8, 4, 3, 12


def _live_state(rng, tmodel, jmodel, spec):
    """The same random live paged state in both layouts."""

    tcache = tmodel.init_paged_cache(ROWS, spec)
    jcache = jmodel.init_cache(ROWS, 0, paged=jkv.PagedSpec(spec.num_pages, spec.page_size,
                                                             spec.max_pages_per_seq))
    for name in ("kp", "vp", "h", "conv"):
        if name in tcache:
            tcache[name].copy_(torch.as_tensor(rng.normal(size=tuple(tcache[name].shape)),
                                               dtype=tcache[name].dtype))
    tcache["len"].copy_(torch.as_tensor([3, 9, 40], dtype=torch.int32))
    tcache["pt"].copy_(torch.as_tensor(rng.integers(0, POOL, (ROWS, MAXP)), dtype=torch.int32))
    tcache["cap"].copy_(torch.as_tensor([32, 0, 32], dtype=torch.int32))
    unit = []
    for u, entry in enumerate(jcache["unit"]):
        layers = [i for i in range(tmodel.cfg.num_layers) if i % tmodel.period == u]
        new = {}
        for name, arr in entry.items():
            port = {"kp": "kp", "vp": "vp", "h": "h", "conv": "conv"}[name]
            stacked = np.stack([tcache[port][tmodel.slot[i]].numpy() for i in layers])
            new[name] = jnp.asarray(stacked, arr.dtype)
        unit.append(new)
    jcache = {"unit": unit, **{k: jnp.asarray(tcache[k].numpy()) for k in ("len", "pt", "cap")}}
    return tcache, jcache


def test_merge_prefill_into_paged_matches_reference(stacks):
    """Two admitted prompts into rows 2 and 0 plus one padding row (index
    ROWS, length 0): the reference drops it; the port must too."""

    jmodel, jparams, tmodel = stacks
    rng = np.random.default_rng(5)
    spec = tkv.PagedSpec(num_pages=POOL, page_size=PAGE, max_pages_per_seq=MAXP)
    tcache, jcache = _live_state(rng, tmodel, jmodel, spec)
    before = {k: v.clone() for k, v in tcache.items()}
    tokens = rng.integers(128, 256, (3, PROMPT))
    _, jd = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, extra=0)
    _, td = tmodel.prefill({"tokens": torch.as_tensor(tokens)}, extra=0)
    pt = np.asarray([[4, 5, 6, 7], [8, 9, 10, 11], [0, 0, 0, 0]], np.int32)
    row_idx = np.asarray([2, 0, ROWS])
    lens = np.asarray([PROMPT, PROMPT, 0], np.int32)
    caps = np.asarray([MAXP * PAGE, MAXP * PAGE, 0], np.int32)
    want = jmodel.merge_prefill_into_paged(jd, jcache, jnp.asarray(pt), jnp.asarray(row_idx),
                                           jnp.asarray(lens), jnp.asarray(caps))
    got = tmodel.merge_prefill_into_paged(td, tcache, pt, row_idx, lens, caps)
    assert got is tcache, "the merge updates the live cache in place"
    for k in ("len", "pt", "cap"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["len"].numpy(), [PROMPT, 9, PROMPT])
    np.testing.assert_array_equal(got["pt"][1].numpy(), before["pt"][1].numpy())
    for i, spec_i in enumerate(tmodel.specs):
        entry = want["unit"][i % tmodel.period]
        j = tmodel.slot[i]
        names = ("kp", "vp") if spec_i[0] == "attn" else ("h", "conv")
        for name in names:
            w = np.asarray(entry[name][i // tmodel.period])
            g = got[name][j].numpy()
            if spec_i[0] == "attn":  # the trash page takes padding writes in any order
                w, g = w[:-1], g[:-1]
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=f"layer {i} {name}")
            if spec_i[0] != "attn":  # row 1 holds no admission: bit-equal
                np.testing.assert_array_equal(g[1], before[name][j][1].numpy())
    # pages no admission names are untouched (page 3 is neither new nor trash)
    np.testing.assert_array_equal(got["kp"][:, 3].numpy(), before["kp"][:, 3].numpy())
