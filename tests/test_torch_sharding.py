"""The port's logical sharding rules, meshes, shard-aware page allocator
and ``Model.param_logical`` against the JAX package's (twins of
``tests/test_sharding.py``).

``logical_to_pspec`` and ``pspec_tree`` run against the reference's own
functions on the same stub meshes (specs equal as tuples); the allocator
cases run the same script through both allocators; ``param_logical`` is
held key for key to the reference's on every smoke arch.  Nothing here
needs more than one device: a port mesh may repeat a device.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

import jax  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import sharding as jshard  # noqa: E402
from repro.models.layers import is_axes  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.runtime.kv_cache import OutOfPages as JaxOutOfPages  # noqa: E402
from repro.runtime.kv_cache import PageAllocator as JaxAllocator  # noqa: E402
from repro_torch.checkpoint.bridge import reference_tensors  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tshard  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime.kv_cache import OutOfPages, PageAllocator  # noqa: E402

CPU = torch.device("cpu")


class _FakeMesh:
    """Stub with the two attributes ``logical_to_pspec`` reads."""

    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


# ---------------------------------------------------------------------------
# logical_to_pspec / pspec_tree against the reference
# ---------------------------------------------------------------------------

# (mesh shape, array shape, logical axes, rule overrides)
PSPEC_CASES = {
    "batch_to_data": (dict(data=4, model=2), (8, 16, 256), ("batch", "seq", "embed"), None),
    "pages_rule": (dict(data=4, model=2), (64, 16, 2, 64),
                   ("pages", None, "kv_heads", "head_dim"), None),
    "non_divisible": (dict(data=2, model=16), (8, 24, 64), ("batch", "heads", "head_dim"), None),
    "axis_once": (dict(data=4, model=2), (8, 8), ("batch", "expert"), None),
    "multipod_batch": (dict(pod=2, data=4, model=2), (16, 256), ("batch", "embed"), None),
    "override": (dict(data=4, model=2), (8, 16, 256), ("batch", "seq", "embed"),
                 {"seq": ("model",)}),
    "pool_uneven": (dict(data=8, model=1), (63, 16, 2, 64), ("pages", None, "kv_heads", None),
                    None),
    "unknown_name": (dict(data=4, model=2), (8, 4), ("batch", "no_such_axis"), None),
}


@pytest.mark.parametrize("case", sorted(PSPEC_CASES))
def test_logical_to_pspec_matches_reference(case):
    mshape, shape, axes, overrides = PSPEC_CASES[case]
    m = _FakeMesh(**mshape)
    want = jshard.logical_to_pspec(shape, axes, m, jshard.make_rules(m, overrides))
    got = tshard.logical_to_pspec(shape, axes, m, tshard.make_rules(m, overrides))
    assert tuple(got) == tuple(want)
    assert isinstance(got, tuple) and got == tshard.P(*tuple(want))


def test_default_rules_match_reference():
    assert tshard.DEFAULT_RULES == jshard.DEFAULT_RULES
    assert tshard.MULTIPOD_BATCH == jshard.MULTIPOD_BATCH
    assert tshard.DEFAULT_RULES["pages"] == ("data",)


def test_pspec_tree_none_axis_replicates():
    m = _FakeMesh(data=4, model=2)
    shapes = {"w": (8, 256), "b": (256,), "l": [(4, 2), (8,)]}
    logical = {"w": ("batch", None), "b": (None,), "l": [("batch", "heads"), ("expert",)]}
    got = tshard.pspec_tree(shapes, logical, m)
    want = jshard.pspec_tree(shapes, logical, m)
    assert got == {"w": ("data", None), "b": (None,), "l": [("data", "model"), ("data",)]}
    assert {k: v for k, v in got.items() if k != "l"} == {
        k: tuple(v) for k, v in want.items() if k != "l"}
    assert [tuple(x) for x in want["l"]] == got["l"]


@pytest.mark.parametrize("shape,spec,local", [
    ((64, 16, 2, 64), ("data", None, "model", None), (16, 16, 1, 64)),
    ((16, 256), (("pod", "data"), None), (2, 256)),
    ((8,), (None,), (8,)),
    ((8, 3), ("data",), (2, 3)),
])
def test_shard_shape(shape, spec, local):
    m = _FakeMesh(pod=2, data=4, model=2)
    assert tshard.shard_shape(m, shape, spec) == local


def test_shard_shape_and_pspec_refuse_bad_input():
    with pytest.raises(ValueError, match="does not divide"):
        tshard.shard_shape(_FakeMesh(data=4), (6,), ("data",))
    with pytest.raises(ValueError, match="differ in length"):
        tshard.logical_to_pspec((8, 4), ("batch",), _FakeMesh(data=4))


# ---------------------------------------------------------------------------
# shard() and the contexts
# ---------------------------------------------------------------------------


def test_shard_identity_outside_and_inside_context():
    x = torch.ones((4, 4))
    assert tshard.shard(x, "batch", None) is x
    with tshard.sharding_rules(tmesh.make_test_mesh(data=4, devices=[CPU] * 4)):
        assert tshard.shard(x, "batch", None) is x


def test_sharding_rules_and_no_sharding_contexts():
    mesh = tmesh.make_test_mesh(data=2, devices=[CPU] * 2)
    assert tshard.active_mesh() is None
    with tshard.sharding_rules(mesh, {"seq": ("data",)}) as rules:
        assert tshard.active_mesh() is mesh and rules["seq"] == ("data",)
        with tshard.no_sharding():
            assert tshard.active_mesh() is None
        assert tshard.active_mesh() is mesh  # restored after the suspension
        inner = tmesh.make_test_mesh(data=1, devices=[CPU])
        with tshard.sharding_rules(inner):
            assert tshard.active_mesh() is inner
        assert tshard.active_mesh() is mesh
    assert tshard.active_mesh() is None


# ---------------------------------------------------------------------------
# mesh factories
# ---------------------------------------------------------------------------


def test_make_host_mesh_on_the_cpu():
    mesh = tmesh.make_host_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 1}
    assert mesh.distinct_devices == [CPU]
    assert tmesh.make_host_mesh(model=5, device="cpu").shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("n,model,shape", [(6, 4, (2, 3)), (7, 4, (7, 1)), (8, 3, (4, 2)),
                                           (4, 1, (4, 1)), (2, 9, (1, 2))])
def test_make_host_mesh_shrinks_model_to_divisor(monkeypatch, n, model, shape):
    """The reference's rule on ``n`` cards (a device count, no card used)."""

    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    mesh = tmesh.make_host_mesh(model=model)
    assert (mesh.shape["data"], mesh.shape["model"]) == shape
    assert mesh.distinct_devices == [torch.device("cuda", i) for i in range(n)]


def test_make_host_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_host_mesh()


def test_make_test_mesh_validates_device_count():
    with pytest.raises(ValueError, match="needs 3 devices but found 2"):
        tmesh.make_test_mesh(data=3, devices=[CPU, CPU])
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.make_test_mesh(data=2, device="cpu")


def test_make_test_mesh_repeats_a_device():
    mesh = tmesh.make_test_mesh(data=8, devices=[CPU] * 8)
    assert mesh.shape == {"data": 8, "model": 1}
    assert mesh.devices.shape == (8, 1) and mesh.distinct_devices == [CPU]
    two = tmesh.make_test_mesh(data=2, model=2, devices=["cpu"] * 4)
    assert two.shape == {"data": 2, "model": 2}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_shape(multi_pod):
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    want = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    assert mesh.shape == want and tuple(mesh.axis_names) == tuple(want)
    assert mesh.distinct_devices == [torch.device("meta")]


def test_split_device_groups(monkeypatch):
    assert tmesh.split_device_groups(device="cpu") == ([CPU], [CPU])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    prefill, decode = tmesh.split_device_groups(prefill=1)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert prefill == cards[3:] and decode == cards[:3]
    assert tmesh.split_device_groups(prefill=4) == (cards, cards)


# ---------------------------------------------------------------------------
# the shard-aware page allocator, script for script with the reference's
# ---------------------------------------------------------------------------


def steers(a, oop):
    p1 = a.alloc(3)
    p2 = a.alloc(3)
    log = [p1, p2, [a.shard_of(p) for p in p1 + p2]]
    a.free(p1)
    a.free(p2)
    return log + [a.num_free, list(a.shard_in_use), list(a.shard_high_water)]


def spills(a, oop):
    ps = a.alloc(10)
    log = [ps, [a.shard_of(p) for p in ps]]
    try:
        a.alloc(6)
        log.append("no raise")
    except oop:
        log.append("out of pages")
    a.free(ps)
    return log + [a.num_free, list(a.shard_in_use)]


def pin_and_high_water(a, oop):
    ps = a.alloc(2, shard=2)
    log = [ps, list(a.shard_in_use), list(a.shard_high_water)]
    a.free(ps)
    log += [list(a.shard_in_use), list(a.shard_high_water)]
    a.reset_high_water()
    return log + [list(a.shard_high_water), a.high_water]


def remainder(a, oop):
    return [a.shard_free, a.shard_of(14), a.shard_of(0), a.shard_of(12)]


def churn(a, oop):
    log, held = [], []
    for n in (4, 4, 2, 3):
        held.append(a.alloc(n))
        log.append(held[-1])
    a.free(held.pop(1))
    log.append(a.alloc(4))
    a.reclaim_all()
    return log + [a.num_free, list(a.shard_in_use), a.total_allocs, a.total_frees]


@pytest.mark.parametrize("script", [steers, spills, pin_and_high_water, remainder, churn])
def test_allocator_matches_reference(script):
    kw = dict(num_shards=4, pages_per_shard=4)
    assert script(PageAllocator(15, **kw), OutOfPages) == script(JaxAllocator(15, **kw),
                                                                  JaxOutOfPages)


def test_allocator_single_shard_unchanged():
    for a, oop in ((PageAllocator(6), OutOfPages), (JaxAllocator(6), JaxOutOfPages)):
        assert a.num_shards == 1
        ps = a.alloc(4)
        assert ps == [0, 1, 2, 3]
        a.free(ps[:2])
        with pytest.raises(oop):
            a.alloc(5)
        a.reclaim_all()
        assert a.num_free == 6


# ---------------------------------------------------------------------------
# Model.param_logical
# ---------------------------------------------------------------------------


def _reference_logical(arch):
    tree = JaxModel(jax_smoke(arch)).param_logical()
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_axes)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): ax.names
            for path, ax in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_logical_matches_reference(arch):
    model = Model(get_smoke_config(arch), device="cpu")
    got = model.param_logical()
    want = _reference_logical(arch)
    assert got == want
    # laid out on the production mesh, key for key as the reference lays it
    shapes = {k: tuple(t.shape) for k, t in reference_tensors(model).items()}
    assert shapes.keys() == got.keys()
    m = _FakeMesh(data=16, model=16)
    specs = tshard.pspec_tree(shapes, got, m)
    for key, names in want.items():
        assert specs[key] == tuple(jshard.logical_to_pspec(shapes[key], names, m)), key
