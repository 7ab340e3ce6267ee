"""The port's public surface against the reference's, and the helpers'
twins.

Surface parity reads both trees with ``ast`` (no import): for each module
of ``src/repro/``, every public top-level ``def`` or ``class`` has a
namesake (a def, class, assignment or import) in the port's module at the
same relative path, and every name of a reference package's ``__all__`` is
in the port's ``__all__``.  The names that have no twin, by design, are the
rows of ``EXEMPT``; a row that names nothing of the reference, or a name
the port now has, is stale and fails.  Leading-underscore names are out of
scope.

The helpers are held to the reference on the CPU: ``window_sum`` to 1e-6,
``min_jerk`` / ``min_jerk_segment`` to rtol = atol = 1e-5 (float32
``linspace`` differs in the last bits), ``logits_from_embedding`` to 1e-5,
``cross_entropy_loss`` to 1e-6, ``attention_mask`` exactly.
"""

import ast
import importlib
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import stats as jstats  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.robotics import dynamics as jdyn  # noqa: E402
from repro_torch.core import stats as tstats  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.robotics import dynamics as tdyn  # noqa: E402

# (``repro.obs`` exports the function ``clock``, which shadows the module)
jclock = importlib.import_module("repro.obs.clock")
tclock = importlib.import_module("repro_torch.obs.clock")

SRC = Path(__file__).resolve().parents[1] / "src"


class Exemption(NamedTuple):
    names: Dict[str, Tuple[str, ...]]  # reference module -> its names without a namesake
    why: str
    counterpart: str
    twins: Tuple[str, ...] = ()        # "module::name" of the port that must exist


INIT_WHY = ("param-tree builders over the jax PRNG, which torch cannot reproduce "
            "(ROADMAP §3)")

EXEMPT = (
    Exemption({"compat.py": ("cost_dict",)}, "jax version shims", "none"),
    Exemption({"models/layers.py": ("Axes", "is_axes", "abstract_init")},
              "logical-axis annotations of jax param trees",
              '`launch/sharding.py` rules; `Model(device="meta")`',
              ("launch/sharding.py::make_rules", "models/model.py::Model")),
    Exemption({"models/layers.py": ("init_dense", "init_embedding", "init_mlp", "init_norm"),
               "models/attention.py": ("init_attention",), "models/moe.py": ("init_moe",),
               "models/ssm.py": ("init_mamba",), "models/xlstm.py": ("init_mlstm", "init_slstm")},
              INIT_WHY,
              "the `nn.Module`s own their parameters; weights come over `checkpoint/bridge.py`",
              ("checkpoint/bridge.py::load_reference_params",)),
    Exemption({"models/attention.py": ("flash_attention_jnp",)},
              "the jnp flash with its custom VJP",
              "`kernels/ref.py` `flash_attention_ref` / `_lse_ref` / `_bwd_ref`; "
              "`ops.flash_attention_train`",
              ("kernels/ref.py::flash_attention_ref", "kernels/ref.py::flash_attention_lse_ref",
               "kernels/ref.py::flash_attention_bwd_ref", "kernels/ops.py::flash_attention_train")),
    Exemption({"models/ssm.py": ("ssd_chunked",)}, "lives beside the plain versions",
              "`kernels/ref.py:206` `mamba_scan_ref`", ("kernels/ref.py::mamba_scan_ref",)),
    Exemption({"launch/sharding.py": ("named_sharding",), "runtime/kv_cache.py": ("donating_jit",),
               "launch/dryrun.py": ("build_combo",)},
              "jax `NamedSharding`, jit donation, a jitted closure to lower",
              "`launch/mesh.py`; none; `launch/dryrun.py` lowers nothing",
              ("launch/mesh.py::make_test_mesh",)),
    Exemption({"roofline/analysis.py": ("collective_bytes_from_hlo",),
               "roofline/__init__.py": ("HW_V5E",)},
              "HLO parsing (the port compiles none); a TPU's figures, which the port never states",
              "none; `HW_H100`", ("roofline/__init__.py::HW_H100",)),
)


def _exempt(rel: str, name: str) -> bool:
    return any(name in e.names.get(rel, ()) for e in EXEMPT)


def read_tree(root: Path) -> Dict[str, str]:
    return {str(p.relative_to(root)): p.read_text() for p in sorted(root.rglob("*.py"))}


def _public_defs(tree: ast.Module):
    return {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _namesakes(tree: ast.Module):
    """Every top-level name a module binds: defs, classes, assignments, imports."""

    out = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
    return out


def _all(tree: ast.Module) -> Optional[set]:
    for n in tree.body:
        if isinstance(n, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__"
                                             for t in n.targets):
            return set(ast.literal_eval(n.value))
    return None


def _imported_from(tree: ast.Module, name: str, pkg: str) -> Optional[str]:
    """The module (relative path) a package's ``__init__`` imports ``name`` from."""

    for n in tree.body:
        if isinstance(n, ast.ImportFrom) and n.module and n.module.startswith(pkg + "."):
            if any((a.asname or a.name) == name for a in n.names):
                return n.module[len(pkg) + 1:].replace(".", "/") + ".py"
    return None


def surface_faults(ref: Dict[str, str], port: Dict[str, str]):
    """Every gap between the two surfaces and every stale exemption."""

    faults = []
    rtrees = {rel: ast.parse(src) for rel, src in ref.items()}
    ptrees = {rel: ast.parse(src) for rel, src in port.items()}
    for rel, rtree in rtrees.items():
        ptree = ptrees.get(rel)
        have = _namesakes(ptree) if ptree is not None else set()
        for name in sorted(_public_defs(rtree) - have):
            if not _exempt(rel, name):
                faults.append(f"{rel}: {name} has no namesake in the port")
        want = _all(rtree)
        if want is None:
            continue
        got = (_all(ptree) if ptree is not None else None) or set()
        for name in sorted(want - got):
            source = _imported_from(rtree, name, "repro")
            if not (_exempt(rel, name) or (source and _exempt(source, name))):
                faults.append(f"{rel}: {name} of __all__ is not in the port's __all__")
    for e in EXEMPT:
        for rel, names in e.names.items():
            rtree = rtrees.get(rel)
            for name in names:
                known = rtree is not None and (name in _public_defs(rtree)
                                               or name in (_all(rtree) or ()))
                if not known:
                    faults.append(f"stale exemption: {rel}: {name} is not in the reference")
                elif rel in ptrees and (name in _namesakes(ptrees[rel])
                                        or name in (_all(ptrees[rel]) or ())):
                    faults.append(f"stale exemption: {rel}: the port has {name}")
        for twin in e.twins:
            rel, name = twin.split("::")
            if rel not in ptrees or name not in _namesakes(ptrees[rel]):
                faults.append(f"exemption's counterpart {twin} is not in the port")
    return faults


def test_the_port_has_the_references_public_surface():
    assert surface_faults(read_tree(SRC / "repro"), read_tree(SRC / "repro_torch")) == []


MUTATIONS = {
    # a new public function of the reference with no twin and no entry
    "new_reference_name": ("repro", "core/stats.py", lambda s: s + "\n\ndef window_max(s):\n"
                           "    return s.buf.max(-1)\n", "core/stats.py: window_max"),
    # a twin taken out of the port
    "twin_removed": ("repro_torch", "core/dispatcher.py",
                     lambda s: s.replace("def run_episode(", "def _run_episode("),
                     "core/dispatcher.py: run_episode"),
    "all_name_removed": ("repro_torch", "core/__init__.py",
                         lambda s: s.replace('    "run_episode",\n', ""),
                         "core/__init__.py: run_episode of __all__"),
    # an exempt name that the reference no longer has
    "stale_entry": ("repro", "models/ssm.py",
                    lambda s: s.replace("def ssd_chunked(", "def _ssd_chunked("),
                    "stale exemption: models/ssm.py: ssd_chunked"),
    # an exempt name that the port now has
    "entry_now_ported": ("repro_torch", "runtime/kv_cache.py",
                         lambda s: s + "\n\ndef donating_jit(fn):\n    return fn\n",
                         "stale exemption: runtime/kv_cache.py: the port has donating_jit"),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_surface_check_catches(mutation):
    trees = {"repro": read_tree(SRC / "repro"), "repro_torch": read_tree(SRC / "repro_torch")}
    side, rel, edit, expect = MUTATIONS[mutation]
    before = trees[side][rel]
    trees[side][rel] = edit(before)
    assert trees[side][rel] != before
    faults = surface_faults(trees["repro"], trees["repro_torch"])
    assert any(f.startswith(expect) for f in faults), faults


def test_package_exports_resolve():
    import repro_torch.configs
    import repro_torch.core
    import repro_torch.data
    from repro_torch.configs import MoEConfig  # noqa: F401
    from repro_torch.core import dispatcher_step, run_episode, trigger_step  # noqa: F401
    from repro_torch.data import EpisodeTokenizer  # noqa: F401

    for mod in (repro_torch.core, repro_torch.data, repro_torch.configs):
        for name in mod.__all__:
            assert getattr(mod, name) is not None, (mod.__name__, name)


# ---------------------------------------------------------------------------
# the helpers' twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("updates", [0, 3, 7, 19])
def test_window_sum_matches_reference(updates):
    rng = np.random.default_rng(updates)
    xs = rng.standard_normal((updates, 4, 3)).astype(np.float32)
    js, ts = jstats.window_init(7, (4, 3)), tstats.window_init(7, (4, 3), device="cpu")
    for x in xs:
        js, ts = jstats.window_update(js, jnp.asarray(x)), tstats.window_update(ts, torch.as_tensor(x))
    np.testing.assert_allclose(tstats.window_sum(ts).numpy(), np.asarray(jstats.window_sum(js)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tstats.window_moving_average(ts).numpy(),
                               np.asarray(jstats.window_moving_average(js)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("steps,dt", [(2, 0.01), (50, 0.002), (301, 0.002)])
def test_min_jerk_matches_reference(steps, dt):
    rng = np.random.default_rng(steps)
    t = np.linspace(0.0, 1.0, 33, dtype=np.float32)
    got = tdyn.min_jerk(t)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jdyn.min_jerk(jnp.asarray(t))), rtol=1e-5, atol=1e-5)
    q0, q1 = (rng.uniform(-1, 1, 7).astype(np.float32) for _ in range(2))
    got = tdyn.min_jerk_segment(q0, q1, steps, dt)
    want = jdyn.min_jerk_segment(jnp.asarray(q0), jnp.asarray(q1), steps, dt)
    for name, a, b in zip(("q", "qd", "qdd"), got, want):
        assert a.dtype == np.float32 and a.shape == (steps, 7), name
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("vocab,vpad", [(512, 512), (300, 512)])
def test_logits_from_embedding_matches_reference(cap, vocab, vpad):
    rng = np.random.default_rng(vpad + vocab)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    table = rng.standard_normal((vpad, 64)).astype(np.float32)
    got = tlayers.logits_from_embedding(torch.as_tensor(x), torch.as_tensor(table), vocab, cap)
    want = jlayers.logits_from_embedding(jnp.asarray(x), jnp.asarray(table), vocab, cap)
    assert got.shape == (2, 5, vpad) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (got[..., vocab:] == -1e9).all()


@pytest.mark.parametrize("mask", ["none", "some", "zero"])
def test_cross_entropy_loss_matches_reference(mask):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, 6, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 40, (3, 6)).astype(np.int32)
    m = {"none": None, "some": (rng.random((3, 6)) < 0.5).astype(np.float32),
         "zero": np.zeros((3, 6), np.float32)}[mask]
    got = tlayers.cross_entropy_loss(torch.as_tensor(logits), torch.as_tensor(labels),
                                     None if m is None else torch.as_tensor(m))
    want = jlayers.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                      None if m is None else jnp.asarray(m))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("q_off,k_off", [(0, 0), (5, 0), (2, 4)])
def test_attention_mask_matches_reference(causal, window, q_off, k_off):
    q_pos = np.arange(6)[None].repeat(2, 0) + np.array([[q_off], [q_off + 1]])
    k_pos = np.arange(9)[None].repeat(2, 0) + k_off
    got = tattn.attention_mask(torch.as_tensor(q_pos), torch.as_tensor(k_pos), causal, window)
    want = jattn.attention_mask(jnp.asarray(q_pos), jnp.asarray(k_pos), causal, window)
    assert got.dtype == torch.bool and got.shape == (2, 6, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_clock_ms_is_monotonic():
    reads = [tclock.clock_ms() for _ in range(1000)]
    assert all(b >= a for a, b in zip(reads, reads[1:]))
    t0 = tclock.clock_ms()
    time.sleep(0.01)
    assert tclock.clock_ms() - t0 >= 10.0 - 1e-6
    # the same timebase as the reference's (both perf_counter)
    assert abs(tclock.clock_ms() - jclock.clock_ms()) < 1e3
