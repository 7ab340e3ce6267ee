"""Checkpoints across the two packages, and the redundancy statistics.

A port checkpoint (``repro_torch.checkpoint.save`` of ``{"params":
reference_tensors(model)}``) restored by ``repro.checkpoint.restore`` into
the reference's parameter tree, and a reference checkpoint restored by the
port into its model, equal bit for bit after the dtype cast (bf16 is
widened to float32 on disk and cast back), on starcoder2-smoke and
jamba-smoke, in bf16 and float32; ``latest_checkpoint``; the Table II
statistics (``core.redundancy``) against ``repro.core.redundancy`` on
``tests/test_system.py``'s pattern and a random batch, to 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import restore as ref_restore  # noqa: E402
from repro.checkpoint import save as ref_save  # noqa: E402
from repro.checkpoint.npz import _flatten  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import redundancy as ref_red  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.checkpoint import latest_checkpoint, restore, save  # noqa: E402
from repro_torch.checkpoint.bridge import load_reference_params, reference_tensors  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import redundancy as red  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker


def _pair(arch, dtype):
    jcfg = jax_smoke(arch).replace(dtype=dtype, param_dtype=dtype)
    jmodel = JaxModel(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = Model(get_smoke_config(arch).replace(dtype=dtype), device="cpu",
                   generator=torch.Generator().manual_seed(3))
    return jmodel, jparams, tmodel


def _same(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got.astype(jnp.float32))
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_checkpoints_restore_across_packages(arch, dtype, tmp_path):
    jmodel, jparams, tmodel = _pair(arch, dtype)
    # port -> reference
    path = save(str(tmp_path / "port"), {"params": reference_tensors(tmodel)}, step=7)
    assert os.path.basename(path) == "ckpt_00000007.npz"
    back = ref_restore(path, {"params": jparams})["params"]
    ours = reference_tensors(tmodel)
    flat = _flatten(back)
    assert set(flat) == set(ours)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert got.dtype == want.dtype
    for key, want in flat.items():
        _same(ours[key], want)
    # reference -> port
    rpath = ref_save(str(tmp_path / "ref"), {"params": jparams}, step=3)
    got = restore(rpath, {"params": reference_tensors(tmodel)})["params"]
    assert all(got[k].dtype == t.dtype for k, t in reference_tensors(tmodel).items())
    load_reference_params(tmodel, got)
    for key, t in reference_tensors(tmodel).items():
        _same(t, _flatten(jparams)[key])
    # and the port reads its own files back, nested structures included
    tree = {"a": [torch.arange(4, dtype=torch.int32), (torch.ones(2, dtype=torch.bfloat16),)],
            "b": np.float32(2.5) * np.ones(3, np.float32)}
    p = save(str(tmp_path / "tree.npz"), tree)
    again = restore(p, tree)
    assert torch.equal(again["a"][0], tree["a"][0])
    assert again["a"][1][0].dtype == torch.bfloat16 and torch.equal(again["a"][1][0],
                                                                   tree["a"][1][0])
    np.testing.assert_array_equal(again["b"], tree["b"])


def test_latest_checkpoint(tmp_path):
    assert latest_checkpoint(str(tmp_path / "none")) is None
    for step in (2, 10, 9):
        save(str(tmp_path), {"x": torch.zeros(1)}, step=step)
    (tmp_path / "ckpt_99.txt").write_text("not a checkpoint")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_00000010.npz")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp.npz")]


def _pattern():
    w = np.full(50, 0.005, np.float32)
    w[10:15] = 0.08  # critical interaction steps (tests/test_system.py)
    return (w / w.sum())[None]


@pytest.mark.parametrize("which", ["pattern", "random"])
def test_redundancy_statistics_match_the_reference(which):
    rng = np.random.default_rng(2)
    if which == "pattern":
        w = _pattern()
    else:
        attn = rng.dirichlet(np.ones(40), size=(3, 4, 6)).astype(np.float32)  # [B,heads,q,L]
        w = np.array(ref_red.step_attention_weights(jnp.asarray(attn)))
        np.testing.assert_allclose(red.step_attention_weights(torch.as_tensor(attn)).numpy(), w,
                                   rtol=1e-6, atol=1e-7)
    ours, theirs = red.redundancy_stats(torch.as_tensor(w)), ref_red.redundancy_stats(
        jnp.asarray(w))
    for name in ref_red.RedundancyStats._fields:
        np.testing.assert_allclose(np.asarray(getattr(ours, name)),
                                   np.asarray(getattr(theirs, name)), rtol=1e-6, atol=1e-7)
    if which == "pattern":
        assert float(ours.p_red[0]) > 0.8 and float(ours.w_crit[0]) > 5 * float(ours.w_red[0])
    kin = rng.standard_normal(w.shape).astype(np.float32) + 3 * w
    for fn in ("pearson_correlation", "surrogate_agreement"):
        got = getattr(red, fn)(torch.as_tensor(kin), torch.as_tensor(w)).numpy()
        want = np.asarray(getattr(ref_red, fn)(jnp.asarray(kin), jnp.asarray(w)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
