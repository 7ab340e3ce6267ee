"""Serving twins of the MoE stacks against the JAX package.

* ``serve_episode`` on phi3.5-moe-smoke (every layer MoE) under
  ``moe_impl`` dense and capacity, dense and paged caches: the rules of
  ``test_torch_serve.py`` (equal offload counts, actions equal to 1e-6,
  which one differing greedy token would break by a whole bin).
* the continuous-batching scheduler at ``scan_rounds=4`` on
  ``Model(moe_impl="capacity")`` against the reference scheduler on the
  reference's capacity twin: the rules of ``test_torch_scheduler.py``.  The
  decode rounds route every row, idle ones included, so the drops depend
  on the rows, as in the reference (which runs its Pallas paged kernel in
  interpret mode there: see the test).
* the split executor's guard (capacity dispatch with ``expert_offload``
  raises, as the reference's) and the expert-offload lanes on
  phi3.5-moe-smoke against the reference executor, as
  ``test_torch_partition.py`` holds jamba-smoke's.
* the serve CLI with ``--arch phi3.5-moe-42b-a6.6b --device cpu``.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # as test_torch_scheduler.py: xdist workers share the cores

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.partition.executor import PartitionExecutor as JaxExecutor  # noqa: E402
from repro.partition.executor import PartitionedPolicy as JaxPolicy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.partition import PartitionExecutor, PartitionedPolicy  # noqa: E402

from test_torch_partition import _jax_chunk_tokens, _offload_cases  # noqa: E402
from test_torch_scheduler import (  # noqa: E402
    _obs,
    _obs_tokens,
    assert_tokens_match,
    make_stacks,
    run_twin,
    staggered,
)

ARCH = "phi3.5-moe-42b-a6.6b"
STEPS = 80


@functools.lru_cache(maxsize=None)
def stacks(moe_impl):
    """``make_stacks``' f32 twins of phi3.5-moe-smoke under ``moe_impl`` (the
    capacity pair shares the dense pair's weights)."""

    base = make_stacks(ARCH)
    if moe_impl == "dense":
        return base
    tmodel = Model(base.tmodel.cfg, device="cpu", moe_impl=moe_impl)
    tmodel.load_state_dict(base.tmodel.state_dict())
    return SimpleNamespace(**{**vars(base), "tmodel": tmodel, "admit_fns": {}, "decode_fns": {},
                              "jmodel": JaxModel(base.jmodel.cfg, moe_impl=moe_impl)})


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("moe_impl", ["dense", "capacity"])
def test_serve_episode_matches_reference(moe_impl, paged):
    st = stacks(moe_impl)
    want = jserve.serve_episode(
        jserve.CloudPolicy(st.jmodel, st.jparams, st.jtok, paged=paged),
        task="drawer_open", max_steps=STEPS, verbose=False,
    )
    policy = tserve.CloudPolicy(st.tmodel, st.tok, paged=paged)
    got = tserve.serve_episode(policy, task="drawer_open", max_steps=STEPS, verbose=False,
                               device="cpu")
    assert got["steps"] == want["steps"] == STEPS
    assert got["offloads"] == want["offloads"] > 0
    np.testing.assert_allclose(got["actions"], want["actions"], rtol=0, atol=1e-6)


def test_capacity_scheduler_matches_reference(monkeypatch):
    """Six robots, three at once then one every 2 rounds, ``max_slots=4``
    (rows double to 8), R = 4, on the capacity dispatch: equal logs,
    results, counters and tokens.

    Idle rows (length 0) route and take expert slots here, so their hidden
    states reach the live rows' drops.  On the CPU the reference's paged
    attention is its gather oracle, which gives an idle row the mean of the
    values it gathers (``repro/kernels/ref.py:92-93``); its Pallas kernel,
    like the port's kernel and plain version, gives 0 (ROADMAP §3).  So the
    reference runs its Pallas kernel here, in interpret mode, as the JAX
    package's kernel tests run it on the CPU."""

    def pallas(q, kp, vp, pt, lens, *, window=0, logit_cap=0.0):
        return jpa.paged_decode_attention(q, kp, vp, pt, lens, window=window,
                                          logit_cap=logit_cap, interpret=True)

    monkeypatch.setattr(jops, "paged_decode_attention", pallas)
    st = stacks("capacity")
    _, ts, res = run_twin(st, staggered, max_slots=4, scan_rounds=4)
    assert ts.model.moe_impl == "capacity"
    assert ts.peak_active > 1 and len(res) == 6
    assert ts.allocator.num_free == ts.allocator.num_pages


def test_executor_guard_on_capacity_dispatch():
    """Gather/scatter expert offload splits the dense mixture only: with
    the capacity dispatch the port raises where the reference does, and a
    plain cut (or ``with_cut`` to one) still builds."""

    st = stacks("capacity")
    for make in (lambda off: JaxExecutor(st.jmodel, st.jparams, 2, expert_offload=off),
                 lambda off: PartitionExecutor(st.tmodel, 2, expert_offload=off)):
        with pytest.raises(ValueError, match="capacity"):
            make((0,))
        assert make(()).expert_offload == ()
    base = PartitionExecutor(st.tmodel, 2)
    with pytest.raises(ValueError, match="capacity"):
        base.with_cut(1, expert_offload=(0,))
    assert base.with_cut(1).cut_layer == 1


@pytest.mark.parametrize("cut,offload", _offload_cases(get_smoke_config(ARCH)))
def test_expert_offload_lane_matches_reference(cut, offload):
    """phi3.5-moe-smoke's expert-offload lanes (both layers under a
    full-depth edge; layer 0 under cut 1): the split forward within 1e-4 of
    the reference executor's and equal to the fused forward, the chunk
    equal to ``CloudPolicy``'s and to the reference ``PartitionedPolicy``'s
    under the greedy-margin rule, and equal shipped bytes."""

    st = stacks("dense")
    cfg = st.tmodel.cfg
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    ex = PartitionExecutor(st.tmodel, cut, expert_offload=offload)
    jex = JaxExecutor(st.jmodel, st.jparams, cut, expert_offload=offload)
    got = ex.logits(ex.forward({"tokens": torch.as_tensor(toks)}))
    want = np.asarray(jex.logits(jex.forward({"tokens": jnp.asarray(toks)})))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    fused = st.tmodel._logits(st.tmodel.forward({"tokens": torch.as_tensor(toks)}))
    assert torch.equal(got, fused)
    assert ex.shipped_bytes == jex.shipped_bytes > 0

    qd, tau = _obs(np.random.default_rng(9))
    policy = PartitionedPolicy(ex, st.tok)
    mine = policy.chunk_tokens(qd, tau)
    np.testing.assert_array_equal(mine, tserve.CloudPolicy(st.tmodel, st.tok).chunk_tokens(qd, tau))
    ref = _jax_chunk_tokens(JaxPolicy(jex, st.jtok), st.jtok, qd, tau)
    assert_tokens_match(st, _obs_tokens(st.tok, qd, tau), ref[0], mine[0],
                        f"cut {cut} offload {offload}")


@pytest.mark.parametrize("paged", [[], ["--paged"]], ids=["dense", "paged"])
def test_serve_cli_phi35_moe_on_cpu(paged, capsys):
    out = tserve.main(["--arch", ARCH, "--device", "cpu", "--steps", "24", *paged])
    assert out["steps"] == 24 and out["offloads"] > 0
    assert np.isfinite(out["actions"]).all()
    assert "offloads=" in capsys.readouterr().out
