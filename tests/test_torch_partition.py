"""The port's split executor (``repro_torch/partition/executor.py``) against
the JAX package's on the f32 smoke stacks of openvla-7b, gemma2-9b and
jamba-1.5-large-398b (weights bridged, as ``test_torch_scheduler.py``
builds them).

* ``PartitionExecutor.forward`` at every cut: the logits within 1e-4 of the
  reference executor's, and equal to the port's own unpartitioned
  ``Model.forward`` (the same block functions run on both sides);
* ``PartitionedPolicy`` chunks at every cut equal to the port's
  ``CloudPolicy``, and at an interior cut to the reference's
  ``PartitionedPolicy`` under the greedy-margin rule (a token may differ
  only where the port's top-two logit gap is within 1e-4);
* the expert-offload lanes of ``tests/test_partition_2d.py``'s
  ``_offload_cases`` on jamba-smoke (the forward and the chunk);
* ``modeled_net_ms`` and ``record_chunk_bytes`` equal to the reference's;
* ``with_cut`` shares the weights' storage;
* the validation errors of ``tests/test_partition.py:290`` and
  ``tests/test_partition_2d.py:329``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.obs import Observability as JaxObservability  # noqa: E402
from repro.partition.executor import PartitionExecutor as JaxExecutor  # noqa: E402
from repro.partition.executor import PartitionedPolicy as JaxPolicy  # noqa: E402
from repro_torch.launch.serve import CloudPolicy  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.partition import PartitionExecutor, PartitionedPolicy  # noqa: E402

from test_torch_scheduler import (  # noqa: E402
    _obs,
    _obs_tokens,
    assert_tokens_match,
    make_stacks,
)

ARCHS = ("openvla-7b", "gemma2-9b", "jamba-1.5-large-398b")
_STACKS = {}


def stacks(arch):
    if arch not in _STACKS:
        _STACKS[arch] = make_stacks(arch)
    return _STACKS[arch]


def _moe_layers(cfg):
    return [i for i in range(cfg.num_layers) if cfg.is_moe_layer(i)]


def _offload_cases(cfg):
    """``tests/test_partition_2d.py``'s cases: every MoE layer under a
    full-depth edge, and one offloaded block under an interior cut."""

    moe = _moe_layers(cfg)
    cases = [(cfg.num_layers, tuple(moe))]
    interior = [l for l in moe if l < cfg.num_layers - 1]
    if interior:
        cases.append((interior[0] + 1, (interior[0],)))
    return cases


def _tokens(cfg, b=2, s=16):
    return np.random.default_rng(5).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _lanes(cfg):
    """(cut, offload) of every plain cut, plus the expert-offload cases."""

    out = [(c, ()) for c in range(cfg.num_layers + 1)]
    return out + (_offload_cases(cfg) if cfg.moe is not None else [])


@pytest.mark.parametrize("arch", ARCHS)
def test_split_forward_matches_reference_at_every_cut(arch):
    st = stacks(arch)
    cfg = st.tmodel.cfg
    toks = _tokens(cfg)
    fused = st.tmodel._logits(st.tmodel.forward({"tokens": torch.as_tensor(toks)}))
    for cut, off in _lanes(cfg):
        ex = PartitionExecutor(st.tmodel, cut, expert_offload=off)
        got = ex.logits(ex.forward({"tokens": torch.as_tensor(toks)}))
        jex = JaxExecutor(st.jmodel, st.jparams, cut, expert_offload=off)
        want = np.asarray(jex.logits(jex.forward({"tokens": jnp.asarray(toks)})))
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-4, (cut, off, err)
        assert torch.equal(got, fused), (cut, off)
        assert ex.shipped_bytes == jex.shipped_bytes == toks.size * cfg.d_model * 4


def _jax_chunk_tokens(policy, tok, qd, tau):
    obs = np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)
    sp = policy.executor.split_params
    logits, state = policy._prefill(sp, {"tokens": jnp.asarray(obs)})
    return np.asarray(policy._decode_chunk(sp, logits, state))


@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_policy_chunks(arch):
    st = stacks(arch)
    cfg = st.tmodel.cfg
    rng = np.random.default_rng(9)
    qd, tau = _obs(rng)
    cloud = CloudPolicy(st.tmodel, st.tok).chunk_tokens(qd, tau)
    obs_tokens = _obs_tokens(st.tok, qd, tau)
    for cut, off in _lanes(cfg):
        policy = PartitionedPolicy(PartitionExecutor(st.tmodel, cut, expert_offload=off), st.tok)
        got = policy.chunk_tokens(qd, tau)
        np.testing.assert_array_equal(got, cloud, err_msg=f"cut {cut} offload {off}")
        assert policy.net_ms_log and policy.net_ms_log[0] > 0
        actions = policy(qd, tau)
        assert actions.shape == (1, 8, 7)
    # the reference's split policy at an interior cut (and its offload lane)
    for cut, off in [(1, ())] + (_offload_cases(cfg)[-1:] if cfg.moe is not None else []):
        jpol = JaxPolicy(JaxExecutor(st.jmodel, st.jparams, cut, expert_offload=off), st.jtok)
        want = _jax_chunk_tokens(jpol, st.jtok, qd, tau)
        tpol = PartitionedPolicy(PartitionExecutor(st.tmodel, cut, expert_offload=off), st.tok)
        assert_tokens_match(st, obs_tokens, want[0], tpol.chunk_tokens(qd, tau)[0],
                            f"cut {cut} offload {off}")
        jpol(qd, tau)
        tpol(qd, tau)
        assert tpol.net_ms_log[-1] == jpol.net_ms_log[-1]


def test_modeled_net_and_chunk_bytes_match_reference():
    st = stacks("jamba-1.5-large-398b")
    cfg = st.tmodel.cfg
    for cut, off in [(1, ()), (2, (1,)), (cfg.num_layers, tuple(_moe_layers(cfg)))]:
        ex = PartitionExecutor(st.tmodel, cut, expert_offload=off)
        jex = JaxExecutor(st.jmodel, st.jparams, cut, expert_offload=off)
        for prompt, n in ((14, 56), (30, 7)):
            assert ex.modeled_net_ms(prompt, n) == jex.modeled_net_ms(prompt, n)
        ex.obs, jex.obs = Observability(), JaxObservability()
        for prompt, n in ((14, 56), (14, 56), (20, 3)):
            ex.record_chunk_bytes(prompt, n)
            jex.record_chunk_bytes(prompt, n)
        got = {k: v for k, v in ex.obs.metrics.to_json().items() if k.startswith("channel.")}
        want = {k: v for k, v in jex.obs.metrics.to_json().items() if k.startswith("channel.")}
        assert got == want and got, (cut, off)
        assert ex.lane_key == jex.lane_key


def test_with_cut_shares_storage():
    """A sibling holds no tensor of its own: both sides run the model's
    blocks, so every weight it reads is the model's storage."""

    st = stacks("jamba-1.5-large-398b")
    model = st.tmodel
    ptrs = {p.data_ptr() for p in model.parameters()}
    base = PartitionExecutor(model, 1)
    assert base.with_cut(1) is base
    for cut, off in [(0, ()), (3, ()), (2, (1,))]:
        sib = base.with_cut(cut, expert_offload=off)
        assert sib.model is model and sib.cut_layer == cut and sib.expert_offload == off
        assert list(sib.edge_layers) + list(sib.cloud_layers) == list(range(cfg_layers(model)))
        assert not any(isinstance(v, torch.Tensor) for v in vars(sib).values())
    assert {p.data_ptr() for p in model.parameters()} == ptrs
    assert base.with_cut(2, (1,)).lane_key == (2, (1,))


def cfg_layers(model):
    return model.cfg.num_layers


def test_executor_validation():
    st = stacks("jamba-1.5-large-398b")
    cfg = st.tmodel.cfg
    moe = _moe_layers(cfg)
    non_moe = next(i for i in range(cfg.num_layers) if i not in moe)
    with pytest.raises(ValueError):
        PartitionExecutor(st.tmodel, cfg.num_layers + 1)
    with pytest.raises(ValueError):
        PartitionExecutor(st.tmodel, -1)
    with pytest.raises(ValueError):  # only MoE layers have a separable expert sub-block
        PartitionExecutor(st.tmodel, cfg.num_layers, expert_offload=(non_moe,))
    with pytest.raises(ValueError):  # offloaded experts must sit edge-side of the cut
        PartitionExecutor(st.tmodel, moe[0], expert_offload=(moe[0],))
    plain = PartitionExecutor(st.tmodel, moe[0] + 1)
    off = PartitionExecutor(st.tmodel, moe[0] + 1, expert_offload=(moe[0],))
    assert plain.lane_key == moe[0] + 1 and off.lane_key == (moe[0] + 1, (moe[0],))
    # an encoder-decoder stack does not split
    enc = type("M", (), {"cfg": cfg.replace(encoder_decoder=True)})()
    with pytest.raises(NotImplementedError):
        PartitionExecutor(enc, 1)
