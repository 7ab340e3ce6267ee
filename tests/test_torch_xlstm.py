"""The port's xLSTM (``repro_torch/models/xlstm.py`` and the xlstm-125m
stack through ``Model``, ``CloudPolicy``, the scheduler and the split
executor) against the JAX package's, on the f32 xlstm-smoke stack (mLSTM
then sLSTM, period 2) with the weights bridged from the reference's
``Model.init``; inputs are numpy arrays from a seed.

Tolerances: the block functions and the stack's logits agree to atol =
rtol = 1e-5 (the two frameworks sum in different orders), the chunked
mLSTM against stepping it token by token to 1e-5 as well; greedy tokens
are equal or differ only under the greedy-margin rule of
``test_torch_scheduler.py`` (a top-two logit gap within 1e-4).  The
reference refuses an mLSTM prompt that its chunk does not divide, and so
does the port.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.partition.executor import PartitionExecutor as JaxExecutor  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.models.model import STATE_NAMES, Model  # noqa: E402
from repro_torch.partition import PartitionExecutor  # noqa: E402
from repro_torch.runtime.kv_cache import PagedSpec  # noqa: E402

import test_torch_partition as tpart  # noqa: E402
import test_torch_scheduler as tsched  # noqa: E402
import test_torch_split_lane as tlane  # noqa: E402
from test_torch_split_lane import shared_reference_jits  # noqa: E402,F401

ARCH = "xlstm-125m"
TOL = dict(atol=1e-5, rtol=1e-5)
B, S, NH, DH = 2, 32, 2, 16


def _mlstm_inputs(seed=0, s=S):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (B, s, NH, DH)).astype(np.float32) for _ in range(3))
    i_gate = rng.normal(0, 1, (B, s, NH)).astype(np.float32)
    logf = np.log(1 / (1 + np.exp(-rng.normal(2, 1, (B, s, NH))))).astype(np.float32)
    return q, k, v, i_gate, logf


def _mlstm_state(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, NH, DH, DH)).astype(np.float32),
            rng.normal(0, 1, (B, NH, DH)).astype(np.float32),
            rng.normal(0, 1, (B, NH)).astype(np.float32))


def _t(arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, what=""):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what, **TOL)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "given-state"])
@pytest.mark.parametrize("chunk", [8, 32, 256])
def test_mlstm_chunked_matches_reference(chunk, with_state):
    """S = 32 in chunks of 8 (the state carried across four chunks), of 32
    and of min(256, S); from the zero state (m = -1e30) or a given one."""

    x = _mlstm_inputs()
    st = _mlstm_state() if with_state else None
    y, state = tx.mlstm_chunked(*_t(x), chunk=chunk, state=None if st is None else _t(st))
    jy, jstate = jx.mlstm_chunked(*_j(x), chunk=chunk, state=None if st is None else _j(st))
    _close((y, *state), (jy, *jstate), f"chunk {chunk}")
    assert all(torch.isfinite(t).all() for t in (y, *state))


def test_mlstm_step_matches_reference():
    q, k, v, i_gate, logf = _mlstm_inputs(s=1)
    args = (q[:, 0], k[:, 0], v[:, 0], i_gate[:, 0], logf[:, 0])
    st = _mlstm_state()
    for state_t, state_j in ((_t(st), _j(st)),
                             (tx.zero_mlstm_state(B, NH, DH, "cpu"),
                              _j([np.zeros((B, NH, DH, DH), np.float32),
                                  np.zeros((B, NH, DH), np.float32),
                                  np.full((B, NH), -1e30, np.float32)]))):
        y, new = tx.mlstm_step(*_t(args), state_t)
        jy, jnew = jx.mlstm_step(*_j(args), state_j)
        _close((y, *new), (jy, *jnew))


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "given-state"])
def test_mlstm_chunked_equals_stepping(with_state):
    """The chunked form over S = 32 (chunks of 8) equals 32 single steps."""

    x = _t(_mlstm_inputs(seed=2))
    st = _t(_mlstm_state(seed=3)) if with_state else tx.zero_mlstm_state(B, NH, DH, "cpu")
    y, end = tx.mlstm_chunked(*x, chunk=8, state=st)
    ys, state = [], st
    for t in range(S):
        yt, state = tx.mlstm_step(*(a[:, t] for a in x), state)
        ys.append(yt)
    _close((y, *end), (torch.stack(ys, 1), *state))


def test_mlstm_chunked_refuses_a_ragged_prompt():
    x = _mlstm_inputs(s=12)
    with pytest.raises(ValueError, match="not a multiple"):
        tx.mlstm_chunked(*_t(x), chunk=8)
    with pytest.raises(AssertionError):
        jx.mlstm_chunked(*_j(x), chunk=8)


def _slstm_params(cfg, seed=4):
    rng = np.random.default_rng(seed)
    d, d_up = cfg.d_model, int(cfg.xlstm.proj_factor_slstm * cfg.d_model)
    return {"w_in": rng.normal(0, d**-0.5, (d, 4 * d)), "w_rec": rng.normal(0, d**-0.5, (d, 4 * d)),
            "bias": rng.normal(0, 1, (4 * d,)), "up": rng.normal(0, d**-0.5, (d, 2 * d_up)),
            "down": rng.normal(0, d_up**-0.5, (d_up, d))}


@pytest.mark.parametrize("step", [False, True], ids=["sequence", "step"])
def test_slstm_forward_matches_reference(step):
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    jcfg = jax_smoke(ARCH).replace(dtype="float32", param_dtype="float32")
    raw = {k: v.astype(np.float32) for k, v in _slstm_params(cfg).items()}
    p = tx.SLSTM(cfg, torch.float32, "cpu")
    for name, arr in raw.items():
        getattr(p, name).copy_(torch.as_tensor(arr))
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (B, 1 if step else 9, cfg.d_model)).astype(np.float32)
    d = cfg.d_model
    st = (rng.normal(0, 1, (B, d)), np.abs(rng.normal(1, 1, (B, d))), rng.normal(0, 1, (B, d)),
          rng.normal(0, 1, (B, d)))
    st = tuple(a.astype(np.float32) for a in st)
    for state_t, state_j in ((None, None), (_t(st), _j(st))):
        out, new = tx.slstm_forward(torch.as_tensor(x), p, cfg, state=state_t, step=step)
        jout, jnew = jx.slstm_forward(jnp.asarray(x), {k: jnp.asarray(v) for k, v in raw.items()},
                                      jcfg, state=state_j, step=step)
        _close((out, *new), (jout, *jnew))


@pytest.mark.parametrize("name", ["zero_mlstm_state", "init_mlstm_state", "zero_slstm_state",
                                  "init_slstm_state"])
def test_state_builders_default_to_the_card(name):
    """The xLSTM state builders default to ``device="cuda"``, as
    ``init_mamba_state`` does: a caller that means the CPU passes it."""

    from repro_torch.models import ssm as tssm

    default = inspect.signature(getattr(tx, name)).parameters["device"].default
    assert default == "cuda"
    assert inspect.signature(tssm.init_mamba_state).parameters["device"].default == default


def test_bf16_stack_keeps_float32_gate_biases():
    """``if_bias`` and the sLSTM ``bias`` are float32 in a bf16 stack, the
    mLSTM head is d_in // num_heads (384 at xlstm-125m), and the
    recurrent state keys are the model's ``state_names``."""

    cfg = get_smoke_config(ARCH)
    model = Model(cfg, device="cpu")
    assert model.layers[0].mlstm.if_bias.dtype == torch.float32
    assert model.layers[1].slstm.bias.dtype == torch.float32
    assert model.layers[0].mlstm.wq.dtype == torch.bfloat16
    assert not hasattr(model.layers[0], "norm2") and not hasattr(model.layers[0], "mlp")
    assert tx.mlstm_dims(get_config(ARCH)) == (1536, 4, 384)
    assert model.state_names == STATE_NAMES["mlstm"] + STATE_NAMES["slstm"]
    cache = model.init_paged_cache(3, PagedSpec(num_pages=4, page_size=16, max_pages_per_seq=2))
    assert "kp" not in cache and set(model.state_names) <= set(cache)
    assert cache["mC"].shape == (1, 3, 2, 128, 128) and cache["sh"].shape == (1, 3, 128)
    floor = float(np.float32(-1e30))
    assert float(cache["mm"].max()) == float(cache["sm"].max()) == floor


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


def _st():
    return tlane.stacks(ARCH)


def test_prefill_decode_step_and_chunk_match_reference():
    st = _st()
    toks = np.random.default_rng(6).integers(0, st.tmodel.cfg.vocab_size, (2, 16))
    jl, jc = st.jmodel.prefill(st.jparams, {"tokens": jnp.asarray(toks)}, extra=8)
    tl, tc = st.tmodel.prefill({"tokens": torch.as_tensor(toks)}, extra=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt = toks[:, :1]
    jl2, _ = st.jmodel.decode_step(st.jparams, jnp.asarray(nxt), jc)
    tl2, _ = st.tmodel.decode_step(torch.as_tensor(nxt), dict(tc))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cloud_policy_matches_reference(paged):
    """``CloudPolicy`` chunks (the state in the dense cache or beside the
    paged one's empty pools) against the reference's ``CloudPolicy``: the
    actions equal to 1e-6, as ``test_torch_serve.py`` holds them (one
    differing token would move a whole bin); with no attention layer the
    dense and the paged chunks are equal."""

    st = _st()
    rng = np.random.default_rng(7)
    qd, tau = tsched._obs(rng, b=2)
    policy = tserve.CloudPolicy(st.tmodel, st.tok, paged=paged)
    got = policy.chunk_tokens(qd, tau)
    other = tserve.CloudPolicy(st.tmodel, st.tok, paged=not paged).chunk_tokens(qd, tau)
    np.testing.assert_array_equal(got, other)
    want = jserve.CloudPolicy(st.jmodel, st.jparams, st.jtok, paged=paged)(qd, tau)
    np.testing.assert_allclose(policy(qd, tau), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rounds", tsched.R14)
def test_scheduler_matches_reference(rounds):
    """The staggered script of ``test_torch_scheduler.py`` on xlstm-smoke:
    the rows hold only recurrent state, the rounds no attention."""

    st = _st()
    _, ts, res = tsched.run_twin(st, tsched.staggered, max_slots=2, scan_rounds=rounds)
    assert len(res) == 6 and ts.allocator.num_in_use == 0


@pytest.mark.parametrize("rounds", tsched.R14)
def test_split_lane_at_cut_1_matches_reference(rounds):
    """Cloud-only robots and robots split after the mLSTM layer (their sLSTM
    state a lane row) in the same rounds."""

    st = _st()
    route = {1: 1, 3: 1, 4: 1}
    ts, res = tlane.run_split_twin(st, tlane.mixed_fleet(route), [1], max_slots=4,
                                   scan_rounds=rounds)
    assert {r.robot_id for r in res if r.kind == "split"} == {1, 3, 4}
    assert ts.allocator.num_in_use == 0 and not ts._lanes[1].has_buffers


def test_split_forward_and_policy_match_reference():
    """``PartitionExecutor.forward`` at every cut (1e-4 of the reference's,
    equal to ``Model.forward``) and ``PartitionedPolicy`` chunks at every
    cut (equal to ``CloudPolicy``'s, the reference's at cut 1 within the
    margin), as ``test_torch_partition.py`` holds the other stacks."""

    tpart.test_split_forward_matches_reference_at_every_cut(ARCH)
    tpart.test_partitioned_policy_chunks(ARCH)


def test_assign_fleet_cuts_gives_a_real_executor():
    """The twin of ``tests/test_partition.py:525-544``: a redundant fleet
    keeps edge prefixes on real layer boundaries."""

    st = _st()
    frac = [0.02] * 4
    ex, cuts, assignment = tserve.assign_fleet_cuts(st.tmodel, ARCH, frac, network="congested",
                                                    verbose=False)
    jex, jcuts, jassignment = jserve.assign_fleet_cuts(st.jmodel, st.jparams, ARCH, frac,
                                                       network="congested", verbose=False)
    assert cuts == jcuts and cuts
    assert assignment.cuts == jassignment.cuts
    assert isinstance(ex, PartitionExecutor) and isinstance(jex, JaxExecutor)
    assert ex.cut_layer == jex.cut_layer and ex.cut_layer in set(cuts.values())
    assert all(0 <= c <= st.tmodel.cfg.num_layers for c in cuts.values())
