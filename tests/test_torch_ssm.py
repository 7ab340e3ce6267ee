"""The port's Mamba path and MoE FFN against the JAX reference.

``mamba_scan_ref`` (the plain version of the ``mamba_scan`` kernel) is held
against the Pallas kernel run with ``interpret=True`` and against the
reference's ``ssd_chunked``, with and without an initial state, at the
shapes of the JAX package's own kernel tests; the Mamba block, its decode
step and the MoE FFN against ``repro.models.ssm`` / ``repro.models.moe`` on
the f32 jamba-smoke widths, with weights from the reference's initialisers.
Inputs are numpy arrays from a seed.  Tolerances: the scan atol 5e-4, rtol
5e-3, as the JAX package holds its own kernel to its oracle (``exp`` of
differences of float32 prefix sums that the two frameworks sum in another
order); the blocks and the router 1e-5 (the same float32 math); the MoE
output 1e-5 absolute on O(1) values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan as pallas_mamba_scan  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import mamba_scan as tms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

SCAN_TOL = dict(atol=5e-4, rtol=5e-3)
TOL = dict(atol=1e-5, rtol=1e-5)
MAMBA_CASES = [  # b, s, h, p, n, chunk
    (2, 512, 8, 64, 16, 128),
    (1, 256, 4, 32, 8, 256),
    (1, 128, 2, 16, 4, 64),
]


def _scan_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    c = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, c, h0


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,p,n,ck", MAMBA_CASES)
def test_mamba_scan_plain_matches_pallas_interpret(b, s, h, p, n, ck):
    x, dt, a, bm, c, _ = _scan_inputs(b, s, h, p, n, seed=s + h)
    want_y, want_h = pallas_mamba_scan(*map(jnp.asarray, (x, dt, a, bm, c)), chunk=ck,
                                       blk_h=min(4, h), interpret=True)
    y, h_t = tref.mamba_scan_ref(*_t(x, dt, a, bm, c), chunk=ck)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(want_h), **SCAN_TOL)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("b,s,h,p,n,ck", MAMBA_CASES)
def test_mamba_scan_plain_matches_ssd_chunked(b, s, h, p, n, ck, with_h0):
    x, dt, a, bm, c, h0 = _scan_inputs(b, s, h, p, n, seed=s * 3 + h)
    h0 = h0 if with_h0 else None
    jfn = jax.jit(lambda *args: jssm.ssd_chunked(*args[:5], chunk=ck, h0=args[5]))
    want_y, want_h = jfn(*map(jnp.asarray, (x, dt, a, bm, c)),
                         None if h0 is None else jnp.asarray(h0))
    y, h_t = ops.mamba_scan(*_t(x, dt, a, bm, c), h0=None if h0 is None else torch.as_tensor(h0),
                            chunk=ck)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(want_h), **SCAN_TOL)


def test_mamba_scan_h0_continues_a_split_sequence():
    """Scanning [0, S/2) and then [S/2, S) from its final state equals one
    scan over [0, S) (the property decode continuation relies on)."""

    x, dt, a, bm, c, _ = _t(*_scan_inputs(1, 128, 4, 16, 8, seed=7))
    y, h_t = ops.mamba_scan(x, dt, a, bm, c, chunk=32)
    y1, h1 = ops.mamba_scan(x[:, :64], dt[:, :64], a, bm[:, :64], c[:, :64], chunk=32)
    y2, h2 = ops.mamba_scan(x[:, 64:], dt[:, 64:], a, bm[:, 64:], c[:, 64:], h0=h1, chunk=32)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **SCAN_TOL)
    torch.testing.assert_close(h2, h_t, **SCAN_TOL)


def test_ssd_step_matches_reference():
    x, dt, a, bm, c, h0 = _scan_inputs(2, 1, 4, 16, 8, seed=3)
    args = (x[:, 0], dt[:, 0], a, bm[:, 0], c[:, 0], h0)
    want_y, want_h = jax.jit(jssm.ssd_step)(*map(jnp.asarray, args))
    y, h = tssm.ssd_step(*_t(*args))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


def test_mamba_scan_raises_on_a_ragged_chunk_and_counts_no_cpu_launch():
    x, dt, a, bm, c, _ = _t(*_scan_inputs(1, 48, 2, 16, 4, seed=1))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.mamba_scan(x, dt, a, bm, c, chunk=32)
    y, _ = ops.mamba_scan(x, dt, a, bm, c, chunk=16)
    torch.testing.assert_close(y, tref.mamba_scan_ref(x, dt, a, bm, c, chunk=16)[0],
                               rtol=0, atol=0)
    assert ops.LAUNCHES["mamba_scan"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tms.mamba_scan(x, dt, a, bm, c, chunk=16)
    meta = torch.empty((1, 16, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no mamba_scan path"):
        ops.mamba_scan(meta, dt, a, bm, c)


# ---------------------------------------------------------------------------
# the Mamba block and the MoE FFN at jamba-smoke widths
# ---------------------------------------------------------------------------


def _cfgs():
    jcfg = jax_smoke("jamba-1.5-large-398b").replace(dtype="float32", param_dtype="float32")
    return jcfg, get_smoke_config("jamba-1.5-large-398b").replace(dtype="float32")


def _load(module, params):
    for name, p in module.named_parameters():
        p.copy_(torch.as_tensor(np.array(params[name], np.float32)))
    return module


@pytest.fixture(scope="module")
def mamba_pair():
    jcfg, tcfg = _cfgs()
    params, _ = jssm.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, params, tcfg, _load(tssm.Mamba(tcfg, torch.float32, "cpu"), params)


def test_mamba_params_follow_the_reference_layout(mamba_pair):
    jcfg, params, _, block = mamba_pair
    names = dict(block.named_parameters())
    assert set(names) == set(params)
    for name, p in names.items():
        assert tuple(p.shape) == tuple(params[name].shape), name
    bf16 = tssm.Mamba(_cfgs()[1], torch.bfloat16, "cpu")
    assert {n for n, p in bf16.named_parameters() if p.dtype == torch.float32} == {
        "dt_bias", "a_log", "d_skip"}


def test_mamba_forward_and_decode_step_match_reference(mamba_pair):
    jcfg, params, tcfg, block = mamba_pair
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    nxt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    want, wstate = jax.jit(lambda p, v: jssm.mamba_forward(v, p, jcfg))(params, jnp.asarray(x))
    got, state = tssm.mamba_forward(torch.as_tensor(x), block, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(wstate[k]), **SCAN_TOL)

    want2, wstate2 = jax.jit(lambda p, v, s: jssm.mamba_decode_step(v, p, jcfg, s))(
        params, jnp.asarray(nxt), wstate)
    got2, state2 = tssm.mamba_decode_step(torch.as_tensor(nxt), block, tcfg, state)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **SCAN_TOL)
    np.testing.assert_allclose(state2["h"].numpy(), np.asarray(wstate2["h"]), **SCAN_TOL)
    # a decode step continues the prompt: it equals the full forward's last row
    full, _ = tssm.mamba_forward(torch.as_tensor(np.concatenate([x, nxt], 1)), block, tcfg)
    torch.testing.assert_close(got2, full[:, -1:], **SCAN_TOL)


def test_init_mamba_state_matches_reference():
    jcfg, tcfg = _cfgs()
    want = jssm.init_mamba_state(jcfg, 3)
    got = tssm.init_mamba_state(tcfg, 3, device="cpu")
    assert tssm.ssm_dims(tcfg) == jssm.ssm_dims(jcfg)
    for k in ("h", "conv"):
        assert tuple(got[k].shape) == tuple(want[k].shape) and not got[k].any()


@pytest.fixture(scope="module")
def moe_pair():
    jcfg, tcfg = _cfgs()
    params, _ = jmoe.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    return jcfg, params, tcfg, _load(tmoe.MoE(tcfg, torch.float32, "cpu"), params)


def test_router_probs_match_reference(moe_pair):
    jcfg, params, _, block = moe_pair
    x = np.random.default_rng(2).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    k = jcfg.moe.num_experts_per_tok
    want_c, want_aux = jax.jit(lambda v, w: jmoe.router_probs(v, w, k))(
        jnp.asarray(x), params["router"])
    got_c, got_aux = tmoe.router_probs(torch.as_tensor(x), block.router, k)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)
    assert ((got_c > 0).sum(-1) == k).all()


def test_moe_forward_matches_reference(moe_pair):
    jcfg, params, tcfg, block = moe_pair
    x = np.random.default_rng(3).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    (want, want_aux) = jax.jit(lambda p, v: jmoe.moe_forward(v, p, jcfg))(params, jnp.asarray(x))
    got, aux = tmoe.moe_forward(torch.as_tensor(x), block, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
