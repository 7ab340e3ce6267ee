"""The port's single-robot closed loop against the JAX ``serve_episode``.

Both serve the same f32 openvla-smoke stack (the port's weights bridged
from the reference's ``Model.init``) on the same task for 80 control
ticks, dense and paged.  The dispatcher's offload count must be equal and
the executed actions equal to 1e-6 (an action is a decoded action-token
bin, so one differing greedy token would differ by a whole bin, 8/255).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.npz import _flatten  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.pipeline import EpisodeTokenizer as JaxTokenizer  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.checkpoint.bridge import load_reference_params  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import EpisodeTokenizer  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

# the reference also has a parameter dtype; the port keeps parameters in cfg.dtype
JAX_F32 = dict(dtype="float32", param_dtype="float32")
STEPS = 80


@pytest.fixture(scope="module")
def stacks():
    jcfg = jax_smoke("openvla-7b").replace(**JAX_F32)
    jmodel = JaxModel(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = Model(get_smoke_config("openvla-7b").replace(dtype="float32"), device="cpu")
    load_reference_params(tmodel, _flatten(jparams))
    return jmodel, jparams, JaxTokenizer(jcfg.vocab_size), tmodel


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serve_episode_matches_reference(stacks, paged):
    jmodel, jparams, jtok, tmodel = stacks
    want = jserve.serve_episode(
        jserve.CloudPolicy(jmodel, jparams, jtok, paged=paged),
        task="drawer_open", max_steps=STEPS, verbose=False,
    )
    policy = tserve.CloudPolicy(tmodel, EpisodeTokenizer(tmodel.cfg.vocab_size), paged=paged)
    got = tserve.serve_episode(policy, task="drawer_open", max_steps=STEPS, verbose=False,
                               device="cpu")
    assert got["steps"] == want["steps"] == STEPS
    assert got["offloads"] == want["offloads"] > 0
    assert len(got["cloud_ms"]) == got["offloads"]
    np.testing.assert_allclose(got["actions"], want["actions"], rtol=0, atol=1e-6)


def test_per_token_loop_matches_fused_chunk(stacks):
    *_, tmodel = stacks
    tok = EpisodeTokenizer(tmodel.cfg.vocab_size)
    rng = np.random.default_rng(4)
    qd, tau = rng.normal(0, 0.5, (2, 7)), rng.normal(0, 0.5, (2, 7))
    fused = tserve.CloudPolicy(tmodel, tok).chunk_tokens(qd, tau)
    loop = tserve.CloudPolicy(tmodel, tok, fused=False).chunk_tokens(qd, tau)
    np.testing.assert_array_equal(loop, fused)
    assert fused.shape == (2, 56) and (fused >= tok.action_base).all()
