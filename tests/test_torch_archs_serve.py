"""Serving twins of the new dense attention archs against the JAX package.

``serve_episode`` on gemma2-smoke (local and global layers, both
softcaps, tied and scaled embeddings) and starcoder2-smoke (a plain GELU
MLP), dense and paged: the same rules as ``test_torch_serve.py`` (equal
offload counts, actions equal to 1e-6, which one differing greedy token
would break by a whole bin).  The continuous-batching scheduler at
``scan_rounds=4`` on gemma2-smoke: the rules of
``test_torch_scheduler.py``.  And the port's serve CLI on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_scheduler import make_stacks, run_twin, staggered  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

STEPS = 80


@pytest.fixture(scope="module")
def stacks():
    return {}


def _stack(stacks, arch):
    if arch not in stacks:
        stacks[arch] = make_stacks(arch)
    return stacks[arch]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ["gemma2-9b", "starcoder2-3b"])
def test_serve_episode_matches_reference(stacks, arch, paged):
    st = _stack(stacks, arch)
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


def test_scheduler_staggered_gemma2(stacks):
    """Six robots, three at once then one every 2 rounds, ``max_slots=4``,
    R = 4: equal logs, results, counters; tokens under the greedy-margin
    rule (the logits' width is the padded vocab of the tied head)."""

    st = _stack(stacks, "gemma2-9b")
    _, ts, res = run_twin(st, staggered, max_slots=4, scan_rounds=4)
    assert not hasattr(st.tmodel, "lm_head")
    assert ts._logits.shape[-1] == st.tmodel.embed.table.shape[0]
    assert ts.peak_active > 1 and len(res) == 6
    assert ts.allocator.num_free == ts.allocator.num_pages


@pytest.mark.parametrize("paged", [[], ["--paged"]], ids=["dense", "paged"])
def test_serve_cli_gemma2_on_cpu(paged, capsys):
    out = tserve.main(["--arch", "gemma2-9b", "--device", "cpu", "--steps", "24", *paged])
    assert out["steps"] == 24 and out["offloads"] > 0
    assert np.isfinite(out["actions"]).all()
    assert "offloads=" in capsys.readouterr().out


def test_serve_cli_takes_every_port_arch():
    for arch in ARCH_IDS:
        assert tserve.parser().parse_args(["--arch", arch]).arch == arch
    with pytest.raises(SystemExit):
        tserve.parser().parse_args(["--arch", "no-such-arch"])
