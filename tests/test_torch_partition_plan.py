"""The port's partition graph and planner (``repro_torch/partition/graph.py``,
``planner.py``, ``roofline/costmodel.py``, the parameter accounting of
``configs/base.py``) against the JAX package's, on the full configs of the
port's 11 archs (``ARCH_IDS``).

Both sides are pure Python and numpy over the same formulas, summed in the
same order, so every float is held equal (``==``), with no tolerance: the
graph's nodes field for field, every ``CutEval`` of ``enumerate_cuts`` /
``enumerate_cuts_2d`` (plain, pipelined, per-cut fraction, executable
only) over the three network profiles, the plans, the JSON strings and the
cut assignments of a spread fleet.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.partition import graph as jgraph  # noqa: E402
from repro.partition import planner as jplanner  # noqa: E402
from repro.runtime.latency import arch_hardware_model as jax_hw  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.partition import graph as tgraph  # noqa: E402
from repro_torch.partition import planner as tplanner  # noqa: E402
from repro_torch.runtime.latency import arch_hardware_model as port_hw  # noqa: E402

PROFILES = ("lan", "wan", "congested")
OPTIONS = [dict(), dict(pipelined=True), dict(per_cut_fraction=True),
           dict(pipelined=True, per_cut_fraction=True), dict(offload_fraction=0.12)]


def _fields(obj):
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert cfg.param_counts() == jcfg.param_counts()
    assert cfg.encoder_param_counts() == jcfg.encoder_param_counts()
    assert (cfg.encoder_param_counts() > 0) == cfg.encoder_decoder
    for i in range(cfg.num_layers):
        assert cfg.block_param_counts(i) == jcfg.block_param_counts(i), i


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_graph_nodes_match_reference(arch):
    got, want = tgraph.build_graph(get_config(arch)), jgraph.build_graph(jax_config(arch))
    assert len(got.nodes) == len(want.nodes) == get_config(arch).num_layers + 2
    for g, w in zip(got.nodes, want.nodes):
        assert _fields(g) == _fields(w), g.index
    top = {f.name for f in dataclasses.fields(want)} - {"nodes"}
    assert {k: getattr(got, k) for k in top} == {k: getattr(want, k) for k in top}
    assert got.total_param_bytes == want.total_param_bytes
    assert got.total_exec_bytes == want.total_exec_bytes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cut_evaluations_match_reference(arch):
    g, jg = tgraph.build_graph(get_config(arch)), jgraph.build_graph(jax_config(arch))
    hw, jhw = port_hw(int(g.total_param_bytes)), jax_hw(int(jg.total_param_bytes))
    for profile in PROFILES:
        ch, jch = tplanner.NETWORK_PROFILES[profile], jplanner.NETWORK_PROFILES[profile]
        for kw in OPTIONS:
            got = tplanner.enumerate_cuts(g, hw, ch, **kw)
            want = jplanner.enumerate_cuts(jg, jhw, jch, **kw)
            assert [_fields(e) for e in got] == [_fields(e) for e in want], (profile, kw)
            for only in (False, True):
                got = tplanner.enumerate_cuts_2d(g, hw, ch, executable_only=only, **kw)
                want = jplanner.enumerate_cuts_2d(jg, jhw, jch, executable_only=only, **kw)
                assert [_fields(e) for e in got] == [_fields(e) for e in want], (profile, kw, only)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plans_and_json_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for profile in PROFILES:
        ch, jch = tplanner.NETWORK_PROFILES[profile], jplanner.NETWORK_PROFILES[profile]
        for kw in OPTIONS + [dict(plan_2d=True), dict(plan_2d=True, executable_only=True),
                             dict(plan_2d=True, pipelined=True, per_cut_fraction=True)]:
            got = tplanner.plan_partition(cfg, channel=ch, **kw)
            want = jplanner.plan_partition(jcfg, channel=jch, **kw)
            assert got.to_json() == want.to_json(), (profile, kw)
            assert jplanner.PartitionPlan.from_json(got.to_json()) == want
            assert tplanner.PartitionPlan.from_json(want.to_json()) == got
            assert got.summary() == want.summary()
        for cut in (0, 1, cfg.num_layers // 2, cfg.num_layers + 1):
            got = tplanner.evaluate_cut(cfg, cut, channel=ch, offload_fraction=0.2)
            want = jplanner.evaluate_cut(jcfg, cut, channel=jch, offload_fraction=0.2)
            assert _fields(got) == _fields(want)
    with pytest.raises(ValueError):
        tplanner.evaluate_cut(cfg, 10_000)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_assign_cuts_matches_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    fractions = np.concatenate([np.linspace(0.0, 1.0, 9), [0.31, 0.31, 0.05]])
    n = len(tgraph.build_graph(cfg).nodes)
    for profile in PROFILES:
        ch, jch = tplanner.NETWORK_PROFILES[profile], jplanner.NETWORK_PROFILES[profile]
        for k_max, kw in ((1, {}), (3, {}), (3, dict(pipelined=True, max_cut=n - 1))):
            got = tplanner.assign_cuts(fractions, k_max, cfg=cfg, channel=ch, **kw)
            want = jplanner.assign_cuts(fractions, k_max, cfg=jcfg, channel=jch, **kw)
            assert _fields(got) == _fields(want), (profile, k_max, kw)
            assert got.to_json() == want.to_json() and got.summary() == want.summary()
    with pytest.raises(ValueError):
        tplanner.assign_cuts([], 3, cfg=cfg)
    with pytest.raises(ValueError):
        tplanner.assign_cuts([0.3], 0, cfg=cfg)
