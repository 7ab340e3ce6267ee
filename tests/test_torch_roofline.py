"""The port's roofline (``repro_torch.roofline``) against the JAX package.

``estimate``, ``forward_flops``, ``block_decode_bytes`` and
``_decode_cache_bytes`` are the reference's arithmetic: equal to 1e-12 on
all 11 full configs, the four input shapes and both variants;
``supports_shape`` and ``registry`` agree; ``roofline_from_compiled`` gives
the reference's terms on the same inputs and hardware (a ``HwSpec`` built
here from the reference's ``HW_V5E`` numbers: the port holds no TPU
constant), and drops the collective term when none was measured.  The
forward count is held to ``torch.utils.flop_counter.FlopCounterMode``
around a CPU forward, in the band the reference holds it to XLA's cost
analysis (``tests/test_roofline.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.roofline import analysis as jana  # noqa: E402
from repro.roofline import costmodel as jcost  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.models.model import Model, layer_specs  # noqa: E402
from repro_torch.roofline import HW_H100, HwSpec, RooflineTerms, roofline_from_compiled  # noqa: E402
from repro_torch.roofline import costmodel as tcost  # noqa: E402

ARCHS = tcfg.ARCH_IDS
SHAPES = tuple(tcfg.INPUT_SHAPES)


def _close(got, want, what):
    assert abs(got - want) <= 1e-12 * max(abs(want), 1.0), (what, got, want)


def test_input_shapes_registry_and_supports_shape_match_reference():
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tcfg.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.INPUT_SHAPES.items()}
    treg, jreg = tcfg.registry(), jcfg.registry()
    assert list(treg) == list(jreg)
    for arch in ARCHS:
        assert treg[arch].name == jreg[arch].name
        assert treg[arch].param_counts() == jreg[arch].param_counts()
        for name in SHAPES:
            assert tcfg.supports_shape(treg[arch], tcfg.INPUT_SHAPES[name]) == \
                jcfg.supports_shape(jreg[arch], jcfg.INPUT_SHAPES[name]), (arch, name)


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_estimate_and_forward_flops_match_reference(arch, shape_name):
    tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
    ts, js = tcfg.INPUT_SHAPES[shape_name], jcfg.INPUT_SHAPES[shape_name]
    b, s = ts.global_batch, ts.seq_len
    for optimized in (False, True):
        for remat in (True, False):
            got = tcost.estimate(tc, ts, optimized=optimized, remat=remat)
            want = jcost.estimate(jc, js, optimized=optimized, remat=remat)
            for f in ("flops", "hbm_bytes", "flops_model"):
                _close(getattr(got, f), getattr(want, f), (arch, shape_name, optimized, remat, f))
        for kw in (dict(), dict(decode=True, kv_len=s), dict(sparse_attn=False),
                   dict(decode=True, kv_len=s, cached_cross_kv=False)):
            _close(tcost.forward_flops(tc, b, 1 if kw.get("decode") else s, optimized=optimized,
                                       **kw),
                   jcost.forward_flops(jc, b, 1 if kw.get("decode") else s, optimized=optimized,
                                       **kw), (arch, shape_name, optimized, kw))
        _close(tcost._decode_cache_bytes(tc, b, s, windowed=optimized),
               jcost._decode_cache_bytes(jc, b, s, windowed=optimized), (arch, shape_name))
    from repro.models.model import layer_specs as jspecs

    assert layer_specs(tc) == jspecs(jc)
    for spec in set(layer_specs(tc)):
        for windowed in (False, True):
            _close(tcost.block_decode_bytes(tc, spec, b, s, windowed=windowed),
                   jcost.block_decode_bytes(jc, spec, b, s, windowed=windowed),
                   (arch, shape_name, spec, windowed))


V5E_NUMBERS = HwSpec(name=jana.HW_V5E.name, peak_flops=jana.HW_V5E.peak_flops,
                     hbm_bw=jana.HW_V5E.hbm_bw, ici_bw=jana.HW_V5E.ici_bw)
TERMS_CASES = [
    dict(flops=3.1e18, bytes_accessed=2.2e15, collective_bytes=7.5e13, model_flops=2.9e18,
         mem_per_device_bytes=41e9),
    dict(flops=1.0e12, bytes_accessed=9.0e12, collective_bytes=1.0e9, model_flops=2.0e11,
         mem_per_device_bytes=3e9),
    dict(flops=5.0e10, bytes_accessed=1.0e8, collective_bytes=4.0e12, model_flops=0.0,
         mem_per_device_bytes=1.0),
    dict(flops=0.0, bytes_accessed=1.0e8, collective_bytes=0.0, model_flops=0.0,
         mem_per_device_bytes=0.0),
]


@pytest.mark.parametrize("case", TERMS_CASES)
def test_roofline_terms_match_reference(case):
    common = dict(arch="gemma-7b", shape="train_4k", mesh_name="pod16x16", chips=256, **case)
    got = roofline_from_compiled(hw=V5E_NUMBERS, **common)
    want = jana.roofline_from_compiled(hw=jana.HW_V5E, **common)
    assert isinstance(got, RooflineTerms)
    assert got.as_dict() == want.as_dict()


@pytest.mark.parametrize("case", TERMS_CASES)
def test_roofline_without_collectives_picks_compute_or_memory(case):
    case = dict(case, collective_bytes=None)
    got = roofline_from_compiled(arch="a", shape="s", mesh_name="m", chips=512, **case)
    assert got.collective_s is None and got.collective_gbytes is None
    assert got.compute_s == case["flops"] / (512 * HW_H100.peak_flops)
    assert got.memory_s == case["bytes_accessed"] / (512 * HW_H100.hbm_bw)
    assert got.bottleneck == ("compute" if got.compute_s > got.memory_s else "memory")


def test_h100_spec_is_the_data_sheet():
    assert (HW_H100.peak_flops, HW_H100.hbm_bw, HW_H100.ici_bw) == (989e12, 3.35e12, 450e9)
    import repro_torch.roofline as roof

    assert not any("V5E" in name.upper() for name in dir(roof))


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "starcoder2-3b"])
def test_costmodel_matches_flop_counter_on_a_cpu_forward(arch):
    """The twin of ``test_costmodel_matches_xla_on_unrolled_forward``: the
    analytic forward FLOPs against ``FlopCounterMode`` (matmuls and
    attention; norms, softmax and RoPE uncounted) on a smoke stack."""

    cfg = tcfg.get_smoke_config(arch).replace(dtype="float32")
    model = Model(cfg, device="cpu")
    b, s = 2, 64
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)))
    counter = FlopCounterMode(display=False)
    with counter:
        model._logits(model.forward({"tokens": tokens}))
    counted = counter.get_total_flops()
    ours = tcost.forward_flops(cfg, b, s, optimized=False)
    assert counted > 0
    assert 0.5 < ours / counted < 2.2, (arch, ours, counted)


def test_optimized_estimates_improve_the_right_terms():
    shapes = tcfg.INPUT_SHAPES
    cfg = tcfg.get_config("qwen3-moe-235b-a22b")
    b0 = tcost.estimate(cfg, shapes["train_4k"])
    o0 = tcost.estimate(cfg, shapes["train_4k"], optimized=True)
    assert o0.flops < 0.2 * b0.flops  # MoE: the capacity dispatch cuts compute
    cfg2 = tcfg.get_config("gemma2-9b")
    b1 = tcost.estimate(cfg2, shapes["long_500k"])
    o1 = tcost.estimate(cfg2, shapes["long_500k"], optimized=True)
    assert o1.hbm_bytes < 0.25 * b1.hbm_bytes  # windowed decode cuts memory


def test_model_flops_definition():
    cfg = tcfg.get_config("h2o-danube-3-4b")
    sh = tcfg.INPUT_SHAPES["train_4k"]
    est = tcost.estimate(cfg, sh)
    expect = 6.0 * cfg.param_counts()["active"] * sh.global_batch * sh.seq_len
    assert abs(est.flops_model - expect) / expect < 1e-9
