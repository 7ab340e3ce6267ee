"""The port's dry run (``repro_torch.launch.dryrun``), its abstract model and
the two examples against the JAX package.

The layout twin: for the ten dry-run archs at full width, both production
meshes and each kind's rules, the port's per-device parameter, AdamW moment
and decode-cache bytes equal the reference's, and its per-parameter
``PartitionSpec``s equal the reference's key for key.  The reference's side
is ``Model(cfg).abstract_params()``, ``param_logical()``,
``jax.eval_shape(init_cache)`` and ``cache_logical()`` laid out by its
``logical_to_pspec`` over ``jax.sharding.AbstractMesh``: no device, no
compile.  The two caches differ in layout (the reference's ``{"unit":
[...]}`` against the port's tensors stacked over the layers of a kind), so
they are held by bytes; the reference's scalar ``len`` and its ``enc_pos``
positions, which the port keeps on the host or computes, are left out.

``Model(cfg, device="meta")`` draws and allocates nothing and matches a CPU
model's parameters; ``dryrun.main`` writes the reference's record keys and
reuses ``ok`` records; the examples run on the CPU, the quickstart's rows
equal to the reference example's on the same episode.
"""

import contextlib
import importlib.util
import io
import json
import math
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.checkpoint.npz import _path_str  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import sharding as jshard  # noqa: E402
from repro.models.layers import is_axes  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.runtime import engine as jeng  # noqa: E402
from repro_torch.checkpoint.bridge import reference_tensors  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import dist, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.sharding import make_rules  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.roofline import HW_H100, RooflineTerms  # noqa: E402
from repro_torch.runtime import engine as teng  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")
DECODE_SHAPES = ("decode_32k", "long_500k")


def _abstract_mesh(multi_pod: bool):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _ref_layout(sds_tree, logical_tree, mesh, rules, skip=()):
    """The reference's layout -> ({path: spec tuple}, one device's bytes)."""

    leaves = jax.tree_util.tree_flatten_with_path(sds_tree)[0]
    names = jax.tree.leaves(logical_tree, is_leaf=is_axes)
    assert len(leaves) == len(names)
    specs, total = {}, 0
    for (path, sds), ax in zip(leaves, names):
        key = "/".join(_path_str(p) for p in path)
        if key.split("/")[0] in skip:
            continue
        spec = tuple(jshard.logical_to_pspec(sds.shape, ax.names, mesh, rules))
        spec += (None,) * (len(sds.shape) - len(spec))
        local = [d // math.prod(mesh.shape[a] for a in ((e,) if isinstance(e, str) else e or ()))
                 for d, e in zip(sds.shape, spec)]
        specs[key] = spec
        total += math.prod(local) * sds.dtype.itemsize
    return specs, total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", dryrun.DRYRUN_ARCHS)
def test_layout_matches_reference(arch, multi_pod):
    jmesh, tmesh = _abstract_mesh(multi_pod), make_production_mesh(multi_pod=multi_pod)
    jref, tmod = JaxModel(jax_config(arch)), Model(get_config(arch), device=META)
    jparams, jlogical = jref.abstract_params(), jref.param_logical()
    tparams = dryrun.abstract_params(tmod)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in tparams.items()} == {
        "/".join(_path_str(p) for p in path): (tuple(s.shape), f"torch.{s.dtype}")
        for path, s in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    for kind, overrides in dryrun.RULE_OVERRIDES.items():
        jrules, trules = jshard.make_rules(jmesh, overrides), make_rules(tmesh, overrides)
        want_specs, want = _ref_layout(jparams, jlogical, jmesh, jrules)
        got_specs, got = dryrun.lay_out(tparams, tmod.param_logical(), tmesh, trules)
        assert {k: tuple(v) for k, v in got_specs.items()} == want_specs, (arch, kind)
        assert got == want, (arch, kind, "params")
        if kind == "train":
            state = adamw_init(tparams, AdamWConfig(moment_dtype="bfloat16"))
            got_m = sum(dryrun.lay_out(m, tmod.param_logical(), tmesh, trules)[1]
                        for m in (state.m, state.v))
            bf16 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, "bfloat16"), jparams)
            assert got_m == 2 * _ref_layout(bf16, jlogical, jmesh, jrules)[1], (arch, "moments")
    overrides = dryrun.RULE_OVERRIDES["decode"]
    jrules, trules = jshard.make_rules(jmesh, overrides), make_rules(tmesh, overrides)
    for name in DECODE_SHAPES:
        shape = INPUT_SHAPES[name]
        if not dryrun.supports_shape(get_config(arch), shape):
            continue
        b, s = shape.global_batch, shape.seq_len
        for opt in (False, True):
            jm = JaxModel(jax_config(arch), windowed_cache=opt, cache_cross_kv=opt)
            tm = Model(get_config(arch), device=META, windowed_cache=opt, cache_cross_kv=opt)
            jcache = jax.eval_shape(lambda: jm.init_cache(b, s))
            want = _ref_layout(jcache, jm.cache_logical(b, s), jmesh, jrules,
                               skip=("len", "enc_pos"))[1]
            got = dryrun.lay_out(dryrun.decode_cache(tm, b, s), tm.cache_logical(b, s), tmesh,
                                 trules)[1]
            assert got == want, (arch, name, opt, got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_model_matches_a_cpu_model_and_allocates_nothing(arch):
    cfg = get_smoke_config(arch)
    meta, cpu = Model(cfg, device=META), Model(cfg, device="cpu")
    assert [(n, p.shape, p.dtype) for n, p in meta.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in cpu.named_parameters()]
    assert all(p.is_meta for p in meta.parameters())
    assert meta.abstract_params() == {k: (tuple(t.shape), t.dtype)
                                      for k, t in reference_tensors(cpu).items()}
    assert meta.abstract_params().keys() == meta.param_logical().keys()
    def shapes(cache):
        return {k: [tuple(x.shape) for x in v] if isinstance(v, list) else tuple(v.shape)
                for k, v in cache.items() if k != "len"}

    for opt in (False, True):
        kw = dict(windowed_cache=opt, cache_cross_kv=opt)
        m = Model(cfg, device=META, **kw)
        cache = dryrun.decode_cache(m, 3, 100)
        names = m.cache_logical(3, 100)
        assert cache.keys() == names.keys()
        for key, t in cache.items():
            for leaf, ax in zip(t if isinstance(t, list) else [t],
                                names[key] if isinstance(t, list) else [names[key]]):
                assert leaf.is_meta and leaf.dim() == len(ax), (arch, key)
        assert shapes(m.init_cache(3, 100)) == shapes(Model(cfg, device="cpu", **kw)
                                                      .init_cache(3, 100))


def test_the_largest_meta_model_builds_in_well_under_a_second():
    cfg = get_config("jamba-1.5-large-398b")
    Model(cfg, device=META)
    t0 = time.perf_counter()
    model = Model(cfg, device=META)
    took = time.perf_counter() - t0
    assert took < 1.0, took
    assert all(p.is_meta for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) > 3.9e11


def test_dryrun_all_archs_both_variants_no_failure(tmp_path):
    out = tmp_path / "dryrun.json"
    for variant in ("baseline", "optimized"):
        with contextlib.redirect_stdout(io.StringIO()):
            res = dryrun.main(["--arch", "all", "--shape", "all", "--mesh", "both",
                               "--out", str(out), "--variant", variant])
    status = [r["status"] for r in res.values()]
    assert status.count("fail") == 0
    assert status.count("skip") == 6 and status.count("ok") == 2 * 2 * 34
    assert json.loads(out.read_text()) == res


def _expected_keys(arch, variant=""):
    from repro.configs import INPUT_SHAPES as JSHAPES
    from repro.configs import supports_shape as jsupports

    keys = set()
    for name, shape in JSHAPES.items():
        if not jsupports(jax_config(arch), shape):
            keys.add(f"{arch}|{name}|skip")
            continue
        for mesh in ("pod16x16", "pod2x16x16"):
            keys.add(f"{arch}|{name}|{mesh}" + (f"|{variant}" if variant else ""))
    return keys


def test_dryrun_records_and_cache(tmp_path, capsys):
    arch = "gemma-7b"  # full attention: long_500k is a skip record
    out = tmp_path / "dryrun.json"
    argv = ["--arch", arch, "--shape", "all", "--mesh", "both", "--out", str(out)]
    first = dryrun.main(argv)
    assert set(first) == _expected_keys(arch)
    fields = set(RooflineTerms.__dataclass_fields__) | {
        "layout_s", "mem_counts", "mem_parts_gb", "hw", "variant", "status",
        "collective_breakdown", "collective_note"}
    for key, rec in first.items():
        if key.endswith("|skip"):
            assert rec["status"] == "skip"
            continue
        assert set(rec) == fields and rec["status"] == "ok" and rec["hw"] == HW_H100.name
        # gemma-7b's 16 heads divide over the 16 ranks: only training has no term
        train = key.split("|")[1] == "train_4k"
        assert (rec["collective_s"] is None) == train and rec["mem_counts"] == dryrun.MEM_COUNTS
        assert math.isclose(rec["mem_per_device_gb"], sum(rec["mem_parts_gb"].values()))
        assert rec["compute_s"] == rec["hlo_gflops"] * 1e9 / (rec["chips"] * HW_H100.peak_flops)
    capsys.readouterr()
    assert dryrun.main(argv) == first  # every ok record reused
    assert capsys.readouterr().out.count("cached: ") == len(first) - 1 == 6
    opt = dryrun.main(argv + ["--variant", "optimized"])
    assert set(opt) == _expected_keys(arch) | _expected_keys(arch, "optimized")


@pytest.mark.parametrize("arch,shape_name,multi_pod", [
    ("openvla-7b", "decode_32k", False), ("openvla-7b", "prefill_32k", True),
    ("jamba-1.5-large-398b", "decode_32k", False), ("jamba-1.5-large-398b", "long_500k", True),
    ("seamless-m4t-medium", "prefill_32k", False), ("phi-3-vision-4.2b", "prefill_32k", False),
    ("qwen3-moe-235b-a22b", "decode_32k", True),
])
def test_dryrun_collective_term_from_the_ranks_counts(arch, shape_name, multi_pod):
    """Prefill and decode records carry the term of the collectives one of
    the 16 ranks issues: ``dist.collective_bytes`` over the device's data
    shard of the batch (the batch over ``data``, or ``pod`` x ``data``;
    long_500k's batch of 1 stays whole), a prefill's ``seq_len`` tokens
    (a VLM's patch positions not looked up, seamless's encoder over the
    frames), by op in GB, the term on ``HW_H100``'s links as the reference
    divides it."""

    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    rec = dryrun.run_combo(arch, shape_name, multi_pod, verbose=False)
    rows = 1 if shape.global_batch == 1 else shape.global_batch // (32 if multi_pod else 16)
    prompt = 1 if shape.kind == "decode" else shape.seq_len
    vlm = cfg.modality in ("vision", "audio") and not cfg.encoder_decoder
    front = cfg.num_modality_tokens if vlm and prompt > 1 else 0
    want = dist.collective_bytes(cfg, rows, prompt, 16, frontend=front)
    sharded = rows < shape.global_batch
    if cfg.moe is not None:  # the experts over the 16 data ranks
        want.update({f"data_{k}": v for k, v in dist.data_collective_bytes(
            cfg, rows, prompt, 16, sharded=sharded).items() if k != "broadcast"})
    total = sum(want.values())
    assert rec["collective_breakdown"] == {**{k: v / 1e9 for k, v in want.items()},
                                           "total": total / 1e9}
    assert rec["collective_gbytes"] == total / 1e9
    assert rec["collective_s"] == total / (rec["chips"] * HW_H100.ici_bw)
    n = dist.collectives(cfg, prompt)
    assert rec["collective_note"].startswith(
        f"counted: {n['all_reduce']} all-reduces and {n['all_gather']} all-gathers")
    assert f"of {rows} rows over 16 ranks" in rec["collective_note"]
    nd = dist.data_collectives(cfg, 16, sharded=sharded)
    assert (f"its experts over 16 data ranks, the rows {'sharded' if sharded else 'replicated'}: "
            f"{nd['all_gather']} all-gathers and {nd['all_reduce']} all-reduces"
            in rec["collective_note"]) == (cfg.moe is not None)


@pytest.mark.parametrize("arch,shape_name,variant", [
    ("phi3.5-moe-42b-a6.6b", "decode_32k", "baseline"),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", "optimized"),
    ("jamba-1.5-large-398b", "long_500k", "baseline"),
])
def test_dryrun_collective_term_counts_the_experts_over_data(arch, shape_name, variant):
    """An MoE stack's term adds its experts' exchanges over the 16 data
    ranks: with the batch sharded over data, a gather of the rows and a
    float32 reduce-scatter of the mixture an MoE layer (both dispatches:
    16 experts divide over 16 ranks); long_500k's batch of 1 stays whole,
    so an all-reduce alone."""

    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    rec = dryrun.run_combo(arch, shape_name, False, verbose=False, variant=variant)
    layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    rows = max(shape.global_batch // 16, 1)
    prompt = 1 if shape.kind == "decode" else shape.seq_len
    d = cfg.d_model
    br = rec["collective_breakdown"]
    if shape.global_batch > 1:
        assert br["data_all_gather"] == layers * 16 * rows * d * 2 / 1e9
        assert br["data_all_reduce"] == layers * 16 * rows * d * 4 / 1e9
    else:
        assert br["data_all_gather"] == 0
        assert br["data_all_reduce"] == layers * rows * prompt * d * 4 / 1e9
    assert dist.experts_split(cfg, 16)


@pytest.mark.parametrize("variant", ["baseline", "optimized"])
def test_dryrun_pod_term_counts_the_batch_group(variant):
    """On the pod mesh (2 x 16 x 16) the rows shard over the 32 (pod, data)
    ranks: the dense dispatch (baseline) gathers the rows of the pod's 16
    data ranks, the capacity dispatch (optimized) gathers its table's rows
    over the whole batch group of 32; both reduce-scatter over the 16 data
    ranks that hold the experts."""

    arch, shape_name = "phi3.5-moe-42b-a6.6b", "decode_32k"
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    rec = dryrun.run_combo(arch, shape_name, True, verbose=False, variant=variant)
    layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    rows, d = shape.global_batch // 32, cfg.d_model
    br = rec["collective_breakdown"]
    over = 32 if variant == "optimized" else 16
    assert br["data_all_gather"] == layers * over * rows * d * 2 / 1e9
    assert br["data_all_reduce"] == layers * 16 * rows * d * 4 / 1e9
    assert ("over the 32 (pod, data) ranks" in rec["collective_note"]) == (over == 32)


@pytest.mark.parametrize("arch,shape_name,words", [
    ("starcoder2-3b", "decode_32k", "24 heads"), ("xlstm-125m", "prefill_32k", "4 heads"),
    ("xlstm-125m", "long_500k", "4 heads"), ("gemma2-9b", "train_4k", "no training over a model"),
    ("openvla-7b", "train_4k", "no training over a model"),
])
def test_dryrun_collective_term_none_with_its_reason(arch, shape_name, words):
    """The two stacks whose heads do not divide over the 16 ranks, and
    every ``train`` record, leave the term None with the refusal's words."""

    rec = dryrun.run_combo(arch, shape_name, False, verbose=False)
    assert rec["collective_s"] is None and rec["collective_gbytes"] is None
    assert rec["collective_breakdown"] is None and words in rec["collective_note"]
    assert rec["bottleneck"] in ("compute", "memory")


def test_model_flops_for_is_estimates_useful_count():
    for arch in dryrun.DRYRUN_ARCHS:
        cfg = get_config(arch)
        for shape in INPUT_SHAPES.values():
            assert dryrun.model_flops_for(cfg, shape) == dryrun.estimate(cfg, shape).flops_model


def test_dryrun_records_a_failure_and_goes_on(tmp_path, monkeypatch):
    def boom(arch, shape_name, multi_pod, verbose=True, variant="baseline"):
        if shape_name == "prefill_32k":
            raise RuntimeError("no layout")
        return {"status": "ok"}

    monkeypatch.setattr(dryrun, "run_combo", boom)
    res = dryrun.main(["--arch", "starcoder2-3b", "--shape", "all", "--mesh", "single",
                       "--out", str(tmp_path / "d.json")])
    assert res["starcoder2-3b|prefill_32k|pod16x16"] == {"status": "fail", "error": "no layout"}
    assert res["starcoder2-3b|decode_32k|pod16x16"]["status"] == "ok"


def _load_example(name):
    spec = importlib.util.spec_from_file_location(name.replace(".py", ""),
                                                  ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_rows_equal_the_reference_example(monkeypatch, capsys):
    """Both examples over one episode of the suite (the reference's jit
    compiles per episode length), printed rows equal."""

    for eng in (jeng, teng):
        monkeypatch.setattr(eng, "episode_suite", lambda seeds, suite=eng.episode_suite:
                            suite(seeds=(0,), tasks=("pick_place",)))
    _load_example("quickstart.py").main()
    want = capsys.readouterr().out.splitlines()
    rows = _load_example("quickstart_torch.py").main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == "decision core on cpu" and got[1:] == want
    assert set(rows) == {"edge_only", "cloud_only", "vision", "rapid"}


@pytest.mark.parametrize("argv", [
    ["--steps", "40"],
    ["--steps", "40", "--paged", "--task", "drawer_open"],
    ["--fleet", "4", "--trigger", "rapid", "--scan-rounds", "4", "--steps", "40"],
    ["--fleet", "6", "--arrivals", "poisson", "--steps", "40"],
    ["--fleet", "4", "--partition", "auto", "--network", "lan", "--steps", "40"],
], ids=["single", "single_paged", "fleet_rapid", "churn", "fleet_split"])
def test_ecc_serving_example_runs_on_the_cpu(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = _load_example("ecc_serving_torch.py").main(argv + ["--device", "cpu"])
    text = out.getvalue()
    assert "on cpu" in text.splitlines()[0]
    launches = json.loads(text.splitlines()[-1].removeprefix("kernel launches: "))
    assert set(launches.values()) == {0}  # a CPU tensor never reaches a hand kernel
    if "--arrivals" in argv:
        assert res["joined"] > 0 and "churn:" in text
    elif "--fleet" in argv:
        assert res["actions"].shape == (40, int(argv[1]), 7) and "chunks served" in text
        if "--partition" in argv:
            assert res["split_robots"] == [1, 3]
    else:
        assert res["actions"].shape == (40, 7) and res["offloads"] > 0


def test_ecc_serving_example_writes_its_trace_metrics_and_profile(tmp_path):
    trace, metrics, prof = tmp_path / "t.json", tmp_path / "m.json", tmp_path / "prof"
    with contextlib.redirect_stdout(io.StringIO()):
        _load_example("ecc_serving_torch.py").main([
            "--fleet", "3", "--steps", "24", "--tick", "legacy", "--scan-rounds", "2",
            "--trace-out", str(trace), "--metrics-json", str(metrics), "--profile", str(prof),
            "--device", "cpu"])
    assert json.loads(trace.read_text())["traceEvents"]
    assert json.loads(metrics.read_text())
    assert list(prof.glob("*.json"))
