"""The JAX package's sharded engine on 8 forced host devices, recorded for
``tests/test_torch_sharded.py``.

Run in a process of its own (the device count is fixed when jax starts):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/torch_sharded_ref.py OUT.npz \\
        [--model-axis [--part engine|fleet] [--params IN.npz]]

It runs the scenarios of ``tests/test_sharded.py`` on the f32 openvla-smoke
stack (``ENGINE_KW``): cloud-only over an 8-way data mesh, a mixed fleet
with a split lane at cut 1 over the same mesh, disaggregated prefill on the
last device, prefill on the last device with decode over the other 7, and
``paged_decode_attention_sharded`` at the shapes of its test.  For each
scheduler run it writes the results (robot, rounds, kind) in harvest order,
their tokens, every reservation (robot, row, pages) in order, the final
``PoolStats`` and counters; and the stack's parameters in the layout of
``repro/checkpoint/npz.py``, so that the port runs on the same weights.

With ``--model-axis`` it runs the meshes with a ``model`` axis instead, for
``tests/test_torch_model_axis.py`` (``TP_SCENARIOS``) and
``tests/test_torch_model_axis_xlstm_encdec.py`` (``--part xlstm``: the
engine on f32 xlstm-smoke over (data 4, model 2) and on its wide variant
over (2, 4), ``XLSTM_SCENARIOS``; ``--part encdec``: f32 seamless-smoke's
``prefill`` and ``decode_chunk`` jitted under ``sharding_rules`` of a (4,
2) and a (2, 4) mesh, its parameters placed by ``param_logical``, in the
four modes of ``ENCDEC_MODES``, dense or paged cache x cross K/V
projected each token or cached; each stack's parameters under
``params/<stack>/``, ``AXIS_STACKS``).  Without ``--part`` or with
``--part engine|fleet``: the engine on
f32 openvla-smoke over (data 4, model 2), starcoder2-smoke over (2, 4),
gemma2-smoke over (4, 2), jamba-smoke over (4, 2), qwen3-moe-smoke over
(2, 4) and phi3.5-moe-smoke under the capacity dispatch over (4, 2), and
``serve_fleet(trigger="rapid")`` on openvla-smoke over (4, 2)
(``TP_FLEET``), each stack's parameters under ``params/<arch>/``.
``--part split`` (``tests/test_torch_model_axis_split.py``): the engine with
split lanes over the (4, 2) meshes of ``SPLIT_SCENARIOS`` (pipelined and
serial lanes on openvla-smoke, jamba- and xlstm-smoke), the first lane
prefill's logits of each, the reference executor's ``split_prefill`` /
``split_decode_step`` logits on one device (``EXEC_CASES``) and one
``PartitionedPolicy`` chunk (``POLICY_CASE``); ``--part split24``: the
(2, 4) meshes (a pipelined lane, heterogeneous lanes and qwen3-moe's
expert-offload lane);
``--part split_fleet``: ``serve_fleet(trigger="rapid")`` over (4, 2) with
the robots of ``SPLIT_FLEET`` split; ``--part split_fleet_p``: the same
over (data 2, model 2) with the prefill on the fifth device
(``SPLIT_FLEET_P``); ``--part pod``: the engine on openvla-smoke and
qwen3-moe-smoke over a (pod 2, data 2, model 2) mesh (``POD_SCENARIOS``).
The split parts hand ``_SplitLane.flush`` a
writable copy of the lane's logits: under jax 0.9 ``harvest`` leaves them
read-only and ``flush`` writes into them, so the pipelined lane fails on
its second admission otherwise (a fault of the reference, which stays as
it is).  Under
the capacity dispatch idle rows route and take expert slots, so there the
engine's paged attention is its CPU oracle with the output of an idle row
(length 0) set to 0, as the Pallas kernel and the port give it (the
oracle gives the mean of the values it gathers).  ``--part`` runs one
part alone, ``engine`` (the scenarios), ``fleet``, ``xlstm``, ``encdec``,
``split``, ``split24``, ``split_fleet``, ``split_fleet_p`` or ``pod``,
so that the parts can run side by side (``--part a,b`` runs several, one after
another); ``--only NAME,...`` runs those scenarios of ``TP_SCENARIOS`` and
``SPLIT_SCENARIOS`` alone (and no executor or policy case);
``--params`` takes the stacks' parameters from an npz
keyed so (``params/<arch>/<key>``, e.g. the port's ``Model.init``
weights) instead of drawing them, and then writes none (without
``--model-axis``: openvla-smoke's, ``params/openvla-7b/<key>``).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint.npz import _flatten, _path_str
from repro.configs import get_smoke_config
from repro.data.pipeline import EpisodeTokenizer
from repro.kernels import ops as kops
from repro.kernels.paged_attention import paged_decode_attention_sharded
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import serve_fleet
from repro.launch.sharding import named_sharding, sharding_rules
from repro.models.layers import is_axes
from repro.models.model import Model
from repro.partition.executor import PartitionExecutor, PartitionedPolicy
from repro.runtime import scheduler as sched_mod
from repro.runtime.kv_cache import PagedSpec
from torch_model_axis_cases import (AXIS_STACKS, ENCDEC_MESHES, ENCDEC_MODES, ENCDEC_PLAN,
                                    ENGINE_KW, EXEC_CASES, POD_SCENARIOS, POLICY_CASE, SCENARIOS,
                                    SMOKE_LAYERS, SPLIT_FLEET, SPLIT_FLEET_P, SPLIT_SCENARIOS,
                                    TP_FLEET, TP_SCENARIOS, XLSTM_SCENARIOS, encdec_batch,
                                    encdec_mode, encdec_pages, exec_inputs, fleet_record, lane_cut,
                                    obs_pair, split_key)

WRAPPER = dict(b=8, h=8, kv=2, d=64, page=16, pool=24, maxp=4, seed=7)


def wrapper_inputs(b, h, kv, d, page, pool, maxp, seed):
    """The inputs of ``tests/test_sharded.py``'s wrapper test (numpy)."""

    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(pool, page, kv, d)).astype(np.float32)
    vp = rng.normal(size=(pool, page, kv, d)).astype(np.float32)
    pt = rng.integers(0, pool, (b, maxp)).astype(np.int32)
    lens = rng.integers(1, maxp * page, (b,)).astype(np.int32)
    return q, kp, vp, pt, lens


def record(out, name, sched, results):
    res = np.asarray([(r.robot_id, r.submitted_round, r.admitted_round, r.completed_round,
                       int(r.kind == "split")) for r in results], np.int64)
    st = sched.pool_stats()
    out[f"{name}/results"] = res
    out[f"{name}/tokens"] = np.stack([np.asarray(r.tokens, np.int64) for r in results])
    out[f"{name}/reserved"] = np.asarray(sched.reserved, np.int64)
    out[f"{name}/pool"] = np.asarray([st.pages_in_use, st.high_water, *(st.shard_in_use or ()),
                                      *(st.shard_high_water or ())], np.int64)
    out[f"{name}/counters"] = np.asarray([sched.round, sched.windows, sched.window_closes,
                                          sched.mixed_rounds, sched.peak_active, sched.rows,
                                          sched.allocator.num_pages], np.int64)


def f32_stack(arch, flat=None, **kw):
    """The reference's f32 smoke stack ``arch`` -> (model, params,
    tokenizer): its parameters drawn, or taken from ``flat`` (keyed as
    ``_flatten`` keys them)."""

    cfg = get_smoke_config(arch).replace(dtype="float32", param_dtype="float32", **kw)
    model = Model(cfg)
    if flat is None:
        params = model.init(jax.random.PRNGKey(0))
    else:
        params = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(flat["/".join(_path_str(q) for q in path)]),
            jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    return model, params, EpisodeTokenizer(cfg.vocab_size)


def idle_zero(oracle):
    """``oracle`` (the CPU paged attention) with idle rows' output 0."""

    def paged(q, kp, vp, pt, lens, *, window=0, logit_cap=0.0):
        out = oracle(q, kp, vp, pt, lens, window=window, logit_cap=logit_cap)
        return jnp.where((jnp.asarray(lens) > 0)[:, None, None], out, 0).astype(out.dtype)

    return paged


def xlstm_part(out, devs, recording, stack):
    """``XLSTM_SCENARIOS``: the engine on an xLSTM stack over its mesh."""

    for name, key, data, model_axis, n, seed in XLSTM_SCENARIOS:
        model, params, tok = stack(key)
        mesh = make_test_mesh(data=data, model=model_axis, devices=devs[:data * model_axis])
        sched = recording(model, params, tok, mesh=mesh, **ENGINE_KW)
        rng = np.random.default_rng(seed)
        for r in range(n):
            sched.submit(r, *obs_pair(rng))
        record(out, name, sched, sched.drain())


def encdec_part(out, devs, stack):
    """seamless-smoke's ``prefill`` (+ ``cache_to_paged``) and
    ``decode_chunk`` jitted under each mesh of ``ENCDEC_MESHES`` in each of
    ``ENCDEC_MODES``: the prefill's logits, the chunk's tokens and its last
    logits."""

    base, params, _ = stack("seamless-m4t-medium")
    cfg, p = base.cfg, ENCDEC_PLAN
    batch = {k: jnp.asarray(v) for k, v in encdec_batch(cfg.vocab_size, cfg.d_model).items()}
    maxp, pt, caps = encdec_pages()
    spec = PagedSpec(num_pages=p["b"] * maxp, page_size=p["page"], max_pages_per_seq=maxp)
    for name, data, model_axis in ENCDEC_MESHES:
        mesh = make_test_mesh(data=data, model=model_axis, devices=devs[:data * model_axis])
        placed = jax.tree.map(
            lambda ax, a: jax.device_put(a, named_sharding(mesh, a.shape, ax.names)),
            base.param_logical(), params, is_leaf=is_axes)
        for cached, paged in ENCDEC_MODES:
            m = Model(cfg, cache_cross_kv=cached)
            extra = 0 if paged else p["steps"]
            with sharding_rules(mesh):
                logits, cache = jax.jit(lambda pr, b, m=m, e=extra: m.prefill(pr, b, extra=e))(
                    placed, batch)
                if paged:
                    cache = m.cache_to_paged(cache, m.init_paged_cache(p["b"], spec),
                                             jnp.asarray(pt), jnp.asarray(caps))
                toks, last, _ = jax.jit(lambda pr, lg, c, m=m: m.decode_chunk(
                    pr, lg, c, p["steps"], 0))(placed, logits, cache)
            key = f"{name}/{encdec_mode(cached, paged)}"
            out[f"{key}/prefill"] = np.asarray(logits)
            out[f"{key}/tokens"] = np.asarray(toks)
            out[f"{key}/last"] = np.asarray(last)


def pod_part(out, devs, recording, stack):
    """``POD_SCENARIOS``: the engine over a (pod, data, model) mesh, whose
    batch rule is ``("pod", "data")``."""

    for name, arch, pod, data, model_axis, n, seed, impl in POD_SCENARIOS:
        model, params, tok = stack(arch)
        if impl != model.moe_impl:
            model = Model(model.cfg, moe_impl=impl)
        k = pod * data * model_axis
        mesh = jax.sharding.Mesh(np.asarray(devs[:k]).reshape(pod, data, model_axis),
                                 ("pod", "data", "model"))
        sched = recording(model, params, tok, mesh=mesh, **ENGINE_KW)
        rng = np.random.default_rng(seed)
        for r in range(n):
            sched.submit(r, *obs_pair(rng))
        record(out, name, sched, sched.drain())


def writable_flush():
    """``_SplitLane.flush`` handed a writable copy of the lane's logits (jax
    0.9's ``harvest`` leaves them read-only, and ``flush`` writes into
    them); the scheduler's first flush records its new rows' logits
    (``first_lane``)."""

    flush = sched_mod._SplitLane.flush

    def patched(self, new):
        if self._logits is not None and not self._logits.flags.writeable:
            self._logits = np.array(self._logits)
        flush(self, new)
        if getattr(self.sched, "first_lane", ()) is None:
            self.sched.first_lane = np.stack([np.asarray(self._logits[s.row]) for s in new])

    sched_mod._SplitLane.flush = patched


def split_part(out, devs, recording, stack, axis, only=None):
    """``SPLIT_SCENARIOS`` over a model axis of ``axis``: the engine with
    split lanes over its mesh; with ``axis`` 2 also the executor's split
    forward on one device (``EXEC_CASES``) and one ``PartitionedPolicy``
    chunk (``POLICY_CASE``)."""

    for name, arch, data, model_axis, keys, pipelined, n, seed in SPLIT_SCENARIOS:
        if model_axis != axis or (only and name not in only):
            continue
        model, params, tok = stack(arch)
        mesh = make_test_mesh(data=data, model=model_axis, devices=devs[:data * model_axis])
        sched = recording(model, params, tok, mesh=mesh, **ENGINE_KW)
        sched.first_lane = None
        for key in keys:
            cut, off = lane_cut(key)
            sched.attach_partition(PartitionExecutor(model, params, cut, expert_offload=off),
                                   pipelined=pipelined)
        rng = np.random.default_rng(seed)
        for r in range(n):
            key = split_key(r, keys)
            sched.submit(r, *obs_pair(rng), partitioned=key is not None, cut=key)
        record(out, name, sched, sched.drain())
        out[f"{name}/first_lane"] = sched.first_lane
    if axis != 2 or only:
        return
    for arch, cut, _ in EXEC_CASES:
        model, params, _ = stack(arch)
        ex = PartitionExecutor(model, params, cut)
        prompts, steps = exec_inputs(model.cfg.vocab_size)
        logits, state = ex.split_prefill(ex.split_params, {"tokens": jnp.asarray(prompts)},
                                         extra=len(steps))
        got = [np.asarray(logits)[:, -1]]
        for token in steps:
            logits, state = ex.split_decode_step(ex.split_params, jnp.asarray(token), state)
            got.append(np.asarray(logits)[:, -1])
        out[f"exec/{arch}/{cut}"] = np.stack(got)
    arch, cut, seed = POLICY_CASE
    model, params, tok = stack(arch)
    policy = PartitionedPolicy(PartitionExecutor(model, params, cut), tok)
    qd, tau = obs_pair(np.random.default_rng(seed))
    obs = np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)
    sp = policy.executor.split_params
    logits, state = policy._prefill(sp, {"tokens": jnp.asarray(obs)})
    out["policy/prefill"] = np.asarray(logits)[:, -1]
    out["policy/tokens"] = np.asarray(policy._decode_chunk(sp, logits, state))
    out["policy/actions"] = policy(qd, tau)
    out["policy/net_ms"] = np.asarray(policy.net_ms_log)


def main_model_axis(path, devs, recording, part=None, params_path=None, only=None):
    out = {}
    stacks = {}
    given = dict(np.load(params_path)) if params_path else None

    def stack(key):
        """``params/<key>/``'s f32 smoke stack: an arch, or an entry of
        ``AXIS_STACKS`` (an arch and its config overrides)."""

        if key not in stacks:
            arch, kw = AXIS_STACKS.get(key, (key, {}))
            pre = f"params/{key}/"
            flat = None if given is None else {k[len(pre):]: v for k, v in given.items()
                                               if k.startswith(pre)}
            stacks[key] = f32_stack(arch, flat, num_layers=SMOKE_LAYERS, **kw)
            if given is None:
                out.update({pre + k: np.asarray(v)
                            for k, v in _flatten(stacks[key][1]).items()})
        return stacks[key]

    for one in (part.split(",") if part else [None]):
        model_axis_part(out, devs, recording, stack, one, only)
    np.savez(path, **out)


def model_axis_part(out, devs, recording, stack, part, only):
    """``--part``'s runs into ``out`` (None: engine and fleet)."""

    if part == "xlstm":
        return xlstm_part(out, devs, recording, stack)
    if part == "pod":
        return pod_part(out, devs, recording, stack)
    if part == "encdec":
        return encdec_part(out, devs, stack)
    if part in ("split", "split24", "split_fleet", "split_fleet_p"):
        writable_flush()
    if part in ("split", "split24"):
        return split_part(out, devs, recording, stack, 4 if part == "split24" else 2, only)
    if part in ("split_fleet", "split_fleet_p"):
        model, params, tok = stack("openvla-7b")
        f, sf = (TP_FLEET if part == "split_fleet" else SPLIT_FLEET_P), SPLIT_FLEET
        n = f["data"] * f["model"]
        mesh = make_test_mesh(data=f["data"], model=f["model"], devices=devs[:n])
        prefill = [devs[n]] if part == "split_fleet_p" else None
        fleet_record(out, "spfleet" if prefill is None else "split_fleet_p", serve_fleet(
            model, params, tok, mesh=mesh, prefill_group=prefill,
            partition_executor=PartitionExecutor(model, params, sf["cut"]),
            split_robots=sf["split_robots"], **TP_FLEET["kw"]))
        return

    for name, arch, data, model_axis, n, seed, impl in TP_SCENARIOS:
        if part not in (None, "engine"):
            break
        if only and name not in only:
            continue
        model, params, tok = stack(arch)
        if impl != model.moe_impl:
            model = Model(model.cfg, moe_impl=impl)
        mesh = make_test_mesh(data=data, model=model_axis, devices=devs[:data * model_axis])
        oracle = kops.paged_decode_attention
        if impl == "capacity":
            kops.paged_decode_attention = idle_zero(oracle)
        try:
            sched = recording(model, params, tok, mesh=mesh, **ENGINE_KW)
            rng = np.random.default_rng(seed)
            for r in range(n):
                sched.submit(r, *obs_pair(rng))
            record(out, name, sched, sched.drain())
        finally:
            kops.paged_decode_attention = oracle
    if part in (None, "fleet"):
        model, params, tok = stack("openvla-7b")
        f = TP_FLEET
        mesh = make_test_mesh(data=f["data"], model=f["model"],
                              devices=devs[:f["data"] * f["model"]])
        fleet_record(out, "fleet42", serve_fleet(model, params, tok, mesh=mesh, **f["kw"]))


def main(path, model_axis=False, part=None, params_path=None, only=None):
    devs = jax.devices()
    assert len(devs) >= 8, "needs XLA_FLAGS=--xla_force_host_platform_device_count=8"

    class Recording(sched_mod.ContinuousBatchingScheduler):
        def __init__(self, *a, **kw):
            self.reserved = []
            super().__init__(*a, **kw)

        def _reserve(self, req):
            seq = super()._reserve(req)
            self.reserved.append([req.robot_id, seq.row, *seq.pages])
            return seq

    lane_reserve = sched_mod._SplitLane.reserve

    def recording_lane_reserve(self, req):
        seq = lane_reserve(self, req)
        if hasattr(self.sched, "reserved"):  # (``serve_fleet``'s scheduler keeps none)
            self.sched.reserved.append([req.robot_id, seq.row, *seq.pages])
        return seq

    sched_mod._SplitLane.reserve = recording_lane_reserve
    if model_axis:
        return main_model_axis(path, devs, Recording, part, params_path, only)

    if params_path:
        pre = "params/openvla-7b/"
        with np.load(params_path) as z:
            flat = {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}
        model, params, tok = f32_stack("openvla-7b", flat)
        out = {}
    else:
        model, params, tok = f32_stack("openvla-7b")
        out = {f"params/{k}": np.asarray(v) for k, v in _flatten(params).items()}

    for name, n, seed, data, disagg, cut in SCENARIOS:
        mesh = make_test_mesh(data=data, devices=devs[:data]) if data else None
        sched = Recording(model, params, tok, mesh=mesh,
                          prefill_group=[devs[-1]] if disagg else None, **ENGINE_KW)
        if cut is not None:
            sched.attach_partition(PartitionExecutor(model, params, cut_layer=cut))
        rng = np.random.default_rng(seed)
        for r in range(n):
            qd, tau = obs_pair(rng)
            sched.submit(r, qd, tau, partitioned=cut is not None and r % 2 == 1)
        record(out, name, sched, sched.drain())

    w = WRAPPER
    q, kp, vp, pt, lens = wrapper_inputs(**w)
    mesh = make_test_mesh(data=w["b"], devices=devs[:w["b"]])
    out["wrapper/out"] = np.asarray(paged_decode_attention_sharded(q, kp, vp, pt, lens,
                                                                   mesh=mesh))
    np.savez(path, **out)


if __name__ == "__main__":
    args = sys.argv[2:]
    opt = {k: args[args.index(f"--{k}") + 1] for k in ("part", "params", "only")
           if f"--{k}" in args}
    main(sys.argv[1], model_axis="--model-axis" in args, part=opt.get("part"),
         params_path=opt.get("params"),
         only=set(opt["only"].split(",")) if "only" in opt else None)
