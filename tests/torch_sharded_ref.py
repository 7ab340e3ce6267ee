"""The JAX package's sharded engine on 8 forced host devices, recorded for
``tests/test_torch_sharded.py``.

Run in a process of its own (the device count is fixed when jax starts):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/torch_sharded_ref.py OUT.npz [--model-axis]

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
``tests/test_torch_model_axis.py`` (``TP_SCENARIOS``): the engine on
f32 openvla-smoke over (data 4, model 2), starcoder2-smoke over (2, 4)
and gemma2-smoke over (4, 2), and ``serve_fleet(trigger="rapid")`` on
openvla-smoke over (4, 2) (``TP_FLEET``), each stack's parameters under
``params/<arch>/``.
"""

import sys

import jax
import numpy as np

from repro.checkpoint.npz import _flatten
from repro.configs import get_smoke_config
from repro.data.pipeline import EpisodeTokenizer
from repro.kernels.paged_attention import paged_decode_attention_sharded
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import serve_fleet
from repro.models.model import Model
from repro.partition.executor import PartitionExecutor
from repro.runtime import scheduler as sched_mod
from torch_model_axis_cases import ENGINE_KW, TP_FLEET, TP_SCENARIOS, fleet_record, obs_pair

# (name, robots, seed, data shards (0: no mesh), prefill on the last device,
# split-lane cut (robots with an odd id go there; None: cloud only))
SCENARIOS = (
    ("cloud8", 6, 0, 8, False, None),
    ("mixed8", 6, 21, 8, False, 1),
    ("disagg", 6, 5, 0, True, None),
    ("combo7", 6, 9, 7, True, None),
)
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


def f32_stack(arch):
    """The reference's f32 smoke stack ``arch`` -> (model, params, tokenizer)."""

    cfg = get_smoke_config(arch).replace(dtype="float32", param_dtype="float32")
    model = Model(cfg)
    return model, model.init(jax.random.PRNGKey(0)), EpisodeTokenizer(cfg.vocab_size)


def main_model_axis(path, devs, recording):
    out = {}
    stacks = {}
    for name, arch, data, model_axis, n, seed in TP_SCENARIOS:
        if arch not in stacks:
            stacks[arch] = f32_stack(arch)
            out.update({f"params/{arch}/{k}": np.asarray(v)
                        for k, v in _flatten(stacks[arch][1]).items()})
        model, params, tok = stacks[arch]
        mesh = make_test_mesh(data=data, model=model_axis, devices=devs[:data * model_axis])
        sched = recording(model, params, tok, mesh=mesh, **ENGINE_KW)
        rng = np.random.default_rng(seed)
        for r in range(n):
            sched.submit(r, *obs_pair(rng))
        record(out, name, sched, sched.drain())
    model, params, tok = stacks["openvla-7b"]
    f = TP_FLEET
    mesh = make_test_mesh(data=f["data"], model=f["model"], devices=devs[:f["data"] * f["model"]])
    fleet_record(out, "fleet42", serve_fleet(model, params, tok, mesh=mesh, **f["kw"]))
    np.savez(path, **out)


def main(path, model_axis=False):
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
        self.sched.reserved.append([req.robot_id, seq.row, *seq.pages])
        return seq

    sched_mod._SplitLane.reserve = recording_lane_reserve
    if model_axis:
        return main_model_axis(path, devs, Recording)

    cfg = get_smoke_config("openvla-7b").replace(dtype="float32", param_dtype="float32")
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tok = EpisodeTokenizer(cfg.vocab_size)
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
    main(sys.argv[1], model_axis="--model-axis" in sys.argv[2:])
