"""The scenarios that the reference's engine (``tests/torch_sharded_ref.py``)
and the port's ranks (``tests/torch_model_axis_rank.py``) both run: numpy
only, so that neither imports the other's framework."""

import numpy as np

ENGINE_KW = dict(max_slots=8, num_pages=63, scan_rounds=2)
# the data-shard scenarios of ``tests/test_sharded.py`` on f32 openvla-smoke:
# (name, robots, seed, data shards (0: no mesh), prefill on the last
# device, split-lane cut (robots with an odd id go there; None: cloud only))
SCENARIOS = (
    ("cloud8", 6, 0, 8, False, None),
    ("mixed8", 6, 21, 8, False, 1),
    ("disagg", 6, 5, 0, True, None),
    ("combo7", 6, 9, 7, True, None),
    ("mixed7p", 6, 21, 7, True, 1),
)
# every smoke stack at 2 layers (jamba-smoke's first two: mamba + MLP,
# attn + MoE; the others have 2)
SMOKE_LAYERS = 2
# (name, arch, data, model, robots, seed, moe_impl): the engine over a
# model axis
TP_SCENARIOS = (
    ("tp42", "openvla-7b", 4, 2, 6, 0, "dense"),
    ("sc24", "starcoder2-3b", 2, 4, 6, 1, "dense"),
    ("gm42", "gemma2-9b", 4, 2, 6, 2, "dense"),
    ("jb42", "jamba-1.5-large-398b", 4, 2, 6, 4, "dense"),
    ("qm24", "qwen3-moe-235b-a22b", 2, 4, 6, 5, "dense"),
    ("pc42", "phi3.5-moe-42b-a6.6b", 4, 2, 6, 6, "capacity"),
)
# (name, arch, pod, data, model, robots, seed, moe_impl): the engine over a
# (pod, data, model) mesh
POD_SCENARIOS = (
    ("pod_tp", "openvla-7b", 2, 2, 2, 6, 0, "dense"),
    ("pod_qm", "qwen3-moe-235b-a22b", 2, 2, 2, 6, 5, "dense"),
)
# serve_fleet(trigger="rapid") on openvla-smoke over (data, model)
TP_FLEET = dict(data=4, model=2, kw=dict(n_robots=8, max_steps=300, seed=3, scan_rounds=2,
                                         max_slots=8, num_pages=63, trigger="rapid",
                                         verbose=False))
FLEET_KEYS = ("actions", "offloads", "service_rounds", "cancelled", "trigger",
              "decode_rounds", "scan_windows", "peak_batch")


def obs_pair(rng):
    qd = rng.normal(0, 0.5, (1, 7)).astype(np.float32)
    tau = rng.normal(0, 0.5, (1, 7)).astype(np.float32)
    return qd, tau


def fleet_record(out, name, res):
    """``serve_fleet``'s run into ``out``: ``FLEET_KEYS`` as arrays (the
    trigger's name as its characters' codes)."""

    for k in FLEET_KEYS:
        v = res[k]
        out[f"{name}/{k}"] = (np.frombuffer(v.encode(), np.uint8) if isinstance(v, str)
                              else np.asarray(v))


# the xLSTM and enc-dec stacks over a model axis: each stack's weights go
# under ``params/<stack>/``, a stack being an arch and its config
# overrides (f32 smoke, ``SMOKE_LAYERS``); "xlstm-wide" is xlstm-smoke at
# widths that divide over 4 ranks (d_in 384, 4 mLSTM heads, d_up 256;
# xlstm-smoke's d_up 170 and 2 heads do not)
AXIS_STACKS = {
    "xlstm-125m": ("xlstm-125m", {}),
    "xlstm-wide": ("xlstm-125m", dict(d_model=192, num_heads=4, num_kv_heads=4)),
    "seamless-m4t-medium": ("seamless-m4t-medium", {}),
}
# (name, stack, data, model, robots, seed): the engine on an xLSTM stack
XLSTM_SCENARIOS = (
    ("xl42", "xlstm-125m", 4, 2, 6, 7),
    ("xw24", "xlstm-wide", 2, 4, 6, 8),
)
# (name, data, model): seamless-smoke's prefill + decode_chunk over a mesh,
# in each of ``ENCDEC_MODES`` (cross K/V cached, paged cache)
ENCDEC_MESHES = (("ed42", 4, 2), ("ed24", 2, 4))
ENCDEC_MODES = tuple((cached, paged) for cached in (False, True) for paged in (False, True))
# its batch: rows, prompt tokens, encoder frames, decode steps; page size
ENCDEC_PLAN = dict(b=4, prompt=14, frames=24, steps=12, page=16, seed=13)


def encdec_mode(cached, paged):
    return f"{'cached' if cached else 'uncached'}_{'paged' if paged else 'dense'}"


def encdec_batch(vocab, d_model):
    """The seamless batch (numpy, seeded): prompt tokens and stub frames."""

    p = ENCDEC_PLAN
    rng = np.random.default_rng(p["seed"])
    return {"tokens": rng.integers(0, vocab, (p["b"], p["prompt"])),
            "frontend": rng.normal(0, 1, (p["b"], p["frames"], d_model)).astype(np.float32)}


def encdec_pages():
    """(pages a row, the page table [b, pages] (reversed ids), each row's
    capacity) of the paged mode."""

    p = ENCDEC_PLAN
    maxp = -(-(p["prompt"] + p["steps"]) // p["page"])
    pt = np.arange(p["b"] * maxp, dtype=np.int32).reshape(p["b"], maxp)[::-1].copy()
    return maxp, pt, np.full((p["b"],), maxp * p["page"], np.int32)


# the split lanes over a model axis: (name, arch, data, model, lane keys,
# pipelined, robots, seed); the odd robots split, lane by lane in turn
# (``split_key``), on f32 smoke stacks at ``SMOKE_LAYERS``, ``ENGINE_KW``;
# a lane key is a cut or (cut, expert_offload); xlstm-smoke's d_up of 170
# does not divide over 4 ranks, so sl42 stays at (4, 2)
SPLIT_SCENARIOS = (
    ("sp42", "openvla-7b", 4, 2, (1,), True, 6, 30),
    ("sp24", "openvla-7b", 2, 4, (1,), True, 6, 31),
    ("ss42", "openvla-7b", 4, 2, (1,), False, 6, 32),
    ("sh24", "openvla-7b", 2, 4, (0, 1), True, 6, 33),
    ("sx24", "qwen3-moe-235b-a22b", 2, 4, ((1, (0,)),), True, 6, 34),
    ("sj42", "jamba-1.5-large-398b", 4, 2, (1,), True, 6, 35),
    ("sl42", "xlstm-125m", 4, 2, (1,), True, 6, 36),
)
# the rapid fleet with split robots over (data, model): ``TP_FLEET``'s
# settings, these robots at this cut
SPLIT_FLEET = dict(split_robots=[1, 3, 5, 7], cut=1)
# the same over (data, model) with the prefill on the next device
SPLIT_FLEET_P = dict(data=2, model=2)
# the executor cases of one rank against the reference executor on one
# device: (arch, cut, worlds); each runs two robots' prompts through
# ``split_prefill`` and two ``split_decode_step`` tokens, and the same
# robots through the suffix path (``edge_prefill``, ``suffix_prefill``,
# ``edge_step``, ``suffix_step``) over a rank's pools and lane state
# (xlstm-smoke's widths do not divide over 4 ranks)
EXEC_CASES = (("openvla-7b", 1, (2, 4)), ("jamba-1.5-large-398b", 0, (2, 4)),
              ("xlstm-125m", 0, (2,)))
EXEC_PLAN = dict(b=2, prompt=14, steps=2, page=8, maxp=4, seed=40)
# one ``PartitionedPolicy`` chunk: (arch, cut, seed of its observation)
POLICY_CASE = ("openvla-7b", 1, 41)


def split_key(robot, lanes):
    """The lane key of ``robot`` (None: cloud-only, an even robot)."""

    return None if robot % 2 == 0 else lanes[(robot // 2) % len(lanes)]


def lane_cut(key):
    """(cut, expert_offload) of a lane key."""

    return (key, ()) if isinstance(key, int) else (key[0], tuple(key[1]))


def exec_inputs(vocab):
    """The executor cases' numpy inputs (seeded): prompts [b, prompt] and the
    decode tokens [steps, b, 1]."""

    p = EXEC_PLAN
    rng = np.random.default_rng(p["seed"])
    return (rng.integers(0, vocab, (p["b"], p["prompt"])),
            rng.integers(0, vocab, (p["steps"], p["b"], 1)))
