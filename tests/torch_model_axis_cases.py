"""The scenarios that the reference's engine (``tests/torch_sharded_ref.py``)
and the port's ranks (``tests/torch_model_axis_rank.py``) both run: numpy
only, so that neither imports the other's framework."""

import numpy as np

ENGINE_KW = dict(max_slots=8, num_pages=63, scan_rounds=2)
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
