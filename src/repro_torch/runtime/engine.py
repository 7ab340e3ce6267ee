"""Edge-cloud co-inference engine: strategy simulation + accounting; torch
twin of ``repro/runtime/engine.py``.

Couples (a) trigger policies — RAPID's kinematic dual-threshold, the
vision-based entropy baseline, static/edge-only/cloud-only — with (b) the
action-chunk queue semantics of Algorithm 1 and (c) the calibrated latency
model, over the synthetic episode suite.

The RAPID trigger stream comes from the real decision core
(``runtime.policy.rollout`` — the same ``trigger_step`` the live
``serve_fleet`` loop steps per control tick, on ``device``), and every
strategy's queue semantics (refill / preempt / executed slot) replay
through the same ``runtime.policy`` queue transition — this module is a
thin accounting adapter over the decision core, so the simulator and the
serving runtime cannot drift.

Accuracy model: executed action error vs the reference trajectory.
  * cloud chunks are exact at fill time and accumulate *staleness* error
    only while the robot is in a critical (contact) phase — the step-wise
    redundancy asymmetry the paper exploits;
  * edge-policy chunks carry the small model's noise (worse in contact);
  * mid-chunk preemptions add a continuity (jerk) penalty.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.baselines import EntropyTriggerConfig
from repro_torch.core.kinematics import KinematicFrame
from repro_torch.core.trigger import TriggerConfig
from repro_torch.robotics.episodes import (
    Episode,
    edge_policy_chunks,
    generate_episode,
    reference_chunks,
)
from repro_torch.robotics.noise import entropy_stream
from repro_torch.runtime.latency import PROFILES, HardwareModel, SimCounters, evaluate
from repro_torch.runtime.policy import PolicyConfig, QueueTrace, queue_replay, rollout

STRATEGIES = (
    "rapid", "vision", "edge_only", "cloud_only", "rapid_no_comp", "rapid_no_red",
)


@dataclass(frozen=True)
class EngineConfig:
    chunk_len: int = 8
    staleness_alpha: float = 0.04   # error growth per stale step in contact
    preempt_jerk: float = 0.5       # continuity penalty per mid-chunk preempt
    success_tol: float = 0.30       # per-step error budget
    trigger: TriggerConfig = TriggerConfig()
    entropy: EntropyTriggerConfig = EntropyTriggerConfig()


@dataclass(frozen=True)
class EpisodeResult:
    counters: SimCounters
    accuracy: float            # fraction of critical steps within tolerance
    mean_error: float
    offload_steps: np.ndarray  # bool [T]


# ---------------------------------------------------------------------------
# trigger streams
# ---------------------------------------------------------------------------


def rapid_trigger_stream(ep: Episode, cfg: TriggerConfig, on_empty: str = "edge",
                         chunk_len: int = 8, device="cuda") -> np.ndarray:
    """Dispatch booleans from the real decision core, stepped on ``device``.

    ``on_empty="edge"`` (the engine's simulation mode: an edge policy
    absorbs routine depletions) leaves the trigger blind to queue state, so
    the stream equals the pure kinematic monitor; ``"cloud"`` closes the
    queue-depletion feedback loop (forced refills reset the cooldown),
    matching ``serve_fleet(trigger="always")`` exactly.
    """

    frames = KinematicFrame(*(torch.as_tensor(a[:, None], device=device)
                              for a in (ep.q, ep.qd, ep.tau)))
    pcfg = PolicyConfig(trigger=cfg, chunk_len=chunk_len, on_empty=on_empty)
    _, dec = rollout(pcfg, frames)
    return dec.offload[:, 0].cpu().numpy()


def _cooldown_mask(trig: np.ndarray, cooldown: int) -> np.ndarray:
    """Cooldown masking: a trigger fires only when the countdown is zero;
    firing re-arms the countdown, every other step decays it."""

    out = np.zeros(len(trig), bool)
    c = 0
    for t, hit in enumerate(np.asarray(trig, bool)):
        fire = bool(hit) and c == 0
        out[t] = fire
        c = cooldown if fire else max(c - 1, 0)
    return out


def entropy_trigger_stream(ep: Episode, regime: str, cfg: EntropyTriggerConfig,
                           seed: int) -> np.ndarray:
    h = entropy_stream(ep, regime, seed)
    # apply the same cooldown masking discipline
    return _cooldown_mask(h > cfg.threshold, cfg.cooldown_steps)


# ---------------------------------------------------------------------------
# unified queue/accounting simulation
# ---------------------------------------------------------------------------


def simulate_queue(
    ep: Episode,
    dispatch: np.ndarray,            # [T] cloud-offload decisions
    cfg: EngineConfig,
    edge_refill_allowed: bool,       # False => queue depletion queries cloud
    edge_chunks: Optional[np.ndarray],
    edge_exact: bool = False,        # edge_only: full model resident
) -> EpisodeResult:
    """Replay ``dispatch`` through the shared queue core, then score it."""

    trace = queue_replay(
        np.asarray(dispatch, bool), cfg.chunk_len,
        on_empty="edge" if edge_refill_allowed else "cloud",
    )
    return score_trace(
        ep, trace, cfg,
        local_src="edge", edge_chunks=edge_chunks, edge_exact=edge_exact,
    )


def score_trace(
    ep: Episode,
    trace: QueueTrace,
    cfg: EngineConfig,
    local_src: str = "edge",         # what a local refill means: "edge" policy
    edge_chunks: Optional[np.ndarray] = None,  # chunk or cached-chunk "reuse"
    edge_exact: bool = False,        # edge_only: full model resident
) -> EpisodeResult:
    """Error/latency accounting over a decision trace.

    The trace (cloud refills, local refills, preemptions, executed slots)
    comes from the decision core — either replayed from a precomputed
    stream (``policy.queue_replay``) or recorded live from a closed-loop
    fleet (``FleetTelemetry.streams``) — so offline scores and serving
    telemetry describe the *same* decisions.

    ``local_src="reuse"`` scores redundancy-aware cache replay — the
    paper's step-wise redundancy asymmetry:

      * a replay during a REDUNDANT step re-anchors the plan (``fill_time``
        advances): in a highly-predictable phase a fresh cloud query would
        return ≈ the cached chunk, so replaying it loses nothing;
      * a replay during a CRITICAL step does NOT re-anchor: the stale
        pre-contact plan keeps executing and both the action mismatch and
        the staleness penalty keep growing until a trigger fire refreshes
        it — which is exactly what a good trigger prevents.
    """

    t_len = ep.critical.shape[0]
    ref = ep.ref_actions
    cloud = reference_chunks(ep, cfg.chunk_len)

    fill_time = -1
    fill_src = "none"
    err = np.zeros(t_len, np.float32)
    n_off = n_edge = n_intr = 0
    offload_steps = np.asarray(trace.refill_cloud, bool).copy()
    preempt_steps = np.asarray(trace.preempt, bool).copy()
    # purposive-preemption windows (identical to the spurious accounting
    # below): imminent contact within the deceleration blend, phase
    # boundaries, and final deceleration to rest
    look_p = 40
    crit_soon_p = np.convolve(
        ep.critical.astype(np.float32), np.ones(look_p), mode="full"
    )[look_p - 1 : look_p - 1 + t_len] > 0
    bound_p = np.zeros(t_len, bool)
    for c0 in (np.flatnonzero(np.diff(ep.phase_id) != 0) + 1):
        bound_p[max(c0 - look_p, 0) : c0 + look_p] = True
    bound_p[-look_p:] = True
    purposive = crit_soon_p | bound_p

    for t in range(t_len):
        if trace.refill_cloud[t]:
            if trace.preempt[t]:
                n_intr += 1
                err[t] += cfg.preempt_jerk
                if not purposive[t]:
                    # spurious mid-motion interruption: the manipulator takes
                    # a few ticks to recover continuity (paper §III-A: noise
                    # triggers "disrupt the physical continuity of motion")
                    hi = min(t + 4, t_len)
                    err[t:hi] += cfg.preempt_jerk * 0.8
            fill_time, fill_src = t, "cloud"
            n_off += 1
        elif trace.refill_local[t]:
            if local_src == "edge":
                # only genuine edge-model inferences are counted (and later
                # priced); a cache replay is a free queue-pointer reset
                n_edge += 1
                fill_time, fill_src = t, "edge"
            elif fill_src == "cloud" and not ep.critical[t]:
                # "reuse" in a redundant step: the cached plan stays
                # execution-valid, re-anchor it (see docstring)
                fill_time = t
            # "reuse" in a critical step: stale plan keeps executing

        idx = int(trace.slot[t])
        if fill_src == "cloud":
            a = cloud[fill_time, idx]
            # staleness only hurts during contact-rich (critical) phases
            err[t] += cfg.staleness_alpha * (t - fill_time) * float(ep.critical[t])
        elif fill_src == "edge":
            if edge_exact:
                a = cloud[fill_time, idx]
            else:
                a = edge_chunks[fill_time, idx]
                err[t] += cfg.staleness_alpha * (t - fill_time) * float(ep.critical[t])
        else:  # nothing cached yet
            a = np.zeros_like(ref[t])
        err[t] += float(np.linalg.norm(a - ref[t]) / max(np.linalg.norm(ref[t]), 0.2))

    crit = ep.critical
    # execution accuracy: fraction of steps tracked within tolerance
    # (redundant steps are easy; critical steps dominate the differences)
    accuracy = float((err < cfg.success_tol).mean())
    # spurious offloads: *mid-chunk preemptions* issued in a redundant phase.
    # Useful trigger zones: imminent contact (lookahead) and phase boundaries
    # (task switches / replanning — exactly what θ_comp is designed to catch).
    # lookahead covers the pre-contact deceleration blend: slowing down on
    # approach to the object is a legitimate reason to refresh the chunk
    look = 40
    crit_soon = np.convolve(crit.astype(np.float32), np.ones(look), mode="full")[
        look - 1 : look - 1 + t_len
    ] > 0
    boundary = np.zeros(t_len, bool)
    change = np.flatnonzero(np.diff(ep.phase_id) != 0) + 1
    for c0 in change:
        boundary[max(c0 - look, 0) : c0 + look] = True
    boundary[-look:] = True  # final deceleration to rest (task completion)
    legit = crit_soon | boundary
    n_spur = int((offload_steps & preempt_steps & ~legit).sum())
    counters = SimCounters(
        n_steps=t_len,
        n_chunks=max(t_len // cfg.chunk_len, 1),
        n_offloads=n_off,
        n_edge_infer=n_edge,
        n_interruptions=n_intr,
        n_spurious=n_spur,
    )
    return EpisodeResult(
        counters=counters,
        accuracy=accuracy,
        mean_error=float(err.mean()),
        offload_steps=offload_steps,
    )


# ---------------------------------------------------------------------------
# strategy runner
# ---------------------------------------------------------------------------


def run_strategy(
    strategy: str,
    ep: Episode,
    regime: str = "standard",
    cfg: EngineConfig = EngineConfig(),
    seed: int = 0,
    device="cuda",
) -> EpisodeResult:
    t_len = ep.critical.shape[0]
    edge_chunks = edge_policy_chunks(ep, cfg.chunk_len, seed)

    if strategy == "edge_only":
        dispatch = np.zeros(t_len, bool)
        return simulate_queue(ep, dispatch, cfg, True, edge_chunks, edge_exact=True)
    if strategy == "cloud_only":
        dispatch = np.zeros(t_len, bool)
        return simulate_queue(ep, dispatch, cfg, False, None)
    if strategy == "vision":
        dispatch = entropy_trigger_stream(ep, regime, cfg.entropy, seed)
        return simulate_queue(ep, dispatch, cfg, True, edge_chunks)
    if strategy in ("rapid", "rapid_no_comp", "rapid_no_red"):
        tcfg = cfg.trigger
        if strategy == "rapid_no_comp":
            tcfg = type(tcfg)(**{**tcfg.__dict__, "theta_comp": 1e9})
        if strategy == "rapid_no_red":
            tcfg = type(tcfg)(**{**tcfg.__dict__, "theta_red": 1e9})
        dispatch = rapid_trigger_stream(ep, tcfg, device=device)
        return simulate_queue(ep, dispatch, cfg, True, edge_chunks)
    raise ValueError(strategy)


def episode_suite(seeds=(0, 1, 2), tasks=("pick_place", "drawer_open", "peg_insertion")):
    return [generate_episode(t, seed=s) for t in tasks for s in seeds]


def evaluate_strategy(
    strategy: str,
    regime: str = "standard",
    cfg: EngineConfig = EngineConfig(),
    hw: Optional[HardwareModel] = None,
    seeds=(0, 1, 2),
    device="cuda",
) -> Dict:
    """Aggregate a strategy over the task suite -> paper-table row; the RAPID
    strategies step their decision core on ``device``."""

    hw = hw or HardwareModel.calibrated(chunk_len=cfg.chunk_len)
    prof = PROFILES[strategy if strategy != "vision" else "vision"]
    results = []
    for i, ep in enumerate(episode_suite(seeds=seeds)):
        results.append(run_strategy(strategy, ep, regime, cfg, seed=seeds[i % len(seeds)],
                                    device=device))

    # pooled counters
    tot = SimCounters(
        n_steps=sum(r.counters.n_steps for r in results),
        n_chunks=sum(r.counters.n_chunks for r in results),
        n_offloads=sum(r.counters.n_offloads for r in results),
        n_edge_infer=sum(r.counters.n_edge_infer for r in results),
        n_interruptions=sum(r.counters.n_interruptions for r in results),
        n_spurious=sum(r.counters.n_spurious for r in results),
    )
    rep = evaluate(hw, prof, tot)
    per_ep_tot = [
        evaluate(hw, prof, r.counters).total_ms for r in results
    ]
    return {
        "strategy": strategy,
        "regime": regime,
        "report": rep,
        "total_ms": rep.total_ms,
        "total_ms_std": float(np.std(per_ep_tot)),
        "accuracy": float(np.mean([r.accuracy for r in results])),
        "mean_error": float(np.mean([r.mean_error for r in results])),
        "offload_fraction": rep.offload_fraction,
        "interruptions_per_chunk": rep.interruptions_per_chunk,
    }
