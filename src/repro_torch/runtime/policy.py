"""Fleet-level redundancy-aware decision core (torch twin of the streaming
part of ``repro/runtime/policy.py``: ``PolicyConfig``, ``FleetTriggerState``,
``trigger_init``, ``trigger_step``).  The offline ``rollout`` /
``queue_replay`` and ``FleetTelemetry`` come with the fleet slice.

Queue-depletion policy (``PolicyConfig.on_empty``): ``"cloud"`` forces a
cloud dispatch on every depletion (Algorithm 1 line 6); ``"edge"`` lets a
resident edge policy refill; ``"reuse"`` replays the cached chunk, and only
the bootstrap fetch of a never-filled queue is forced cloudward.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import kinematics as kin
from repro_torch.core.trigger import (
    TriggerConfig,
    TriggerOutput,
    TriggerState,
    trigger_init as kin_trigger_init,
    trigger_step as kin_trigger_step,
)

ON_EMPTY_MODES = ("cloud", "edge", "reuse")


@dataclass(frozen=True)
class PolicyConfig:
    trigger: TriggerConfig = field(default_factory=TriggerConfig)
    chunk_len: int = 8  # k — action-chunk horizon
    on_empty: str = "reuse"

    def __post_init__(self):
        if self.on_empty not in ON_EMPTY_MODES:
            raise ValueError(f"on_empty must be one of {ON_EMPTY_MODES}")


class FleetTriggerState(NamedTuple):
    trigger: TriggerState
    head: torch.Tensor    # [...] int32 next chunk index (== k -> empty)
    primed: torch.Tensor  # [...] bool — has ever fetched a chunk


class TriggerDecision(NamedTuple):
    offload: torch.Tensor   # bool — cloud refill this tick (incl. forced)
    replayed: torch.Tensor  # bool — local refill: edge policy or cache replay
    preempt: torch.Tensor   # bool — cloud refill mid-chunk (0 < head < k)
    slot: torch.Tensor      # int32 — chunk index executed this tick
    trig: TriggerOutput


def trigger_init(cfg: PolicyConfig, batch_shape: Tuple[int, ...] = (),
                 device="cuda") -> FleetTriggerState:
    return FleetTriggerState(
        trigger=kin_trigger_init(cfg.trigger, batch_shape, device),
        head=torch.full(batch_shape, cfg.chunk_len, dtype=torch.int32, device=device),
        primed=torch.zeros(batch_shape, dtype=torch.bool, device=device),
    )


def _forced(queue_empty, primed, cfg: PolicyConfig):
    if cfg.on_empty == "cloud":
        return queue_empty
    if cfg.on_empty == "reuse":
        return queue_empty & ~primed
    return torch.zeros_like(queue_empty)


def _queue_transition(head, primed, offload, queue_empty, cfg: PolicyConfig):
    """Algorithm-1 queue semantics given this tick's cloud decision."""

    k = cfg.chunk_len
    offload = offload | _forced(queue_empty, primed, cfg)
    replayed = torch.zeros_like(offload) if cfg.on_empty == "cloud" else queue_empty & ~offload
    preempt = offload & (head > 0) & ~queue_empty
    head = torch.where(offload | replayed, torch.zeros_like(head), head)
    slot = torch.clamp(head, max=k - 1)
    return torch.clamp(head + 1, max=k), primed | offload, offload, replayed, preempt, slot


def trigger_step(state: FleetTriggerState, frame: kin.KinematicFrame, cfg: PolicyConfig):
    """One control tick of the closed-loop decision core (batched)."""

    queue_empty = state.head >= cfg.chunk_len
    forced = _forced(queue_empty, state.primed, cfg)
    trig_state, trig_out = kin_trigger_step(
        state.trigger, frame, cfg.trigger,
        # forced fetches flow through the kinematic step so they reset the
        # cooldown exactly like an organic dispatch (Eq. 8)
        queue_empty=forced if cfg.on_empty != "edge" else None,
    )
    head, primed, offload, replayed, preempt, slot = _queue_transition(
        state.head, state.primed, trig_out.dispatch, queue_empty, cfg
    )
    return (
        FleetTriggerState(trigger=trig_state, head=head, primed=primed),
        TriggerDecision(offload=offload, replayed=replayed, preempt=preempt, slot=slot,
                        trig=trig_out),
    )
