"""RAPID edge dispatcher — Algorithm 1 as a stateful step; torch twin of
``repro/core/dispatcher.py``.

The dispatcher owns the cached action-chunk queue Q and the trigger state.
Each tick the caller supplies the chunk the cloud *would* return now; the
shared decision core (``runtime/policy.py``) decides refill, preemption and
the executed slot, and this module adds the chunk contents and the action.
``run_episode`` steps it over an episode (the reference's ``lax.scan``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from repro_torch.core import kinematics as kin
from repro_torch.core.trigger import TriggerConfig, TriggerOutput, TriggerState, trigger_init
from repro_torch.runtime import policy as rpolicy


@dataclass(frozen=True)
class DispatcherConfig:
    trigger: TriggerConfig = field(default_factory=TriggerConfig)
    chunk_len: int = 8  # k — action-chunk horizon
    action_dim: int = 7


class QueueState(NamedTuple):
    chunk: torch.Tensor  # [..., k, A] cached action chunk
    head: torch.Tensor   # [...] int32 next action index (== k -> empty)


class DispatcherState(NamedTuple):
    trigger: TriggerState
    queue: QueueState


class DispatchOutput(NamedTuple):
    action: torch.Tensor       # [..., A] action executed this tick
    offloaded: torch.Tensor    # bool — cloud query issued
    edge_refill: torch.Tensor  # bool — queue refilled by the edge policy
    trig: TriggerOutput


def queue_init(cfg: DispatcherConfig, batch_shape=(), device="cuda") -> QueueState:
    return QueueState(
        chunk=torch.zeros(batch_shape + (cfg.chunk_len, cfg.action_dim),
                          dtype=torch.float32, device=device),
        head=torch.full(batch_shape, cfg.chunk_len, dtype=torch.int32, device=device),  # empty
    )


def dispatcher_init(cfg: DispatcherConfig, batch_shape=(), device="cuda") -> DispatcherState:
    return DispatcherState(trigger=trigger_init(cfg.trigger, batch_shape, device),
                           queue=queue_init(cfg, batch_shape, device))


def dispatcher_step(state: DispatcherState, frame: kin.KinematicFrame, cloud_chunk,
                    cfg: DispatcherConfig, edge_chunk: Optional[torch.Tensor] = None):
    """One control tick of Algorithm 1.

    ``cloud_chunk`` [..., k, A]: the chunk the cloud VLA would return if
    queried now.  ``edge_chunk``: the small edge policy's chunk; when None a
    depleted queue also queries the cloud (pure offload mode).
    """

    pcfg = rpolicy.PolicyConfig(
        trigger=cfg.trigger, chunk_len=cfg.chunk_len,
        on_empty="cloud" if edge_chunk is None else "edge",
    )
    pstate = rpolicy.FleetTriggerState(
        trigger=state.trigger, head=state.queue.head,
        primed=torch.zeros_like(state.queue.head, dtype=torch.bool),
    )
    pstate, dec = rpolicy.trigger_step(pstate, frame, pcfg)
    offload, edge_refill = dec.offload, dec.replayed

    # line 7: preemption — overwrite Q with the fresh chunk
    refill = offload | edge_refill
    source = cloud_chunk if edge_chunk is None else torch.where(
        offload[..., None, None], cloud_chunk, edge_chunk
    )
    chunk = torch.where(refill[..., None, None], source, state.queue.chunk)
    # line 9: dispatch action a_t <- pop(Q)
    idx = dec.slot.long()[..., None, None].expand(*dec.slot.shape, 1, chunk.shape[-1])
    action = torch.gather(chunk, -2, idx)[..., 0, :]
    new_state = DispatcherState(trigger=pstate.trigger, queue=QueueState(chunk, pstate.head))
    return new_state, DispatchOutput(action=action, offloaded=offload,
                                     edge_refill=edge_refill, trig=dec.trig)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)


def run_episode(cfg: DispatcherConfig, frames: kin.KinematicFrame, cloud_chunks,
                state: Optional[DispatcherState] = None,
                edge_chunks: Optional[torch.Tensor] = None):
    """Algorithm 1 over an episode, one ``dispatcher_step`` a tick on the
    frames' device.

    ``frames`` [T, ..., N] streams; ``cloud_chunks`` (and ``edge_chunks``)
    [T, ..., k, A].  Returns (final state, ``DispatchOutput`` with each
    field stacked over T).  Inputs on another device than the frames raise.
    """

    device = frames.q.device
    given = [("frames", t) for t in frames] + [("cloud_chunks", cloud_chunks)]
    if edge_chunks is not None:
        given.append(("edge_chunks", edge_chunks))
    if state is not None:
        given += [("state", t) for t in _leaves(state)]
    for name, t in given:
        if t.device != device:
            raise ValueError(f"run_episode: {name} is on {t.device}, the frames on {device}")
    if state is None:
        state = dispatcher_init(cfg, tuple(frames.q.shape[1:-1]), device=device)

    outs = []
    for t in range(frames.q.shape[0]):
        state, out = dispatcher_step(
            state, kin.KinematicFrame(*(f[t] for f in frames)), cloud_chunks[t], cfg,
            edge_chunk=None if edge_chunks is None else edge_chunks[t])
        outs.append(out)
    trig = TriggerOutput(*(torch.stack(f) for f in zip(*(o.trig for o in outs))))
    return state, DispatchOutput(
        *(torch.stack([getattr(o, n) for o in outs]) for n in DispatchOutput._fields[:-1]),
        trig=trig,
    )
