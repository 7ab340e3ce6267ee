"""Baseline partitioning strategies the paper compares against (§VI-A.3);
torch twin of ``repro/core/baselines.py``.

  * Edge-Only — the full VLA runs on the edge device; never offloads.
  * Cloud-Only — every chunk is fetched from the cloud.
  * Vision-based dynamic partitioning (SAFE/ISAR style) — offload when the
    Shannon entropy H of the VLA action distribution exceeds a threshold.
    This is the environment-oriented strategy whose noise fragility
    motivates RAPID (paper §III-A, Table I).
  * Static split — offload every ``period`` steps regardless of state
    (traditional fixed partitioning).

All share the dispatcher's queue semantics so the engine can run any policy
through one code path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.core.dispatcher import DispatcherConfig, QueueState, queue_init


@dataclass(frozen=True)
class EntropyTriggerConfig:
    threshold: float = 2.2      # nats; offload when H exceeds
    cooldown_steps: int = 15
    chunk_len: int = 8
    action_dim: int = 7


class EntropyState(NamedTuple):
    queue: QueueState
    cooldown: torch.Tensor


def action_entropy(action_logits: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of the action-token distribution. [..., V] -> [...]."""

    logp = torch.log_softmax(action_logits.float(), dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def entropy_init(cfg: EntropyTriggerConfig, batch_shape=(), device="cuda") -> EntropyState:
    dcfg = DispatcherConfig(chunk_len=cfg.chunk_len, action_dim=cfg.action_dim)
    return EntropyState(queue=queue_init(dcfg, batch_shape, device),
                        cooldown=torch.zeros(batch_shape, dtype=torch.int32, device=device))


def entropy_step(state: EntropyState, entropy: torch.Tensor, cloud_chunk: torch.Tensor,
                 cfg: EntropyTriggerConfig):
    """One tick: ``entropy`` [...] is H of the edge model's action head,
    ``cloud_chunk`` [..., k, A] the chunk the cloud would return now."""

    k = cfg.chunk_len
    queue_empty = state.queue.head >= k
    trig = entropy > cfg.threshold
    dispatch = (trig & (state.cooldown == 0)) | queue_empty
    cooldown = torch.where(dispatch, torch.full_like(state.cooldown, cfg.cooldown_steps),
                           torch.clamp(state.cooldown - 1, min=0))
    chunk = torch.where(dispatch[..., None, None], cloud_chunk, state.queue.chunk)
    head = torch.where(dispatch, torch.zeros_like(state.queue.head), state.queue.head)
    idx = torch.clamp(head, max=k - 1).long()[..., None, None]
    action = torch.gather(chunk, -2, idx.expand(*idx.shape[:-1], chunk.shape[-1]))[..., 0, :]
    head = torch.clamp(head + 1, max=k)
    return EntropyState(QueueState(chunk, head), cooldown), (action, dispatch)


def run_entropy_episode(cfg: EntropyTriggerConfig, entropies, cloud_chunks, state=None):
    """The vision-based baseline over [T, ...] entropy + chunk streams, one
    ``entropy_step`` a tick -> (final state, (actions, dispatch) stacked
    over T)."""

    if state is None:
        state = entropy_init(cfg, tuple(entropies.shape[1:]), entropies.device)
    acts, disp = [], []
    for t in range(entropies.shape[0]):
        state, (a, d) = entropy_step(state, entropies[t], cloud_chunks[t], cfg)
        acts.append(a)
        disp.append(d)
    return state, (torch.stack(acts), torch.stack(disp))


def static_offload_mask(n_steps: int, period: int, device="cuda") -> torch.Tensor:
    """Static split: offload every ``period`` control ticks."""

    return torch.arange(n_steps, device=device) % period == 0


def cloud_only_mask(n_steps: int, chunk_len: int, device="cuda") -> torch.Tensor:
    """Cloud-Only: a query at every chunk boundary."""

    return static_offload_mask(n_steps, chunk_len, device)


def edge_only_mask(n_steps: int, device="cuda") -> torch.Tensor:
    """Edge-Only: no cloud queries at all (full model on edge)."""

    return torch.zeros((n_steps,), dtype=torch.bool, device=device)
