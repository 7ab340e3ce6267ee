"""The mesh's ``model`` axis as ``torch.distributed`` ranks (the torch
counterpart of the reference's multi-device runtime, where GSPMD places
the reductions of a tensor-parallel layer).

One process per model shard.  ``init_model_group`` joins the process group
of the ``model`` axis; the backend is the caller's choice, ``"nccl"`` (one
rank a card) or ``"gloo"`` (CPU ranks, or ranks that share one card, which
NCCL refuses).  ``all_reduce_sum`` and ``all_gather_cat`` are the two
collectives a tensor-parallel layer needs: every one is a
``torch.distributed`` call, and a group of one rank (or none) makes both
the identity.

Gloo on CUDA tensors: ``all_reduce_sum`` and ``all_gather_cat`` stage the
tensor through pinned host memory when the backend is gloo and the tensor
lies on a card, here and nowhere else.  Staging syncs the host with the
card, so a gloo group's rounds run eagerly (``ModelGroup.graphs``): only an
NCCL group's collectives can be captured in a CUDA graph.

``CALLS`` counts the collectives by name, one for each call that reaches
``torch.distributed`` (``runtime.graphs.GraphedCall`` keeps it right across
graph replays, as it keeps the kernel launches).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

BACKENDS = ("nccl", "gloo")
# collectives issued, by name (the counterpart of ``kernels._lib.LAUNCHES``)
CALLS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}


@dataclass(frozen=True, eq=False)
class ModelGroup:
    """The ranks of the ``model`` axis, as one rank sees them: its own
    ``rank`` of ``size``, the ``backend``, its ``device`` and every rank's
    device (``devices[m]``), and the ``torch.distributed`` process group
    (``pg``; None for a group of one)."""

    rank: int
    size: int
    backend: str
    device: torch.device
    devices: Tuple[torch.device, ...]
    pg: object = None

    @property
    def graphs(self) -> bool:
        """Whether a CUDA graph may capture this group's collectives (NCCL
        only: gloo stages through the host)."""

        return self.backend == "nccl"


def init_model_group(rank: int, world: int, *, backend: str, init_method: Optional[str] = None,
                     device="cuda") -> ModelGroup:
    """Join the ``model`` axis as ``rank`` of ``world`` ranks on
    ``device``: ``torch.distributed.init_process_group(backend,
    init_method, rank, world)`` (``init_method``: a ``file://`` store or
    ``tcp://localhost:<port>``), then every rank's device gathered.  A
    world of 1 makes no process group.  An NCCL rank needs a card of its
    own (``device="cuda:<i>"``, made current here); gloo ranks on one host
    want ``GLOO_SOCKET_IFNAME=lo`` in their environment."""

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL rank needs a CUDA device, not {device}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")
    if world == 1:
        return ModelGroup(0, 1, backend, device, (device,))
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    names = [None] * world
    dist.all_gather_object(names, str(device))
    return ModelGroup(rank, world, backend, device, tuple(torch.device(n) for n in names),
                      dist.group.WORLD)


def destroy_model_group(group: Optional[ModelGroup]) -> None:
    """Leave the process group (nothing for a group of one)."""

    if group is not None and group.pg is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


def _staged(x: torch.Tensor, group: ModelGroup) -> bool:
    return group.backend == "gloo" and x.device.type == "cuda"


def _pinned(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def all_reduce_sum(x: torch.Tensor, group: Optional[ModelGroup]) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, in ``x``'s dtype, on every
    rank -> a tensor on ``x``'s device (``x`` itself, reduced in place,
    unless gloo staged it through the host)."""

    if group is None or group.size == 1:
        return x
    import torch.distributed as dist

    CALLS["all_reduce"] += 1
    if _staged(x, group):
        h = _pinned(x)
        dist.all_reduce(h, group=group.pg)
        return h.to(x.device)
    x = x.contiguous()
    dist.all_reduce(x, group=group.pg)
    return x


def all_gather_cat(x: torch.Tensor, dim: int, group: Optional[ModelGroup]) -> torch.Tensor:
    """Every rank's ``x``, concatenated along ``dim`` in rank order, on
    every rank."""

    if group is None or group.size == 1:
        return x
    import torch.distributed as dist

    CALLS["all_gather"] += 1
    src = _pinned(x) if _staged(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    return torch.cat(parts, dim).to(x.device)


def reset_calls() -> None:
    for name in CALLS:
        CALLS[name] = 0
