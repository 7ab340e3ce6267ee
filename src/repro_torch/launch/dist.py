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
``torch.distributed``, and ``BYTES`` their result bytes (an all-reduce's
tensor, an all-gather's concatenation; ``runtime.graphs.GraphedCall`` keeps
both right across graph replays, as it keeps the kernel launches).

``collectives`` and ``collective_bytes`` give what a rank issues for one
decode token or one prefill from the layer kinds alone: the count that
``CALLS`` and ``BYTES`` must show, and the dry run's collective term.  They
hold where the rank model cuts every vocab, MLP and expert block, as it
does for every stack of ``configs`` over 2, 4 and 16 ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import torch

BACKENDS = ("nccl", "gloo")
# collectives issued, by name (the counterpart of ``kernels._lib.LAUNCHES``)
CALLS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}
# their result bytes, by name
BYTES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}


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
    BYTES["all_reduce"] += x.numel() * x.element_size()
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
    BYTES["all_gather"] += x.numel() * x.element_size() * group.size
    src = _pinned(x) if _staged(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    return torch.cat(parts, dim).to(x.device)


def reset_calls() -> None:
    for name in CALLS:
        CALLS[name] = BYTES[name] = 0


# ---------------------------------------------------------------------------
# the collectives a rank issues, from the layer kinds
# ---------------------------------------------------------------------------


def layer_collectives(cfg, layers: Iterable[int], prompt: int = 1) -> Dict[str, int]:
    """The collectives of the decoder layers ``layers`` of a rank of
    ``cfg`` over one decode token (``prompt`` = 1) or a prompt of
    ``prompt`` tokens: a Mamba layer 2 all-reduces (``dt`` / B / C, then
    ``out_proj``), an attention layer 1 (``wo``; an enc-dec layer 1 more,
    its cross-attention's), an mLSTM layer 1 and 1 all-gather (its output;
    its xi), an sLSTM layer 1 and 1 all-gather a token (its output; its
    h), an FFN (MLP or MoE) 1."""

    reduce = gather = 0
    for i in layers:
        kind = cfg.blocks[i]
        reduce += 1 + (kind == "mamba") + (cfg.d_ff > 0)
        reduce += kind == "attn" and cfg.encoder_decoder
        gather += (kind == "mlstm") + prompt * (kind == "slstm")
    return {"all_reduce": int(reduce), "all_gather": int(gather)}


def collectives(cfg, prompt: int = 1) -> Dict[str, int]:
    """The collectives of one decode token (``prompt`` = 1) or a prefill of
    ``prompt`` tokens on a rank of ``cfg``: the embedding's all-reduce,
    every layer's (``layer_collectives``), an enc-dec prefill's encoder (2
    all-reduces a layer: its attention and its MLP), the logits' one
    all-gather.  26 a token at xlstm-125m (13 + 13), 38 at
    seamless-m4t-medium (37 + 1)."""

    out = layer_collectives(cfg, range(cfg.num_layers), prompt)
    out["all_reduce"] += 1
    if cfg.encoder_decoder and prompt > 1:
        out["all_reduce"] += 2 * cfg.num_encoder_layers
    out["all_gather"] += 1
    return out


def lane_collectives(cfg, cuts: Tuple[int, ...]) -> Dict[str, int]:
    """The collectives of one token of a fused split round over lanes at
    ``cuts`` (``PartitionExecutor.build_fleet_decode``): each
    lane's embedding all-reduce and edge layers, the shared tail from the
    shallowest cut once, the logits' one all-gather.  One lane makes the
    unsplit decode token's count (``collectives``)."""

    out = layer_collectives(cfg, range(min(cuts), cfg.num_layers))
    for cut in cuts:
        edge = layer_collectives(cfg, range(cut))
        out = {k: n + edge[k] for k, n in out.items()}
        out["all_reduce"] += 1
    out["all_gather"] += 1
    return out


def collective_bytes(cfg, rows: int, prompt: int = 1, ranks: int = 2, *,
                     frames: Optional[int] = None, frontend: int = 0) -> Dict[str, int]:
    """The result bytes of ``collectives(cfg, prompt)`` on a rank of
    ``ranks`` over ``rows`` sequences: an all-reduce's tensor, an
    all-gather's concatenation, each in its own dtype.  The embedding's
    sum is bf16 (``embed_lookup`` looks up in bf16, as the reference
    does); the Mamba ``dt`` / B / C partials, the xLSTM's output sums
    (``_sum_over``) and the sLSTM's h are float32; the rest the model's
    dtype.  The logits are gathered for the last position only.  An enc-dec
    prefill's encoder runs over ``frames`` frames (default ``prompt``); a
    VLM's prompt holds ``frontend`` patch positions, which the embedding
    does not look up.  One rank issues none; ``check_model_axis`` refuses
    widths that do not divide over ``ranks``."""

    if ranks == 1:
        return {"all_reduce": 0, "all_gather": 0}
    from repro_torch.models.layers import VOCAB_PAD
    from repro_torch.models.model import check_model_axis
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.models.xlstm import mlstm_dims

    check_model_axis(cfg, ranks)
    it, f32 = getattr(torch, cfg.dtype).itemsize, 4
    d, tokens = cfg.d_model, rows * prompt
    act = tokens * d
    _, nh, n = ssm_dims(cfg)
    reduce = rows * (prompt - frontend) * d * 2   # the embedding, bf16
    gather = rows * -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD * it  # the logits
    for kind in cfg.blocks:
        if kind == "attn":
            reduce += act * it * (2 if cfg.encoder_decoder else 1)
        elif kind == "mamba":
            reduce += tokens * (nh + 2 * n) * f32 + act * it
        elif kind == "mlstm":
            reduce += act * f32
            gather += tokens * mlstm_dims(cfg)[0] * it
        else:
            reduce += act * f32
            gather += act * f32
        if cfg.d_ff > 0:
            reduce += act * it
    if cfg.encoder_decoder and prompt > 1:
        frames = prompt if frames is None else frames
        reduce += 2 * cfg.num_encoder_layers * rows * frames * d * it
    return {"all_reduce": int(reduce), "all_gather": int(gather)}
