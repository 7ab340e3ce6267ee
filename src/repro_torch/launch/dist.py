"""The mesh's ``model`` and ``data`` axes as ``torch.distributed`` ranks
(the torch counterpart of the reference's multi-device runtime, where
GSPMD places the reductions of a tensor-parallel layer and the exchanges
of an expert-parallel one).

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

``CALLS`` counts the model axis's collectives by name, one for each call
that reaches ``torch.distributed``, and ``BYTES`` their result bytes (an
all-reduce's tensor, an all-gather's concatenation, a broadcast's tensor);
``DATA_CALLS`` / ``DATA_BYTES`` count the data axis's and the prefill
handoff's so (``runtime.graphs.GraphedCall`` keeps all four right across
graph replays, as it keeps the kernel launches).

**The rank grid.**  ``init_rank_grid`` (or ``rank_grid`` inside a world
that is already up) lays ``P * D * M + F`` ranks out as a (pod, data,
model) grid plus ``F`` prefill ranks: rank ``(p, d, m)`` is world rank
``(p * D + d) * M + m``, the prefill ranks come last (as
``launch.mesh.split_device_groups`` puts the prefill on the last devices).
Each grid rank joins its model group (the ``ModelGroup`` of a
tensor-parallel ``Model``), its data group (the data ranks of its pod and
model column: the experts spread over it), its batch group (every (pod,
data) rank of its model column: the engine's rows are blocked over it;
the data group itself where ``P`` is 1, so that a (data, model) grid keeps
its groups) and, with a prefill rank, the handoff group of every rank of
the grid, over which the prefill rank hands its K/V and logits to the
decode ranks and the decode ranks hand each window's tokens back.  A
prefill rank is in no model, data or batch group.  A group of one makes
every collective the identity; the batch group's collectives count with
the data axis's.

``collectives`` and ``collective_bytes`` give what a rank issues for one
decode token or one prefill from the layer kinds alone: the count that
``CALLS`` and ``BYTES`` must show, and the dry run's collective term.  They
hold where the rank model cuts every vocab, MLP and expert block, as it
does for every stack of ``configs`` over 2, 4 and 16 ranks.  The data
axis's and the batch group's count so: an MoE layer's exchanges
(``moe_calls`` / ``moe_call_bytes``; a stack's, ``data_collectives``; a
fused split round's over the lanes' blocks, ``lane_data_collectives``),
a window's one gather of every block of the cloud rows and the lanes
(``harvest_bytes``) and the prefill rank's handoff (``handoff_bytes``).
A row doubling gathers each buffer it re-cuts, and the pages (and a
serial lane's edge caches) of the rows that change rank: the scheduler
and each lane count those from their own buffers (``grow_gathers``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import torch

BACKENDS = ("nccl", "gloo")
# the model axis's collectives issued, by name (the counterpart of
# ``kernels._lib.LAUNCHES``), and their result bytes
CALLS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}
BYTES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}
# the data axis's and the prefill handoff's
DATA_CALLS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
DATA_BYTES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


@dataclass(frozen=True, eq=False)
class ModelGroup:
    """The ranks of one axis, as one rank sees them: its own ``rank`` of
    ``size``, the ``backend``, its ``device`` and every rank's device
    (``devices[m]``), the ``torch.distributed`` process group (``pg``;
    None for a group of one) and the ``axis`` it spans (``"model"``,
    ``"data"`` or ``"handoff"``), which decides where its collectives are
    counted."""

    rank: int
    size: int
    backend: str
    device: torch.device
    devices: Tuple[torch.device, ...]
    pg: object = None
    axis: str = "model"

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

    if world == 1:
        device = _rank_device(rank, world, backend, device)
        return ModelGroup(0, 1, backend, device, (device,))
    import torch.distributed as dist

    device = _join(rank, world, backend, init_method, device)
    names = [None] * world
    dist.all_gather_object(names, str(device))
    return ModelGroup(rank, world, backend, device, tuple(torch.device(n) for n in names),
                      dist.group.WORLD)


def destroy_model_group(group: Optional[ModelGroup]) -> None:
    """Leave the process group (nothing for a group of one)."""

    if group is not None and group.pg is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


@dataclass(frozen=True, eq=False)
class RankGrid:
    """This process's place on a grid of ``pod`` x ``data`` x ``model``
    ranks plus ``prefill`` prefill ranks (``rank_grid``): its world
    ``rank``, every grid rank's device (``devices``, by grid rank), and its
    groups: the model group (its ``(pod, data)`` place), the data group
    (the data ranks of its own pod and model column: the experts spread
    over it), the handoff group (every grid rank, the prefill rank last;
    None without a prefill rank) and the batch group (every ``(pod,
    data)`` rank of its model column, in that order: the rows are blocked
    over it; the data group itself where ``pod`` is 1).  A prefill rank
    has no model, data or batch group."""

    data: int
    model: int
    prefill: int
    rank: int
    backend: str
    device: torch.device
    devices: Tuple[torch.device, ...]
    model_group: Optional[ModelGroup]
    data_group: Optional[ModelGroup]
    handoff: Optional[ModelGroup]
    pod: int = 1
    batch_group: Optional[ModelGroup] = None

    def __post_init__(self):
        if self.pod == 1:
            object.__setattr__(self, "batch_group", self.data_group)

    @property
    def decode_ranks(self) -> int:
        """The grid's ranks without the prefill rank: ``pod * data * model``."""

        return self.pod * self.data * self.model

    @property
    def is_prefill(self) -> bool:
        return self.rank >= self.decode_ranks

    @property
    def blocks(self) -> int:
        """The blocks the rows are cut into: one a ``(pod, data)`` rank."""

        return self.pod * self.data

    @property
    def p(self) -> int:
        """This rank's place on the pod axis (0 on a prefill rank)."""

        return 0 if self.is_prefill else self.rank // (self.data * self.model)

    @property
    def d(self) -> int:
        """This rank's place on the data axis (0 on a prefill rank)."""

        return 0 if self.is_prefill else self.rank // self.model % self.data

    @property
    def m(self) -> int:
        """This rank's place on the model axis (0 on a prefill rank)."""

        return 0 if self.is_prefill else self.rank % self.model


def rank_grid(data: int, model: int = 1, prefill: int = 0, pod: int = 1) -> Optional[RankGrid]:
    """Lay a grid of ``pod`` x ``data`` x ``model`` ranks and ``prefill``
    (0 or 1) prefill ranks over the first ``pod * data * model + prefill``
    world ranks of the default process group, which must be up (every
    process of the world calls this, in the same order: each group is a
    ``torch.distributed.new_group``): rank ``(p, d, m)`` is world rank
    ``(p * data + d) * model + m``, the prefill rank last -> this
    process's ``RankGrid``, or None for a process outside the grid.  A grid
    with ``pod`` 1 makes exactly the groups of a (data, model) grid."""

    import torch.distributed as dist

    if data < 1 or model < 1 or pod < 1 or prefill not in (0, 1):
        raise ValueError(f"a grid of pod {pod}, data {data}, model {model}, prefill {prefill}: "
                         "pod, data and model at least 1, prefill 0 or 1")
    n = pod * data * model + prefill
    world, r = dist.get_world_size(), dist.get_rank()
    if n > world:
        raise ValueError(f"a grid of {n} ranks in a world of {world}")
    backend = dist.get_backend()
    names = [None] * world
    dist.all_gather_object(names, str(_DEVICE or "cpu"))
    devices = tuple(torch.device(x) for x in names[:n])

    def group(members, axis):
        # every process makes every group, in the same order
        pg = dist.new_group(members) if len(members) > 1 else None
        if r not in members:
            return None
        return ModelGroup(members.index(r), len(members), backend, devices[r],
                          tuple(devices[i] for i in members), pg, axis)

    def at(p, d, m):
        return (p * data + d) * model + m

    rows = [group([at(p, d, m) for m in range(model)], "model")
            for p in range(pod) for d in range(data)]
    cols = [group([at(p, d, m) for d in range(data)], "data")
            for p in range(pod) for m in range(model)]
    batch = ([group([at(p, d, m) for p in range(pod) for d in range(data)], "batch")
              for m in range(model)] if pod > 1 else [])
    handoff = group(list(range(n)), "handoff") if prefill else None
    if r >= n:
        return None
    return RankGrid(data, model, prefill, r, backend, devices[r], devices,
                    next((g for g in rows if g), None), next((g for g in cols if g), None),
                    handoff, pod, next((g for g in batch if g), None))


# this process's device, as ``init_model_group`` / ``init_rank_grid`` set it
_DEVICE: Optional[torch.device] = None


def init_rank_grid(rank: int, *, data: int, model: int = 1, prefill: int = 0, pod: int = 1,
                   backend: str, init_method: Optional[str] = None, device="cuda") -> RankGrid:
    """Join a world of ``pod * data * model + prefill`` ranks as ``rank`` on
    ``device`` (``torch.distributed.init_process_group``, as
    ``init_model_group``) and lay the grid over it (``rank_grid``).  Gloo
    ranks may share a card (or the CPU); NCCL wants a card a rank."""

    world = pod * data * model + prefill
    _join(rank, world, backend, init_method, device)
    return rank_grid(data, model, prefill, pod)


def _rank_device(rank, world, backend, device) -> torch.device:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL rank needs a CUDA device, not {device}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")
    return device


def _join(rank, world, backend, init_method, device) -> torch.device:
    """``init_process_group`` as ``rank`` of ``world`` on ``device`` (made
    current on a card) -> the device, kept for ``rank_grid``."""

    global _DEVICE
    import torch.distributed as dist

    device = _rank_device(rank, world, backend, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    _DEVICE = device
    return device


def destroy_rank_grid(grid: Optional[RankGrid]) -> None:
    """Leave the world the grid lies in."""

    import torch.distributed as dist

    if grid is not None and dist.is_initialized():
        dist.destroy_process_group()


def _counts(group: ModelGroup):
    return (CALLS, BYTES) if group.axis == "model" else (DATA_CALLS, DATA_BYTES)


def _count(group: ModelGroup, name: str, nbytes: int) -> None:
    calls, sizes = _counts(group)
    calls[name] += 1
    sizes[name] += int(nbytes)


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

    _count(group, "all_reduce", x.numel() * x.element_size())
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

    _count(group, "all_gather", x.numel() * x.element_size() * group.size)
    src = _pinned(x) if _staged(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    return torch.cat(parts, dim).to(x.device)


def reduce_rows(x: torch.Tensor, group: Optional[ModelGroup]) -> torch.Tensor:
    """The reduce-scatter of rows: the sum of ``x`` [B, ...] over the
    group's ranks, this rank's block of ``B / size`` rows of it (an
    all-reduce, then the rank's slice)."""

    if group is None or group.size == 1:
        return x
    n = x.shape[0] // group.size
    return all_reduce_sum(x, group).narrow(0, group.rank * n, n)


def broadcast(x: torch.Tensor, src: int, group: Optional[ModelGroup]) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank: the others pass a buffer
    of its shape and dtype -> the tensor on ``x``'s device."""

    if group is None or group.size == 1:
        return x
    import torch.distributed as dist

    _count(group, "broadcast", x.numel() * x.element_size())
    if _staged(x, group):
        h = _pinned(x)
        dist.broadcast(h, dist.get_global_rank(group.pg, src), group=group.pg)
        return h.to(x.device)
    x = x.contiguous()
    dist.broadcast(x, dist.get_global_rank(group.pg, src), group=group.pg)
    return x


def reset_calls() -> None:
    for counts in (CALLS, BYTES, DATA_CALLS, DATA_BYTES):
        for name in counts:
            counts[name] = 0


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
    """The model axis's collectives of one token of a fused split round
    over lanes at ``cuts`` (``PartitionExecutor.build_fleet_decode``): each
    lane's embedding all-reduce and edge layers, the shared tail from the
    shallowest cut once, the logits' one all-gather.  One lane makes the
    unsplit decode token's count (``collectives``).  Where the lanes' rows
    are blocked over data ranks, their MoE layers' exchanges over the data
    axis are ``lane_data_collectives``'."""

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


# ---------------------------------------------------------------------------
# the data axis's and the handoff's collectives
# ---------------------------------------------------------------------------


def experts_split(cfg, data: int) -> bool:
    """Whether ``cfg``'s experts spread over ``data`` data ranks (the
    ``"expert": ("data",)`` rule: E divides over them)."""

    return cfg.moe is not None and data > 1 and cfg.moe.num_experts % data == 0


def _moe_in(cfg, layers: Iterable[int]) -> list:
    return [i for i in layers if cfg.d_ff > 0 and cfg.is_moe_layer(i)]


def moe_calls(cfg, layers: Iterable[int], data: int, *, sharded: bool, moe_impl: str = "dense",
              offload: Iterable[int] = ()) -> Dict[str, int]:
    """The data-axis collectives of one call of each MoE layer among
    ``layers`` on a data rank of ``data`` (``models/moe.py``): over rows
    that a round shards over ranks (``sharded``: a decode round, a fused
    split round, a serial lane's suffix step) a layer gathers its rows and
    reduce-scatters its mixture where the experts spread over the data
    ranks, and gathers its rows under the capacity dispatch where they do
    not; an expert-offload layer (``offload``) also gathers its combine
    weights where it gathers its rows; over replicated rows (an admission
    prefill, a lane's flush and edge prefill) a layer all-reduces its
    mixture where the experts spread.  Every other layer makes none."""

    moe, split, off = _moe_in(cfg, layers), experts_split(cfg, data), set(offload)
    gather = sum(sharded * (split or moe_impl == "capacity") + sharded * split * (i in off)
                 for i in moe)
    return {"all_reduce": len(moe) * split, "all_gather": int(gather), "broadcast": 0}


def moe_call_bytes(cfg, layers: Iterable[int], rows: int, prompt: int, data: int, *,
                   sharded: bool, moe_impl: str = "dense", offload: Iterable[int] = (),
                   batch: Optional[int] = None) -> Dict[str, int]:
    """The result bytes of ``moe_calls`` over ``rows`` rows of ``prompt``
    tokens a rank sees: a gather's concatenation of every rank's rows in
    the model's dtype (over the pod's ``data`` ranks, or, under the
    capacity dispatch, the ``batch`` ranks of every (pod, data) place;
    default ``data``), an offload layer's float32 combine weights so, a
    reduction's float32 partials of every row it sums (the pod's gathered
    rows, or the replicated ones)."""

    moe, split, off = _moe_in(cfg, layers), experts_split(cfg, data), set(offload)
    it, d = getattr(torch, cfg.dtype).itemsize, cfg.d_model
    tokens = rows * prompt
    over = (batch or data) if moe_impl == "capacity" else data
    out = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
    for i in moe:
        if sharded and (split or moe_impl == "capacity"):
            out["all_gather"] += over * tokens * d * it
        if sharded and split and i in off:
            out["all_gather"] += data * tokens * cfg.moe.num_experts * 4
        if split:
            out["all_reduce"] += (data if sharded else 1) * tokens * d * 4
    return out


def data_collectives(cfg, data: int, *, sharded: bool, moe_impl: str = "dense"
                     ) -> Dict[str, int]:
    """The data-axis collectives of one call of ``cfg``'s stack (a decode
    token, or a prefill) on a data rank of ``data``: ``moe_calls`` over
    every layer."""

    return moe_calls(cfg, range(cfg.num_layers), data, sharded=sharded, moe_impl=moe_impl)


def data_collective_bytes(cfg, rows: int, prompt: int, data: int, *, sharded: bool,
                          moe_impl: str = "dense", batch: Optional[int] = None
                          ) -> Dict[str, int]:
    """The result bytes of ``data_collectives`` over ``rows`` rows of
    ``prompt`` tokens a data rank sees (``moe_call_bytes``; ``batch``: the
    ranks the rows are blocked over, pod x data)."""

    return moe_call_bytes(cfg, range(cfg.num_layers), rows, prompt, data, sharded=sharded,
                          moe_impl=moe_impl, batch=batch)


def lane_data_collectives(cfg, data: int, cuts: Tuple[int, ...],
                          offloads: Optional[Tuple[Tuple[int, ...], ...]] = None,
                          moe_impl: str = "dense") -> Dict[str, int]:
    """The data-axis (and batch-group) collectives of one token of a fused
    split round over lanes at ``cuts`` (ascending, ``offloads`` each
    lane's offloaded layers) whose rows a rank holds in blocks: each
    lane's edge layers over its block, then the shared tail from the
    shallowest cut once over the joined blocks (``moe_calls``, sharded)."""

    out = moe_calls(cfg, range(min(cuts), cfg.num_layers), data, sharded=True, moe_impl=moe_impl)
    for k, cut in enumerate(cuts):
        edge = moe_calls(cfg, range(cut), data, sharded=True, moe_impl=moe_impl,
                         offload=offloads[k] if offloads else ())
        out = {name: n + edge[name] for name, n in out.items()}
    return out


def lane_data_collective_bytes(cfg, data: int, cuts: Tuple[int, ...], blocks: Tuple[int, ...],
                               offloads: Optional[Tuple[Tuple[int, ...], ...]] = None,
                               moe_impl: str = "dense", batch: Optional[int] = None
                               ) -> Dict[str, int]:
    """The result bytes of ``lane_data_collectives`` with ``blocks[k]``
    rows of lane ``k`` a rank: an edge layer over its lane's block, a tail
    layer over the blocks of the lanes joined at it."""

    kw = dict(sharded=True, moe_impl=moe_impl, batch=batch)
    out = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
    parts = [moe_call_bytes(cfg, range(cut), blocks[k], 1, data,
                            offload=offloads[k] if offloads else (), **kw)
             for k, cut in enumerate(cuts)]
    parts += [moe_call_bytes(cfg, [i], sum(b for b, c in zip(blocks, cuts) if c <= i), 1, data,
                             **kw) for i in range(min(cuts), cfg.num_layers)]
    for part in parts:
        out = {name: n + part[name] for name, n in out.items()}
    return out


def harvest_bytes(rows: int, steps: int, data: int, prefill: int) -> Dict[str, int]:
    """The result bytes of one window's harvest over ``rows`` gathered rows
    of ``steps`` tokens (int64: every block of the cloud rows and of each
    pipelined lane, the blocks of ``data`` ranks, pad rows included): the
    ranks' gather of their blocks, one for the window, then, with a
    prefill rank, the broadcast of every gathered row to it."""

    every = rows * steps * 8
    return {"all_reduce": 0, "all_gather": every if data > 1 else 0,
            "broadcast": every if prefill else 0}


def handoff_bytes(cfg, batch: int, prompt: int) -> int:
    """The bytes a prefill rank hands to the decode ranks for a prefill of
    ``batch`` prompts of ``prompt`` tokens (``Model.handoff_layout``: the
    last logits and the dense cache, each in its dtype): for openvla-7b
    cut to 4 layers, ``batch`` x 917,504 B of K/V at 14 tokens plus
    ``batch`` x 2 x ``vocab_padded`` B of bf16 logits."""

    from repro_torch.models.model import Model

    layout = Model(cfg, device="meta").handoff_layout(batch, prompt)
    return sum(math.prod(shape) * dtype.itemsize for _, shape, dtype in layout)
