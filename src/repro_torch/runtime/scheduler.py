"""Continuous-batching scheduler on the paged KV substrate, cloud lane
(counterpart of ``repro/runtime/scheduler.py``).

Sequences are backed by page tables over one shared KV page pool (the
model's paged decode mode), and

  * **admission** is bounded only by free pages: pending requests are
    prefilled in one batched call (padded to a power of two) and their
    prompt KV is scattered into the pool pages they were given
    (``Model.merge_prefill_into_paged``);
  * **batch rows** carry only O(1) per-sequence state (last logits, page
    table row, length, capacity, the recurrent state of Mamba and xLSTM
    layers, ``Model.state_names``); when more sequences are resident than
    rows, the row buffers double;
  * **decode rounds** advance every row by ``decode_block`` greedy action
    tokens through ``Model.decode_chunk`` (attention through
    ``ops.paged_decode_attention``).

**Scan windows.**  ``scan_rounds=R``: one ``step()`` call per window
dispatches R decode rounds, the next R-1 calls return at once, and the
window-closing call makes the window's one host sync and harvests every
finished chunk.  Admission, completion and page release happen only at
these boundaries; a ``cancel`` landing mid-window marks the sequence dead
and the boundary frees its pages, never while the dispatched rounds may
still write them.  ``scan_rounds=1`` is the one-round-per-call loop.

**CUDA graphs.**  On a CUDA model one decode round of ``block`` tokens is a
CUDA graph over the live buffers, built per ``(block, rows)`` (the
reference jits its window per ``(block, rounds, rows)``); a window is R
replays issued back to back, each round's tokens copied into the window's
``[rows, R * block]`` buffer.  Every live tensor (logits rows, pools,
``len``, ``pt``, ``cap``, the recurrent state) is a static buffer that the
graph reads and writes in place; growing the rows re-allocates them and
drops the graphs.  Admission runs eagerly, once per boundary
(``admit_ms`` keeps its host time).  On a CPU model the same round runs
eagerly.

**Split lanes.**  ``attach_partition(executor)`` serves partitioned robots'
cloud suffixes in the same rounds, one lane per lane key (a cut, or ``(cut,
expert_offload)``), their suffix K/V drawn from the same allocator, so
admission is FIFO across the cloud queue and every lane.  A **serial** lane
(``pipelined=False``) ping-pongs each token through the host (each robot's
batch-1 edge step, then one batched suffix step), eagerly: the reference
for the fused path.  A **pipelined** lane keeps its robots' edge caches as
rows on the device, and a window of (argmax -> edge prefix -> shared tail)
runs as one function over every active pipelined lane
(``PartitionExecutor.build_fleet_decode``): lanes join a progressively
concatenated row batch at their cut, so each tail layer runs once over the
combined rows, its attention through one scheduler-owned pool per model
layer.  A window is ``R`` fused rounds of ``block`` tokens, each, as a
decode round, a replay of one CUDA graph per ``(lanes, block, rows per
lane)`` where the model allows graphs.  A
lane's row buffers are allocated at an admission into the empty lane (the
shared suffix pools with the first lane's) and freed when its last
sequence leaves, by completion or cancel, together with the fused graphs
captured over them; the shared pools go with the last lane's buffers, as
the reference frees them.  Idle rows of a live lane keep a zero capacity;
a lane whose rows double drops every fused graph.  ``mixed_rounds`` counts
rounds where cloud-only and split work decoded together, ``hetero_rounds``
rounds where two or more distinct cuts did.

**Observability.**  ``obs=Observability()`` stamps submission, admission,
window close, completion and cancels with ``obs.clock``, only at those
host-owned boundaries (no device syncs added), into the metrics registry
(``serve.chunk_latency_ms``, ``serve.queue_wait_ms``, ``sched.*`` counters,
``pool.*`` gauges) and, when tracing, spans on one track per robot (chunk >
queue > decode) and one for the lane (windows).

**Mesh.**  ``mesh=`` (``launch/mesh.py``) splits the engine over the
mesh's ``data`` axis as the reference does: the page pool is rounded so
that its pages and the trash page split evenly into per-shard blocks of
global page ids (the "pages" rule), the allocator steers each request to
the least-loaded shard (``PoolStats.shard_in_use`` / ``shard_high_water``),
the rows stay a multiple of the data size, and each decode round runs
under ``sharding_rules(mesh)``, so its paged attention launches once a
shard a layer over that shard's block of rows
(``kernels.paged_attention.paged_decode_attention_sharded``).  The split
lanes draw from the same shard-aware pool; in one process their rounds
are not row-sharded.  In one process the shards share one device (a
``pod`` axis folds into them: the rows stay a multiple of ``data``, the
allocator keeps ``data`` shards, as the reference's does); a mesh over
more than one distinct device, or on another device than the model's,
raises ``NotImplementedError`` naming the ranks that serve it.

**Data ranks.**  Over a rank grid's mesh (``launch.dist.RankGrid``,
``make_rank_mesh``) each data shard is a rank of its own, SPMD: every rank
makes the same admissions, reservations, rounds, cancels and harvests
from the same requests (the allocator, ``PoolStats`` and every
reservation are the one process's).  The rows of every buffer (the cloud
rows, each split lane's) are blocked over the N ranks of the batch group
(the data ranks; on a grid with a ``pod`` axis every (pod, data) rank):
of a buffer of R rows (the reference's counts: the cloud rows a multiple
of ``data``, a lane's from ``attach_partition``'s ``rows``, both
doubling) rank ``k`` holds the padded block of rows ``[k B, (k + 1) B)``,
``B = ceil(R / N)``, those at R and above pad rows that no sequence takes
(``_block``, ``_own``).  A rank holds and decodes its blocks (logits,
page table, lengths, capacities, recurrent state; a lane's edge rows and
suffix state), its paged attention one launch a layer over them, and a
pool of every global page id, of which it writes and reads its own rows'
pages (a row's pages come from the least-loaded shard, so they need not
lie in its rank's block of ids).  The admission prefill, and a lane's
flush, run whole on every data rank, each merging its own rows; a
window's tokens, the cloud rows' and every lane's blocks in one buffer,
are gathered over the ranks at its close, one collective a window, so
every rank harvests every row (a serial lane gathers its window's tokens
once, at its end: each robot's edge steps on its row's rank alone, unless
its edge layers exchange over the data ranks); doubling a buffer's rows
gathers each row buffer once and each rank keeps its block of the doubled
rows, and a row that changes rank takes its pages' K/V along
(``_move_pages``, one gather a pool tensor) and, on a serial lane, its
robot's edge caches (``_move_edge_caches``).  A decode or fused split
round of a dense stack makes no data-axis collective, so it stays a CUDA
graph under gloo; an MoE stack's round exchanges its rows over the data
ranks (the capacity dispatch over the batch group) and follows the
group's backend (``Model.graphs``, ``round_mode``).

**Model axis.**  A rank mesh (``launch.mesh.make_rank_mesh``) over a
tensor-parallel model (``Model(group=...)``, the same group) runs the
engine on every rank, SPMD: each rank makes the same admissions, rounds,
reservations and harvests from the same requests, over its own heads and
its page pool of its KV heads (page ids, the allocator and the data shards
as above) and its rows of the recurrent state at the rank's sizes (Mamba
heads and channels, mLSTM heads, sLSTM units; ``Model.init_paged_cache``);
every rank's results are the same, and rank 0's are the engine's.  MoE
stacks run either dispatch: every rank routes the same rows, idle ones
included.  A mesh whose model axis is not the model's group is refused;
its data shards share the rank's device, or are ranks of a grid (above).
Decode rounds are CUDA
graphs when the group's backend is NCCL; under gloo (CPU ranks, or ranks sharing one
card) the collectives stage through the host and the rounds run eagerly
(``round_mode`` says which, and the scheduler logs it).  Split lanes run
over the model axis too (``attach_partition`` with an executor of the
rank's model): every rank makes the same lane admissions, reservations,
flushes, rounds and harvests, its suffix pools hold its KV heads, its lane
state and edge rows the rank's sizes, and an emptied lane frees its
buffers on every rank; the fused split rounds follow the decode rounds
(graphs under NCCL, eager under gloo), and a serial lane's host ping-pong
runs the same on every rank.

**Disaggregated prefill.**  ``prefill_group=[device]`` pipelines admission
over two boundaries (the reference's ``_dispatch_prefill`` and
``_merge_pending``): at a boundary the admitted prompts' batched prefill is
issued after the window's rounds, and the sequences stay ``pending``
(capacity 0: the window's writes on their rows go to the trash page, and
harvest skips them; a split lane's admissions flush at once, as the
reference's do); at the next boundary, before any new reservation, the
prefill's K/V and logits merge into the live pool
(``merge_prefill_into_paged``), rows cancelled meanwhile dropped by an
out-of-range row index with their prompt K/V sent, at length 0, to the
trash page.  On a CUDA model the prefill runs on a stream of its own, so
the device runs it beside the window's graph replays on the current stream
while the host issues it; the merge waits on its event, and its outputs
are recorded on the current stream before they are dropped.  On the CPU
both phases run in order, so admissions land one window later as on the
card.  In one process the prefill device must be the model's
(``NotImplementedError`` otherwise, naming the prefill rank).

**The prefill rank.**  ``prefill_group=grid.handoff`` over a grid with a
prefill rank: that rank holds the whole model (no model or data group)
and no rows or pool, runs the same host logic, prefills each boundary's
admitted batch, and at the next boundary broadcasts its last logits and
dense cache (``Model.handoff_layout``, one byte buffer) over the handoff
group; each decode rank takes its KV heads and state blocks
(``Model.rank_block``) and its rows, and merges them as above.  Each
window's tokens go from decode rank 0 to the prefill rank after the data
ranks' gather.  Split lanes stay on the decode ranks: only cloud-only
admissions go to the prefill rank, which makes the same lane
reservations, releases and counters (``record_chunk_bytes``) but holds no
lane buffers and runs no lane kernel; the lanes' tokens reach it in the
window's broadcast, a serial lane's at its window's end.

An encoder-decoder stack is refused, as the reference refuses it: a
request carries observation tokens only, no encoder frames.
"""

from __future__ import annotations

import contextlib
import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import EpisodeTokenizer
from repro_torch.launch.dist import ModelGroup, all_gather_cat, broadcast
from repro_torch.launch.sharding import (logical_to_pspec, no_sharding, shard_shape,
                                         sharding_rules)
from repro_torch.models.model import Model
from repro_torch.obs.clock import clock
from repro_torch.runtime.graphs import GraphedCall, owner_call
from repro_torch.runtime.kv_cache import PageAllocator, PagedSpec

DEFAULT_PAGE_SIZE = 16
LOG = logging.getLogger(__name__)


def _lane_order(key) -> Tuple[int, tuple]:
    """Total order over lane keys: plain int cuts sort with ``(cut,
    offload)`` expert-offload keys at the same boundary (plain first)."""

    return (key, ()) if isinstance(key, int) else (key[0], tuple(key[1]))


def _bucket(n: int) -> int:
    """Smallest power of two >= n (admission batch sizes)."""

    b = 1
    while b < n:
        b *= 2
    return b


def _canon(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


# where the refused placements go
_RANKS = ("serve distinct devices as ranks (launch.dist.init_rank_grid, "
          "launch.mesh.make_rank_mesh)")
_PREFILL_RANK = ("a prefill device of its own is a prefill rank (launch.dist.init_rank_grid("
                 "prefill=1), prefill_group=RankGrid.handoff)")


def _check_placement(model, mesh, prefill_group) -> None:
    """Refuse what the engine does not run: an axis other than ``pod``,
    ``data`` and ``model``, a ``model`` axis that is not the model's group,
    a one-process mesh over more than one distinct device or on another
    device than the model's (distinct devices are ranks), a prefill device
    other than the model's in one process (it is a prefill rank), and a
    grid's rank whose model or prefill group is not the grid's."""

    dev = _canon(model.device)
    grid = getattr(mesh, "grid", None)
    if mesh is not None:
        extra = {a: n for a, n in mesh.shape.items()
                 if a not in ("pod", "data", "model") and n > 1}
        if extra:
            raise NotImplementedError(f"mesh axes {extra}: the engine shards over the pod, data "
                                      "and model axes")
        ranks = int(mesh.shape.get("model", 1))
        group = model.group
        if mesh.prefill_rank:
            if group is not None or model.data_group is not None:
                raise ValueError("a prefill rank holds the whole model: build it with no model "
                                 "or data group")
        elif ranks != (group.size if group else 1) or (ranks > 1 and mesh.group is not group):
            raise NotImplementedError(
                f"a mesh whose model axis ({ranks}) is not the model's group "
                f"({group.size if group else 1} ranks): build the model with the mesh's group "
                "(launch.mesh.make_rank_mesh)")
        elif grid is None:
            col = mesh.devices.reshape(-1, ranks)[:, mesh.rank] if ranks > 1 else mesh.devices
            devs = []
            for d in (_canon(d) for d in np.asarray(col).reshape(-1)):
                if d not in devs:
                    devs.append(d)
            if len(devs) > 1:
                raise NotImplementedError(
                    f"data shards over {len(devs)} distinct devices {[str(d) for d in devs]} in "
                    "one process: " + _RANKS)
            if devs[0] != dev:
                raise NotImplementedError(f"a mesh on {devs[0]} for a model on {dev} in one "
                                          "process: " + _RANKS)
        elif model.cfg.moe is not None and (model.data_group is not mesh.data_group
                                            or model.batch_group is not mesh.batch_group):
            raise ValueError("a data rank's MoE stack spreads its experts over the grid's data "
                             "group and exchanges rows over its batch group: build the model "
                             "with data_group=RankGrid.data_group, "
                             "batch_group=RankGrid.batch_group")
    if isinstance(prefill_group, ModelGroup):
        if grid is None or prefill_group is not grid.handoff:
            raise ValueError("a handoff group serves the grid it belongs to: pass its rank mesh "
                             "(launch.mesh.make_rank_mesh) and prefill_group=RankGrid.handoff")
    elif grid is not None and grid.prefill:
        raise ValueError("a grid with a prefill rank serves with prefill_group=RankGrid.handoff")
    elif prefill_group and _canon(prefill_group[0]) != dev:
        raise NotImplementedError(f"prefill on {prefill_group[0]} apart from decode on {dev} in "
                                  "one process: " + _PREFILL_RANK)


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a cache (a dict of tensors or lists of tensors)."""

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@dataclass
class ChunkRequest:
    robot_id: int
    obs: np.ndarray          # [S_obs] observation token ids
    submitted_round: int
    order: int = 0           # FIFO position
    earliest_round: int = 0  # admission deferral
    submit_ts: float = 0.0   # obs.clock at submission (0 when obs is off)


@dataclass(frozen=True)
class PoolStats:
    """KV page-pool utilization snapshot; with a mesh, each data shard's
    pages in use and high-water mark (None on a single-shard pool)."""

    pages_in_use: int
    pages_free: int
    high_water: int
    shard_in_use: Optional[Tuple[int, ...]] = None
    shard_high_water: Optional[Tuple[int, ...]] = None


@dataclass
class ChunkResult:
    robot_id: int
    tokens: np.ndarray       # [chunk_len * n_joints] greedy action tokens
    submitted_round: int
    admitted_round: int
    completed_round: int
    kind: str = "cloud"      # "cloud" (full stack) | "split" (cloud suffix)
    pool: Optional[PoolStats] = None
    cut: Optional[int] = None  # split kind: the lane's edge layer count
    expert_offload: Tuple[int, ...] = ()  # the lane's cloud-resident experts
    # obs.clock stamps (0 when obs is off); results of one window share
    # ``completed_ts``, the boundary's one clock read
    submitted_ts: float = 0.0
    admitted_ts: float = 0.0
    completed_ts: float = 0.0


@dataclass
class _Sequence:
    """One page-table-backed in-flight sequence."""

    robot_id: int
    row: int
    remaining: int
    pages: List[int]
    request: ChunkRequest
    admitted_round: int
    tokens: List[int] = field(default_factory=list)
    # cancelled while its window was in flight: the dispatched rounds still
    # write this row's pages, so the boundary frees them
    dead: bool = False
    # disaggregated admission: prefilled but not merged yet (capacity 0,
    # not harvested) until the next boundary
    pending: bool = False
    admit_ts: float = 0.0


@dataclass
class _ScanWindow:
    """One dispatched multi-round decode whose tokens await harvest."""

    steps_left: int
    n_steps: int                            # tokens decoded per row
    cloud: bool = False                     # cloud rows decoded (on some rank)
    toks: Optional[torch.Tensor] = None     # this rank's cloud tokens [rows, n_steps]
    seqs: List[_Sequence] = field(default_factory=list)
    lane_toks: Dict[object, torch.Tensor] = field(default_factory=dict)  # by lane key
    lane_seqs: Dict[object, list] = field(default_factory=dict)
    t_open: float = 0.0


class ContinuousBatchingScheduler:
    """Page-bounded continuous batcher over the model's paged decode mode."""

    def __init__(
        self,
        model: Model,
        tokenizer: EpisodeTokenizer,
        max_slots: int = 8,
        chunk_len: int = 8,
        n_joints: int = 7,
        decode_block: Optional[int] = None,
        adaptive_block: bool = False,
        max_block: Optional[int] = None,
        page_size: int = DEFAULT_PAGE_SIZE,
        num_pages: Optional[int] = None,
        scan_rounds: int = 1,
        obs=None,
        mesh=None,
        prefill_group=None,
    ):
        if model.cfg.encoder_decoder:
            raise NotImplementedError("continuous batching targets decoder-only VLAs")
        _check_placement(model, mesh, prefill_group)
        self.model = model
        self.mesh = mesh
        self.data_shards = int(mesh.shape["data"]) if mesh is not None else 1
        # rows blocked over ranks (the data ranks, or every (pod, data) rank
        # of a pod grid): this rank's padded block of every row buffer (one
        # block in one process)
        grid = getattr(mesh, "grid", None)
        self._bgroup = mesh.batch_group if mesh is not None else None
        self._nranks = grid.blocks if grid is not None else 1
        self._brank = self._bgroup.rank if self._bgroup is not None else 0
        self.round_mode = ("cuda graphs" if model.graphs else "eager") + (
            f", {model.group.size} ranks over {model.group.backend}" if model.group else "")
        if model.group is not None:
            LOG.info("scheduler rank %d of %d: decode rounds %s", model.group.rank,
                     model.group.size, self.round_mode)
        # disaggregated prefill: a prefill rank's handoff group, or the
        # stream (CUDA) of a prefill in this process; the dispatched
        # prefills awaiting their merge: (sequences, logits, cache, event),
        # over ranks (sequences, the prefill rank's payload, None, None)
        self._handoff = prefill_group if isinstance(prefill_group, ModelGroup) else None
        self.is_prefill_rank = mesh is not None and mesh.prefill_rank
        if self._handoff is not None:
            self.prefill_device = torch.device(self._handoff.devices[-1])
            self.round_mode += (" (the prefill rank)" if self.is_prefill_rank
                                else f"; prefill on rank {self._handoff.size - 1}")
        else:
            self.prefill_device = torch.device(prefill_group[0]) if prefill_group else None
        if self._nranks > 1 and not self.is_prefill_rank:
            self.round_mode += (f"; rows over {self._nranks} data ranks" if grid.pod == 1 else
                                f"; rows over {grid.pod} x {grid.data} pod and data ranks")
        self._prefill_stream = None
        if (self._handoff is None and self.prefill_device is not None
                and model.device.type == "cuda"):
            self._prefill_stream = torch.cuda.Stream(device=model.device)
        self._pending_admit: List[tuple] = []
        self.tok = tokenizer
        self.obs = obs
        # ``max_slots`` sizes the initial rows and the default pool; pass
        # ``num_pages`` to admit more sequences than rows
        self.max_slots = max_slots
        self.chunk_len = chunk_len
        self.n_joints = n_joints
        self.total_tokens = chunk_len * n_joints
        self.decode_block = decode_block or n_joints
        self.adaptive_block = adaptive_block
        self.max_block = min(max_block or 4 * self.decode_block, self.total_tokens)
        self.prompt_len = 2 * n_joints
        self.scan_rounds = max(int(scan_rounds), 1)
        self.round = 0
        self.peak_active = 0
        self.mixed_rounds = 0        # rounds where cloud-only and split work decoded
        self.hetero_rounds = 0       # rounds where >= 2 distinct cuts decoded
        self.decode_rounds = 0       # rounds where any sequence decoded
        self.cancelled = 0           # sequences cancelled
        self.deferred = 0            # submissions admitted late on purpose
        self.windows = 0             # dispatched scan windows
        self.window_closes = 0       # harvested (synced) scan windows
        # CUDA graphs of the decode round, and the host time of admissions
        self.graph_captures = 0
        self.capture_s = 0.0
        # row doublings over ranks that moved rows, and so their pages
        # (``_move_pages``)
        self.page_moves = 0
        self.admit_ms: List[float] = []
        self.merge_ms: List[float] = []  # host time of the disaggregated merges

        # a request holds prompt + chunk tokens resident
        self.page_size = page_size
        self.pages_per_req = -(-(self.prompt_len + self.total_tokens) // page_size)
        pool = num_pages if num_pages is not None else self.pages_per_req * max_slots
        nd, per_shard = self.data_shards, None
        if nd > 1:
            # the pool and its trash page split evenly over the data axis, so
            # each shard owns a contiguous block of global page ids
            pool = nd * -(-(pool + 1) // nd) - 1
            per_shard = shard_shape(mesh, (pool + 1,),
                                    logical_to_pspec((pool + 1,), ("pages",), mesh))[0]
        self.allocator = PageAllocator(pool, num_shards=nd, pages_per_shard=per_shard)
        self.paged_spec = PagedSpec(num_pages=pool, page_size=page_size,
                                    max_pages_per_seq=self.pages_per_req)
        self.cap_tokens = self.pages_per_req * page_size

        # rows shard over the data axis: a multiple of it (doubling keeps it)
        rows0 = nd * -(-max_slots // nd)
        self._queue: Deque[ChunkRequest] = deque()
        self._seqs: Dict[int, _Sequence] = {}    # row -> sequence
        self._free_rows: List[int] = list(range(rows0))
        self._order = 0
        self._window: Optional[_ScanWindow] = None
        self._token_floor = tokenizer.action_base
        self._graphs: Dict[Tuple[int, int], GraphedCall] = {}  # (block, rows)
        # split lanes by lane key; the shared suffix pools by model layer;
        # the fused rounds' functions and graphs by (lane keys, block) and
        # (lane keys, block, rows per lane)
        self._lanes: Dict[object, "_SplitLane"] = {}
        self._suffix_pools: Dict[int, dict] = {}
        self._fleet_fns: Dict[tuple, object] = {}
        self._fleet_graphs: Dict[tuple, GraphedCall] = {}
        # tokens a fused round runs past the lanes' harvested lengths
        self._fused_offset = torch.zeros((), dtype=torch.int32, device=model.device)

        # live batch state: logits rows + the paged cache (shared pools,
        # per-row page table / length / capacity; zeros mean inactive); a
        # data rank holds its block of the rows and a pool of every global
        # page id, of which it writes and reads its rows' pages; a prefill
        # rank holds none
        self.rows = rows0
        self._vdim = model.vocab_padded  # the logits' width, head tied or not
        self._logits = self._pcache = None
        if not self.is_prefill_rank:
            self._logits = torch.zeros((self._local_rows, self._vdim), dtype=model.dtype,
                                       device=model.device)
            self._pcache = model.init_paged_cache(self._local_rows, self.paged_spec)

    # ------------------------------------------------------------------
    # request interface
    # ------------------------------------------------------------------

    def attach_partition(self, executor, rows: int = 2, pipelined: bool = True) -> None:
        """Serve partitioned robots' cloud suffixes in the same rounds.

        ``executor`` is a ``PartitionExecutor`` over this scheduler's model;
        its suffix K/V draws pages from this scheduler's allocator.  Call
        once per distinct lane key (``executor.lane_key``: the cut, or
        ``(cut, expert_offload)``) for a heterogeneous fleet; derive the
        siblings with ``executor.with_cut``.  ``pipelined`` (default)
        decodes the lane in the fused window; ``pipelined=False`` keeps the
        per-token host ping-pong."""

        key = executor.lane_key
        if key in self._lanes:
            raise ValueError(f"lane {key} already attached")
        if executor.model is not self.model:
            raise ValueError("the executor must split this scheduler's model")
        if self.obs is not None and executor.obs is None:
            executor.obs = self.obs  # lane spans share the run's registry
        self._lanes[key] = _SplitLane(self, executor, rows, pipelined)

    def _lane_for(self, cut) -> "_SplitLane":
        if not self._lanes:
            raise ValueError("no PartitionExecutor attached; call attach_partition")
        if cut is None:
            if len(self._lanes) > 1:
                raise ValueError(f"multiple lanes attached "
                                 f"{sorted(self._lanes, key=_lane_order)}; pass cut=")
            return next(iter(self._lanes.values()))
        if cut not in self._lanes:
            raise ValueError(f"no lane for {cut}; attached: "
                             f"{sorted(self._lanes, key=_lane_order)}")
        return self._lanes[cut]

    def submit(self, robot_id: int, qd: np.ndarray, tau: np.ndarray,
               partitioned: bool = False, cut=None, defer_rounds: int = 0) -> None:
        """Queue one chunk request for ``robot_id`` (qd/tau [1, N]).
        ``partitioned`` routes it to a split lane (``cut``: its lane key,
        optional while one lane is attached).  ``defer_rounds`` delays
        admission, not submission order."""

        obs = np.concatenate([self.tok.encode_state(qd), self.tok.encode_state(tau)], axis=1)[0]
        self._order += 1
        req = ChunkRequest(
            robot_id, obs, self.round, order=self._order,
            earliest_round=self.round + max(defer_rounds, 0) + 1 if defer_rounds > 0 else 0,
        )
        if defer_rounds > 0:
            self.deferred += 1
        if self.obs is not None:
            req.submit_ts = clock()
            m = self.obs.metrics
            m.counter("sched.submissions").inc()
            if defer_rounds > 0:
                m.counter("sched.deferred").inc()
        if partitioned:
            self._lane_for(cut).queue.append(req)
        else:
            self._queue.append(req)

    def cancel(self, robot_id: int) -> bool:
        """Cancel ``robot_id``'s queued or in-flight request.

        A queued request is removed.  An in-flight sequence is freed at
        once, unless it belongs to the dispatched window: its rounds still
        write its pages and row, so it is only marked dead and the boundary
        releases it, emitting no result.  Returns ``False`` when nothing
        was in flight (the chunk already completed): nothing is freed twice.
        """

        for queue in (self._queue, *(lane.queue for lane in self._lanes.values())):
            for req in queue:
                if req.robot_id == robot_id:
                    queue.remove(req)
                    self.cancelled += 1
                    self._obs_cancel(req.robot_id, req.submit_ts, queued=True)
                    return True
        w = self._window
        for seq in self._seqs.values():
            if seq.robot_id == robot_id and not seq.dead:
                dead = w is not None and any(s is seq for s in w.seqs)
                if dead:
                    seq.dead = True
                else:
                    self._release(seq)
                self.cancelled += 1
                self._obs_cancel(seq.robot_id, seq.request.submit_ts, dead=dead)
                return True
        for lane in self._lanes.values():
            for seq in lane.seqs.values():
                if seq.robot_id == robot_id and not seq.dead:
                    dead = w is not None and any(s is seq for s in w.lane_seqs.get(lane.key, ()))
                    if dead:
                        seq.dead = True
                    else:
                        lane.release(seq)
                    self.cancelled += 1
                    self._obs_cancel(seq.robot_id, seq.request.submit_ts, dead=dead,
                                     cut=lane.cut)
                    return True
        return False

    def submit_batch(self, robot_ids, qd: np.ndarray, tau: np.ndarray,
                     partitioned=None, cuts=None, defer_rounds=None) -> None:
        """Queue requests for many robots (qd/tau [n, N]); the queue after
        this call is that of ``n`` serial ``submit`` calls in row order.
        ``partitioned``: an optional [n] bool mask; ``cuts``: optional [n]
        lane keys (int cuts, ``None`` or < 0 for "the only lane", or
        ``(cut, expert_offload)`` tuples).  Obs stamps the batch with one
        clock read."""

        robot_ids = np.asarray(robot_ids, np.int64)
        n = int(robot_ids.shape[0])
        if n == 0:
            return
        obs_toks = np.concatenate([self.tok.encode_state(np.asarray(qd)),
                                   self.tok.encode_state(np.asarray(tau))], axis=1)
        part = np.zeros(n, bool) if partitioned is None else np.asarray(partitioned, bool)
        defer = (np.zeros(n, np.int64) if defer_rounds is None
                 else np.asarray(defer_rounds, np.int64))
        cut_seq = None if cuts is None else list(cuts)
        ts = 0.0
        if self.obs is not None:
            ts = clock()
            m = self.obs.metrics
            m.counter("sched.submissions").inc(n)
            n_deferred = int((defer > 0).sum())
            if n_deferred:
                m.counter("sched.deferred").inc(n_deferred)
        for i in range(n):
            self._order += 1
            d = int(defer[i])
            req = ChunkRequest(
                int(robot_ids[i]), obs_toks[i], self.round, order=self._order,
                earliest_round=self.round + d + 1 if d > 0 else 0, submit_ts=ts,
            )
            if d > 0:
                self.deferred += 1
            if part[i]:
                cut = None
                if cut_seq is not None:
                    c = cut_seq[i]
                    if isinstance(c, tuple):
                        cut = (int(c[0]), tuple(int(x) for x in c[1]))
                    elif c is not None and int(c) >= 0:
                        cut = int(c)
                self._lane_for(cut).queue.append(req)
            else:
                self._queue.append(req)

    def cancel_batch(self, robot_ids) -> np.ndarray:
        """Element ``i`` is ``cancel(robot_ids[i])``, in order."""

        ids = np.asarray(robot_ids)
        return np.fromiter((self.cancel(int(r)) for r in ids), dtype=bool, count=len(ids))

    @property
    def n_pending(self) -> int:
        return len(self._queue) + sum(len(lane.queue) for lane in self._lanes.values())

    @property
    def n_active(self) -> int:
        return len(self._seqs) + sum(len(lane.seqs) for lane in self._lanes.values())

    @property
    def active_cuts(self) -> List[int]:
        """Distinct cuts with in-flight suffixes (ascending); a plain and an
        expert-offload lane at one cut count once."""

        return sorted({lane.cut for lane in self._lanes.values() if lane.seqs})

    @property
    def active_lanes(self) -> List[object]:
        """Lane keys with in-flight suffixes (ascending)."""

        return sorted((k for k, lane in self._lanes.items() if lane.seqs), key=_lane_order)

    def pool_stats(self) -> PoolStats:
        a = self.allocator
        sharded = a.num_shards > 1
        return PoolStats(pages_in_use=a.num_in_use, pages_free=a.num_free,
                         high_water=a.high_water,
                         shard_in_use=tuple(a.shard_in_use) if sharded else None,
                         shard_high_water=tuple(a.shard_high_water) if sharded else None)

    def reset(self) -> None:
        """Drop all queued and in-flight work; keep the cloud rows' buffers
        and graphs (zeroed in place), while the split lanes free theirs (as
        an emptied lane does).  Dispatched prefills awaiting their merge are
        dropped.  Lifetime page counters survive; the high-water mark
        restarts."""

        self._queue.clear()
        self._seqs.clear()
        self._free_rows = list(range(self.rows))
        self.allocator.reclaim_all()
        self._window = None
        self._pending_admit = []
        if self._pcache is not None:
            self._logits.zero_()
            self._pcache["len"].zero_()
            self._pcache["cap"].zero_()
        for lane in self._lanes.values():
            lane.reset()
        self.round = 0
        self.peak_active = 0
        self.mixed_rounds = 0
        self.hetero_rounds = 0
        self.decode_rounds = 0
        self.cancelled = 0
        self.deferred = 0
        self.windows = 0
        self.window_closes = 0

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def _block_for_depth(self, depth: int) -> int:
        """Decode block, monotone in queue depth: ``decode_block``, doubled
        (adaptive mode) each time the backlog could refill a row array's
        worth of sequences, at most ``max_block``."""

        blk = self.decode_block
        if not self.adaptive_block:
            return blk
        while depth >= self.max_slots and blk * 2 <= self.max_block:
            blk *= 2
            depth -= self.max_slots
        return blk

    @property
    def local_shards(self) -> int:
        """The data shards whose rows this process decodes: every one in
        one process, its own on a rank, none on a prefill rank."""

        if self.is_prefill_rank:
            return 0
        return self.mesh.local_shards if self.mesh is not None else 1

    def _block(self, rows: int) -> int:
        """The padded block of a buffer of ``rows`` global rows that a rank
        holds, ``ceil(rows / ranks)`` (``rows`` in one process): rank ``k``
        holds rows ``[k B, (k + 1) B)``, those at ``rows`` and above pad
        rows that no sequence takes."""

        return -(-rows // self._nranks)

    @property
    def _local_rows(self) -> int:
        """The cloud rows this rank holds: its block of ``rows``."""

        return self._block(self.rows)

    def _own(self, row: int, rows: Optional[int] = None) -> Optional[int]:
        """Global row ``row`` of a buffer of ``rows`` (default the cloud
        rows') -> its index in this rank's block, or None where another
        rank (or no rank: the prefill rank) holds it."""

        if self.is_prefill_rank:
            return None
        d, i = divmod(row, self._block(self.rows if rows is None else rows))
        return i if d == self._brank else None

    def _regrow(self, old: int, new: int):
        """-> a function that re-cuts a row buffer of ``old`` global rows to
        ``new`` (along ``dim``): every rank's block gathered (one collective
        a buffer over ranks), the real rows kept, zero rows added and this
        rank's block of the new rows taken."""

        n = self._block(new)

        def grow(t, dim=0):
            t = all_gather_cat(t, dim, self._bgroup).narrow(dim, 0, old)
            pad = list(t.shape)
            pad[dim] = n * self._nranks - old
            return torch.cat([t, t.new_zeros(pad)], dim).narrow(dim, self._brank * n,
                                                                n).contiguous()

        return grow

    def _move_pages(self, pools, dim: int, seqs, old: int, new: int) -> bool:
        """Rows that change rank as a buffer of ``old`` rows is re-cut to
        ``new`` take their pages' K/V along: every rank's pages of its rows
        that leave it, gathered over the ranks (one gather a pool tensor of
        ``pools``, page axis ``dim``), written into the new owner's pools
        -> whether any row moved (every rank sees the same rows, so all or
        none gather)."""

        if self._bgroup is None:
            return False
        bo, bn = self._block(old), self._block(new)
        moving = [(s.row // bo, s.row // bn, s.pages) for s in seqs if s.row // bo != s.row // bn]
        if not moving:
            return False
        # each rank's pages of its leaving rows, in order; those this rank takes
        out, take = [[] for _ in range(self._nranks)], []
        for src, dst, pages in moving:
            for p in pages:
                if dst == self._brank:
                    take.append((src, len(out[src]), p))
                out[src].append(p)
        width = max(len(x) for x in out)
        dev = self.model.device
        pad = [self.paged_spec.num_pages] * (width - len(out[self._brank]))  # the trash page
        mine = torch.as_tensor(out[self._brank] + pad, dtype=torch.long, device=dev)
        src_idx = torch.as_tensor([k * width + j for k, j, _ in take], dtype=torch.long,
                                  device=dev)
        dst_idx = torch.as_tensor([p for _, _, p in take], dtype=torch.long, device=dev)
        for t in pools:
            every = all_gather_cat(t.index_select(dim, mine), dim, self._bgroup)
            if take:
                t.index_copy_(dim, dst_idx, every.index_select(dim, src_idx))
        return True

    def _grow_rows(self) -> None:
        """Double the row buffers (the page pools are shared and do not
        grow); the graphs of the old row count go with the old buffers.
        Over ranks the blocks move: each rank gathers every rank's block,
        pads the rows and keeps its block of the doubled rows, and a row
        that changes rank takes its pages' K/V along (``_move_pages``)."""

        old, new = self.rows, self.rows * 2
        grow = self._regrow(old, new)
        if self._pcache is not None:
            self._logits = grow(self._logits)
            for name, dim in self._row_buffers():
                self._pcache[name] = grow(self._pcache[name], dim)
            if self._kv_pools():
                self.page_moves += self._move_pages(self._kv_pools(), 1, self._seqs.values(),
                                                    old, new)
        self._graphs.clear()
        self._free_rows.extend(range(old, new))
        self.rows = new

    def _row_buffers(self) -> List[Tuple[str, int]]:
        """The paged cache's row buffers that a doubling re-cuts, with
        their row axes: lengths, page table, capacities and each stacked
        recurrent state."""

        return [(n, 0) for n in ("len", "pt", "cap")] + [(n, 1) for n in self.model.state_names]

    def _kv_pools(self) -> List[torch.Tensor]:
        return [self._pcache[k] for k in ("kp", "vp") if k in self._pcache]

    def grow_gathers(self, moved: bool = False) -> int:
        """The gathers a doubling of the cloud rows makes over ranks
        (``_grow_rows``): one for the logits and one a row buffer of the
        paged cache, and, where rows change rank (``moved``), one a K / V
        pool (``_move_pages``); none on the prefill rank."""

        if self._pcache is None:
            return 0
        return 1 + len(self._row_buffers()) + (len(self._kv_pools()) if moved else 0)

    def _take_row(self) -> int:
        if not self._free_rows:
            self._grow_rows()
        return self._free_rows.pop(0)

    def _reserve(self, req: ChunkRequest) -> _Sequence:
        pages = self.allocator.alloc(self.pages_per_req)
        row = self._take_row()
        seq = _Sequence(robot_id=req.robot_id, row=row, remaining=self.total_tokens,
                        pages=pages, request=req, admitted_round=self.round)
        self._seqs[row] = seq
        return seq

    def _try_admit(self) -> List[_Sequence]:
        """Admit pending requests FIFO across the cloud queue and every
        lane (split suffixes and cloud-only robots compete for the same
        pages in submission order) while a request's pages are free; a head
        whose ``earliest_round`` lies ahead holds its queue this round.  A
        lane's admissions prefill as one suffix batch (``flush``); the
        cloud's prompts as one batch of ``_bucket(n)`` rows (padding rows
        dropped by the merge), eagerly.  Disaggregated, the cloud admissions
        are returned ``pending``: ``step`` issues their prefill after the
        window (so that it runs beside it), and the next boundary merges it
        before its reservations (so no page reserved there is one a
        cancelled pending sequence held)."""

        if self._pending_admit:
            self._merge_pending()
        new: List[_Sequence] = []
        new_split: Dict[object, list] = {}
        while self.allocator.num_free >= self.pages_per_req:
            heads = []
            if self._queue and self._queue[0].earliest_round <= self.round:
                heads.append((self._queue[0].order, None))
            for key, lane in self._lanes.items():
                if lane.queue and lane.queue[0].earliest_round <= self.round:
                    heads.append((lane.queue[0].order, key))
            if not heads:
                break
            _, key = min(heads, key=lambda h: h[0])  # orders are unique
            if key is None:
                new.append(self._reserve(self._queue.popleft()))
            else:
                lane = self._lanes[key]
                new_split.setdefault(key, []).append(lane.reserve(lane.queue.popleft()))
        if self.obs is not None and (new or new_split):
            # one clock read per admission boundary
            t_adm = clock()
            m = self.obs.metrics
            admitted = new + [s for seqs in new_split.values() for s in seqs]
            m.counter("sched.admissions").inc(len(admitted))
            qw = m.histogram("serve.queue_wait_ms")
            for seq in admitted:
                seq.admit_ts = t_adm
                qw.observe((t_adm - seq.request.submit_ts) * 1e3)
        for key, seqs in new_split.items():
            self._lanes[key].flush(seqs)
        if not new:
            return []
        if self.prefill_device is not None:
            for seq in new:
                seq.pending = True
            return new
        t0 = clock()
        logits, dcache = self.model.prefill({"tokens": self._prompts(new)}, extra=0)
        self._merge_rows(new, logits[:, -1], dcache)
        self.admit_ms.append((clock() - t0) * 1e3)
        return []

    def _prompts(self, new: List[_Sequence]) -> torch.Tensor:
        """The admitted prompts as one batch of ``_bucket(n)`` rows (the
        padding rows' prompts 0)."""

        obs = np.zeros((_bucket(len(new)), self.prompt_len), np.int64)
        for i, seq in enumerate(new):
            obs[i] = seq.request.obs
        return torch.as_tensor(obs, device=self.model.device)

    def _merge_rows(self, new: List[_Sequence], last, dcache) -> None:
        """Merge a prefill of ``new``'s prompts (its last logits [n, V] and
        dense cache) into this rank's rows and pool: a row another data rank
        holds, a padding row, and a sequence released (cancelled) since it
        was admitted take an out-of-range row and length 0, so their prompt
        K/V goes to the trash page, never to pages reserved again since."""

        n, local = last.shape[0], self._local_rows
        pt_new = np.zeros((n, self.pages_per_req), np.int32)
        row_idx = np.full((n,), local, np.int64)  # dropped
        lens = np.zeros((n,), np.int32)
        caps = np.zeros((n,), np.int32)
        for i, seq in enumerate(new):
            loc = self._own(seq.row)
            if seq.dead or self._seqs.get(seq.row) is not seq or loc is None:
                continue
            pt_new[i] = seq.pages
            row_idx[i] = loc
            lens[i] = self.prompt_len
            caps[i] = self.cap_tokens
        self.model.merge_prefill_into_paged(dcache, self._pcache, pt_new, row_idx, lens, caps)
        keep = np.flatnonzero(row_idx < local)
        if keep.size:
            dev = self.model.device
            self._logits.index_copy_(0, torch.as_tensor(row_idx[keep], device=dev),
                                     last.index_select(0, torch.as_tensor(keep, device=dev)))

    def _release(self, seq: _Sequence) -> None:
        """Return pages and row; zero the row's capacity (in place) so the
        still-batched row never writes pages a later admission reuses."""

        self.allocator.free(seq.pages)
        del self._seqs[seq.row]
        self._free_rows.append(seq.row)
        loc = self._own(seq.row)
        if loc is not None:
            self._pcache["cap"][loc] = 0

    # ------------------------------------------------------------------
    # prefill/decode disaggregation (``prefill_group``)
    # ------------------------------------------------------------------

    def _dispatch_prefill(self, new: List[_Sequence]) -> None:
        """Phase 1, at this boundary, after the window is issued: the
        ``pending`` admissions' batched prefill is issued (on a CUDA model
        on the prefill stream, so that the device runs it beside the
        window's rounds while the host issues it; over ranks on the prefill
        rank alone, beside the decode ranks' window); their rows keep
        capacity 0 until the next boundary merges it."""

        t0 = clock()
        if self._handoff is not None:
            payload = None
            if self.is_prefill_rank:
                logits, dcache = self.model.prefill({"tokens": self._prompts(new)}, extra=0)
                payload = self._pack(logits[:, -1], dcache)
                self.admit_ms.append((clock() - t0) * 1e3)
            self._pending_admit.append((new, payload, None, None))
            return
        stream, done = self._prefill_stream, None
        with no_sharding(), (torch.cuda.stream(stream) if stream is not None
                             else contextlib.nullcontext()):
            logits, dcache = self.model.prefill({"tokens": self._prompts(new)}, extra=0)
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
        self._pending_admit.append((new, logits, dcache, done))
        self.admit_ms.append((clock() - t0) * 1e3)

    def _merge_pending(self) -> None:
        """Phase 2, at the next boundary: the current stream waits for the
        prefill (over ranks: the prefill rank hands its last logits and
        dense cache to the decode ranks, one broadcast over the handoff
        group, and each takes its KV heads and state blocks), then its K/V
        and last logits merge into the live pool and rows.  Sequences
        released while pending (cancelled) take an out-of-range row and
        length 0: their prompt K/V goes to the trash page, never to pages
        reserved again since."""

        pending, self._pending_admit = self._pending_admit, []
        dev = self.model.device
        for new, logits, dcache, done in pending:
            t0 = clock()
            for seq in new:
                if not seq.dead and self._seqs.get(seq.row) is seq:
                    seq.pending = False
            if self._handoff is not None:
                last, dcache = self._unpack(self._handoff_payload(len(new), logits),
                                            _bucket(len(new)))
            else:
                last = logits[:, -1]
                if done is not None:
                    cur = torch.cuda.current_stream(dev)
                    cur.wait_event(done)
                    # made on the prefill stream, read here: the allocator must
                    # not hand their blocks out before this stream is past them
                    for t in [logits, *_tensors(dcache)]:
                        t.record_stream(cur)
            if last is not None:
                self._merge_rows(new, last, dcache)
            self.merge_ms.append((clock() - t0) * 1e3)

    # the prefill rank's handoff: its last logits and dense cache as one
    # byte buffer (``Model.handoff_layout``), one broadcast a boundary

    def _pack(self, last, dcache) -> torch.Tensor:
        parts = {"logits": last, **dcache}
        return torch.cat([parts[name].to(dtype).contiguous().view(torch.uint8).reshape(-1)
                          for name, _, dtype in self.model.handoff_layout(last.shape[0],
                                                                          self.prompt_len)])

    def _handoff_payload(self, n_new: int, payload) -> torch.Tensor:
        """The prefill rank's ``payload`` of ``n_new`` admissions on every
        rank of the handoff group (a decode rank passes None and receives
        it into a buffer of the layout's bytes)."""

        if payload is None:
            layout = self.model.handoff_layout(_bucket(n_new), self.prompt_len)
            nbytes = sum(int(np.prod(shape)) * dtype.itemsize for _, shape, dtype in layout)
            payload = torch.empty((nbytes,), dtype=torch.uint8, device=self.model.device)
        return broadcast(payload, self._handoff.size - 1, self._handoff)

    def _unpack(self, buf: torch.Tensor, n: int):
        """A decode rank's (last logits, dense cache) of the handoff bytes
        of ``n`` prompts: its KV heads and its blocks of the recurrent
        state of the whole model's cache (``Model.rank_block``); (None,
        None) on the prefill rank."""

        if self.is_prefill_rank:
            return None, None
        out, at = {}, 0
        for name, shape, dtype in self.model.handoff_layout(n, self.prompt_len):
            size = int(np.prod(shape)) * dtype.itemsize
            out[name] = self.model.rank_block(name, buf[at:at + size].view(dtype).reshape(shape))
            at += size
        return out.pop("logits"), out

    def _ctx(self, rows=None):
        """The mesh's rules around a decode round (nothing without a mesh);
        over ranks with the blocks of the row buffers the round joins
        (``rows``: (global rows, rows a block) each; the cloud rows' by
        default)."""

        if self.mesh is None:
            return contextlib.nullcontext()
        if self._bgroup is None:
            return sharding_rules(self.mesh)
        return sharding_rules(self.mesh, rows=rows or ((self.rows, self._local_rows),))

    def _lane_ctx(self, lanes):
        """The rules around a split lane's rounds: over ranks the mesh's,
        with the lanes' blocks; in one process none (a lane's rounds do
        not split its rows over the data shards)."""

        if self._bgroup is None:
            return contextlib.nullcontext()
        return self._ctx([(l.rows, l.block) for l in lanes])

    def _settle_prefill(self) -> None:
        """Before a CUDA graph capture: no prefill in flight on the side
        stream while the capture runs."""

        if self._prefill_stream is not None:
            self._prefill_stream.synchronize()

    def _round(self, block: int) -> torch.Tensor:
        """One decode round of ``block`` greedy tokens over every row, on the
        live buffers in place, under the mesh's rules -> tokens [rows,
        block]."""

        with self._ctx():
            toks, logits, cache = self.model.decode_chunk(
                self._logits[:, None], self._pcache, block, self._token_floor
            )
        self._logits.copy_(logits[:, -1])
        self._pcache["len"].copy_(cache["len"])
        return toks

    def _decode_round(self, block: int) -> torch.Tensor:
        """``_round`` eagerly on a CPU model or a gloo group's; else a
        replay of its CUDA graph for ``(block, rows)``."""

        if not self.model.graphs:
            return self._round(block)
        call = self._graphs.get((block, self.rows))
        if call is None:
            call = self._graphs[(block, self.rows)] = GraphedCall(owner_call(self, "_round", block))
        first = call.graph is None
        if first:
            self._settle_prefill()
        toks = call()
        if first:
            self.graph_captures += 1
            self.capture_s += call.capture_s
        return toks

    def _decode_window(self, block: int, rounds: int) -> torch.Tensor:
        """``rounds`` decode rounds issued back to back -> tokens of this
        rank's rows [rows, rounds * block]; nothing waits for the device."""

        toks = torch.empty((self._local_rows, rounds * block), dtype=torch.long,
                           device=self.model.device)
        for r in range(rounds):
            toks[:, r * block:(r + 1) * block].copy_(self._decode_round(block))
        return toks

    def _ensure_suffix_pools(self, ex) -> None:
        """The shared suffix K/V pools, one per model layer at or past
        ``ex``'s cut: every lane whose cut precedes a layer writes that
        layer's pool (page ids are global, one allocator)."""

        for layer in ex.cloud_layers:
            if self.model.specs[layer][0] == "attn" and layer not in self._suffix_pools:
                self._suffix_pools[layer] = ex.init_layer_pool(self.paged_spec)

    def _fused_window(self, keys: tuple, block: int):
        """One fused round of ``block`` tokens over the lanes ``keys``
        (ascending), their live buffers and the shared pools, in place; the
        lanes' lengths read ``_fused_offset`` tokens past their harvested
        ones -> per-lane tokens [R_i, block]."""

        lanes = [self._lanes[k] for k in keys]
        pools = {layer: p for layer, p in self._suffix_pools.items() if layer >= lanes[0].cut}
        lane_in = [{"logits": l._logits, "edge": l._edge, "state": l._state,
                    "lens": l._len + self._fused_offset} for l in lanes]
        if self._bgroup is not None:
            for d, l in zip(lane_in, lanes):
                d["rows"] = (l.rows, l.block)
        with self._lane_ctx(lanes):
            return self._fleet_fns[(keys, block)](
                pools, lane_in, [l._pt for l in lanes], [l._cap for l in lanes])

    def _split_fused_step(self, lanes: List["_SplitLane"], block: int,
                          rounds: int) -> Dict[object, torch.Tensor]:
        """Dispatch one fused window of ``rounds`` rounds of ``block`` tokens
        over every active pipelined lane: ``rounds`` fused rounds issued
        back to back, where the model allows graphs (``Model.graphs``)
        replays of the round's graph for ``(lane keys, block, rows per
        lane)``, captured on first use (a
        round, not the window, so that the captures a freed lane forces
        stay small) -> tokens [R_i, rounds * block] by lane key, on the
        device until the lanes' ``harvest``."""

        lanes = sorted(lanes, key=lambda l: _lane_order(l.key))
        keys = tuple(l.key for l in lanes)
        if (keys, block) not in self._fleet_fns:
            self._fleet_fns[(keys, block)] = lanes[0].ex.build_fleet_decode(
                tuple(l.cut for l in lanes), block, self._token_floor,
                offloads=tuple(l.expert_offload for l in lanes))
        t0 = clock() if self.obs is not None else 0.0
        call = None
        if self.model.graphs:
            gkey = (keys, block, tuple(l.rows for l in lanes))
            call = self._fleet_graphs.get(gkey)
            if call is None:
                call = self._fleet_graphs[gkey] = GraphedCall(
                    owner_call(self, "_fused_window", keys, block))
        dev = self.model.device
        toks = [torch.empty((l.block, rounds * block), dtype=torch.long, device=dev)
                for l in lanes]
        for r in range(rounds):
            self._fused_offset.fill_(r * block)
            if call is None:
                out = self._fused_window(keys, block)
            else:
                first = call.graph is None
                if first:
                    self._settle_prefill()
                out = call()
                if first:
                    self.graph_captures += 1
                    self.capture_s += call.capture_s
            for t, o in zip(toks, out):
                t[:, r * block:(r + 1) * block].copy_(o)
        if self.obs is not None:
            # the host cost of issuing the window (no sync added)
            self.obs.metrics.histogram(
                "sched.fused_dispatch_ms", cuts="+".join(str(l.cut) for l in lanes)
            ).observe((clock() - t0) * 1e3)
        return dict(zip(keys, toks))

    # ------------------------------------------------------------------
    # observability producers (no-ops when ``obs`` is None)
    # ------------------------------------------------------------------

    def _obs_cancel(self, robot_id: int, submit_ts: float, queued: bool = False,
                    dead: bool = False, cut: Optional[int] = None) -> None:
        if self.obs is None:
            return
        t = clock()
        m = self.obs.metrics
        m.counter("sched.cancels").inc()
        if queued:
            m.counter("sched.cancelled_queued").inc()
        if dead:
            m.counter("sched.dead_marked").inc()
        tr = self.obs.trace
        if tr is not None:
            args = {"robot": robot_id, "queued": queued, "dead": dead}
            if cut is not None:
                args["cut"] = cut
            track = f"robot {robot_id}"
            if submit_ts > 0.0:
                tr.complete(track, "cancelled", submit_ts, t, args)
            else:
                tr.instant(track, "cancelled", t, args)

    def _obs_complete(self, results: List[ChunkResult], t_end: float) -> None:
        """Stamp completions with the boundary's one clock read ``t_end``."""

        if self.obs is None or not results:
            return
        m = self.obs.metrics
        m.counter("sched.completions").inc(len(results))
        h = m.histogram("serve.chunk_latency_ms")
        tr = self.obs.trace
        for r in results:
            r.completed_ts = t_end
            h.observe((t_end - r.submitted_ts) * 1e3)
            if tr is not None:
                track = f"robot {r.robot_id}"
                args = {"robot": r.robot_id, "kind": r.kind,
                        "rounds": r.completed_round - r.submitted_round}
                if r.cut is not None:
                    args["cut"] = r.cut
                # nesting: chunk (lifetime) > queue wait > decode
                tr.complete(track, "chunk", r.submitted_ts, t_end, args)
                tr.complete(track, "queue", r.submitted_ts, r.admitted_ts)
                tr.complete(track, "decode", r.admitted_ts, t_end)

    def _obs_window_close(self, w: _ScanWindow, done: List[ChunkResult]) -> None:
        t_end = clock()
        m = self.obs.metrics
        m.histogram("sched.window_ms").observe((t_end - w.t_open) * 1e3)
        tr = self.obs.trace
        if tr is not None:
            name = f"window {self.windows}"
            if w.cloud:
                tr.complete("lane cloud", name, w.t_open, t_end,
                            {"rows": len(w.seqs), "rounds": self.scan_rounds})
            for key, seqs in w.lane_seqs.items():
                tr.complete(f"lane {self._lanes[key].label}", name, w.t_open, t_end,
                            {"rows": len(seqs), "rounds": self.scan_rounds})
        self._obs_complete(done, t_end)
        alloc = self.allocator
        m.gauge("pool.pages_in_use").set(alloc.num_in_use)
        m.gauge("pool.high_water").set(alloc.high_water)
        m.gauge("pool.page_allocs_total").set(alloc.total_allocs)
        m.gauge("pool.page_frees_total").set(alloc.total_frees)
        if alloc.num_shards > 1:
            m.gauge("pool.num_shards").set(alloc.num_shards)
            for sh, (iu, hw) in enumerate(zip(alloc.shard_in_use, alloc.shard_high_water)):
                m.gauge("pool.shard_pages_in_use", shard=str(sh)).set(iu)
                m.gauge("pool.shard_high_water", shard=str(sh)).set(hw)

    # ------------------------------------------------------------------
    # the round loop
    # ------------------------------------------------------------------

    def step(self) -> List[ChunkResult]:
        """Advance one decode round.

        ``scan_rounds == 1``: every call admits, decodes one round and
        harvests.  ``scan_rounds == R > 1``: one call per window admits and
        dispatches R rounds, the next R-2 calls return [] without touching
        the device, and the R-th syncs once and emits what the window
        finished.
        """

        if self._window is not None:
            self.round += 1
            self._window.steps_left -= 1
            if self._window.steps_left <= 0:
                return self._close_window()
            return []
        self.round += 1
        prefill = self._try_admit()
        n_cloud = len(self._seqs)
        n_split = sum(len(lane.seqs) for lane in self._lanes.values())
        if n_cloud + n_split == 0:
            return []
        rounds = self.scan_rounds
        self.mixed_rounds += rounds * (n_cloud > 0 and n_split > 0)
        self.hetero_rounds += rounds * (len(self.active_cuts) >= 2)
        self.decode_rounds += rounds
        self.windows += 1
        self.peak_active = max(self.peak_active, n_cloud + n_split)
        block = self._block_for_depth(self.n_pending)
        if self.obs is not None:
            m = self.obs.metrics
            m.counter("sched.decode_rounds").inc(rounds)
            m.counter("sched.windows").inc()
            m.gauge("sched.queue_depth").set(self.n_pending)
            m.gauge("sched.active_rows").set(n_cloud + n_split)
        done: List[ChunkResult] = []
        # serial lanes ping-pong through the host: their window runs to its
        # end here and its results ride this call's return
        for lane in [l for l in self._lanes.values() if l.seqs and not l.pipelined]:
            done.extend(lane.serial_window(block, rounds))
        if done and self.obs is not None:
            self._obs_complete(done, clock())
        w = _ScanWindow(steps_left=rounds, n_steps=rounds * block)
        if self.obs is not None:
            w.t_open = clock()
        if n_cloud:
            w.cloud = True
            if not self.is_prefill_rank:
                w.toks = self._decode_window(block, rounds)
            # pending (disaggregated) rows decode into the trash page this
            # window; they are merged, and harvested, later
            w.seqs = [s for s in self._seqs.values() if not s.pending]
        planes = [l for l in self._lanes.values() if l.seqs and l.pipelined]
        if planes:
            # the lanes decode on the decode ranks; the prefill rank takes
            # their tokens at the window's close
            if not self.is_prefill_rank:
                w.lane_toks = self._split_fused_step(planes, block, rounds)
            for lane in planes:
                w.lane_seqs[lane.key] = list(lane.seqs.values())
        if prefill:
            self._dispatch_prefill(prefill)
        self._window = w
        w.steps_left -= 1
        if w.steps_left <= 0:
            done.extend(self._close_window())
        return done

    def _close_window(self) -> List[ChunkResult]:
        """Window boundary: the one host sync, then harvest and releases.

        Sequences past their chunk kept decoding (their writes land in
        their own spare page slots, then the trash page); only the first
        ``remaining`` tokens are taken.  Dead sequences release their pages
        here and emit nothing.
        """

        w, self._window = self._window, None
        self.window_closes += 1
        done: List[ChunkResult] = []
        # the cloud rows' and every pipelined lane's tokens to the host in
        # one gather first: a lane that empties drops the fused graphs that
        # produced them
        parts = [(self._local_rows, self.rows, w.toks)] if w.cloud else []
        parts += [(self._lanes[key].block, self._lanes[key].rows, w.lane_toks.get(key))
                  for key in w.lane_seqs]
        every = self._window_tokens(parts, w.n_steps) if parts else []
        if w.cloud:
            toks = every.pop(0)
            for seq in w.seqs:
                if seq.dead:
                    continue
                take = min(seq.remaining, toks.shape[1])
                seq.tokens.extend(int(t) for t in toks[seq.row, :take])
                seq.remaining -= take
                if seq.remaining == 0:
                    self._release(seq)
                    done.append(ChunkResult(
                        robot_id=seq.robot_id,
                        tokens=np.asarray(seq.tokens, np.int64),
                        submitted_round=seq.request.submitted_round,
                        admitted_round=seq.admitted_round,
                        completed_round=self.round,
                        kind="cloud",
                        pool=self.pool_stats(),
                        submitted_ts=seq.request.submit_ts,
                        admitted_ts=seq.admit_ts,
                    ))
            for seq in w.seqs:
                if seq.dead and self._seqs.get(seq.row) is seq:
                    self._release(seq)
        for (key, seqs), toks in zip(w.lane_seqs.items(), every):
            done.extend(self._lanes[key].harvest(seqs, toks, self.round))
        if self.obs is not None:
            self._obs_window_close(w, done)
        return done

    def _window_tokens(self, parts, n_steps: int) -> List[np.ndarray]:
        """Every row's tokens of a window on the host, [R, n_steps] for each
        of ``parts`` ((rows a block, global rows R, this rank's block of the
        tokens [block, n_steps]) each: the cloud rows, a lane): the rank's
        blocks joined into one buffer, gathered over the ranks the rows are
        blocked over (one collective a window), then handed from decode
        rank 0 to the prefill rank, so that every rank harvests the same."""

        width = sum(b for b, _, _ in parts)
        toks = None
        if not self.is_prefill_rank:
            toks = torch.cat([t for _, _, t in parts], 0) if len(parts) > 1 else parts[0][2]
            toks = all_gather_cat(toks, 0, self._bgroup)
        if self._handoff is not None:
            if toks is None:
                toks = torch.empty((self._nranks * width, n_steps), dtype=torch.long,
                                   device=self.model.device)
            toks = broadcast(toks, 0, self._handoff)
        every = toks.cpu().numpy().reshape(self._nranks, width, n_steps)
        out, at = [], 0
        for b, r, _ in parts:
            out.append(every[:, at:at + b].reshape(-1, n_steps)[:r])
            at += b
        return out

    def drain(self, max_rounds: int = 10_000) -> List[ChunkResult]:
        """Run rounds until queue and batch are empty; return all results."""

        out: List[ChunkResult] = []
        rounds = 0
        while (self.n_pending or self.n_active) and rounds < max_rounds:
            out.extend(self.step())
            rounds += 1
        return out


# ---------------------------------------------------------------------------
# split lanes: partitioned robots' cloud suffixes in the shared rounds
# ---------------------------------------------------------------------------


@dataclass
class _SplitSeq:
    robot_id: int
    row: int
    remaining: int
    length: int              # resident suffix tokens (host-tracked)
    pages: List[int]
    request: ChunkRequest
    admitted_round: int
    edge_cache: object       # the robot's batch-1 edge caches (serial mode)
    tokens: List[int] = field(default_factory=list)
    dead: bool = False       # cancelled while its window was in flight
    admit_ts: float = 0.0
    x_cut: Optional[torch.Tensor] = None  # the prefill's cut activations, until flushed


class _SplitLane:
    """Batched cloud-suffix decode of one lane of partitioned robots.

    Admission, rows and pages are shared by both modes: ``reserve`` takes a
    row and pages and runs the robot's own batch-1 edge prefill, ``flush``
    prefills the reserved robots' suffixes as one batch into the shared
    pools.  A serial lane's ``serial_window`` then ping-pongs every token
    through the host; a pipelined lane installs the robots' edge caches as
    rows of its device caches and decodes in the scheduler's fused window,
    ``harvest`` taking the tokens at the boundary.

    The lane's live buffers, on the model's device: per-row recurrent
    state of its suffix (``_state``), the row-batched edge caches
    (``_edge``, pipelined), page table, lengths, capacities and float32
    logits.  They are allocated at an admission into an empty lane and
    freed when its last sequence leaves (``has_buffers``), with the fused
    graphs captured over them; a released row of a lane that keeps members
    gets capacity 0.  ``peak_bytes`` is the most its buffers held,
    ``drops`` how often they were freed.

    Over ranks the buffers hold the rank's padded block of the lane's rows
    (``block``: rank ``k`` rows ``[k B, (k + 1) B)``); every rank makes the
    same reservations and releases, runs every robot's edge prefill and
    the flushed batch's suffix prefill whole, and merges its own rows.  A
    serial robot's edge then steps on its row's rank alone, which hands
    the caches on when a doubling moves the row (``_move_edge_caches``).  A
    prefill rank holds no buffers and runs no lane kernel: its host state
    follows the decode ranks', and the lanes' tokens reach it at a
    window's close.
    """

    def __init__(self, sched: ContinuousBatchingScheduler, executor, rows: int,
                 pipelined: bool = True):
        self.sched = sched
        self.ex = executor
        self.cut = executor.cut_layer
        self.expert_offload = executor.expert_offload
        self.key = executor.lane_key
        self.rows = rows
        self.pipelined = pipelined
        self.queue: Deque[ChunkRequest] = deque()
        self.seqs: Dict[int, _SplitSeq] = {}
        self._free_rows: List[int] = list(range(rows))
        self._state = self._edge = None
        self._pt = self._len = self._cap = self._logits = None
        self.peak_bytes = 0
        self.drops = 0
        self.page_moves = 0  # doublings over ranks that moved rows and their pages
        # a serial lane whose edge layers exchange over the data ranks (split
        # experts) steps every robot's edge on every rank, each token's
        # tokens gathered first, so that the exchanges pair
        m = sched.model
        self._edge_exchanges = sched._bgroup is not None and any(
            m.layers[i].moe.split for i in executor.edge_layers if hasattr(m.layers[i], "moe"))

    @property
    def block(self) -> int:
        """The rows of the lane a rank holds: its padded block of ``rows``
        (every row in one process)."""

        return self.sched._block(self.rows)

    def _own(self, row: int) -> Optional[int]:
        return self.sched._own(row, self.rows)

    @property
    def has_buffers(self) -> bool:
        return self._pt is not None

    @property
    def buffer_bytes(self) -> int:
        """Device bytes the lane's row buffers hold now (the shared suffix
        pools are the scheduler's)."""

        return sum(t.numel() * t.element_size() for t in self._buffers())

    def _buffers(self) -> List[torch.Tensor]:
        """The lane's row buffers (none while it holds none)."""

        if self._pt is None:
            return []
        ts = [self._pt, self._len, self._cap, self._logits]
        for caches in (self._state, self._edge or {}):
            ts += [t for c in caches.values() for t in c.values()]
        return ts

    def _suffix_kv(self) -> List[torch.Tensor]:
        """The shared K and V pools of the lane's suffix attention layers."""

        pools = self.sched._suffix_pools
        return [pools[i][k] for i in self.ex.cloud_layers if i in pools for k in ("kp", "vp")]

    @property
    def _edge_on_owner(self) -> bool:
        """Whether a robot's edge steps run on its row's rank alone (a
        serial lane over ranks whose edge layers make no exchange), so
        that a row changing rank takes its edge caches along."""

        return (self.sched._bgroup is not None and not self.pipelined
                and not self._edge_exchanges)

    def grow_gathers(self, moved: bool = False) -> int:
        """The gathers a doubling of the lane's rows makes over ranks
        (``_grow_rows``; none while it holds no buffers): one a row buffer
        and, where rows change rank (``moved``), one a suffix K / V pool
        and, where edge steps stay on a row's rank, one a tensor of the
        moved robots' edge caches (``_move_edge_caches``)."""

        if self._pt is None:
            return 0
        n = len(self._buffers())
        if moved:
            n += len(self._suffix_kv())
            if self._edge_on_owner:
                n += len(_tensors(self.ex.init_edge_rows(0, 1)))
        return n

    @property
    def label(self) -> str:
        off = "+exp" + ",".join(map(str, self.expert_offload)) if self.expert_offload else ""
        return f"cut={self.cut}{off}"

    def _ensure_buffers(self) -> None:
        if self._pt is not None or self.sched.is_prefill_rank:
            return
        sched, dev, n = self.sched, self.sched.model.device, self.block
        sched._ensure_suffix_pools(self.ex)
        self._state = self.ex.init_lane_state(sched.paged_spec, n)
        if self.pipelined:
            self._edge = self.ex.init_edge_rows(n, sched.prompt_len + sched.total_tokens)
        i32 = dict(dtype=torch.int32, device=dev)
        self._pt = torch.zeros((n, sched.pages_per_req), **i32)
        self._len = torch.zeros((n,), **i32)
        self._cap = torch.zeros((n,), **i32)
        self._logits = torch.zeros((n, sched._vdim), dtype=torch.float32, device=dev)
        self.peak_bytes = max(self.peak_bytes, self.buffer_bytes)

    def _drop_buffers(self) -> None:
        """Free the lane's row buffers and state, and the fused graphs
        captured over them (nothing in flight reads them: the lane is
        empty, its last window harvested); the scheduler's shared suffix
        pools go too once no lane holds buffers.  ``_ensure_buffers``
        allocates zeros again at the next admission."""

        if self._pt is None:
            return
        self._state = self._edge = None
        self._pt = self._len = self._cap = self._logits = None
        self.drops += 1
        sched = self.sched
        for gkey in [g for g in sched._fleet_graphs if self.key in g[0]]:
            del sched._fleet_graphs[gkey]
        if not any(lane.has_buffers for lane in sched._lanes.values()):
            sched._suffix_pools.clear()

    def reset(self) -> None:
        self.queue.clear()
        self.seqs.clear()
        self._free_rows = list(range(self.rows))
        self._drop_buffers()

    def _grow_rows(self) -> None:
        """Double the lane's rows; every fused graph goes (the buffers it
        was captured over are replaced).  Over ranks each buffer is
        gathered once and re-cut to the rank's block of the new rows, and a
        row that changes rank takes its pages' suffix K/V along."""

        old, new = self.rows, self.rows * 2
        if self._pt is not None:
            grow = self.sched._regrow(old, new)

            def rows_of(caches):
                return {i: {k: grow(t) for k, t in c.items()} for i, c in caches.items()}

            self._state = rows_of(self._state)
            if self._edge is not None:
                self._edge = rows_of(self._edge)
            self._pt, self._len, self._cap, self._logits = (
                grow(t) for t in (self._pt, self._len, self._cap, self._logits))
            moved = self.sched._move_pages(self._suffix_kv(), 0, self.seqs.values(), old, new)
            if moved and self._edge_on_owner:
                self._move_edge_caches(old, new)
            self.page_moves += moved
            self.sched._fleet_graphs.clear()
            self.peak_bytes = max(self.peak_bytes, self.buffer_bytes)
        self._free_rows.extend(range(old, new))
        self.rows = new

    def _move_edge_caches(self, old: int, new: int) -> None:
        """The robots whose rows change rank as the lane's ``old`` rows are
        re-cut to ``new`` take their batch-1 edge caches to the new owner
        (a serial robot's edge steps on its row's rank alone, so the other
        ranks' copies are as its reservation left them): each rank's
        caches of its leaving rows as rows of the edge caches' shape,
        gathered over the ranks (one gather a tensor), each new owner
        taking its own."""

        sched = self.sched
        bo, bn = sched._block(old), sched._block(new)
        out, take = [[] for _ in range(sched._nranks)], []
        for seq in self.seqs.values():
            src, dst = seq.row // bo, seq.row // bn
            if src != dst:
                if dst == sched._brank:
                    take.append((seq, src, len(out[src])))
                out[src].append(seq)
        width = max(len(x) for x in out)
        mine = out[sched._brank]
        rows = self.ex.init_edge_rows(width, sched.prompt_len + sched.total_tokens)
        self.ex.merge_edge_rows(rows, [s.edge_cache for s in mine], range(len(mine)))
        every = {i: {k: all_gather_cat(t, 0, sched._bgroup) for k, t in c.items()}
                 for i, c in rows.items()}
        for seq, src, j in take:
            at = src * width + j
            seq.edge_cache = {i: {k: t[at:at + 1].clone() for k, t in c.items()}
                              for i, c in every.items()}

    def _take_row(self) -> int:
        if not self._free_rows:
            self._grow_rows()
        return self._free_rows.pop(0)

    def release(self, seq: _SplitSeq) -> None:
        """Return the pages and the row; zero the row's capacity so the
        still-batched row never writes pages a later admission reuses.  The
        lane's last member (completed or cancelled) takes the lane's
        buffers with it (``_drop_buffers``)."""

        self.sched.allocator.free(seq.pages)
        del self.seqs[seq.row]
        self._free_rows.append(seq.row)
        if self.seqs:
            loc = self._own(seq.row)
            if loc is not None:
                self._cap[loc] = 0
        else:
            self._drop_buffers()

    def reserve(self, req: ChunkRequest) -> _SplitSeq:
        sched = self.sched
        pages = sched.allocator.alloc(sched.pages_per_req)
        row = self._take_row()
        self.ex.record_chunk_bytes(sched.prompt_len, sched.total_tokens)
        # the edge prefix runs on the robot's own device: a batch-1 prefill
        # (on every decode rank; the prefill rank keeps the host state only)
        x_cut = edge_cache = None
        if not sched.is_prefill_rank:
            x_cut, edge_cache = self.ex.edge_prefill(req.obs[None], sched.total_tokens)
        seq = _SplitSeq(robot_id=req.robot_id, row=row, remaining=sched.total_tokens,
                        length=sched.prompt_len, pages=pages, request=req,
                        admitted_round=sched.round, edge_cache=edge_cache, x_cut=x_cut)
        self.seqs[row] = seq
        return seq

    def _layers_view(self) -> list:
        """The suffix's per-layer caches: the shared pool of an attention
        layer, this lane's row state of a recurrent layer."""

        pools = self.sched._suffix_pools
        return [pools[i] if self.sched.model.specs[i][0] == "attn" else self._state[i]
                for i in self.ex.cloud_layers]

    def flush(self, new: List[_SplitSeq]) -> None:
        """One batched cloud-suffix prefill over the reserved admissions,
        whole on every decode rank; each merges its own rows (the others'
        suffix K/V go to the trash page at length 0)."""

        sched = self.sched
        if sched.is_prefill_rank:
            for seq in new:
                seq.x_cut = None
            return
        self._ensure_buffers()
        dev = sched.model.device
        n, s, local = _bucket(len(new)), sched.prompt_len, self.block
        x = torch.zeros((n, s, self.ex.cfg.d_model), dtype=sched.model.dtype, device=dev)
        pt_new = np.zeros((n, sched.pages_per_req), np.int32)
        row_idx = np.full((n,), local, np.int64)  # padding and other ranks' rows: dropped
        lens = np.zeros((n,), np.int32)
        caps = np.zeros((n,), np.int32)
        for i, seq in enumerate(new):
            x[i] = seq.x_cut[0]
            seq.x_cut = None
            loc = self._own(seq.row)
            if loc is None:
                continue
            pt_new[i] = seq.pages
            row_idx[i] = loc
            lens[i] = s
            caps[i] = sched.cap_tokens
        i32 = dict(dtype=torch.int32, device=dev)
        pt_t, lens_t, caps_t = (torch.as_tensor(a, **i32) for a in (pt_new, lens, caps))
        _, logits = self.ex.suffix_prefill(x, self._layers_view(), pt_t, row_idx, lens_t, caps_t)
        keep = np.flatnonzero(row_idx < local)
        if keep.size:
            src = torch.as_tensor(keep, dtype=torch.long, device=dev)
            rows = torch.as_tensor(row_idx[keep], dtype=torch.long, device=dev)
            self._pt.index_copy_(0, rows, pt_t.index_select(0, src))
            self._len.index_copy_(0, rows, lens_t.index_select(0, src))
            self._cap.index_copy_(0, rows, caps_t.index_select(0, src))
            self._logits.index_copy_(0, rows, logits.index_select(0, src).float())
        if self.pipelined:
            # the robots' batch-1 edge caches become rows of the lane's
            # device caches (a full-row overwrite), each on its rank
            own = [(seq.edge_cache, self._own(seq.row)) for seq in new]
            self.ex.merge_edge_rows(self._edge, [c for c, loc in own if loc is not None],
                                    [loc for _, loc in own if loc is not None])
            for seq in new:
                seq.edge_cache = None

    def _result(self, seq: _SplitSeq, completed_round: int) -> ChunkResult:
        return ChunkResult(
            robot_id=seq.robot_id, tokens=np.asarray(seq.tokens, np.int64),
            submitted_round=seq.request.submitted_round, admitted_round=seq.admitted_round,
            completed_round=completed_round, kind="split", pool=self.sched.pool_stats(),
            cut=self.cut, expert_offload=self.expert_offload,
            submitted_ts=seq.request.submit_ts, admitted_ts=seq.admit_ts,
        )

    def serial_window(self, block: int, rounds: int) -> List[ChunkResult]:
        """Serial mode: ``rounds`` rounds of ``block`` tokens of per-token
        host ping-pong (each robot's batch-1 edge step, then one batched
        suffix step over the rank's block), then the window's tokens of
        every row gathered over the ranks once (and handed to the prefill
        rank) -> the chunks it completed, in completion order."""

        sched = self.sched
        steps = rounds * block
        start = [(seq, seq.remaining) for seq in self.seqs.values()]
        toks = None if sched.is_prefill_rank else np.zeros((self.block, steps), np.int64)
        done = []
        for j in range(steps):
            active = [s for s in self.seqs.values() if s.remaining > 0]
            if not active:
                break
            self._serial_token(active, toks, j)
            for seq in active:
                if seq.remaining == 0:
                    self.release(seq)
                    done.append((seq, self._result(seq, sched.round)))
        if toks is not None:
            toks = torch.as_tensor(toks, device=sched.model.device)
        every = sched._window_tokens([(self.block, self.rows, toks)], steps)[0]
        for seq, remaining in start:
            seq.tokens.extend(int(t) for t in every[seq.row, :remaining - seq.remaining])
        for seq, res in done:
            res.tokens = np.asarray(seq.tokens, np.int64)
        return [res for _, res in done]

    def _serial_token(self, active: List[_SplitSeq], toks, j: int) -> None:
        """One token of the serial ping-pong for the ``active`` sequences:
        the rank's rows' greedy tokens into column ``j`` of ``toks``, their
        edge steps, one suffix step over the rank's block."""

        sched = self.sched
        prefill = sched.is_prefill_rank
        picked: Dict[int, int] = {}
        if not prefill:
            logits = self._logits.cpu().numpy()
            for seq in active:
                loc = self._own(seq.row)
                if loc is not None:
                    ls = logits[loc].copy()
                    ls[:sched._token_floor] = -1e9
                    picked[seq.row] = int(np.argmax(ls))
                    toks[loc, j] = picked[seq.row]
            if self._edge_exchanges:
                picked = self._every_token(active, toks[:, j])
            xs = torch.zeros((self.block, 1, self.ex.cfg.d_model), dtype=sched.model.dtype,
                             device=sched.model.device)
        for seq in active:
            seq.remaining -= 1
            if seq.row in picked:
                # ping-pong: the token ships edge-ward, the edge prefix runs
                # it, the cut activation ships back
                x_cut, seq.edge_cache = self.ex.edge_step(picked[seq.row], seq.edge_cache,
                                                          seq.length)
                loc = self._own(seq.row)
                if loc is not None:
                    xs[loc] = x_cut[0]
            seq.length += 1
        if prefill:
            return
        with sched._lane_ctx([self]):
            out, _ = self.ex.suffix_step(xs, self._layers_view(), self._pt, self._len, self._cap)
        own = [loc for loc in (self._own(s.row) for s in active) if loc is not None]
        if own:
            rows = torch.as_tensor(own, dtype=torch.long, device=sched.model.device)
            self._logits.index_copy_(0, rows, out.index_select(0, rows).float())
            self._len.index_add_(0, rows, torch.ones_like(rows, dtype=torch.int32))

    def _every_token(self, active: List[_SplitSeq], mine: np.ndarray) -> Dict[int, int]:
        """Every active row's token of this step, the rank's ``mine`` [block]
        gathered over the ranks (one gather a token: a serial lane whose
        edge layers exchange over the data ranks)."""

        sched = self.sched
        every = all_gather_cat(torch.as_tensor(mine, device=sched.model.device), 0,
                               sched._bgroup).cpu().numpy()
        return {seq.row: int(every[seq.row]) for seq in active}

    def harvest(self, seqs: List[_SplitSeq], toks, completed_round: int) -> List[ChunkResult]:
        """Pipelined mode, window boundary: take each live sequence's tokens
        (``toks``: every row's [rows, steps] on the host; the over-decoded
        tail dropped), advance its length, release the completed and the
        dead (cancelled mid-window) ones."""

        done: List[ChunkResult] = []
        n_steps = toks.shape[1]
        live = [s for s in seqs if not s.dead]
        own = [loc for loc in (self._own(s.row) for s in live) if loc is not None]
        if own:
            rows = torch.as_tensor(own, dtype=torch.long, device=self._len.device)
            self._len.index_add_(0, rows, torch.full_like(rows, n_steps, dtype=torch.int32))
        for seq in live:
            take = min(seq.remaining, n_steps)
            seq.tokens.extend(int(t) for t in toks[seq.row, :take])
            seq.remaining -= take
            seq.length += take
            if seq.remaining == 0:
                self.release(seq)
                done.append(self._result(seq, completed_round))
        for seq in seqs:
            if seq.dead and self.seqs.get(seq.row) is seq:
                self.release(seq)
        return done
