"""Continuous-batching scheduler on the paged KV substrate, cloud lane
(counterpart of ``repro/runtime/scheduler.py``).

Sequences are backed by page tables over one shared KV page pool (the
model's paged decode mode), and

  * **admission** is bounded only by free pages: pending requests are
    prefilled in one batched call (padded to a power of two) and their
    prompt KV is scattered into the pool pages they were given
    (``Model.merge_prefill_into_paged``);
  * **batch rows** carry only O(1) per-sequence state (last logits, page
    table row, length, capacity, Mamba state); when more sequences are
    resident than rows, the row buffers double;
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
``len``, ``pt``, ``cap``, Mamba ``h`` / ``conv``) is a static buffer that the
graph reads and writes in place; growing the rows re-allocates them and
drops the graphs.  Admission runs eagerly, once per boundary
(``admit_ms`` keeps its host time).  On a CPU model the same round runs
eagerly.

**Observability.**  ``obs=Observability()`` stamps submission, admission,
window close, completion and cancels with ``obs.clock``, only at those
host-owned boundaries (no device syncs added), into the metrics registry
(``serve.chunk_latency_ms``, ``serve.queue_wait_ms``, ``sched.*`` counters,
``pool.*`` gauges) and, when tracing, spans on one track per robot (chunk >
queue > decode) and one for the lane (windows).

Partitioned lanes, the mesh and prefill disaggregation are not ported: the
counters only they move (``mixed_rounds``, ``hetero_rounds``) stay 0.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import EpisodeTokenizer
from repro_torch.models.model import Model
from repro_torch.obs.clock import clock
from repro_torch.runtime.graphs import GraphedCall, owner_call
from repro_torch.runtime.kv_cache import PageAllocator, PagedSpec

DEFAULT_PAGE_SIZE = 16


def _bucket(n: int) -> int:
    """Smallest power of two >= n (admission batch sizes)."""

    b = 1
    while b < n:
        b *= 2
    return b


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
    """KV page-pool utilization snapshot (the per-shard tuples stay None:
    the port's pool is single-shard)."""

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
    kind: str = "cloud"
    pool: Optional[PoolStats] = None
    cut: Optional[int] = None
    expert_offload: Tuple[int, ...] = ()
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
    admit_ts: float = 0.0


@dataclass
class _ScanWindow:
    """One dispatched multi-round decode whose tokens await harvest."""

    steps_left: int
    n_steps: int                            # tokens decoded per row
    toks: Optional[torch.Tensor] = None     # [rows, n_steps]
    seqs: List[_Sequence] = field(default_factory=list)
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
    ):
        self.model = model
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
        self.mixed_rounds = 0        # split lanes only: stays 0
        self.hetero_rounds = 0       # split lanes only: stays 0
        self.decode_rounds = 0       # rounds where any sequence decoded
        self.cancelled = 0           # sequences cancelled
        self.deferred = 0            # submissions admitted late on purpose
        self.windows = 0             # dispatched scan windows
        self.window_closes = 0       # harvested (synced) scan windows
        # CUDA graphs of the decode round, and the host time of admissions
        self.graph_captures = 0
        self.capture_s = 0.0
        self.admit_ms: List[float] = []

        # a request holds prompt + chunk tokens resident
        self.page_size = page_size
        self.pages_per_req = -(-(self.prompt_len + self.total_tokens) // page_size)
        pool = num_pages if num_pages is not None else self.pages_per_req * max_slots
        self.allocator = PageAllocator(pool)
        self.paged_spec = PagedSpec(num_pages=pool, page_size=page_size,
                                    max_pages_per_seq=self.pages_per_req)
        self.cap_tokens = self.pages_per_req * page_size

        self._queue: Deque[ChunkRequest] = deque()
        self._seqs: Dict[int, _Sequence] = {}    # row -> sequence
        self._free_rows: List[int] = list(range(max_slots))
        self._order = 0
        self._window: Optional[_ScanWindow] = None
        self._token_floor = tokenizer.action_base
        self._graphs: Dict[Tuple[int, int], GraphedCall] = {}  # (block, rows)

        # live batch state: logits rows + the paged cache (shared pools,
        # per-row page table / length / capacity; zeros mean inactive)
        self.rows = max_slots
        vdim = model.embed.table.shape[0]  # the padded vocab, head tied or not
        self._logits = torch.zeros((self.rows, vdim), dtype=model.dtype, device=model.device)
        self._pcache = model.init_paged_cache(self.rows, self.paged_spec)

    # ------------------------------------------------------------------
    # request interface
    # ------------------------------------------------------------------

    def submit(self, robot_id: int, qd: np.ndarray, tau: np.ndarray,
               defer_rounds: int = 0) -> None:
        """Queue one chunk request for ``robot_id`` (qd/tau [1, N]).
        ``defer_rounds`` delays admission, not submission order."""

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
        self._queue.append(req)

    def cancel(self, robot_id: int) -> bool:
        """Cancel ``robot_id``'s queued or in-flight request.

        A queued request is removed.  An in-flight sequence is freed at
        once, unless it belongs to the dispatched window: its rounds still
        write its pages and row, so it is only marked dead and the boundary
        releases it, emitting no result.  Returns ``False`` when nothing
        was in flight (the chunk already completed): nothing is freed twice.
        """

        for req in self._queue:
            if req.robot_id == robot_id:
                self._queue.remove(req)
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
        return False

    def submit_batch(self, robot_ids, qd: np.ndarray, tau: np.ndarray,
                     defer_rounds=None) -> None:
        """Queue requests for many robots (qd/tau [n, N]); the queue after
        this call is that of ``n`` serial ``submit`` calls in row order.
        Obs stamps the batch with one clock read."""

        robot_ids = np.asarray(robot_ids, np.int64)
        n = int(robot_ids.shape[0])
        if n == 0:
            return
        obs_toks = np.concatenate([self.tok.encode_state(np.asarray(qd)),
                                   self.tok.encode_state(np.asarray(tau))], axis=1)
        defer = (np.zeros(n, np.int64) if defer_rounds is None
                 else np.asarray(defer_rounds, np.int64))
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
            self._queue.append(ChunkRequest(
                int(robot_ids[i]), obs_toks[i], self.round, order=self._order,
                earliest_round=self.round + d + 1 if d > 0 else 0, submit_ts=ts,
            ))
            if d > 0:
                self.deferred += 1

    def cancel_batch(self, robot_ids) -> np.ndarray:
        """Element ``i`` is ``cancel(robot_ids[i])``, in order."""

        ids = np.asarray(robot_ids)
        return np.fromiter((self.cancel(int(r)) for r in ids), dtype=bool, count=len(ids))

    @property
    def n_pending(self) -> int:
        return len(self._queue)

    @property
    def n_active(self) -> int:
        return len(self._seqs)

    def pool_stats(self) -> PoolStats:
        a = self.allocator
        return PoolStats(pages_in_use=a.num_in_use, pages_free=a.num_free,
                         high_water=a.high_water)

    def reset(self) -> None:
        """Drop all queued and in-flight work; keep the buffers and graphs
        (zeroed in place).  Lifetime page counters survive; the high-water
        mark restarts."""

        self._queue.clear()
        self._seqs.clear()
        self._free_rows = list(range(self.rows))
        self.allocator.reclaim_all()
        self._window = None
        self._logits.zero_()
        self._pcache["len"].zero_()
        self._pcache["cap"].zero_()
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

    def _grow_rows(self) -> None:
        """Double the row buffers (the page pools are shared and do not
        grow); the graphs of the old row count go with the old buffers."""

        old, new = self.rows, self.rows * 2

        def grow(t, dim=0):
            pad = list(t.shape)
            pad[dim] = new - old
            return torch.cat([t, t.new_zeros(pad)], dim)

        self._logits = grow(self._logits)
        for name in ("len", "pt", "cap"):
            self._pcache[name] = grow(self._pcache[name])
        for name in ("h", "conv"):
            if name in self._pcache:
                self._pcache[name] = grow(self._pcache[name], 1)
        self._graphs.clear()
        self._free_rows.extend(range(old, new))
        self.rows = new

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

    def _try_admit(self) -> None:
        """Admit pending requests FIFO while a request's pages are free; a
        head whose ``earliest_round`` lies ahead holds the queue this round.
        The admitted prompts prefill as one batch of ``_bucket(n)`` rows
        (padding rows dropped by the merge), eagerly."""

        new: List[_Sequence] = []
        while (self.allocator.num_free >= self.pages_per_req and self._queue
               and self._queue[0].earliest_round <= self.round):
            new.append(self._reserve(self._queue.popleft()))
        if not new:
            return
        if self.obs is not None:
            # one clock read per admission boundary
            t_adm = clock()
            m = self.obs.metrics
            m.counter("sched.admissions").inc(len(new))
            qw = m.histogram("serve.queue_wait_ms")
            for seq in new:
                seq.admit_ts = t_adm
                qw.observe((t_adm - seq.request.submit_ts) * 1e3)
        t0 = clock()
        n = _bucket(len(new))
        obs = np.zeros((n, self.prompt_len), np.int64)
        pt_new = np.zeros((n, self.pages_per_req), np.int32)
        row_idx = np.full((n,), self.rows, np.int64)  # padding rows: dropped
        lens = np.zeros((n,), np.int32)
        caps = np.zeros((n,), np.int32)
        for i, seq in enumerate(new):
            obs[i] = seq.request.obs
            pt_new[i] = seq.pages
            row_idx[i] = seq.row
            lens[i] = self.prompt_len
            caps[i] = self.cap_tokens
        dev = self.model.device
        logits, dcache = self.model.prefill({"tokens": torch.as_tensor(obs, device=dev)}, extra=0)
        self.model.merge_prefill_into_paged(dcache, self._pcache, pt_new, row_idx, lens, caps)
        rows = torch.as_tensor(row_idx[: len(new)], device=dev)
        self._logits.index_copy_(0, rows, logits[: len(new), -1])
        self.admit_ms.append((clock() - t0) * 1e3)

    def _release(self, seq: _Sequence) -> None:
        """Return pages and row; zero the row's capacity (in place) so the
        still-batched row never writes pages a later admission reuses."""

        self.allocator.free(seq.pages)
        del self._seqs[seq.row]
        self._free_rows.append(seq.row)
        self._pcache["cap"][seq.row] = 0

    def _round(self, block: int) -> torch.Tensor:
        """One decode round of ``block`` greedy tokens over every row, on the
        live buffers in place -> tokens [rows, block]."""

        toks, logits, cache = self.model.decode_chunk(
            self._logits[:, None], self._pcache, block, self._token_floor
        )
        self._logits.copy_(logits[:, -1])
        self._pcache["len"].copy_(cache["len"])
        return toks

    def _decode_round(self, block: int) -> torch.Tensor:
        """``_round`` eagerly on a CPU model; on a CUDA model a replay of its
        graph for ``(block, rows)``."""

        if self.model.device.type != "cuda":
            return self._round(block)
        call = self._graphs.get((block, self.rows))
        if call is None:
            call = self._graphs[(block, self.rows)] = GraphedCall(owner_call(self, "_round", block))
        first = call.graph is None
        toks = call()
        if first:
            self.graph_captures += 1
            self.capture_s += call.capture_s
        return toks

    def _decode_window(self, block: int, rounds: int) -> torch.Tensor:
        """``rounds`` decode rounds issued back to back -> tokens
        [rows, rounds * block]; nothing waits for the device."""

        toks = torch.empty((self.rows, rounds * block), dtype=torch.long,
                           device=self.model.device)
        for r in range(rounds):
            toks[:, r * block:(r + 1) * block].copy_(self._decode_round(block))
        return toks

    # ------------------------------------------------------------------
    # observability producers (no-ops when ``obs`` is None)
    # ------------------------------------------------------------------

    def _obs_cancel(self, robot_id: int, submit_ts: float, queued: bool = False,
                    dead: bool = False) -> None:
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
                # nesting: chunk (lifetime) > queue wait > decode
                tr.complete(track, "chunk", r.submitted_ts, t_end, args)
                tr.complete(track, "queue", r.submitted_ts, r.admitted_ts)
                tr.complete(track, "decode", r.admitted_ts, t_end)

    def _obs_window_close(self, w: _ScanWindow, done: List[ChunkResult]) -> None:
        t_end = clock()
        m = self.obs.metrics
        m.histogram("sched.window_ms").observe((t_end - w.t_open) * 1e3)
        tr = self.obs.trace
        if tr is not None and w.toks is not None:
            tr.complete("lane cloud", f"window {self.windows}", w.t_open, t_end,
                        {"rows": len(w.seqs), "rounds": self.scan_rounds})
        self._obs_complete(done, t_end)
        alloc = self.allocator
        m.gauge("pool.pages_in_use").set(alloc.num_in_use)
        m.gauge("pool.high_water").set(alloc.high_water)
        m.gauge("pool.page_allocs_total").set(alloc.total_allocs)
        m.gauge("pool.page_frees_total").set(alloc.total_frees)

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
        self._try_admit()
        n_cloud = len(self._seqs)
        if n_cloud == 0:
            return []
        rounds = self.scan_rounds
        self.decode_rounds += rounds
        self.windows += 1
        self.peak_active = max(self.peak_active, n_cloud)
        block = self._block_for_depth(self.n_pending)
        if self.obs is not None:
            m = self.obs.metrics
            m.counter("sched.decode_rounds").inc(rounds)
            m.counter("sched.windows").inc()
            m.gauge("sched.queue_depth").set(self.n_pending)
            m.gauge("sched.active_rows").set(n_cloud)
        w = _ScanWindow(steps_left=rounds, n_steps=rounds * block)
        if self.obs is not None:
            w.t_open = clock()
        w.toks = self._decode_window(block, rounds)
        w.seqs = list(self._seqs.values())
        self._window = w
        w.steps_left -= 1
        if w.steps_left <= 0:
            return self._close_window()
        return []

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
        toks = w.toks.cpu().numpy()
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
        if self.obs is not None:
            self._obs_window_close(w, done)
        return done

    def drain(self, max_rounds: int = 10_000) -> List[ChunkResult]:
        """Run rounds until queue and batch are empty; return all results."""

        out: List[ChunkResult] = []
        rounds = 0
        while (self.n_pending or self.n_active) and rounds < max_rounds:
            out.extend(self.step())
            rounds += 1
        return out
