"""Paged KV-cache manager (counterpart of ``repro/runtime/kv_cache.py``):
fixed-size pages, a free-list allocator, page tables.

All sequences draw fixed-size pages from one shared pool; a per-sequence
page table maps token positions to pool pages, and the paged decode kernel
(``ops.paged_decode_attention``) follows that indirection with per-sequence
lengths, so ragged sequences share one decode launch.  Bookkeeping (free
lists, page tables, lengths) is host-side Python; the pools are tensors
updated in place (the reference's ``donating_jit`` has no counterpart).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import ops


class OutOfPages(RuntimeError):
    """The pool has no free pages; the scheduler must defer admission."""


@dataclass(frozen=True)
class PagedSpec:
    """Static page-pool geometry: ``num_pages`` shared pages of
    ``page_size`` tokens; every row's page table has ``max_pages_per_seq``
    entries, so a row holds at most ``tokens_per_seq`` tokens.  The model
    adds one trash page per pool."""

    num_pages: int
    page_size: int
    max_pages_per_seq: int

    @property
    def tokens_per_seq(self) -> int:
        return self.max_pages_per_seq * self.page_size


class PageAllocator:
    """LIFO free list over a fixed pool of page ids (host-side, O(1) ops).

    ``high_water`` is the peak of pages in use since construction or the
    last ``reset_high_water``; ``total_allocs`` / ``total_frees`` are
    lifetime page counts (never reset).

    Shard-aware mode (``num_shards > 1``): page ids stay global, and the
    free list splits into per-shard LIFO lists, shard ``page //
    pages_per_shard`` (contiguous id blocks, the layout of a pool sharded
    over its page axis).  ``alloc`` steers a whole request to the
    least-loaded shard that can hold it and spills across shards only when
    none can.  Per-shard in-use and high-water counts are host counters.
    """

    def __init__(self, num_pages: int, num_shards: int = 1,
                 pages_per_shard: Optional[int] = None):
        if num_pages <= 0:
            raise ValueError("num_pages must be positive")
        if num_shards <= 0:
            raise ValueError("num_shards must be positive")
        self.num_pages = num_pages
        self.num_shards = num_shards
        self.pages_per_shard = (pages_per_shard if pages_per_shard is not None
                                else -(-num_pages // num_shards))
        if self.pages_per_shard * num_shards < num_pages:
            raise ValueError(f"{num_shards} shards x {self.pages_per_shard} pages/shard "
                             f"< {num_pages} pool pages")
        self._fill_free_lists()
        self.high_water = 0
        self.total_allocs = 0
        self.total_frees = 0

    def _fill_free_lists(self) -> None:
        self._free_by_shard: List[List[int]] = [[] for _ in range(self.num_shards)]
        for p in range(self.num_pages - 1, -1, -1):
            self._free_by_shard[self.shard_of(p)].append(p)
        self._shard_in_use = [0] * self.num_shards
        self._shard_high = [0] * self.num_shards

    def shard_of(self, page: int) -> int:
        return min(page // self.pages_per_shard, self.num_shards - 1)

    @property
    def _free(self) -> List[int]:
        """Flat view of the free lists (tests)."""

        return [p for f in self._free_by_shard for p in f]

    @property
    def num_free(self) -> int:
        return sum(len(f) for f in self._free_by_shard)

    @property
    def num_in_use(self) -> int:
        return self.num_pages - self.num_free

    @property
    def shard_in_use(self) -> List[int]:
        return list(self._shard_in_use)

    @property
    def shard_free(self) -> List[int]:
        return [len(f) for f in self._free_by_shard]

    @property
    def shard_high_water(self) -> List[int]:
        return list(self._shard_high)

    def _take(self, shard: int, n: int) -> List[int]:
        free = self._free_by_shard[shard]
        out = [free.pop() for _ in range(n)]
        self._shard_in_use[shard] += n
        self._shard_high[shard] = max(self._shard_high[shard], self._shard_in_use[shard])
        return out

    def alloc(self, n: int = 1, shard: Optional[int] = None) -> List[int]:
        """Allocate ``n`` pages.  ``shard=None``: the least-loaded shard that
        can hold all ``n`` (ties to the lowest id), else spill across shards
        least-loaded first; an explicit ``shard`` is tried first."""

        if n > self.num_free:
            raise OutOfPages(f"requested {n} pages, {self.num_free} free")
        if self.num_shards == 1:
            out = self._take(0, n)
        else:
            order = sorted(range(self.num_shards), key=lambda s: (self._shard_in_use[s], s))
            if shard is not None:
                order = [shard] + [s for s in order if s != shard]
            home = next((s for s in order if len(self._free_by_shard[s]) >= n), None)
            if home is not None:
                out = self._take(home, n)
            else:
                out, need = [], n
                for s in order:
                    take = min(need, len(self._free_by_shard[s]))
                    if take:
                        out.extend(self._take(s, take))
                        need -= take
                    if not need:
                        break
        self.total_allocs += n
        self.high_water = max(self.high_water, self.num_in_use)
        return out

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page id {p} out of range")
            s = self.shard_of(p)
            if p in self._free_by_shard[s]:
                raise ValueError(f"double free of page {p}")
            self._free_by_shard[s].append(p)
            self._shard_in_use[s] -= 1
        self.total_frees += len(pages)

    def reset_high_water(self) -> None:
        """Restart the high-water marks at the current occupancy."""

        self.high_water = self.num_in_use
        self._shard_high = list(self._shard_in_use)

    def reclaim_all(self) -> None:
        """Return every page to the free lists and restart the high-water
        mark (a scheduler reset); the reclaimed pages count as freed."""

        self.total_frees += self.num_in_use
        self._fill_free_lists()
        self.reset_high_water()


def scatter_prompt_into_pool(pool, dense, page_table, lens):
    """Scatter a dense prefilled prompt cache into the shared page pool, in
    place (the reference returns a new array).

    pool [P+1, page, KV, D] (the last page is trash); dense [B, S, KV, D]
    RoPE'd prompt K or V; page_table [B, MAXP]; lens [B] valid prompt
    tokens per row.  Positions at or beyond ``lens[b]`` go to the trash
    page.  Returns ``pool``.
    """

    p1, page = pool.shape[:2]
    b, s = dense.shape[:2]
    positions = torch.arange(s, device=pool.device)
    pidx = torch.clamp(positions // page, max=page_table.shape[1] - 1)
    slot = page_table[:, pidx].long() * page + positions % page          # [B, S]
    trash = torch.full_like(slot, (p1 - 1) * page)
    slot = torch.where(positions[None, :] < lens[:, None], slot, trash)
    flat = pool.view((p1 * page,) + tuple(pool.shape[2:]))
    flat.index_copy_(0, slot.reshape(-1), dense.reshape((b * s,) + tuple(dense.shape[2:])).to(pool.dtype))
    return pool


@dataclass
class SeqEntry:
    pages: List[int]
    length: int


class PagedKVCache:
    """One attention layer's shared KV page pool and per-sequence page
    tables.  ``write_prompt`` bulk-writes a prefilled prompt, ``append``
    one decode token per sequence, ``attend`` runs the paged decode kernel
    over the registered sequences.  Storage is flat [P*page, KV, D] and
    updated in place."""

    def __init__(self, num_pages: int, page_size: int, num_kv_heads: int, head_dim: int,
                 max_pages_per_seq: int, dtype=torch.float32, device="cuda"):
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.max_pages_per_seq = max_pages_per_seq
        self.device = torch.device(device)
        self.allocator = PageAllocator(num_pages)
        shape = (num_pages * page_size, num_kv_heads, head_dim)
        self._k = torch.zeros(shape, dtype=dtype, device=self.device)
        self._v = torch.zeros_like(self._k)
        self._seqs: Dict[int, SeqEntry] = {}

    def add_seq(self, seq_id: int) -> None:
        if seq_id in self._seqs:
            raise ValueError(f"seq {seq_id} already registered")
        self._seqs[seq_id] = SeqEntry(pages=[], length=0)

    def free_seq(self, seq_id: int) -> None:
        entry = self._seqs.pop(seq_id)
        self.allocator.free(entry.pages)

    def seq_len(self, seq_id: int) -> int:
        return self._seqs[seq_id].length

    @property
    def seq_ids(self) -> List[int]:
        return sorted(self._seqs)

    def can_admit(self, total_tokens: int) -> bool:
        """Would a sequence of ``total_tokens`` fit right now?"""

        need = -(-total_tokens // self.page_size)
        return need <= min(self.allocator.num_free, self.max_pages_per_seq)

    def _ensure_capacity(self, entry: SeqEntry, new_len: int) -> None:
        need = -(-new_len // self.page_size)
        if need > self.max_pages_per_seq:
            raise OutOfPages(f"sequence needs {need} pages > "
                             f"max_pages_per_seq={self.max_pages_per_seq}")
        if need > len(entry.pages):
            entry.pages.extend(self.allocator.alloc(need - len(entry.pages)))

    def _flat_slots(self, entry: SeqEntry, positions: np.ndarray) -> np.ndarray:
        pages = np.asarray(entry.pages, np.int64)
        return pages[positions // self.page_size] * self.page_size + positions % self.page_size

    def _scatter(self, slots: np.ndarray, k, v) -> None:
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        self._k.index_copy_(0, idx, k.to(self._k.dtype))
        self._v.index_copy_(0, idx, v.to(self._v.dtype))

    def write_prompt(self, seq_id: int, k, v) -> None:
        """Bulk-write a prefilled prompt.  k/v: [S, KV, D]."""

        entry = self._seqs[seq_id]
        s = k.shape[0]
        self._ensure_capacity(entry, entry.length + s)
        self._scatter(self._flat_slots(entry, np.arange(entry.length, entry.length + s)), k, v)
        entry.length += s

    def append(self, seq_ids: List[int], k, v) -> None:
        """Write one decode token per sequence.  k/v: [len(seq_ids), KV, D].
        Capacity for every sequence is reserved before any length moves, so
        an ``OutOfPages`` leaves the cache consistent."""

        counts: Dict[int, int] = {}
        for sid in seq_ids:
            counts[sid] = counts.get(sid, 0) + 1
        for sid, n in counts.items():
            entry = self._seqs[sid]
            self._ensure_capacity(entry, entry.length + n)
        slots = np.empty(len(seq_ids), np.int64)
        for i, sid in enumerate(seq_ids):
            entry = self._seqs[sid]
            slots[i] = self._flat_slots(entry, np.asarray([entry.length]))[0]
            entry.length += 1
        self._scatter(slots, k, v)

    def page_table(self, seq_ids: Optional[List[int]] = None) -> np.ndarray:
        """[B, max_pages_per_seq] int32; unallocated entries point at page 0."""

        ids = self.seq_ids if seq_ids is None else seq_ids
        table = np.zeros((len(ids), self.max_pages_per_seq), np.int32)
        for i, sid in enumerate(ids):
            pages = self._seqs[sid].pages
            table[i, : len(pages)] = pages
        return table

    def lengths(self, seq_ids: Optional[List[int]] = None) -> np.ndarray:
        ids = self.seq_ids if seq_ids is None else seq_ids
        return np.asarray([self._seqs[sid].length for sid in ids], np.int32)

    def kernel_view(self):
        """(k_pages, v_pages) [P, page, KV, D] views of the storage."""

        shape = (self.num_pages, self.page_size, self.num_kv_heads, self.head_dim)
        return self._k.view(shape), self._v.view(shape)

    def attend(self, q, seq_ids: Optional[List[int]] = None, *, window: int = 0,
               logit_cap: float = 0.0):
        """Ragged paged decode attention, q [B, H, D] in ``seq_ids`` order."""

        kp, vp = self.kernel_view()
        i32 = dict(dtype=torch.int32, device=self.device)
        return ops.paged_decode_attention(
            q, kp, vp, torch.as_tensor(self.page_table(seq_ids), **i32),
            torch.as_tensor(self.lengths(seq_ids), **i32), window=window, logit_cap=logit_cap,
        )
