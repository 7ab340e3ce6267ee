"""KV page-pool geometry and the prompt scatter (counterpart of the first
part of ``repro/runtime/kv_cache.py``).  The page allocator and the
per-layer ``PagedKVCache`` come with the continuous-batching scheduler.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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
