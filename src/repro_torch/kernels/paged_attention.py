"""Launcher of the hand-written paged decode attention kernel
(``csrc/paged_attention.cu``; replaces ``repro/kernels/paged_attention.py``).

Layout, as in the reference:
  q           [B, H, D]           one new query token per row
  k/v pages   [P, page, KV, D]    the shared page pool
  page_table  [B, MAXP] int32     page_table[b, i] holds tokens [i*page, (i+1)*page)
  cache_lens  [B] int32           valid tokens per row (0 -> the row's output is 0)

Only CUDA tensors are accepted; ``kernels.ops`` sends CPU tensors to the
plain version in ``kernels.ref``.

The table's MAXP * page slots are split over blocks in whole pages by
``_lib.decode_splits`` (host integers only; no length is read from the
device); a split call runs the split kernel and then the combine kernel.
``_lib.LAUNCHES`` counts one per call of this function, whatever the
number of kernels it runs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib

NAME = "paged_attention"
_fn = None  # the C entry point, once loaded


def paged_decode_attention(q, k_pages, v_pages, page_table, cache_lens, *,
                           window: int = 0, logit_cap: float = 0.0):
    global _fn
    b, h, d = q.shape
    _, page, kv, dk = k_pages.shape
    code = _lib.check_attention_args(q, k_pages, v_pages, ints=(page_table, cache_lens))
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)}/{tuple(v_pages.shape)} vs q {tuple(q.shape)}")
    if h % kv or h // kv > 16:
        raise ValueError(f"H={h} must be a multiple of KV={kv}, at most 16 per KV head")
    if page_table.dim() != 2 or page_table.shape[0] != b or cache_lens.shape != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} must be [B, MAXP] and "
                         f"cache_lens {tuple(cache_lens.shape)} [B], B = {b}")
    maxp = page_table.shape[1]
    n_split, split_len = _lib.decode_splits(b * kv, h // kv, maxp * page, page)
    out = torch.empty_like(q)
    ws = _lib.decode_workspace(q, b * kv, n_split, h // kv, d)
    if _fn is None:
        _fn = _lib.load(NAME)
    status = _fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        cache_lens.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(), b, h,
        kv, d, page, maxp, int(window), d**-0.5, float(logit_cap), n_split, split_len, code,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _lib.check(status, NAME)
    _lib.LAUNCHES[NAME] += 1
    return out


def paged_decode_attention_sharded(q, k_pages, v_pages, page_table, cache_lens, *, mesh,
                                   window: int = 0, logit_cap: float = 0.0):
    """Rows sharded over the mesh's ``data`` axis (the reference's
    ``shard_map`` of ``kernels/paged_attention.py:162``): the B rows split
    into the ``mesh.local_shards`` contiguous blocks this process holds
    (every data shard in one process; one, its own rows, on a data rank,
    ``launch.dist.RankGrid``), each through ``ops.paged_decode_attention``
    (one launch of the kernel a block on CUDA, the plain version on the
    CPU) against the whole pool with its global page ids; the blocks'
    outputs concatenate.  Decode attention is per-row math, so on the CPU
    the result equals the unsharded call bit for bit; on CUDA a block may
    take another split plan (``_lib.decode_splits`` reads its rows).  B must
    divide by the data size."""

    from repro_torch.kernels import ops

    n = mesh.local_shards
    b = q.shape[0]
    if b % n:
        raise ValueError(f"{b} rows do not divide over a data axis of {n}")
    rows = b // n
    outs = [ops.paged_decode_attention(q[i:i + rows], k_pages, v_pages, page_table[i:i + rows],
                                       cache_lens[i:i + rows], window=window,
                                       logit_cap=logit_cap)
            for i in range(0, b, rows)]
    return outs[0] if n == 1 else torch.cat(outs, 0)
