"""Launcher of the hand-written paged decode attention kernel
(``csrc/paged_attention.cu``; replaces ``repro/kernels/paged_attention.py``).

Layout, as in the reference:
  q           [B, H, D]           one new query token per row
  k/v pages   [P, page, KV, D]    the shared page pool
  page_table  [B, MAXP] int32     page_table[b, i] holds tokens [i*page, (i+1)*page)
  cache_lens  [B] int32           valid tokens per row (0 -> the row's output is 0)

Only CUDA tensors are accepted; ``kernels.ops`` sends CPU tensors to the
plain version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib

NAME = "paged_attention"


def paged_decode_attention(q, k_pages, v_pages, page_table, cache_lens, *,
                           window: int = 0, logit_cap: float = 0.0):
    b, h, d = q.shape
    _, page, kv, dk = k_pages.shape
    _lib.check_attention_args(q, k_pages, v_pages)
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)}/{tuple(v_pages.shape)} vs q {tuple(q.shape)}")
    if h % kv or h // kv > 16:
        raise ValueError(f"H={h} must be a multiple of KV={kv}, at most 16 per KV head")
    _lib.check_int_vector(page_table, "page_table", b, q.device)
    _lib.check_int_vector(cache_lens, "cache_lens", b, q.device)
    if page_table.dim() != 2:
        raise ValueError("page_table must be [B, MAXP]")
    out = torch.empty_like(q)
    status = _lib.load(NAME)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        cache_lens.data_ptr(), out.data_ptr(), b, h, kv, d, page, page_table.shape[1],
        int(window), d**-0.5, float(logit_cap), _lib.dtype_code(q),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _lib.check(status, NAME)
    _lib.LAUNCHES[NAME] += 1
    return out
