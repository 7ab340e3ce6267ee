"""Launcher of the hand-written dense decode attention kernel
(``csrc/decode_attention.cu``; replaces ``repro/kernels/decode_attention.py``).

q [B, H, D] attends cache [B, S, KV, D] over its first ``cache_len``
positions: one int for the whole batch (the single-robot serving loop) or a
[B] int32 tensor (ragged rows).  Only CUDA tensors are accepted.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib

NAME = "decode_attention"


def decode_attention(q, cache_k, cache_v, *, cache_len, window: int = 0,
                     logit_cap: float = 0.0):
    b, h, d = q.shape
    _, s, kv, dk = cache_k.shape
    _lib.check_attention_args(q, cache_k, cache_v)
    if cache_v.shape != cache_k.shape or cache_k.shape[0] != b or dk != d:
        raise ValueError(f"cache shapes {tuple(cache_k.shape)}/{tuple(cache_v.shape)} vs q {tuple(q.shape)}")
    if h % kv or h // kv > 16:
        raise ValueError(f"H={h} must be a multiple of KV={kv}, at most 16 per KV head")
    if isinstance(cache_len, torch.Tensor):
        _lib.check_int_vector(cache_len, "cache_len", b, q.device)
        lens_ptr, len_all = cache_len.data_ptr(), 0
    else:
        len_all = int(cache_len)
        if not 0 <= len_all <= s:
            raise ValueError(f"cache_len {len_all} outside [0, {s}]")
        lens_ptr = None
    out = torch.empty_like(q)
    status = _lib.load(NAME)(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), lens_ptr, len_all,
        out.data_ptr(), b, s, h, kv, d, int(window), d**-0.5, float(logit_cap),
        _lib.dtype_code(q), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _lib.check(status, NAME)
    _lib.LAUNCHES[NAME] += 1
    return out
