"""Launcher of the hand-written dense decode attention kernel
(``csrc/decode_attention.cu``; replaces ``repro/kernels/decode_attention.py``).

q [B, H, D] attends cache [B, S, KV, D] over its first ``cache_len``
positions: one int for the whole batch (the single-robot serving loop) or a
[B] int32 tensor (ragged rows).  Only CUDA tensors are accepted.

The KV length is split over blocks by ``_lib.decode_splits`` from host
integers only (``cache_len`` when it is an int, else S); a split call runs
the split kernel and then the combine kernel.  ``_lib.LAUNCHES`` counts one
per call of this function, whatever the number of kernels it runs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib

NAME = "decode_attention"
_fn = None  # the C entry point, once loaded


def decode_attention(q, cache_k, cache_v, *, cache_len, window: int = 0,
                     logit_cap: float = 0.0):
    global _fn
    b, h, d = q.shape
    _, s, kv, dk = cache_k.shape
    lens = cache_len if isinstance(cache_len, torch.Tensor) else None
    code = _lib.check_attention_args(q, cache_k, cache_v, ints=() if lens is None else (lens,))
    if cache_v.shape != cache_k.shape or cache_k.shape[0] != b or dk != d:
        raise ValueError(f"cache shapes {tuple(cache_k.shape)}/{tuple(cache_v.shape)} vs q {tuple(q.shape)}")
    if h % kv or h // kv > 16:
        raise ValueError(f"H={h} must be a multiple of KV={kv}, at most 16 per KV head")
    if lens is None:
        len_all = max_len = int(cache_len)
        if not 0 <= len_all <= s:
            raise ValueError(f"cache_len {len_all} outside [0, {s}]")
    elif lens.shape != (b,):
        raise ValueError(f"cache_len has shape {tuple(lens.shape)}, expected ({b},)")
    else:
        len_all, max_len = 0, s
    n_split, split_len = _lib.decode_splits(b * kv, h // kv, max_len)
    out = torch.empty_like(q)
    ws = _lib.decode_workspace(q, b * kv, n_split, h // kv, d)
    if _fn is None:
        _fn = _lib.load(NAME)
    status = _fn(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        None if lens is None else lens.data_ptr(), len_all, out.data_ptr(),
        None if ws is None else ws.data_ptr(), b, s, h, kv, d, int(window), d**-0.5,
        float(logit_cap), n_split, split_len, code,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _lib.check(status, NAME)
    _lib.LAUNCHES[NAME] += 1
    return out
