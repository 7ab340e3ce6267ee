"""Launcher of the hand-written causal flash attention kernel
(``csrc/flash_attention.cu``; replaces ``repro/kernels/flash_attention.py``).

q [B, S, H, D], k/v [B, S, KV, D] -> [B, S, H, D]; GQA by ``h // (H/KV)``,
any S (the ragged edge is masked in the kernel).  bf16 runs on the tensor
cores, float32 on a scalar body; the tile plan comes from
``_lib.flash_plan`` (host ints only) and the kernel refuses a plan that
does not fit it.  Serves the port's prefill and, with ``with_lse``, the
forward of the training attention (``ops.flash_attention_train``), which
also takes each row's log-sum-exp (float32 [B, H, S]) for the backward
kernel.  Only CUDA tensors are accepted.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib

NAME = "flash_attention"


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0, with_lse: bool = False):
    """-> out, or (out, lse) with ``with_lse``."""

    b, s, h, d = q.shape
    kv = k.shape[2]
    code = _lib.check_attention_args(q, k, v)
    if k.shape != (b, s, kv, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    if h % kv:
        raise ValueError(f"H={h} must be a multiple of KV={kv}")
    plan = _lib.flash_plan(b, s, h, kv, d, q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    status = _lib.load(NAME)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, h, kv, d,
        int(bool(causal)), int(window), d**-0.5, float(logit_cap), code,
        plan.rows, plan.warps, plan.key_tile, *plan.grid,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _lib.check(status, NAME)
    _lib.LAUNCHES[NAME] += 1
    return (out, lse) if with_lse else out
