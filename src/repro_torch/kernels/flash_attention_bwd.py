"""Launcher of the hand-written flash-attention backward
(``csrc/flash_attention_bwd.cu``; the port's own kernel: the JAX package
trains through a jnp custom VJP, ``repro/models/attention.py:261``
``strip_bwd``, with no Pallas counterpart).

q [B, S, H, D], k/v [B, S, KV, D], out and dout like q, lse float32
[B, H, S] (the forward kernel's, ``flash_attention(..., with_lse=True)``)
-> (dq, dk, dv) like q, k, v.  float32 or bf16, every sum in float32; GQA,
causal or not, window, softcap, any S.  bf16 runs on the tensor cores
(``mma.sync``; P and dS rounded to bf16 before their products), float32 on
scalar FMAs.  One call is two launches on the current stream in bf16
(delta, then the dk / dv and dq blocks together), three when the plan
splits a KV head's query heads over several dk / dv blocks (their float32
partials, in a workspace allocated here, are summed by a reduce pass), and
three in float32 (delta, dk / dv, dq); it counts as one.  The plan comes from
``_lib.flash_bwd_plan``.  Only CUDA tensors are accepted.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib

NAME = "flash_attention_bwd"


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0):
    b, s, h, d = q.shape
    kv = k.shape[2]
    code = _lib.check_attention_args(q, k, v, out, dout)
    if k.shape != (b, s, kv, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out/dout shapes {tuple(out.shape)}/{tuple(dout.shape)} vs q "
                         f"{tuple(q.shape)}")
    if h % kv:
        raise ValueError(f"H={h} must be a multiple of KV={kv}")
    _lib.check_tensors(lse, align=4)
    if lse.dtype != torch.float32 or lse.shape != (b, h, s) or lse.device != q.device:
        raise ValueError(f"lse must be float32 [B, H, S] = {(b, h, s)} on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    plan = _lib.flash_bwd_plan(b, s, h, kv, d, q.dtype)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws = None  # the splits' float32 partials of dk, then dv
    if plan.splits > 1:
        ws = torch.empty(2 * plan.splits * k.numel(), dtype=torch.float32, device=q.device)
    status = _lib.load(NAME)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if ws is None else ws.data_ptr(),
        b, s, h, kv, d, int(bool(causal)), int(window), d**-0.5, float(logit_cap), code,
        plan.q_tile, plan.k_tile, plan.splits, plan.grid_dq, plan.grid_dkdv,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _lib.check(status, NAME)
    _lib.LAUNCHES[NAME] += 1
    return dq, dk, dv
