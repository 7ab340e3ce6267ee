"""Dispatch for the hand-written kernels: the tensor's device decides.

A CUDA tensor goes to the hand-written Hopper kernel, which launches or
raises; a CPU tensor goes to the plain PyTorch version in ``kernels.ref``.
Nothing here checks whether a GPU exists and nothing falls back: any other
device raises.  ``flash_attention_train`` is the differentiable attention
of the training path: the flash forward kernel (keeping each row's
log-sum-exp) and the flash backward kernel on the card, their plain
versions on the CPU.  ``mamba_scan`` is differentiable in the same way when
grad is enabled and an input requires it: the scan kernel keeping the state
entering each chunk, then the hand-written scan backward on the card;
``ref.mamba_scan_ref`` and ``ref.mamba_scan_bwd_ref`` on the CPU.  Without
grad (serving) it is the forward kernel alone.  ``LAUNCHES`` counts kernel
launches by name (plain-version calls never count); ``reset_launch_counts``
zeroes it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import mamba_scan_bwd as _msb
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rolling_stats as _rs

LAUNCHES = _lib.LAUNCHES
reset_launch_counts = _lib.reset_launch_counts


def _on_cuda(t, what: str = "attention") -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no {what} path for device {t.device}")


def flash_attention(q, k, v, *, causal=True, window=0, logit_cap=0.0):
    """Causal self-attention [B,S,H,D] x [B,S,KV,D]^2 -> [B,S,H,D] (prefill)."""

    fn = _fa.flash_attention if _on_cuda(q) else _ref.flash_attention_ref
    return fn(q, k, v, causal=causal, window=window, logit_cap=logit_cap)


class _FlashTrain(torch.autograd.Function):
    """Attention whose backward recomputes P from the saved log-sum-exp
    (the reference's custom-VJP strip, repro/models/attention.py:198-289)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kw = dict(causal=causal, window=window, logit_cap=logit_cap)
        if _on_cuda(q):
            out, lse = _fa.flash_attention(q, k, v, with_lse=True, **kw)
        else:
            out, lse = _ref.flash_attention_lse_ref(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        fn = _fab.flash_attention_bwd if _on_cuda(q) else _ref.flash_attention_bwd_ref
        dq, dk, dv = fn(q, k, v, out, lse, dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, *, causal=True, window=0, logit_cap=0.0):
    """``flash_attention`` with a gradient: [B,S,H,D] x [B,S,KV,D]^2 ->
    [B,S,H,D]; dq, dk, dv come from the flash backward (the kernel on a
    CUDA tensor, ``ref.flash_attention_bwd_ref`` on a CPU tensor)."""

    return _FlashTrain.apply(q, k, v, bool(causal), int(window), float(logit_cap))


def decode_attention(q, cache_k, cache_v, *, cache_len, window=0, logit_cap=0.0):
    """One-token decode q [B,H,D] over dense slabs [B,S,KV,D]; ``cache_len``
    is an int for the batch or a [B] int32 tensor."""

    fn = _dec.decode_attention if _on_cuda(q) else _ref.decode_attention_ref
    return fn(q, cache_k, cache_v, cache_len=cache_len, window=window, logit_cap=logit_cap)


def paged_decode_attention(q, k_pages, v_pages, page_table, cache_lens, *,
                           window=0, logit_cap=0.0):
    """Ragged one-token decode over the shared page pool."""

    fn = _pa.paged_decode_attention if _on_cuda(q) else _ref.paged_decode_attention_ref
    return fn(q, k_pages, v_pages, page_table, cache_lens, window=window, logit_cap=logit_cap)


class _MambaScanTrain(torch.autograd.Function):
    """The scan with its gradients: the forward keeps the state entering
    each chunk, from which the backward recomputes what it needs."""

    @staticmethod
    def forward(ctx, x, dt, a, bm, c, h0, chunk):
        ctx.set_materialize_grads(False)  # hT unused by the loss: its cotangent stays None
        x, dt, a, bm, c = (t.contiguous() for t in (x, dt, a, bm, c))
        h0 = None if h0 is None else h0.contiguous()
        fn = _ms.mamba_scan if _on_cuda(x, "mamba_scan") else _ref.mamba_scan_ref
        y, h_t, h_in = fn(x, dt, a, bm, c, h0=h0, chunk=chunk, with_states=True)
        ctx.save_for_backward(x, dt, a, bm, c, h_in)
        ctx.chunk, ctx.has_h0 = chunk, h0 is not None
        return y, h_t

    @staticmethod
    def backward(ctx, dy, dh_t):
        x, dt, a, bm, c, h_in = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dh_t = None if dh_t is None else dh_t.contiguous()
        fn = _msb.mamba_scan_bwd if _on_cuda(x, "mamba_scan") else _ref.mamba_scan_bwd_ref
        dx, ddt, da, dbm, dc, dh0 = fn(x, dt, a, bm, c, h_in, dy, dh_t, chunk=ctx.chunk)
        return dx, ddt, da, dbm, dc, dh0 if ctx.has_h0 else None, None


def mamba_scan(x, dt, a, bm, c, h0=None, chunk: int = 256):
    """Chunked SSD scan (Mamba-2) -> (y [B,S,H,P], hT [B,H,P,N]); starts
    from ``h0`` [B,H,P,N] when given.  ``min(chunk, S)`` must divide S.
    Differentiable (``_MambaScanTrain``) when grad is enabled and an input
    requires it."""

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, a, bm, c, h0)):
        return _MambaScanTrain.apply(x, dt, a, bm, c, h0, int(chunk))
    fn = _ms.mamba_scan if _on_cuda(x, "mamba_scan") else _ref.mamba_scan_ref
    return fn(x, dt, a, bm, c, h0=h0, chunk=chunk)


def rolling_stats(m_acc, tau_pow, *, window_acc=64, window_tau=16, sigma_floor_acc=1.0,
                  sigma_floor_tau=0.05, eps=1e-6):
    """RAPID monitor over [N, T] streams -> (score_acc, score_tau, m_tau)."""

    fn = _rs.rolling_stats if _on_cuda(m_acc, "rolling_stats") else _ref.rolling_stats_ref
    return fn(m_acc, tau_pow, window_acc=window_acc, window_tau=window_tau,
              sigma_floor_acc=sigma_floor_acc, sigma_floor_tau=sigma_floor_tau, eps=eps)
