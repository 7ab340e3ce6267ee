"""Dispatch for the attention kernels: the tensor's device decides.

A CUDA tensor goes to the hand-written Hopper kernel, which launches or
raises; a CPU tensor goes to the plain PyTorch version in ``kernels.ref``.
Nothing here checks whether a GPU exists and nothing falls back: any other
device raises.  ``LAUNCHES`` counts kernel launches by name (plain-version
calls never count); ``reset_launch_counts`` zeroes it.
"""

from __future__ import annotations

from repro_torch.kernels import _lib
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref

LAUNCHES = _lib.LAUNCHES
reset_launch_counts = _lib.reset_launch_counts


def _on_cuda(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no attention path for device {t.device}")


def flash_attention(q, k, v, *, causal=True, window=0, logit_cap=0.0):
    """Causal self-attention [B,S,H,D] x [B,S,KV,D]^2 -> [B,S,H,D] (prefill)."""

    fn = _fa.flash_attention if _on_cuda(q) else _ref.flash_attention_ref
    return fn(q, k, v, causal=causal, window=window, logit_cap=logit_cap)


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
