"""Plain PyTorch versions of the attention kernels (CPU path and card oracle).

Each function computes what its CUDA kernel computes — scores, softmax and
the value sum all in float32, output cast to the query dtype — and is what
``kernels.ops`` runs for a tensor on the CPU.  ``chip_smoke.py`` holds each
kernel against these on the card.  They mirror ``repro.kernels.ref``:

* masked logits are ``NEG_INF = -1e30`` as in the kernels (the model's
  ``_sdpa`` uses ``-2e38``; both exp to exactly 0);
* the reference model's dense decode (``_sdpa``, attention.py:95-112) takes
  the score einsum in the input dtype before casting to float32 and casts
  the probabilities back to the value dtype; the port's decode path keeps
  both in float32 — the same in float32 stacks, a rounding difference in
  bf16, where parity is held only by the greedy-margin rule;
* ``paged_decode_attention_ref`` returns **0** for a row with length 0, as
  the kernels do (the JAX oracle returns the uniform mean there), and keeps
  the probabilities in float32 (the JAX oracle casts them to the value
  dtype, a difference visible only in bf16).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap else s


def flash_attention_ref(q, k, v, *, causal=True, window=0, logit_cap=0.0):
    """[B,S,H,D] x [B,S,KV,D]^2 -> [B,S,H,D]; materializes the score matrix."""

    b, s, h, d = q.shape
    g = h // k.shape[2]
    kr = k.float().repeat_interleave(g, dim=2)
    vr = v.float().repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * d**-0.5
    logits = _softcap(logits, logit_cap)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)


def _attend_rows(q, k, v, valid, logit_cap):
    """q [B,H,D]; k/v [B,S,KV,D]; valid [B,S] -> [B,H,D] (rows with no valid
    position give 0)."""

    b, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.float().reshape(b, kv, g, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * d**-0.5
    logits = _softcap(logits, logit_cap)
    logits = torch.where(valid[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1) * valid[:, None, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def _valid(lens, s, window, device):
    pos = torch.arange(s, device=device)[None, :]
    lens = lens[:, None]
    valid = pos < lens
    if window:
        valid &= pos >= lens - window
    return valid


def decode_attention_ref(q, cache_k, cache_v, *, cache_len, window=0, logit_cap=0.0):
    """q [B,H,D], cache [B,S,KV,D] -> [B,H,D] over cache[:cache_len].

    ``cache_len`` is an int shared by the batch or a [B] int tensor.
    """

    b, s = cache_k.shape[:2]
    lens = torch.as_tensor(cache_len, device=q.device).expand(b)
    return _attend_rows(q, cache_k, cache_v, _valid(lens, s, window, q.device), logit_cap)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, cache_lens, *,
                               window=0, logit_cap=0.0):
    """Ragged paged decode: gather each row's pages into a dense
    [MAXP*page] cache and attend over its first ``cache_lens[b]`` slots.

    q [B,H,D]; k/v pages [P,page,KV,D]; page_table [B,MAXP]; cache_lens [B].
    """

    _, page, kv, d = k_pages.shape
    b = q.shape[0]
    table = page_table.long()
    k = k_pages[table].reshape(b, -1, kv, d)
    v = v_pages[table].reshape(b, -1, kv, d)
    valid = _valid(cache_lens.long(), k.shape[1], window, q.device)
    return _attend_rows(q, k, v, valid, logit_cap)
