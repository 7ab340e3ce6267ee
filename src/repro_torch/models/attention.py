"""Attention of the port (counterpart of ``repro/models/attention.py``).

Self-attention goes through ``kernels.ops``: prefill through the flash
kernel, dense decode through the decode kernel, paged decode through the
paged kernel — on a CUDA tensor the hand-written Hopper kernel, on a CPU
tensor its plain version.  (The reference's jnp ``_sdpa`` and
``_sdpa_chunked`` have no separate twin here: ``kernels/ref.py`` is the
plain path.)  Caches are updated in place, where the reference returns new
arrays.

Under autograd (q requires a gradient: the training path, whose
parameters require gradients) the prompt's self-attention and the
encoder's go through ``ops.flash_attention_train`` instead: the same
forward kernel, which then also keeps each row's log-sum-exp, and the
flash backward kernel (the reference's custom-VJP strip,
attention.py:198-326).  The serving entry points run under
``torch.no_grad`` and never take it.

An encoder-decoder stack adds two kinds, both without RoPE and non-causal
(the reference's ``kv_override`` path, attention.py:357-362): the
encoder's self-attention (``encoder_attention``, the flash kernel with
``causal=False``) and the decoder's cross-attention over the encoder's
output.  A cross-attention prefill has q and k of different lengths, which
the flash kernel does not take; the reference computes it in XLA, outside
any kernel, and so does the port, as a plain float32 softmax
(``cross_attention_forward``).  A decode step's cross-attention is the
decode kernel at ``cache_len = S_enc``, every key valid: over K/V cached at
prefill (``cross_attention_cached``) or projected from the encoder's output
each token (``cross_attention_decode``, the reference's baseline).

On a tensor-parallel rank (``Model(group=...)``) a self-attention layer
runs the rank's heads: ``n_heads`` query heads, ``[m H/M, (m+1) H/M)``,
and ``n_kv`` KV heads, its own ``KV/M`` where KV divides over the M ranks,
else the one KV head its query heads read (``kv_cols``: the columns of
the whole ``wk`` / ``wv`` it projects, a contiguous block).  ``wo`` is cut
by rows, and its partial products are summed over the ranks (``tp``).
RoPE, windows and softcaps are per head and unchanged.  The encoder's
self-attention and the decoder's cross-attention are cut alike: the rank's
heads of q, its KV heads of the K/V it projects from the encoder's output
(which every rank holds whole), and one all-reduce of the output.
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import paged_decode_attention_sharded
from repro_torch.launch import sharding
from repro_torch.launch.dist import all_reduce_sum
from repro_torch.models.layers import dense, global_shape, normal_


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nh, nkv = cfg.num_heads, cfg.num_kv_heads

        def p(shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)

        self.wq, self.wk, self.wv = p((d, nh * hd)), p((d, nkv * hd)), p((d, nkv * hd))
        self.wo = p((nh * hd, d))
        # the heads this rank runs (all of them outside a model axis)
        self.n_heads, self.n_kv, self.kv_cols, self.tp = nh, nkv, None, None

    def init(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            normal_(w, global_shape(w)[0] ** -0.5, generator)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: [B, S, H, Dh]; positions: [B, S] or [S].

    Parity: the head is split in halves, not interleaved, and the
    frequencies and angles are float32 (repro/models/attention.py:37-40).
    """

    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                   window: int) -> torch.Tensor:
    """Boolean mask [*, Sq, Sk]; True = attend.  (The kernels mask by
    position themselves; this is the mask they apply.)"""

    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window:
        ok &= diff < window
    return ok


def _kv_weights(p: Attention):
    """``wk`` / ``wv``, or the columns of the one KV head the rank's query
    heads read (``kv_cols``)."""

    return (p.wk, p.wv) if p.kv_cols is None else (p.wk[:, p.kv_cols], p.wv[:, p.kv_cols])


def _qkv(x, p: Attention, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    hd, nh, nkv = cfg.resolved_head_dim, p.n_heads, p.n_kv
    wk, wv = _kv_weights(p)
    q = dense(x, p.wq).reshape(b, s, nh, hd)
    k = dense(x, wk).reshape(b, s, nkv, hd)
    v = dense(x, wv).reshape(b, s, nkv, hd)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _out(o, p: Attention):
    """The output projection of o [B, S, n_heads, Dh] -> [B, S, D], summed
    over the ranks of ``p.tp``."""

    b, s = o.shape[:2]
    return all_reduce_sum(dense(o.reshape(b, s, -1), p.wo), p.tp)


def _attend(q, k, v, **kw):
    """The flash kernel: differentiable where q needs a gradient."""

    return (ops.flash_attention_train if q.requires_grad else ops.flash_attention)(q, k, v, **kw)


def attention_forward(x, p: Attention, cfg: ModelConfig, positions, window: int):
    """Causal self-attention over a prompt (the prefill path).

    x [B, S, D]; positions [B, S] or [S].  Returns (out [B, S, D], k, v) with
    the RoPE'd keys and the values [B, S, KV, Dh] for the decode cache.
    """

    q, k, v = _qkv(x, p, cfg, positions)
    out = _attend(q, k, v, causal=True, window=window, logit_cap=cfg.attn_logit_softcap)
    return _out(out, p), k, v


def attention_decode_step(x, p: Attention, cfg: ModelConfig, cache_k, cache_v,
                          cache_len: Union[int, torch.Tensor], window: int,
                          ring: bool = False):
    """One-token decode over dense slabs.  x [B,1,D]; cache_k/v [B,S,KV,Dh].

    ``cache_len`` is an int (the whole batch at one depth: the single-robot
    serving loop) or a [B] int32 tensor (each row at its own depth; the
    row's token lands at ``min(len, S-1)``).  The new K/V are written into
    the caches in place; the row attends positions ``<= len`` (the
    reference's ``k_pos <= pos`` mask, as a length of ``len + 1``).

    ``ring``: the cache is a ring of S slots (the layer's window); the token
    lands at ``len % S`` and the row attends its ``min(len + 1, S)``
    resident slots with no window mask (repro/models/attention.py:404-470).
    Keys are stored RoPE'd, so the slots' order does not matter.
    Returns out [B, 1, D].
    """

    b = x.shape[0]
    s_cache = cache_k.shape[1]
    if isinstance(cache_len, torch.Tensor):
        pos_b = cache_len.to(torch.int32)
        q, k, v = _qkv(x, p, cfg, pos_b[:, None])
        rows = torch.arange(b, device=x.device)
        slot = (pos_b % s_cache if ring else torch.clamp(pos_b, max=s_cache - 1)).long()
        cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
        lens = torch.clamp(pos_b + 1, max=s_cache) if ring else pos_b + 1
    else:
        pos = int(cache_len)
        q, k, v = _qkv(x, p, cfg, torch.full((b, 1), pos, device=x.device))
        slot = pos % s_cache if ring else pos
        cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
        lens = min(pos + 1, s_cache) if ring else pos + 1
    out = ops.decode_attention(
        q[:, 0], cache_k.to(q.dtype), cache_v.to(q.dtype), cache_len=lens,
        window=0 if ring else window, logit_cap=cfg.attn_logit_softcap,
    )
    return _out(out[:, None], p)


def attention_decode_step_paged(x, p: Attention, cfg: ModelConfig, k_pool, v_pool,
                                page_table, cache_len, cap, window: int):
    """One-token decode against the shared KV page pool.  x [B,1,D].

    k/v_pool [P+1, page, KV, Dh]: the last page is trash.  Each row's new
    K/V land at the flat slot its page table maps ``cache_len`` to; rows at
    or over ``cap`` (idle rows, rows decoding past their chunk) write the
    trash page and attend over ``min(len + 1, cap)`` tokens
    (repro/models/attention.py:512-523).  Pools are updated in place.
    Under ``sharding_rules(mesh)`` with ``data > 1`` the attention runs
    row-sharded (``paged_decode_attention_sharded``).  Returns out [B, 1, D].
    """

    b = x.shape[0]
    n_pages, page = k_pool.shape[0] - 1, k_pool.shape[1]
    maxp = page_table.shape[1]
    pos_b = cache_len.to(torch.int32).expand(b)
    cap_b = cap.to(torch.int32).expand(b)
    q, k, v = _qkv(x, p, cfg, pos_b[:, None])

    page_idx = torch.clamp(pos_b // page, max=maxp - 1).long()
    rows = torch.arange(b, device=x.device)
    slot = page_table[rows, page_idx].long() * page + (pos_b % page).long()
    slot = torch.where(pos_b < cap_b, slot, torch.full_like(slot, n_pages * page))
    flat = (-1,) + tuple(k_pool.shape[2:])
    k_pool.view(flat).index_copy_(0, slot, k[:, 0].to(k_pool.dtype))
    v_pool.view(flat).index_copy_(0, slot, v[:, 0].to(v_pool.dtype))

    lens_eff = torch.minimum(pos_b + 1, cap_b)
    args = (q[:, 0], k_pool[:n_pages].to(q.dtype), v_pool[:n_pages].to(q.dtype), page_table,
            lens_eff)
    kw = dict(window=window, logit_cap=cfg.attn_logit_softcap)
    mesh = sharding.active_mesh()
    if mesh is not None and mesh.shape["data"] > 1:
        # the rows shard over the active mesh's data axis (a scheduler's round)
        out = paged_decode_attention_sharded(*args, mesh=mesh, **kw)
    else:
        out = ops.paged_decode_attention(*args, **kw)
    return _out(out[:, None], p)


# ---------------------------------------------------------------------------
# encoder-decoder: the encoder's self-attention, the decoder's cross-attention
# ---------------------------------------------------------------------------


def _project(x, w, heads: int, hd: int):
    b, s, _ = x.shape
    return dense(x, w).reshape(b, s, heads, hd)


def encoder_attention(x, p: Attention, cfg: ModelConfig):
    """The encoder's self-attention over x [B,S,D]: no RoPE, non-causal,
    no window, through the flash kernel -> out [B,S,D] (the rank's heads,
    summed over ``p.tp``)."""

    hd = cfg.resolved_head_dim
    q = _project(x, p.wq, p.n_heads, hd)
    k, v = (_project(x, w, p.n_kv, hd) for w in _kv_weights(p))
    out = _attend(q, k, v, causal=False, window=0, logit_cap=cfg.attn_logit_softcap)
    return _out(out, p)


def cross_kv(enc_out, p: Attention, cfg: ModelConfig):
    """A cross-attention layer's K, V [B, S_enc, KV, Dh] over the encoder's
    output (no RoPE; the rank's KV heads)."""

    hd = cfg.resolved_head_dim
    return tuple(_project(enc_out, w, p.n_kv, hd) for w in _kv_weights(p))


def cross_attention_forward(x, p: Attention, cfg: ModelConfig, enc_out):
    """The decoder's cross-attention over a prompt x [B,S,D] against
    ``enc_out`` [B,S_enc,D], every key valid, as a plain softmax (scores,
    probabilities and the value sum in float32) -> (out [B,S,D], k, v),
    the K/V for a cached decode."""

    hd = cfg.resolved_head_dim
    q = _project(x, p.wq, p.n_heads, hd)
    k, v = cross_kv(enc_out, p, cfg)
    g = p.n_heads // k.shape[2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float().repeat_interleave(g, dim=2)) * hd**-0.5
    cap = cfg.attn_logit_softcap
    if cap:
        logits = cap * torch.tanh(logits / cap)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float().repeat_interleave(g, dim=2))
    return _out(out.to(q.dtype), p), k, v


def cross_attention_cached(x, p: Attention, cfg: ModelConfig, xk, xv):
    """One decode token's cross-attention, x [B,1,D], over K/V cached at
    prefill (xk/xv [B,S_enc,KV,Dh]): the decode kernel with every key valid
    -> out [B,1,D]."""

    b = x.shape[0]
    q = dense(x, p.wq).reshape(b, p.n_heads, cfg.resolved_head_dim)
    out = ops.decode_attention(q, xk.to(q.dtype), xv.to(q.dtype), cache_len=xk.shape[1],
                               logit_cap=cfg.attn_logit_softcap)
    return _out(out[:, None], p)


def cross_attention_decode(x, p: Attention, cfg: ModelConfig, enc_out):
    """The uncached baseline: the token's cross-attention with K/V projected
    from ``enc_out`` afresh -> out [B,1,D]."""

    return cross_attention_cached(x, p, cfg, *cross_kv(enc_out, p, cfg))
