"""Mixture-of-experts FFN of the port (counterpart of ``repro/models/moe.py``):
a float32 top-k router and SwiGLU experts stacked as [E, ., .].

Two dispatches, as in the reference (``Model(moe_impl=...)``):

- ``moe_forward`` ("dense", the reference's baseline): every expert runs
  on every token and the top-k combine weights zero the others, so a
  token's output is its top-k experts' outputs mixed, at E / k times the
  FLOPs of a dispatch.  Experts go through batched products a group at a
  time (``moe_apply_experts``), so no [B, S, E, F] intermediate exists.
- ``moe_forward_capacity`` ("capacity"): each expert takes at most ``cap``
  tokens, in row-major token order, gathered to [E, cap, D]; the experts
  run as batched products over E and each token sums its kept slots.
  Tokens beyond an expert's capacity are dropped (GShard / Switch), so the
  output depends on the batch: padding and idle rows route and take slots
  too, as in the reference.

Both read every expert's weights on every call: at decode the capacity
path runs all E experts over ``cap >= 1`` slots each, most of them empty.
Neither synchronises with the host, so both run inside a CUDA graph.

On a tensor-parallel rank (``Model(group=...)``) each expert holds the
rank's block of its ``mlp`` axis, the ``d_ff / M`` columns of ``up`` and
``gate`` and the same rows of ``down``; the router is whole.  The
``expert`` axis rides ``data``, whose shards share the rank's device, so
every rank holds all E experts.  Every rank sees the same ``x`` and routes
the same way; each dispatch ends in one all-reduce of its [B, S, D] output
(``tp``), its partials in the model's dtype, as the dense MLP's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.dist import all_reduce_sum
from repro_torch.models.layers import _param, block_of, global_shape, normal_

# the dense mixture runs experts in groups whose [E_g, T, max(F, D)]
# intermediate holds at most this many elements (all experts at once in
# decode; a long prefill takes several groups)
GROUP_ELEMS = 1 << 26


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
        self.router = _param((d, e), torch.float32, device)
        self.up = _param((e, d, f), dtype, device)
        self.gate = _param((e, d, f), dtype, device)
        self.down = _param((e, f, d), dtype, device)
        self.tp = None  # the ranks over the mlp axis (launch.dist.ModelGroup)

    def init(self, generator: torch.Generator) -> None:
        d, f = global_shape(self.up)[1:]
        normal_(self.router, d**-0.5, generator)
        for w, std in ((self.up, d**-0.5), (self.gate, d**-0.5), (self.down, f**-0.5)):
            # one expert at a time: a float32 draw of a whole [16, 8192, 24576]
            # stack (Jamba's width) would be a 12.9 GB temporary; a rank
            # draws each expert's global [D, F] (or [F, D]) and keeps its block
            shape, index = block_of(w)
            for e in range(w.shape[0]):
                normal_(w[e], std, generator, block=(shape[1:], index[1:]))


def router_probs(x, router_w, k: int):
    """-> (combine [.., E] holding the renormalised top-k softmax weights,
    the Switch-style load-balance aux loss)."""

    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    e = probs.shape[-1]
    top_vals, top_idx = torch.topk(probs, k, dim=-1)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True)
    combine = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
    lead = tuple(range(probs.dim() - 1))
    density = (combine > 0).float().mean(dim=lead)
    aux = e * torch.sum(density * probs.mean(dim=lead)) / k
    return combine, aux


def _hidden(x, p: MoE, sl: slice):
    """x [E_g, C, D] (or [1, C, D], shared by the group) through experts
    ``sl``'s gate and up projections as batched products -> SwiGLU's hidden
    [E_g, C, F]; ``_down`` finishes the FFN."""

    up, gate = p.up[sl].to(x.dtype), p.gate[sl].to(x.dtype)
    x = x.expand(up.shape[0], *x.shape[1:])
    return F.silu(torch.bmm(x, gate)) * torch.bmm(x, up)


def _down(h, p: MoE, sl: slice):
    return torch.bmm(h, p.down[sl].to(h.dtype))


def moe_apply_experts(x, combine, p: MoE):
    """x [B,S,D], combine [B,S,E] -> the experts' mixture [B,S,D].

    Each expert's output is the reference's, ``((silu(x Wg) * x Wu) *
    c_e) Wd`` in x's dtype; the sum over experts is taken over a group at
    once (float32 accumulation in a bf16 model) where the reference adds
    one expert at a time.  On a rank of ``p.tp`` the mixture of its
    ``d_ff`` block is summed over the ranks."""

    b, s, d = x.shape
    e, _, f = p.up.shape
    t = b * s
    xt = x.reshape(1, t, d)
    cmb = combine.reshape(t, e).T.to(x.dtype)[..., None]  # [E, T, 1]
    group = max(1, min(e, GROUP_ELEMS // max(t * max(f, d), 1)))
    acc = None
    for e0 in range(0, e, group):
        sl = slice(e0, e0 + group)
        part = _down(_hidden(xt, p, sl) * cmb[sl], p, sl).sum(0)
        acc = part if acc is None else acc + part
    return all_reduce_sum(acc.reshape(b, s, d).to(x.dtype), p.tp)


def moe_forward(x, p: MoE, cfg: ModelConfig):
    """x [B,S,D] -> (out [B,S,D], aux loss): route, then the dense mixture."""

    combine, aux = router_probs(x, p.router, cfg.moe.num_experts_per_tok)
    return moe_apply_experts(x, combine, p), aux


def capacity_slots(selected, cap: int):
    """selected [T, E] (the router's top-k) -> (keep [T, E], slot [T, E]):
    a token keeps an expert while the expert's running count over the
    tokens, in order, is below ``cap``; a kept (token, expert) sits in slot
    ``expert * cap + count`` of the [E * cap] buffer, the rest in the
    overflow slot ``E * cap``."""

    e = selected.shape[1]
    pos = torch.cumsum(selected.to(torch.int32), dim=0) - 1
    keep = selected & (pos < cap)
    base = torch.arange(e, device=selected.device) * cap
    return keep, torch.where(keep, pos + base, e * cap)


def moe_forward_capacity(x, p: MoE, cfg: ModelConfig, capacity_factor=None):
    """x [B,S,D] -> (out [B,S,D], aux loss) through the capacity dispatch
    (``repro/models/moe.py:122-177``).

    ``cap = max(int(B*S*k*cf / E), 1)`` slots an expert, from static shapes.
    A token's slot in its expert's buffer is the running count of the
    expert's tokens over the flattened [B*S] order; a token past ``cap``
    is dropped.  The kept tokens are gathered to [E, cap, D] (empty slots
    are zero rows), the experts run as batched products, and each token
    sums its kept experts' weighted outputs in ascending expert order (the
    order in which the reference's scatter-add visits them), cast to x's
    dtype each, gathered rather than scattered so the sum is the same on
    every run.  The table of slots is built by a scatter whose repeated
    writes land only in an overflow slot that is cut off.  On a rank of
    ``p.tp`` the k-way sum of its ``d_ff`` block is summed over the
    ranks."""

    m = cfg.moe
    b, s, d = x.shape
    k, e = m.num_experts_per_tok, m.num_experts
    cf = capacity_factor or m.capacity_factor
    t = b * s
    cap = max(int(t * k * cf / e), 1)
    dev = x.device

    combine, aux = router_probs(x, p.router, k)
    flat = combine.reshape(t, e)
    xt = x.reshape(t, d)
    selected = flat > 0
    keep, slot = capacity_slots(selected, cap)
    experts = torch.arange(e, device=dev)
    overflow = e * cap
    # each slot's token + 1 (0: an empty slot)
    tokens = torch.arange(1, t + 1, device=dev)[:, None].expand(t, e)
    table = torch.zeros(overflow + 1, dtype=torch.long, device=dev)
    table.scatter_(0, slot.reshape(-1), tokens.reshape(-1))
    fill = table[:overflow].view(e, cap)
    vmask = (fill > 0)[..., None].to(x.dtype)
    xg = xt[(fill - 1).clamp(min=0)] * vmask                     # [E, cap, D]
    every = slice(None)
    oe = _down(_hidden(xg, p, every), p, every)                 # [E, cap, D]

    # each token's selected experts in ascending order: topk over e - expert
    # (0 where unselected) lists the selected ones smallest index first
    order = torch.topk(torch.where(selected, e - experts, 0), k, dim=-1).indices  # [T, k]
    kept = keep.gather(1, order)
    where = torch.where(kept, slot.gather(1, order), overflow)
    w = torch.where(kept, flat.gather(1, order), 0.0)
    rows = torch.cat([oe.reshape(overflow, d), oe.new_zeros(1, d)])
    parts = (rows[where].float() * w[..., None]).to(x.dtype)    # [T, k, D]
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return all_reduce_sum(out.reshape(b, s, d), p.tp), aux
