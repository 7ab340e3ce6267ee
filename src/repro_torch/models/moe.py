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
``gate`` and the same rows of ``down``; the router is whole.  Every rank
sees the same ``x`` and routes the same way; each dispatch ends in one
all-reduce of its [B, S, D] output (``tp``), its partials in the model's
dtype, as the dense MLP's.

**Experts over the data axis.**  The ``expert`` axis rides ``data``
(the reference's ``"expert": ("data",)`` rule).  Where the data axis is
ranks (``Model(data_group=...)``, ``dp``) and E divides over them, data
rank ``d`` holds experts ``[d E / D, (d + 1) E / D)``; else the rule drops
and every data rank holds all E.  On a grid with a ``pod`` axis the
experts spread over the data ranks of the rank's own pod (replicated over
``pod``, as the reference's rule leaves them).  A layer runs in one of two
cases:

- rows sharded over ranks (a scheduler's decode round, or a fused split
  round: the active mesh's ``rows_group``, the batch group of every (pod,
  data) rank, the data group where there is no pod axis): under the dense
  dispatch with split experts x is gathered over the data ranks of the
  pod, every token routed (the same float32 router on every rank), the
  rank's experts run on their tokens, and the mixture is reduce-scattered
  back to the rank's rows; where the experts do not split the dense
  dispatch stays on the rank's rows; the capacity dispatch gathers x over
  the batch group, whatever the experts, and builds its table from the
  real rows in their global order (``launch.sharding.real_rows``: a
  block's pad rows take no slot), then each pod reduce-scatters its rows
  over its data ranks (split experts) or each rank takes its block;
- rows replicated over data (an admission prefill, a split lane's flush
  or edge prefill): the rank's experts run on the tokens, and the mixture
  is all-reduced over the data ranks.

The partials of split experts are float32, summed over the data ranks
and rounded once; the model axis's all-reduce follows.  The capacity
dispatch takes ``cap`` and its slot table from the global [B*S] token
order, so the tokens dropped are those of one device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.dist import all_gather_cat, all_reduce_sum, reduce_rows
from repro_torch.launch.sharding import real_rows, rows_group
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
        self.dp = None  # the ranks over the data axis, where they are processes

    @property
    def experts(self) -> slice:
        """The global experts this rank holds (``[e0, e0 + E_local)``)."""

        return block_of(self.up)[1][0]

    @property
    def split(self) -> bool:
        """Whether the experts are spread over the data ranks."""

        return self.up.shape[0] < global_shape(self.up)[0]

    def init(self, generator: torch.Generator) -> None:
        d, f = global_shape(self.up)[1:]
        normal_(self.router, d**-0.5, generator)
        mine = range(global_shape(self.up)[0])[self.experts]
        for w, std in ((self.up, d**-0.5), (self.gate, d**-0.5), (self.down, f**-0.5)):
            # one expert at a time: a float32 draw of a whole [16, 8192, 24576]
            # stack (Jamba's width) would be a 12.9 GB temporary; a rank
            # draws every global expert's [D, F] (or [F, D]) and keeps its
            # experts' blocks
            shape, index = block_of(w)
            for e in range(shape[0]):
                if e in mine:
                    normal_(w[e - mine.start], std, generator, block=(shape[1:], index[1:]))
                else:
                    torch.randn(shape[1:], generator=generator, device=w.device)


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


class Rows(NamedTuple):
    """How a layer's rows were gathered: over ``group``, ``local`` rows a
    rank, ``idx`` the real rows' positions in global order (None: every
    gathered row, in order)."""

    group: object
    local: int
    idx: Optional[List[int]] = None


def _gathered(x, p: MoE, capacity: bool):
    """``x`` [B, S, D], where a round shards its rows over ranks and the
    layer needs more than the rank's rows: gathered over the pod's data
    ranks (the dense dispatch over split experts), or over the batch group
    with its pad rows dropped and its rows in global order (the capacity
    dispatch) -> (x or the gathered rows, their ``Rows``; None where
    nothing was gathered)."""

    group = rows_group()
    if group is None or not (p.split or capacity):
        return x, None
    if not capacity:
        return all_gather_cat(x, 0, p.dp), Rows(p.dp, x.shape[0])
    xa = all_gather_cat(x, 0, group)
    idx = real_rows(x.shape[0], group.size)
    if idx is not None:
        xa = xa[torch.as_tensor(idx, device=x.device)]
    return xa, Rows(group, x.shape[0], idx)


def _finish(out, p: MoE, rows, dtype):
    """A mixture of the rank's experts over the rows it saw -> the rank's
    rows of the whole mixture in ``dtype``: float32 partials of split
    experts summed over the data ranks (reduce-scattered back to the rank's
    rows where they were gathered: over a batch group, the rank's pod's
    rows) and rounded once, then the model axis's sum."""

    if rows is not None and rows.idx is not None:
        full = out.new_zeros((rows.group.size * rows.local,) + tuple(out.shape[1:]))
        full[torch.as_tensor(rows.idx, device=out.device)] = out
        out = full
    if p.split:
        if rows is None:
            out = all_reduce_sum(out, p.dp)
        else:
            if rows.group is not p.dp:
                n = p.dp.size * rows.local
                out = out.narrow(0, rows.group.rank // p.dp.size * n, n)
            out = reduce_rows(out, p.dp)
        out = out.to(dtype)
    elif rows is not None:
        out = out.narrow(0, rows.group.rank * rows.local, rows.local)
    return all_reduce_sum(out, p.tp)


def moe_apply_experts(x, combine, p: MoE, rows=None):
    """x [B,S,D], combine [B,S,E] -> the experts' mixture [B,S,D].

    Each expert's output is the reference's, ``((silu(x Wg) * x Wu) *
    c_e) Wd`` in x's dtype; the sum over experts is taken over a group at
    once (float32 accumulation in a bf16 model) where the reference adds
    one expert at a time.  On a rank of ``p.tp`` the mixture of its
    ``d_ff`` block is summed over the ranks; with the experts spread over
    the data ranks (``p.dp``) the rank's experts' float32 mixture is summed
    over those (``rows``: x holds the rows ``_gathered`` gathered, and the
    result is this rank's)."""

    b, s, d = x.shape
    e, _, f = p.up.shape
    t = b * s
    xt = x.reshape(1, t, d)
    cmb = combine.reshape(t, -1)[:, p.experts].T.to(x.dtype)[..., None]  # [E, T, 1]
    group = max(1, min(e, GROUP_ELEMS // max(t * max(f, d), 1)))
    acc = None
    for e0 in range(0, e, group):
        sl = slice(e0, e0 + group)
        h = _down(_hidden(xt, p, sl) * cmb[sl], p, sl)
        part = h.sum(0, dtype=torch.float32) if p.split else h.sum(0)
        acc = part if acc is None else acc + part
    out = acc.reshape(b, s, d)
    return _finish(out if p.split else out.to(x.dtype), p, rows, x.dtype)


def moe_forward(x, p: MoE, cfg: ModelConfig):
    """x [B,S,D] -> (out [B,S,D], aux loss): route, then the dense mixture."""

    xa, rows = _gathered(x, p, capacity=False)
    combine, aux = router_probs(xa, p.router, cfg.moe.num_experts_per_tok)
    return moe_apply_experts(xa, combine, p, rows), aux


def moe_apply_offloaded(h2, combine, p: MoE):
    """The cloud half of an expert-offload split (``h2`` and its
    ``combine`` routed edge-side): ``moe_apply_experts``, with both
    gathered over the pod's data ranks where a round shards its rows and
    the experts split (the dense dispatch's case: two gathers, one
    reduce-scatter)."""

    xa, rows = _gathered(h2, p, capacity=False)
    if rows is not None:
        combine = all_gather_cat(combine, 0, rows.group)
    return moe_apply_experts(xa, combine, p, rows)


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
    dtype = x.dtype
    x, seen = _gathered(x, p, capacity=True)
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
    fill = table[:overflow].view(e, cap)[p.experts]               # the rank's experts
    vmask = (fill > 0)[..., None].to(x.dtype)
    xg = xt[(fill - 1).clamp(min=0)] * vmask                     # [E_local, cap, D]
    every = slice(None)
    oe = _down(_hidden(xg, p, every), p, every)                 # [E_local, cap, D]

    # each token's selected experts in ascending order: topk over e - expert
    # (0 where unselected) lists the selected ones smallest index first
    order = torch.topk(torch.where(selected, e - experts, 0), k, dim=-1).indices  # [T, k]
    kept = keep.gather(1, order)
    where = torch.where(kept, slot.gather(1, order), overflow)
    w = torch.where(kept, flat.gather(1, order), 0.0)
    rows = oe.new_zeros(overflow + 1, d)                         # other ranks' experts: 0
    mine = p.experts
    rows[(mine.start or 0) * cap:(mine.start or 0) * cap + oe.shape[0] * cap] = oe.reshape(-1, d)
    parts = rows[where].float() * w[..., None]                   # [T, k, D]
    if not p.split:
        parts = parts.to(x.dtype)
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return _finish(out.reshape(b, s, d), p, seen, dtype), aux
