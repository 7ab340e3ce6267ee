"""Mixture-of-experts FFN of the port (counterpart of ``repro/models/moe.py``):
a float32 top-k router and SwiGLU experts stacked as [E, ., .].

``moe_forward`` is the reference's dense baseline: every expert runs on
every token and the top-k combine weights zero the others, so a token's
output is its top-k experts' outputs mixed, at E / k times the FLOPs of a
dispatch.  Experts are applied one at a time, so no [B, S, E, F]
intermediate exists.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _param, dense, normal_


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
        self.router = _param((d, e), torch.float32, device)
        self.up = _param((e, d, f), dtype, device)
        self.gate = _param((e, d, f), dtype, device)
        self.down = _param((e, f, d), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        d, f = self.up.shape[1:]
        normal_(self.router, d**-0.5, generator)
        for w, std in ((self.up, d**-0.5), (self.gate, d**-0.5), (self.down, f**-0.5)):
            # one expert at a time: a float32 draw of a whole [16, 8192, 24576]
            # stack (Jamba's width) would be a 12.9 GB temporary
            for e in range(w.shape[0]):
                normal_(w[e], std, generator)


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


def moe_apply_experts(x, combine, p: MoE):
    """x [B,S,D], combine [B,S,E] -> the experts' mixture [B,S,D]."""

    acc = torch.zeros_like(x)
    for e in range(p.up.shape[0]):
        h = F.silu(dense(x, p.gate[e])) * dense(x, p.up[e])
        acc = acc + dense(h * combine[..., e].to(h.dtype)[..., None], p.down[e])
    return acc.to(x.dtype)


def moe_forward(x, p: MoE, cfg: ModelConfig):
    """x [B,S,D] -> (out [B,S,D], aux loss): route, then the dense mixture."""

    combine, aux = router_probs(x, p.router, cfg.moe.num_experts_per_tok)
    return moe_apply_experts(x, combine, p), aux
