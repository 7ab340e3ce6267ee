"""Step-wise redundancy analysis of the port (counterpart of
``repro/core/redundancy.py``; paper §III-B, Table II, Fig. 3).

Per-step action importance from a VLA's attention weights, and its
agreement with kinematic surrogates, the empirical basis of the
redundancy-aware trigger.  Definitions from Table II: the per-step
attention weight ``w_t`` is the mean attention mass the action steps
receive; the uniform baseline is ``1/L`` over an L-step episode; redundant
steps have ``w_t < 1/L``, critical ones ``w_t >= 1/L``; P_red / P_crit are
their proportions, W_red / W_crit their mean weights.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RedundancyStats(NamedTuple):
    p_red: torch.Tensor    # proportion of redundant steps
    p_crit: torch.Tensor
    w_red: torch.Tensor    # mean attention weight of redundant steps
    w_crit: torch.Tensor
    uniform: torch.Tensor  # the 1/L baseline
    mask_critical: torch.Tensor  # [..., L] bool


def step_attention_weights(attn: torch.Tensor) -> torch.Tensor:
    """attn [..., heads, q, L] attention probabilities onto L action steps
    -> [..., L]: the mean over heads and queries, normalised to sum 1."""

    w = attn.mean(dim=(-3, -2))
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)


def redundancy_stats(weights: torch.Tensor) -> RedundancyStats:
    """Table II statistics from per-step weights [..., L]."""

    l = weights.shape[-1]
    uniform = torch.tensor(1.0 / l, dtype=torch.float32, device=weights.device)
    crit = weights >= uniform
    n = float(l)
    n_crit = crit.sum(-1).float()
    n_red = n - n_crit
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    w_crit = torch.where(crit, weights, zero).sum(-1) / torch.clamp(n_crit, min=1.0)
    w_red = torch.where(crit, zero, weights).sum(-1) / torch.clamp(n_red, min=1.0)
    return RedundancyStats(p_red=n_red / n, p_crit=n_crit / n, w_red=w_red, w_crit=w_crit,
                           uniform=uniform, mask_critical=crit)


def pearson_correlation(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Correlation over the last axis between a kinematic surrogate and the
    attention redundancy (Fig. 3's joint-torque to step-importance)."""

    x = x - x.mean(-1, keepdim=True)
    y = y - y.mean(-1, keepdim=True)
    den = torch.sqrt((x * x).sum(-1) * (y * y).sum(-1))
    return (x * y).sum(-1) / torch.clamp(den, min=1e-9)


def surrogate_agreement(kinematic_score: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The share of steps on which the kinematic surrogate (above its mean)
    and the attention criterion (``w >= 1/L``) agree on critical against
    redundant (Fig. 3 as a classification)."""

    l = weights.shape[-1]
    attn_crit = weights >= (1.0 / l)
    kin_crit = kinematic_score >= kinematic_score.mean(-1, keepdim=True)
    return (attn_crit == kin_crit).float().mean(-1)
