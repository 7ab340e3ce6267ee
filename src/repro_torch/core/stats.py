"""Rolling statistics for the RAPID monitors; torch twin of
``repro/core/stats.py``.  ``WindowStats`` is a ring-buffer window (the
acceleration monitor), ``RunningStats`` a Welford running mean/std (the
torque monitor).  All updates are O(1) per step and return new states."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-6


class WindowStats(NamedTuple):
    buf: torch.Tensor    # [..., w] ring buffer
    idx: torch.Tensor    # [...] int32 write cursor
    count: torch.Tensor  # [...] int32 samples seen (saturates at w)


def window_init(window: int, batch_shape: Tuple[int, ...] = (), device="cuda") -> WindowStats:
    return WindowStats(
        buf=torch.zeros(batch_shape + (window,), dtype=torch.float32, device=device),
        idx=torch.zeros(batch_shape, dtype=torch.int32, device=device),
        count=torch.zeros(batch_shape, dtype=torch.int32, device=device),
    )


def window_update(s: WindowStats, x) -> WindowStats:
    w = s.buf.shape[-1]
    one_hot = F.one_hot(s.idx.long(), w).to(s.buf.dtype)
    buf = s.buf * (1.0 - one_hot) + one_hot * x[..., None]
    return WindowStats(buf, (s.idx + 1) % w, torch.clamp(s.count + 1, max=w))


def _mask(s: WindowStats):
    return torch.arange(s.buf.shape[-1], device=s.buf.device) < s.count[..., None]


def window_mean_std(s: WindowStats):
    n = torch.clamp(s.count, min=1).float()
    mask = _mask(s)
    mean = torch.where(mask, s.buf, 0.0).sum(-1) / n
    var = torch.where(mask, torch.square(s.buf - mean[..., None]), 0.0).sum(-1) / n
    return mean, torch.sqrt(torch.clamp(var, min=0.0))


def window_sum(s: WindowStats):
    return torch.where(_mask(s), s.buf, 0.0).sum(-1)


def window_moving_average(s: WindowStats):
    """Mean over the (possibly not yet full) window — Eq. 5's 1/w sum."""

    return window_sum(s) / torch.clamp(s.count, min=1).float()


class RunningStats(NamedTuple):
    count: torch.Tensor  # [...] float32
    mean: torch.Tensor
    m2: torch.Tensor     # sum of squared deviations


def running_init(batch_shape: Tuple[int, ...] = (), device="cuda") -> RunningStats:
    z = torch.zeros(batch_shape, dtype=torch.float32, device=device)
    return RunningStats(z, z, z)


def running_update(s: RunningStats, x) -> RunningStats:
    count = s.count + 1.0
    delta = x - s.mean
    mean = s.mean + delta / count
    return RunningStats(count, mean, s.m2 + delta * (x - mean))


def running_mean_std(s: RunningStats):
    var = s.m2 / torch.clamp(s.count, min=1.0)
    return s.mean, torch.sqrt(torch.clamp(var, min=0.0))


def normalized_score(x, mean, std, eps: float = EPS):
    """(M - mu) / (sigma + eps) — the paper's normalized anomaly score."""

    return (x - mean) / (std + eps)
