"""Launcher of the hand-written RAPID monitor kernel
(``csrc/rolling_stats.cu``; replaces the TPU kernel
``repro/kernels/rolling_stats.py:104``, ``pallas_call`` at :136).

m_acc, tau_pow [N, T] float32 (one stream a row: a fleet's robots, or a
bank of replayed episodes) -> (score_acc, score_tau, m_tau), each [N, T].
Only CUDA tensors are accepted.

Bound on an H100: bytes (5 N T floats; the fleet's 1024 x 600 streams in
3.7 us).  The kernel gives a stream one warp and splits its ticks over the
lanes: super-tiles of 32 segments (``monitor_plan``), the running stats
entering each segment from a warp scan of Chan's merge, the window sums
recomputed at each segment's start from a staged halo of earlier ticks.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib

NAME = "rolling_stats"
MAX_RING = 192  # window_acc + window_tau (csrc/rolling_stats.cu)
MAX_SEG = 32    # ticks a lane takes in one super-tile of 32 segments


def monitor_plan(t: int, window_acc: int, window_tau: int):
    """-> (seg, halo) for streams of ``t`` ticks: super-tiles of 32 * seg
    ticks (seg = ceil(t / 32), at most ``MAX_SEG``), each staged with the
    ``halo`` ticks before it (max of the windows; 0 when one super-tile
    holds the stream).  A super-tile of ``len`` ticks gives each lane
    ceil(len / 32) of them."""

    seg = min(MAX_SEG, -(-t // 32))
    return seg, (max(window_acc, window_tau) if t > 32 * seg else 0)


def rolling_stats(m_acc, tau_pow, *, window_acc: int = 64, window_tau: int = 16,
                  sigma_floor_acc: float = 1.0, sigma_floor_tau: float = 0.05,
                  eps: float = 1e-6):
    _lib.check_tensors(m_acc, tau_pow, align=4)
    if m_acc.dtype != torch.float32:
        raise TypeError(f"rolling_stats takes float32, got {m_acc.dtype}")
    if m_acc.dim() != 2 or tau_pow.shape != m_acc.shape or m_acc.numel() == 0:
        raise ValueError(f"m_acc {tuple(m_acc.shape)} and tau_pow {tuple(tau_pow.shape)} "
                         "must be one non-empty [N, T] shape")
    if window_acc < 1 or window_tau < 1 or window_acc + window_tau > MAX_RING:
        raise ValueError(f"windows {window_acc} + {window_tau} must be >= 1 each and "
                         f"<= {MAX_RING} together")
    n, t = m_acc.shape
    seg, halo = monitor_plan(t, int(window_acc), int(window_tau))
    outs = [torch.empty_like(m_acc) for _ in range(3)]
    status = _lib.load(NAME)(
        m_acc.data_ptr(), tau_pow.data_ptr(), *(o.data_ptr() for o in outs), n, t,
        int(window_acc), int(window_tau), float(sigma_floor_acc), float(sigma_floor_tau),
        float(eps), seg, halo, torch.cuda.current_stream(m_acc.device).cuda_stream,
    )
    _lib.check(status, NAME)
    _lib.LAUNCHES[NAME] += 1
    return tuple(outs)
