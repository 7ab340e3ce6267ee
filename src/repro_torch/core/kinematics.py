"""Kinematic feature extraction (paper §IV-A/B, Eq. 2-5); torch twin of
``repro/core/kinematics.py``, elementwise over any leading batch dims."""

from __future__ import annotations

from typing import NamedTuple

import torch


class KinematicFrame(NamedTuple):
    """One proprioceptive sample for an N-DoF manipulator."""

    q: torch.Tensor    # joint positions  [..., N]
    qd: torch.Tensor   # joint velocities [..., N]
    tau: torch.Tensor  # joint torques    [..., N]


def finite_diff_accel(qd, qd_prev, dt: float):
    """Eq. 2: joint acceleration by finite difference."""

    return (qd - qd_prev) / dt


def end_joint_weights(n_joints: int, emphasis: float = 2.0, device="cuda"):
    """Diagonal weights W: a linear ramp from 1.0 (base) to ``emphasis``."""

    return torch.linspace(1.0, emphasis, n_joints, dtype=torch.float32, device=device)


def accel_magnitude(accel, w_a):
    """Eq. 4: M_acc = ||W_a qdd||_2 over the joint axis."""

    return torch.sqrt(torch.sum(torch.square(w_a * accel), dim=-1))


def torque_variation(tau, tau_prev):
    return tau - tau_prev


def torque_power(dtau, w_tau):
    """|W_tau dtau|^2 — the term inside Eq. 5's moving average."""

    return torch.sum(torch.square(w_tau * dtau), dim=-1)


def velocity_norm(qd):
    return torch.sqrt(torch.sum(torch.square(qd), dim=-1))


def phase_weights(v, v_max: float):
    """Eq. 6: w_a = clip(v / v_max, 0, 1); w_tau = 1 - w_a."""

    w_a = torch.clamp(v / v_max, 0.0, 1.0)
    return w_a, 1.0 - w_a
