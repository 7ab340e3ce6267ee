"""Synthetic rigid-body manipulator dynamics (numpy float32 twin of
``repro/robotics/dynamics.py``): tau = M(q) qdd + C(q, qd) qd + G(q) + tau_ext.

Host-side episode data; every array is float32, as the reference computes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

F32 = np.float32


@dataclass(frozen=True)
class ArmModel:
    n_joints: int = 7
    inertia_base: Tuple[float, ...] = (2.5, 2.2, 1.6, 1.2, 0.5, 0.3, 0.15)
    coriolis_coeff: float = 0.12
    gravity_coeff: Tuple[float, ...] = (12.0, 18.0, 9.0, 6.5, 1.8, 0.9, 0.3)
    viscous_friction: float = 0.35


def mass_matrix_diag(arm: ArmModel, q: np.ndarray) -> np.ndarray:
    base = np.asarray(arm.inertia_base, F32)
    posture = F32(1.0) + F32(0.25) * np.cos(q) * np.linspace(1.0, 0.1, arm.n_joints, dtype=F32)
    return base * posture


def coriolis(arm: ArmModel, q: np.ndarray, qd: np.ndarray) -> np.ndarray:
    return F32(arm.coriolis_coeff) * qd * np.roll(qd, 1, axis=-1) * np.cos(q)


def gravity(arm: ArmModel, q: np.ndarray) -> np.ndarray:
    return np.asarray(arm.gravity_coeff, F32) * np.sin(q)


def inverse_dynamics(arm: ArmModel, q, qd, qdd, tau_ext) -> np.ndarray:
    """Eq. 3: full joint torque for a trajectory sample."""

    return (
        mass_matrix_diag(arm, q) * qdd
        + coriolis(arm, q, qd)
        + gravity(arm, q)
        + F32(arm.viscous_friction) * qd
        + tau_ext
    )


def min_jerk(t: np.ndarray) -> np.ndarray:
    """Minimum-jerk scalar profile s(t) on t in [0, 1] (smooth approach)."""

    _, t3, t4, t5 = _powers(t)
    return F32(10.0) * t3 - F32(15.0) * t4 + F32(6.0) * t5


def _powers(t: np.ndarray):
    """t^2..t^5 as XLA's integer powers form them (by squaring), not
    numpy's ``pow``: the min-jerk sums cancel near t = 1, where one ulp of
    a power shows."""

    t2 = t * t
    t4 = t2 * t2
    return t2, t * t2, t4, t * t4


def min_jerk_segment(q0: np.ndarray, q1: np.ndarray, steps: int, dt: float):
    """Joint trajectory q(t), qd(t), qdd(t) between two waypoints."""

    # the reference's float32 linspace: i / (steps - 1), not i * step
    t = np.arange(steps, dtype=F32) / F32(max(steps - 1, 1))
    s = min_jerk(t)
    t2, t3, t4, _ = _powers(t)
    # analytic derivatives of the min-jerk polynomial
    sd = (F32(30.0) * t2 - F32(60.0) * t3 + F32(30.0) * t4) / F32(steps * dt)
    sdd = (F32(60.0) * t - F32(180.0) * t2 + F32(120.0) * t3) / F32((steps * dt) ** 2)
    dq = (q1 - q0)[None, :]
    return q0[None, :] + s[:, None] * dq, sd[:, None] * dq, sdd[:, None] * dq


def trapezoid_segment(q0: np.ndarray, q1: np.ndarray, steps: int, dt: float,
                      blend_frac: float = 0.15):
    """Trapezoidal-velocity point-to-point move with smoothstep blends."""

    t = np.linspace(0.0, 1.0, steps, dtype=F32)
    tb = F32(blend_frac)
    up = np.clip(t / tb, F32(0.0), F32(1.0))
    down = np.clip((F32(1.0) - t) / tb, F32(0.0), F32(1.0))
    vprof = (3 * up**2 - 2 * up**3) * (3 * down**2 - 2 * down**3)
    s_raw = np.cumsum(vprof, dtype=F32)
    s = s_raw / s_raw[-1]
    sd = vprof / (s_raw[-1] * F32(dt))
    sdd = np.gradient(sd).astype(F32) / F32(dt)
    dq = (q1 - q0)[None, :]
    return q0[None, :] + s[:, None] * dq, sd[:, None] * dq, sdd[:, None] * dq
