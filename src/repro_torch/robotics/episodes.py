"""Phase-structured synthetic manipulation episodes (numpy twin of
``repro/robotics/episodes.py``; host data, same rng stream, float32).

Episode tensors (all [T, ...]): q, qd, tau (the RAPID inputs), tau_ext
(contact torque), critical (phase label), ref_actions [T, A], phase_id.
``reference_chunks`` and ``edge_policy_chunks`` give the chunks a perfect
cloud policy and the small edge policy return at each step (the offline
engine's accounting).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Tuple

import numpy as np

from repro_torch.robotics.dynamics import ArmModel, inverse_dynamics, trapezoid_segment


class Episode(NamedTuple):
    q: np.ndarray
    qd: np.ndarray
    tau: np.ndarray
    tau_ext: np.ndarray
    critical: np.ndarray
    ref_actions: np.ndarray
    phase_id: np.ndarray
    task: str
    dt: float


@dataclass(frozen=True)
class TaskSpec:
    name: str
    phases: Tuple[Tuple[str, int], ...]  # (kind in {"move", "contact", "fine"}, steps)
    contact_torque: float = 2.5
    fine_torque: float = 1.2


TASKS = {
    "pick_place": TaskSpec(
        name="pick_place",
        phases=(("move", 220), ("contact", 60), ("move", 200), ("contact", 50), ("move", 120)),
        contact_torque=2.8,
    ),
    "drawer_open": TaskSpec(
        name="drawer_open",
        phases=(("move", 260), ("contact", 80), ("fine", 120), ("move", 180)),
        contact_torque=3.5,
        fine_torque=1.6,
    ),
    "peg_insertion": TaskSpec(
        name="peg_insertion",
        phases=(("move", 240), ("fine", 90), ("contact", 70), ("fine", 60), ("move", 140)),
        contact_torque=2.2,
        fine_torque=1.0,
    ),
}


def generate_episode(task: str, seed: int = 0, arm: ArmModel = ArmModel(),
                     dt: float = 0.002) -> Episode:
    """Build one episode from ``np.random.default_rng(seed)``."""

    spec = TASKS[task]
    rng = np.random.default_rng(seed)
    n = arm.n_joints
    q_parts: List[np.ndarray] = []
    qd_parts: List[np.ndarray] = []
    qdd_parts: List[np.ndarray] = []
    text_parts: List[np.ndarray] = []
    crit_parts: List[np.ndarray] = []
    phase_parts: List[np.ndarray] = []

    q_cur = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    for pid, (kind, steps) in enumerate(spec.phases):
        if kind == "move":
            target = q_cur + rng.uniform(-0.9, 0.9, n).astype(np.float32)
            # float32 waypoints, as the reference's jnp.asarray makes them
            # (q_cur is float64 after a contact phase)
            q, qd, qdd = trapezoid_segment(
                q_cur.astype(np.float32), target.astype(np.float32), steps, dt
            )
            text = np.zeros((steps, n), np.float32)
            crit = np.zeros(steps, bool)
            q_cur = target
        else:
            # contact / fine manipulation: micro-motions + external torque
            scale = 0.02 if kind == "contact" else 0.035
            jitter = rng.normal(0.0, scale, (steps, n)).astype(np.float32)
            kernel = np.ones(9) / 9.0
            jitter = np.apply_along_axis(lambda v: np.convolve(v, kernel, mode="same"), 0, jitter)
            q = q_cur[None, :] + np.cumsum(jitter, 0) * 0.1
            qd = np.gradient(q, dt, axis=0).astype(np.float32)
            qdd = np.gradient(qd, dt, axis=0).astype(np.float32)
            amp = spec.contact_torque if kind == "contact" else spec.fine_torque
            bursts = (rng.random((steps, 1)) < 0.35).astype(np.float32)
            profile = np.linspace(0.3, 1.0, n)[None, :] ** 2
            text = (amp * bursts * profile * (1.0 + 0.5 * rng.standard_normal((steps, n)))).astype(
                np.float32
            )
            crit = np.ones(steps, bool)
            q_cur = q[-1]
        q_parts.append(np.asarray(q, np.float32))
        qd_parts.append(np.asarray(qd, np.float32))
        qdd_parts.append(np.asarray(qdd, np.float32))
        text_parts.append(text)
        crit_parts.append(crit)
        phase_parts.append(np.full(steps, pid, np.int32))

    q = np.concatenate(q_parts)
    qd = np.concatenate(qd_parts)
    qdd = np.concatenate(qdd_parts)
    tau_ext = np.concatenate(text_parts)
    tau = np.asarray(inverse_dynamics(arm, q, qd, qdd, tau_ext), np.float32)
    tau = tau + rng.normal(0, 0.02, tau.shape).astype(np.float32)
    qd_meas = qd + rng.normal(0, 1e-4, qd.shape).astype(np.float32)
    ref_actions = np.roll(qd, -1, axis=0).astype(np.float32)
    ref_actions[-1] = qd[-1]
    return Episode(
        q=q, qd=qd_meas, tau=tau, tau_ext=tau_ext, critical=np.concatenate(crit_parts),
        ref_actions=ref_actions, phase_id=np.concatenate(phase_parts), task=task, dt=dt,
    )


def reference_chunks(ep: Episode, chunk_len: int) -> np.ndarray:
    """[T, k, A] — the chunk a *perfect* (cloud) policy returns if queried
    at step t: the next k reference actions."""

    t_len = ep.ref_actions.shape[0]
    idx = np.minimum(np.arange(t_len)[:, None] + np.arange(chunk_len)[None, :], t_len - 1)
    return ep.ref_actions[idx]


def edge_policy_chunks(ep: Episode, chunk_len: int, seed: int = 0, base_noise: float = 0.02,
                       contact_degradation: float = 6.0) -> np.ndarray:
    """Chunks from the small resident edge policy: accurate in free space,
    degraded during contact (it lacks the full VLA's context)."""

    rng = np.random.default_rng(seed + 1)
    chunks = reference_chunks(ep, chunk_len)
    scale = base_noise * (1.0 + contact_degradation * ep.critical[:, None, None])
    vel_scale = np.maximum(np.abs(chunks), 0.05)
    return (chunks + rng.standard_normal(chunks.shape) * scale * vel_scale).astype(np.float32)


def stale_penalty_mask(ep: Episode, executed_from: np.ndarray) -> np.ndarray:
    """Helper for accuracy scoring — see runtime.engine."""

    return ep.critical.astype(np.float32) * executed_from
