"""RAPID dual-threshold trigger (paper §IV-C, Eq. 6-8); torch twin of
``repro/core/trigger.py``.  One kinematic frame per tick, O(1) state;
``run_trigger`` walks a whole [T, ..., N] stream."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import kinematics as kin
from repro_torch.core import stats as st


@dataclass(frozen=True)
class TriggerConfig:
    n_joints: int = 7
    dt: float = 0.002              # f_sensor = 500 Hz
    v_max: float = 2.0             # rad/s normalizer for phase weights
    theta_comp: float = 0.65       # compatibility-optimal threshold
    theta_red: float = 0.35        # redundancy-aware threshold
    window_acc: int = 64           # sliding window w_a
    window_tau: int = 16           # short moving-average window w_tau
    cooldown_steps: int = 8        # C — one action-chunk horizon
    end_joint_emphasis: float = 2.0
    warmup: int = 64               # no trigger until the windows are filled
    eps: float = 1e-6
    sigma_floor_acc: float = 1.0   # rad/s^2
    sigma_floor_tau: float = 0.05  # (N m)^2


class TriggerState(NamedTuple):
    qd_prev: torch.Tensor
    tau_prev: torch.Tensor
    acc_stats: st.WindowStats
    acc_running: st.RunningStats
    tau_window: st.WindowStats
    tau_stats: st.RunningStats
    cooldown: torch.Tensor  # [...] int32
    tick: torch.Tensor      # [...] int32


class TriggerOutput(NamedTuple):
    trigger: torch.Tensor     # bool: Eq. 7
    dispatch: torch.Tensor    # bool: Eq. 8 (cooldown-masked)
    importance: torch.Tensor
    score_acc: torch.Tensor
    score_tau: torch.Tensor
    w_acc: torch.Tensor
    raw_acc: torch.Tensor
    raw_tau: torch.Tensor


def trigger_init(cfg: TriggerConfig, batch_shape: Tuple[int, ...] = (),
                 device="cuda") -> TriggerState:
    zeros = torch.zeros(batch_shape + (cfg.n_joints,), dtype=torch.float32, device=device)
    i32 = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    return TriggerState(
        qd_prev=zeros,
        tau_prev=zeros,
        acc_stats=st.window_init(cfg.window_acc, batch_shape, device),
        acc_running=st.running_init(batch_shape, device),
        tau_window=st.window_init(cfg.window_tau, batch_shape, device),
        tau_stats=st.running_init(batch_shape, device),
        cooldown=i32,
        tick=i32,
    )


def trigger_step(state: TriggerState, frame: kin.KinematicFrame, cfg: TriggerConfig,
                 queue_empty: Optional[torch.Tensor] = None):
    """One monitor tick (Algorithm 1 lines 1-5 + Eq. 8 masking).

    ``queue_empty``: when given, a depleted queue forces a dispatch
    regardless of trigger and cooldown (Algorithm 1 line 6).
    """

    w_a = kin.end_joint_weights(cfg.n_joints, cfg.end_joint_emphasis, frame.qd.device)
    accel = kin.finite_diff_accel(frame.qd, state.qd_prev, cfg.dt)
    v_t = kin.velocity_norm(frame.qd)
    dtau = kin.torque_variation(frame.tau, state.tau_prev)

    m_acc = kin.accel_magnitude(accel, w_a)
    acc_stats = st.window_update(state.acc_stats, m_acc)
    acc_running = st.running_update(state.acc_running, m_acc)
    tau_pow = kin.torque_power(dtau, w_a)
    tau_window = st.window_update(state.tau_window, tau_pow)
    m_tau = st.window_moving_average(tau_window)  # Eq. 5
    tau_stats = st.running_update(state.tau_stats, m_tau)

    mu_a, sig_a = st.window_mean_std(acc_stats)
    _, sig_a_run = st.running_mean_std(acc_running)
    sig_a = torch.clamp(torch.maximum(sig_a, sig_a_run), min=cfg.sigma_floor_acc)
    score_acc = st.normalized_score(m_acc, mu_a, sig_a, cfg.eps)
    mu_t, sig_t = st.running_mean_std(tau_stats)
    sig_t = torch.clamp(sig_t, min=cfg.sigma_floor_tau)
    score_tau = st.normalized_score(m_tau, mu_t, sig_t, cfg.eps)

    omega_a, omega_t = kin.phase_weights(v_t, cfg.v_max)
    warm = state.tick >= cfg.warmup
    trig = warm & ((omega_a * score_acc > cfg.theta_comp) | (omega_t * score_tau > cfg.theta_red))

    dispatch = trig & (state.cooldown == 0)
    if queue_empty is not None:
        dispatch = dispatch | queue_empty
    cooldown = torch.where(
        dispatch,
        torch.full_like(state.cooldown, cfg.cooldown_steps),
        torch.clamp(state.cooldown - 1, min=0),
    )
    new_state = TriggerState(
        qd_prev=frame.qd, tau_prev=frame.tau, acc_stats=acc_stats, acc_running=acc_running,
        tau_window=tau_window, tau_stats=tau_stats, cooldown=cooldown, tick=state.tick + 1,
    )
    out = TriggerOutput(
        trigger=trig, dispatch=dispatch, importance=omega_a * score_acc + omega_t * score_tau,
        score_acc=score_acc, score_tau=score_tau, w_acc=omega_a, raw_acc=m_acc, raw_tau=m_tau,
    )
    return new_state, out


def run_trigger(cfg: TriggerConfig, frames: kin.KinematicFrame,
                state: Optional[TriggerState] = None) -> Tuple[TriggerState, TriggerOutput]:
    """The monitor over a [T, ..., N] stream, one ``trigger_step`` a tick
    (the reference's ``lax.scan``).  Returns the final state and each
    output field stacked over T."""

    if state is None:
        state = trigger_init(cfg, tuple(frames.q.shape[1:-1]), frames.q.device)
    outs = []
    for t in range(frames.q.shape[0]):
        state, out = trigger_step(state, kin.KinematicFrame(*(f[t] for f in frames)), cfg)
        outs.append(out)
    return state, TriggerOutput(*(torch.stack(field) for field in zip(*outs)))
