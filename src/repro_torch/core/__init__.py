"""RAPID core — the paper's contribution (torch twin of ``repro.core``).

Kinematic feature extraction (kinematics), rolling statistics (stats),
dual-threshold trigger (trigger), the Algorithm-1 edge dispatcher
(dispatcher), baseline partitioning strategies (baselines), and the
attention-redundancy analysis (redundancy).
"""

from repro_torch.core.dispatcher import (
    DispatcherConfig,
    DispatcherState,
    dispatcher_init,
    dispatcher_step,
    run_episode,
)
from repro_torch.core.trigger import TriggerConfig, TriggerState, trigger_init, trigger_step

__all__ = [
    "DispatcherConfig",
    "DispatcherState",
    "dispatcher_init",
    "dispatcher_step",
    "run_episode",
    "TriggerConfig",
    "TriggerState",
    "trigger_init",
    "trigger_step",
]
