"""Compatibility-optimal edge-cloud partitioning (RAPID pillar 2), the
port's counterpart of ``repro/partition``.

Three layers:
  * ``graph``    — lower a ``ModelConfig`` into a linear block-level
    inference graph: per block, resident/executed bytes, FLOPs, decode
    traffic, and the activation size at every cut point.
  * ``planner``  — enumerate cut points against a ``HardwareModel`` +
    ``ChannelConfig`` + the trigger's offload fraction, under edge/cloud
    memory budgets, returning a serializable ``PartitionPlan``.
  * ``executor`` — run a ``Model`` split at a layer boundary (the split
    forward, the split serving path and the scheduler's split lanes), on
    the same per-layer block functions as the fused path.
"""

from repro_torch.partition.graph import BlockNode, InferenceGraph, build_graph
from repro_torch.partition.planner import (
    NETWORK_PROFILES,
    CutAssignment,
    CutEval,
    PartitionPlan,
    assign_cuts,
    enumerate_cuts,
    enumerate_cuts_2d,
    plan_partition,
)
from repro_torch.partition.executor import PartitionExecutor, PartitionedPolicy

__all__ = [
    "BlockNode",
    "InferenceGraph",
    "build_graph",
    "NETWORK_PROFILES",
    "CutAssignment",
    "CutEval",
    "PartitionPlan",
    "assign_cuts",
    "enumerate_cuts",
    "enumerate_cuts_2d",
    "plan_partition",
    "PartitionExecutor",
    "PartitionedPolicy",
]
