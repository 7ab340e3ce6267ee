"""Calibrated latency/load model for edge-cloud co-inference (own copy of
``repro/runtime/latency.py``, pure Python).

The wall-times of this model are *modelled*, not measured.  The model has
three calibration constants fixed against the paper's anchor rows (Table
III Edge-Only and Cloud-Only):

    rate_edge  [ms/GB]  — edge device time per GB of resident model executed
    rate_cloud [ms/GB]  — cloud accelerator time per GB executed
    (network from runtime.channel)

Everything else (per-strategy latencies, ablations, noise degradation)
EMERGES from the trigger simulation: offload fractions, edge inference
events, mid-chunk interruptions, and monitor overhead.  The same machinery
reports any assigned architecture by swapping in its param-bytes and the
dry-run roofline time for the cloud side.

Load semantics follow the paper: "Load" columns are the *partition sizes*
(GB resident on each side); they sum to the full model.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict

from repro_torch.runtime.channel import ChannelConfig, query_latency_ms

# --- paper anchor rows (Table III, LIBERO simulation benchmark) -----------
FULL_MODEL_GB = 14.2          # OpenVLA-7B bf16 + vision stack, paper figure
EDGE_ONLY_MS = 782.5
CLOUD_ONLY_MS = 113.8


@dataclass(frozen=True)
class HardwareModel:
    full_model_gb: float = FULL_MODEL_GB
    channel: ChannelConfig = field(default_factory=ChannelConfig)
    chunk_len: int = 8
    # calibrated below
    rate_edge_ms_per_gb: float = 0.0
    rate_cloud_ms_per_gb: float = 0.0

    # quadratic cloud-time model: t(gb) = a·gb + b·gb² (bigger resident
    # splits span more devices/pipeline stages — superlinear comms cost).
    cloud_a: float = 0.0
    cloud_b: float = 0.0

    @staticmethod
    def calibrated(
        full_model_gb: float = FULL_MODEL_GB,
        edge_only_ms: float = EDGE_ONLY_MS,
        cloud_only_ms: float = CLOUD_ONLY_MS,
        safe_cloud_ms: float = 62.5,   # Table I standard row (baseline char.)
        safe_cloud_gb: float = 9.5,
        channel: ChannelConfig = ChannelConfig(),
        chunk_len: int = 8,
    ) -> "HardwareModel":
        """Calibrate on the paper's anchor rows.

        Anchors: Edge-Only (edge rate), Cloud-Only + the vision-baseline
        characterization from Table I (two points for the quadratic cloud
        model).  Every OTHER row of Tables III/IV/V is then a prediction.
        """

        net = query_latency_ms(channel, chunk_len)
        g1, t1 = safe_cloud_gb, safe_cloud_ms - net
        g2, t2 = full_model_gb, cloud_only_ms - net
        b = (t2 / g2 - t1 / g1) / (g2 - g1)
        a = t1 / g1 - b * g1
        return HardwareModel(
            full_model_gb=full_model_gb,
            channel=channel,
            chunk_len=chunk_len,
            rate_edge_ms_per_gb=edge_only_ms / full_model_gb,
            rate_cloud_ms_per_gb=(cloud_only_ms - net) / full_model_gb,
            cloud_a=a,
            cloud_b=b,
        )

    def cloud_time_ms(self, gb: float) -> float:
        if self.cloud_a or self.cloud_b:
            return self.cloud_a * gb + self.cloud_b * gb * gb
        return self.rate_cloud_ms_per_gb * gb


@dataclass(frozen=True)
class StrategyProfile:
    """Static partition + monitor costs of one partitioning strategy."""

    name: str
    edge_gb: float                 # resident split on the edge device
    monitor_overhead: float = 0.0  # fraction of edge compute (RAPID: 5-7%)
    # does the trigger itself require an edge forward pass? (vision-based
    # entropy does; kinematic triggers don't)
    trigger_needs_edge_pass: bool = False

    @property
    def cloud_gb(self) -> float:
        return FULL_MODEL_GB - self.edge_gb


# Partition sizes mirror the paper's Load columns (Table III/V).
PROFILES: Dict[str, StrategyProfile] = {
    "edge_only": StrategyProfile("edge_only", edge_gb=FULL_MODEL_GB),
    "cloud_only": StrategyProfile("cloud_only", edge_gb=0.0),
    "vision": StrategyProfile(
        "vision", edge_gb=4.7, trigger_needs_edge_pass=True
    ),
    "rapid": StrategyProfile("rapid", edge_gb=2.4, monitor_overhead=0.055),
    "rapid_no_comp": StrategyProfile("rapid_no_comp", edge_gb=4.0, monitor_overhead=0.04),
    "rapid_no_red": StrategyProfile("rapid_no_red", edge_gb=5.7, monitor_overhead=0.04),
}


@dataclass(frozen=True)
class SimCounters:
    """Per-episode event counts from the trigger simulation."""

    n_steps: int
    n_chunks: int            # chunk decisions (= steps / chunk_len)
    n_offloads: int          # cloud queries
    n_edge_infer: int        # full edge-part inferences (incl. wasted)
    n_interruptions: int     # mid-chunk preemptions (wasted partial work)
    n_spurious: int = 0      # offloads issued outside critical phases


@dataclass(frozen=True)
class LatencyReport:
    cloud_ms: float
    edge_ms: float
    total_ms: float
    cloud_gb: float
    edge_gb: float
    offload_fraction: float
    spurious_fraction: float
    interruptions_per_chunk: float


# congestion penalty: spurious offload storms saturate routing/network —
# calibrated against Table I's *visual_noise* row (the distraction row is
# then a prediction; see EXPERIMENTS.md §Repro)
CONGESTION_MS_PER_SPURIOUS = 1500.0
CLOUD_QUEUEING_PER_SPURIOUS = 1.7
# vision dynamic splitter shifts layers cloudward under offload pressure
# (Table I: SAFE edge load 4.7 -> 3.0 -> 1.2 GB); coefficient from the
# visual_noise row
SPLIT_SHIFT_PER_OFFLOAD = 3.0
SPLIT_SHIFT_FLOOR = 0.2


def evaluate(hw: HardwareModel, prof: StrategyProfile, c: SimCounters) -> LatencyReport:
    """Map simulation counters to the paper's latency decomposition.

    Semantics (matches Tables I/III/IV/V arithmetic): the Cloud-Side and
    Edge-Side columns decompose ONE end-to-end action-chunk inference under
    the strategy's partition —
      edge_ms  = edge-resident split execution (+ monitor overhead and
                 mid-chunk interruption waste measured in simulation),
      cloud_ms = network + cloud-resident split execution (0 if the strategy
                 never offloads),
      total    = edge_ms + cloud_ms (+ congestion when spurious offload
                 storms saturate the channel — the Table I noise pathology).
    """

    net = query_latency_ms(hw.channel, hw.chunk_len)
    chunks = max(c.n_chunks, 1)
    p_off = c.n_offloads / chunks
    spurious = c.n_spurious / chunks
    # fraction of edge work wasted by *spurious* mid-chunk preemptions
    waste = 0.5 * c.n_spurious / max(c.n_offloads + c.n_edge_infer, 1)

    offloads_at_all = c.n_offloads > 0
    edge_gb = prof.edge_gb
    if prof.trigger_needs_edge_pass and offloads_at_all:
        # vision dynamic splitter migrates layers cloudward as offload
        # pressure rises (Table I load shift 4.7 -> 3.0 -> 1.2 GB)
        baseline_p = 0.10
        shift = SPLIT_SHIFT_PER_OFFLOAD * max(p_off - baseline_p, 0.0)
        edge_gb = max(edge_gb * (1.0 - shift), prof.edge_gb * SPLIT_SHIFT_FLOOR)
    cloud_gb = hw.full_model_gb - edge_gb if offloads_at_all else 0.0

    cloud_ms = (net + hw.cloud_time_ms(cloud_gb)) if offloads_at_all else 0.0
    # queueing inflation at the cloud under spurious offload pressure
    cloud_ms *= 1.0 + CLOUD_QUEUEING_PER_SPURIOUS * spurious
    # vision-style triggers burn an edge pass per preemption (the entropy
    # computation *is* edge inference); kinematic monitors are out-of-band
    intr_waste = waste if prof.trigger_needs_edge_pass else 0.0
    if prof.trigger_needs_edge_pass:
        intr_waste = 0.5 * c.n_interruptions / max(c.n_offloads + c.n_edge_infer, 1)
    edge_ms = (
        edge_gb * hw.rate_edge_ms_per_gb
        * (1.0 + prof.monitor_overhead)
        * (1.0 + max(waste, intr_waste))
    )
    total = edge_ms + cloud_ms + CONGESTION_MS_PER_SPURIOUS * spurious
    return LatencyReport(
        cloud_ms=cloud_ms,
        edge_ms=edge_ms,
        total_ms=total,
        cloud_gb=cloud_gb,
        edge_gb=edge_gb,
        offload_fraction=p_off,
        spurious_fraction=spurious,
        interruptions_per_chunk=c.n_interruptions / chunks,
    )


def arch_hardware_model(param_bytes: int, chunk_len: int = 8) -> HardwareModel:
    """HardwareModel for an assigned architecture: scale the anchor rates by
    model size (latency ~ bytes moved on both devices)."""

    gb = param_bytes / 1e9
    return replace(
        HardwareModel.calibrated(chunk_len=chunk_len), full_model_gb=gb
    )
