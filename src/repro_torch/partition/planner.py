"""Compatibility-optimal cut-point search over the partition graph (the
port's own copy of ``repro/partition/planner.py``, pure numpy; its
milliseconds come from ``runtime/latency.py``'s calibrated model, not from a
measurement of the port).

The planner enumerates every cut of the linear block graph (prefix sums make
the sweep O(N) — the "DP" degenerates to a scan because the graph is a
chain) and scores the *expected per-action-chunk latency* under:

  * the calibrated ``HardwareModel`` (ms per executed GB on each side, the
    quadratic cloud-span term),
  * a ``ChannelConfig`` network (cut-activation shipping for prefill, a
    per-token ping-pong for split decode, the paper's observation payload
    for the cloud-only cut),
  * the trigger's offload fraction ``f`` — the edge prefix runs every chunk
    (it IS the redundancy monitor's substrate), the cloud suffix only on the
    fraction of chunks the trigger actually offloads.  A cut at 0 (nothing
    resident on the edge) forces ``f = 1``: with no edge model there is no
    cached-chunk fallback, every chunk must be fetched — the compatibility
    constraint that makes cloud-only a *different regime*, not just a limit.

Cut semantics: ``cut == c`` puts ``nodes[:c]`` on the edge. ``c == 0`` is
cloud-only, ``c == len(nodes)`` is edge-only, both always enumerated — so
the chosen plan is never worse than either single-device deployment (among
feasible ones).

Memory feasibility: resident (not executed) bytes against per-side budgets;
tied-embedding models double-count the table when the cut separates the
lookup from the logits matmul.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.partition.graph import InferenceGraph, build_graph
from repro_torch.runtime.channel import (
    ChannelConfig,
    query_latency_ms,
    roundtrip_ms,
    ship_ms,
)
from repro_torch.runtime.latency import HardwareModel, arch_hardware_model

# the simulated RAPID kinematic trigger's offload rate on the episode suite
# (architecture-independent — the trigger reads sensors, not activations);
# the JAX package's benchmarks/partition_bench.py re-derives it from the
# live trigger sim
DEFAULT_OFFLOAD_FRACTION = 0.31

# per-cut staleness profile: the edge prefix IS the redundancy monitor's
# substrate, so a shallower prefix produces a staler redundancy estimate.
# ``DEFAULT_STALE_MISS_RATE`` is the fraction of REPLAYED chunks a stem-only
# monitor mis-classifies as redundant (divergence caught only by the safety
# net); it decays linearly to zero as the edge prefix deepens to the full
# stack.  Every miss costs a corrective cloud-only refetch — the robot
# cannot trust its own prefix for the fix-up.
DEFAULT_STALE_MISS_RATE = 0.5

# deployment-class defaults: a Jetson-class edge box, an effectively
# unbounded cloud pool
DEFAULT_EDGE_MEM_GB = 8.0

TOKEN_ID_BYTES = 4.0  # ping-pong downlink payload: one sampled token id

NETWORK_PROFILES: Dict[str, ChannelConfig] = {
    "lan": ChannelConfig(rtt_ms=1.0, uplink_mbps=1000.0, downlink_mbps=1000.0,
                         jitter_ms=0.2),
    "wan": ChannelConfig(),  # the paper's serving setup (8 ms RTT, 200/400)
    "congested": ChannelConfig(rtt_ms=40.0, uplink_mbps=20.0,
                               downlink_mbps=50.0, jitter_ms=12.0),
}


def interior_net_ms(
    channel: ChannelConfig,
    prompt_act_bytes: float,
    tok_act_bytes: float,
    n_decode_tokens: int,
    pipelined: bool = False,
) -> Dict[str, float]:
    """Network cost of an interior cut, decomposed.

    Prefill: one uplink shipping the cut activations of the whole prompt.
    Decode: the suffix owner holds the LM head, the prefix owner the
    embedding, so every action token ping-pongs — cut activation up, sampled
    token id down, one RTT each — which is exactly why interior cuts win on
    LAN and lose on WAN.

    ``pipelined`` prices the overlapped split decode (ROADMAP "pipelined
    split decode", pricing side only): while the cloud suffix computes token
    ``t``, the edge prefix already runs token ``t+1`` behind it, so the
    token-id downlink and the return half of the RTT hide under compute and
    only ONE channel leg — half the RTT plus the cut-activation uplink —
    stays exposed per decode token.
    """

    prefill = channel.rtt_ms + ship_ms(prompt_act_bytes, channel.uplink_mbps)
    if pipelined:
        per_tok = channel.rtt_ms / 2.0 + ship_ms(tok_act_bytes, channel.uplink_mbps)
    else:
        per_tok = (
            channel.rtt_ms
            + ship_ms(tok_act_bytes, channel.uplink_mbps)
            + ship_ms(TOKEN_ID_BYTES, channel.downlink_mbps)
        )
    return {
        "prefill_ms": prefill,
        "per_token_ms": per_tok,
        "total_ms": prefill + n_decode_tokens * per_tok,
    }


@dataclass(frozen=True)
class CutEval:
    """One scored cut point."""

    cut: int
    feasible: bool
    edge_gb: float          # resident
    cloud_gb: float         # resident (0 when the cut never offloads)
    edge_exec_gb: float
    cloud_exec_gb: float
    offload_fraction: float  # effective (forced to 1.0 at cut 0, 0.0 at N)
    edge_ms: float
    cloud_ms: float
    net_ms: float
    total_ms: float          # expected per-chunk: edge + f*(net + cloud)
    # per-cut staleness profile (``per_cut_fraction=True`` pricing only)
    stale_ms: float = 0.0    # expected corrective-refetch cost per chunk
    sim_fraction: Optional[float] = None  # simulated cloudward fraction
    # (planned offloads + staleness refetches) under THIS cut's profile
    # --- 2-D plan coordinates (``enumerate_cuts_2d``) ---------------------
    # ``placement``: "" = the plain 1-D cut; "experts_cloud" = the listed
    # edge layers' experts live cloud-side behind gather/scatter legs;
    # "monitor" = the edge prefix is a redundancy-monitor substrate only and
    # the cloud holds a full replica; "encoder_edge" = the modality encoder
    # runs edge-side at cut 0 and its output (not raw pixels) crosses up.
    placement: str = ""
    expert_offload: Tuple[int, ...] = ()   # model layer indices, ascending
    net_expert_ms: float = 0.0             # gather/scatter legs per chunk


@dataclass(frozen=True)
class PartitionPlan:
    """Serializable deployment plan: where to cut, what it costs."""

    arch: str
    cut: int                 # node-space cut (nodes[:cut] on the edge)
    cut_layer: int           # transformer layers resident on the edge
    n_nodes: int
    mode: str                # cloud_only | edge_only | split
    edge_gb: float
    cloud_gb: float
    edge_exec_gb: float
    cloud_exec_gb: float
    offload_fraction: float
    edge_ms: float
    cloud_ms: float
    net_ms: float
    total_ms: float
    edge_only_ms: Optional[float]   # None when the edge budget can't hold it
    cloud_only_ms: Optional[float]
    prompt_len: int
    chunk_tokens: int
    edge_mem_gb: float
    channel: Dict[str, float] = field(default_factory=dict)
    pipelined: bool = False   # overlapped split-decode pricing used
    per_cut_fraction: bool = False  # per-cut staleness pricing used
    stale_ms: float = 0.0
    sim_fraction: Optional[float] = None
    # 2-D plan coordinates (``plan_partition(plan_2d=True)``); defaulted so
    # every existing 1-D construction site keeps working unchanged
    plan_2d: bool = False
    placement: str = ""
    expert_offload: Tuple[int, ...] = ()
    net_expert_ms: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "PartitionPlan":
        d = json.loads(s)
        # JSON has no tuple: restore the dataclass-default type so a
        # round-tripped plan compares equal to the original
        d["expert_offload"] = tuple(d.get("expert_offload", ()))
        return cls(**d)

    def summary(self) -> str:
        extra = ""
        if self.placement == "experts_cloud":
            extra = (
                f" experts_cloud={len(self.expert_offload)} layer(s) "
                f"(+{self.net_expert_ms:.1f}ms legs)"
            )
        elif self.placement:
            extra = f" placement={self.placement}"
        return (
            f"{self.arch}: {self.mode} cut={self.cut}/{self.n_nodes} "
            f"({self.cut_layer} layers on edge){extra} "
            f"edge={self.edge_gb:.2f}GB "
            f"cloud={self.cloud_gb:.2f}GB f_off={self.offload_fraction:.2f} "
            f"-> {self.total_ms:.1f}ms "
            f"(edge {self.edge_ms:.1f} + net {self.net_ms:.1f} "
            f"+ cloud {self.cloud_ms:.1f}; "
            f"edge-only {self.edge_only_ms and round(self.edge_only_ms, 1)}, "
            f"cloud-only {self.cloud_only_ms and round(self.cloud_only_ms, 1)})"
        )


def enumerate_cuts(
    graph: InferenceGraph,
    hw: HardwareModel,
    channel: Optional[ChannelConfig] = None,
    *,
    offload_fraction: float = DEFAULT_OFFLOAD_FRACTION,
    edge_mem_gb: float = DEFAULT_EDGE_MEM_GB,
    cloud_mem_gb: float = float("inf"),
    pipelined: bool = False,
    per_cut_fraction: bool = False,
    stale_miss_rate: float = DEFAULT_STALE_MISS_RATE,
) -> List[CutEval]:
    """Score every cut of ``graph`` under ``hw`` + ``channel``.

    ``pipelined``: price interior cuts with overlapped split decode — the
    two sides compute concurrently (``max(edge, cloud)`` instead of their
    sum on offloaded chunks) and each decode token pays one exposed channel
    leg instead of the full ping-pong.  Single-device cuts are unaffected.

    ``per_cut_fraction``: simulate the trigger's offload behaviour under
    each cut's OWN staleness profile instead of one global fraction.  The
    edge prefix is the redundancy monitor's substrate, so a shallow prefix
    mis-classifies ``stale_miss_rate * (1 - depth)`` of its replayed chunks
    as redundant; every miss is charged a corrective cloud-only refetch
    (observation upload + full-stack cloud inference — the robot cannot
    trust its own prefix for the fix-up).  Deeper edge prefixes therefore
    buy lower effective cloudward traffic, which is exactly the lever
    ``assign_cuts`` uses to give high-redundancy robots deeper prefixes.
    Boundary cuts are untouched: cut 0 never replays (``f = 1``) and the
    full-depth prefix never goes stale.
    """

    channel = channel or hw.channel
    n = len(graph.nodes)
    n_layers = max(n - 2, 1)
    # normalize graph bytes so the resident total matches the hardware
    # model's calibrated full_model_gb (the paper's 14.2 GB includes the
    # vision stack our stub under-counts; per-arch models scale by 1.0)
    scale = hw.full_model_gb / (graph.total_param_bytes / 1e9)

    res = [nd.param_bytes * scale / 1e9 for nd in graph.nodes]
    exe = [nd.exec_bytes * scale / 1e9 for nd in graph.nodes]
    # corrective refetch = the paper's cloud-only query shape over the FULL
    # executed stack (cut-independent: a stale miss invalidates the local
    # chunk wholesale)
    refetch_ms = (
        query_latency_ms(channel, hw.chunk_len) + hw.cloud_time_ms(sum(exe))
        if per_cut_fraction else 0.0
    )
    evals: List[CutEval] = []
    for cut in range(n + 1):
        edge_gb = sum(res[:cut])
        cloud_gb = sum(res[cut:])
        edge_exec = sum(exe[:cut])
        cloud_exec = sum(exe[cut:])
        if graph.tie_embeddings and 0 < cut < n:
            # the suffix's logits matmul needs the embedding table too
            cloud_gb += graph.embed_bytes * scale / 1e9

        if cut == 0:
            f_eff = 1.0
        elif cut == n:
            f_eff, cloud_gb, cloud_exec = 0.0, 0.0, 0.0
        else:
            f_eff = offload_fraction

        if cut == n:
            net = 0.0
        elif cut == 0:
            # raw observation payload, the paper's cloud-query shape
            net = query_latency_ms(channel, hw.chunk_len)
        else:
            act_tok = graph.nodes[cut - 1].cut_act_bytes
            net = interior_net_ms(
                channel,
                graph.prompt_len * act_tok,
                act_tok,
                graph.chunk_tokens,
                pipelined=pipelined,
            )["total_ms"]

        edge_ms = edge_exec * hw.rate_edge_ms_per_gb
        cloud_ms = hw.cloud_time_ms(cloud_exec) if f_eff > 0.0 else 0.0
        if pipelined and 0 < cut < n:
            # overlapped split decode: on offloaded chunks the edge prefix
            # of token t+1 hides behind the cloud suffix of token t, so the
            # compute term is max(edge, cloud), not their sum; ``net``
            # already charges one exposed leg per token
            total = (1.0 - f_eff) * edge_ms + f_eff * (
                max(edge_ms, cloud_ms) + net
            )
        else:
            total = edge_ms + f_eff * (net + cloud_ms)
        stale_ms, sim_fraction = 0.0, None
        if per_cut_fraction:
            depth = graph.cut_layers(cut) / n_layers if cut > 0 else 0.0
            miss = stale_miss_rate * (1.0 - depth)
            stale_ms = (1.0 - f_eff) * miss * refetch_ms
            sim_fraction = min(1.0, f_eff + (1.0 - f_eff) * miss)
            total += stale_ms
        feasible = edge_gb <= edge_mem_gb + 1e-9 and cloud_gb <= cloud_mem_gb + 1e-9
        evals.append(
            CutEval(
                cut=cut,
                feasible=feasible,
                edge_gb=edge_gb,
                cloud_gb=cloud_gb,
                edge_exec_gb=edge_exec,
                cloud_exec_gb=cloud_exec,
                offload_fraction=f_eff,
                edge_ms=edge_ms,
                cloud_ms=cloud_ms,
                net_ms=net,
                total_ms=total,
                stale_ms=stale_ms,
                sim_fraction=sim_fraction,
            )
        )
    return evals


def enumerate_cuts_2d(
    graph: InferenceGraph,
    hw: HardwareModel,
    channel: Optional[ChannelConfig] = None,
    *,
    offload_fraction: float = DEFAULT_OFFLOAD_FRACTION,
    edge_mem_gb: float = DEFAULT_EDGE_MEM_GB,
    cloud_mem_gb: float = float("inf"),
    pipelined: bool = False,
    per_cut_fraction: bool = False,
    stale_miss_rate: float = DEFAULT_STALE_MISS_RATE,
    executable_only: bool = False,
) -> List[CutEval]:
    """Score the 2-D plan space: (cut layer x placement).

    The option set at every cut INCLUDES the plain 1-D point (``placement
    == ""``), so the 2-D minimum is never worse than the 1-D minimum by
    construction — 1-D cuts are a strict subset of this space.  Three
    placement families extend it:

      * **experts_cloud** — for an interior (or edge-only) cut whose edge
        prefix contains MoE blocks, the trailing ``j`` MoE blocks' experts
        live cloud-side: their resident bytes leave the edge budget, and
        every decode token pays a gather/scatter round trip per offloaded
        block (top-k hidden states up on the uplink, the expert-mixture
        output back on the downlink).  The edge prefix is the monitor
        substrate and runs every chunk, so the legs — and the cloud's
        expert FFN time — are charged at fraction 1, not ``f``; this is the
        honest price of keeping router+attention edge-side when the experts
        don't fit (the jamba regime: 19 GB of experts per MoE block against
        an 8 GB edge).
      * **monitor** — the edge prefix is kept purely as the redundancy
        monitor's substrate while the cloud holds a FULL replica
        (resident-vs-executed asymmetry applied at the system level: cloud
        residency is cheap, edge residency is not).  Offloaded chunks are
        single-leg full-stack cloud queries (prompt cut-activations up,
        action token ids down) instead of the per-token ping-pong — which
        is what frees the big MoE archs from ``cloud_only`` on WAN.  A
        monitor-only prefix contributes nothing to offloaded computation,
        so its staleness cost is INTRINSIC and always charged (even under
        global-fraction pricing): ``(1-f) * miss(depth) * refetch``.
      * **encoder_edge** — at cut 0, the modality encoder (vision
        projector / audio encoder stack) runs edge-side and its OUTPUT
        crosses the uplink instead of the raw observation payload; wins
        exactly when the encoded tokens are smaller than the compressed
        observation (seamless: 28 KB vs 80 KB) and is priced either way.

    ``executable_only`` restricts the space to the placements the split
    executor realizes today — plain cuts and ``experts_cloud`` lanes
    (monitor-resident prefixes and encoder staging are priced-only
    deployments); the restricted minimum is still never worse than 1-D.
    """

    channel = channel or hw.channel
    n = len(graph.nodes)
    n_layers = max(n - 2, 1)
    scale = hw.full_model_gb / (graph.total_param_bytes / 1e9)
    res = [nd.param_bytes * scale / 1e9 for nd in graph.nodes]
    exe = [nd.exec_bytes * scale / 1e9 for nd in graph.nodes]
    exp_res = [nd.expert_param_bytes * scale / 1e9 for nd in graph.nodes]
    exp_exe = [nd.expert_exec_bytes * scale / 1e9 for nd in graph.nodes]
    total_exec = sum(exe)
    full_refetch_ms = query_latency_ms(channel, hw.chunk_len) + hw.cloud_time_ms(
        total_exec
    )

    # the 1-D points, bit-identical to the 1-D planner's own evals
    evals = enumerate_cuts(
        graph, hw, channel,
        offload_fraction=offload_fraction,
        edge_mem_gb=edge_mem_gb,
        cloud_mem_gb=cloud_mem_gb,
        pipelined=pipelined,
        per_cut_fraction=per_cut_fraction,
        stale_miss_rate=stale_miss_rate,
    )
    base = {e.cut: e for e in evals}
    out = list(evals)
    f = offload_fraction

    def _stale(cut: int, f_eff: float, always: bool = False):
        """(stale_ms, sim_fraction) for a prefix of node-cut ``cut``."""

        if not (per_cut_fraction or always):
            return 0.0, None
        depth = graph.cut_layers(cut) / n_layers if cut > 0 else 0.0
        miss = stale_miss_rate * (1.0 - depth)
        return (
            (1.0 - f_eff) * miss * full_refetch_ms,
            min(1.0, f_eff + (1.0 - f_eff) * miss),
        )

    # --- experts_cloud: trailing expert offload at every deeper cut -------
    for cut in range(1, n + 1):
        edge_moe = [
            i for i in range(cut) if graph.nodes[i].is_moe and exp_res[i] > 0
        ]
        b = base[cut]
        for j in range(1, len(edge_moe) + 1):
            off = edge_moe[-j:]  # the j deepest edge MoE blocks
            moved_res = sum(exp_res[i] for i in off)
            moved_exe = sum(exp_exe[i] for i in off)
            edge_gb = b.edge_gb - moved_res
            cloud_gb = b.cloud_gb + moved_res
            edge_exec = b.edge_exec_gb - moved_exe
            cloud_exec = b.cloud_exec_gb + moved_exe
            act = graph.nodes[0].cut_act_bytes  # d_model bf16 everywhere
            # gather/scatter legs, per offloaded block: top-k hidden states
            # up, the mixed expert output down — prefill ships the whole
            # prompt's worth, decode one token's worth per step; charged
            # every chunk (the edge monitor pass needs the expert outputs)
            net_exp = 0.0
            for i in off:
                k = graph.nodes[i].moe_top_k
                net_exp += roundtrip_ms(
                    channel, graph.prompt_len * k * act, graph.prompt_len * act
                )
                net_exp += graph.chunk_tokens * roundtrip_ms(
                    channel, k * act, act
                )
            exp_cloud_ms = hw.cloud_time_ms(moved_exe)
            edge_ms = edge_exec * hw.rate_edge_ms_per_gb
            if cut == n:
                # edge-only body, experts cloudward: no suffix to offload to
                f_eff = 0.0
                cloud_gb = moved_res
                cloud_exec = moved_exe
                total = edge_ms + net_exp + exp_cloud_ms
                cloud_ms = exp_cloud_ms
                net_cut = 0.0
            else:
                f_eff = f
                cloud_ms = hw.cloud_time_ms(cloud_exec)
                net_cut = b.net_ms
                if pipelined:
                    total = (1.0 - f_eff) * (edge_ms + exp_cloud_ms + net_exp) + (
                        f_eff * (max(edge_ms, cloud_ms) + net_cut + net_exp)
                    )
                else:
                    total = (
                        edge_ms
                        + net_exp
                        + (1.0 - f_eff) * exp_cloud_ms
                        + f_eff * (net_cut + cloud_ms)
                    )
            stale_ms, sim_fraction = _stale(cut, f_eff)
            total += stale_ms
            feasible = (
                edge_gb <= edge_mem_gb + 1e-9 and cloud_gb <= cloud_mem_gb + 1e-9
            )
            out.append(CutEval(
                cut=cut, feasible=feasible,
                edge_gb=edge_gb, cloud_gb=cloud_gb,
                edge_exec_gb=edge_exec, cloud_exec_gb=cloud_exec,
                offload_fraction=f_eff,
                edge_ms=edge_ms, cloud_ms=cloud_ms,
                net_ms=net_cut, total_ms=total,
                stale_ms=stale_ms, sim_fraction=sim_fraction,
                placement="experts_cloud",
                expert_offload=tuple(
                    graph.nodes[i].layer for i in off
                ),
                net_expert_ms=net_exp,
            ))

    # --- monitor: prefix as redundancy substrate, full replica cloud ------
    for cut in range(1, n) if not executable_only else ():
        b = base[cut]
        edge_gb = sum(res[:cut])
        cloud_gb = sum(res)  # full replica; tied table already counted once
        edge_exec = sum(exe[:cut])
        edge_ms = edge_exec * hw.rate_edge_ms_per_gb
        cloud_ms = hw.cloud_time_ms(total_exec)
        act = graph.nodes[cut - 1].cut_act_bytes
        net = roundtrip_ms(
            channel,
            graph.prompt_len * act,
            graph.chunk_tokens * TOKEN_ID_BYTES,
        )
        stale_ms, sim_fraction = _stale(cut, f, always=True)
        total = edge_ms + f * (net + cloud_ms) + stale_ms
        feasible = (
            edge_gb <= edge_mem_gb + 1e-9 and cloud_gb <= cloud_mem_gb + 1e-9
        )
        out.append(CutEval(
            cut=cut, feasible=feasible,
            edge_gb=edge_gb, cloud_gb=cloud_gb,
            edge_exec_gb=edge_exec, cloud_exec_gb=total_exec,
            offload_fraction=f,
            edge_ms=edge_ms, cloud_ms=cloud_ms,
            net_ms=net, total_ms=total,
            stale_ms=stale_ms, sim_fraction=sim_fraction,
            placement="monitor",
        ))

    # --- encoder_edge: the modality encoder as its own stage at cut 0 -----
    if graph.encoder_out_bytes > 0 and not executable_only:
        enc_res = graph.encoder_param_bytes * scale / 1e9
        enc_exe = graph.encoder_exec_bytes * scale / 1e9
        edge_ms = enc_exe * hw.rate_edge_ms_per_gb
        cloud_exec = total_exec - enc_exe
        cloud_ms = hw.cloud_time_ms(cloud_exec)
        net = roundtrip_ms(
            channel,
            graph.encoder_out_bytes,
            hw.chunk_len * channel.per_action_bytes,
        )
        total = edge_ms + net + cloud_ms  # f = 1: no LM prefix, no replay
        feasible = (
            enc_res <= edge_mem_gb + 1e-9
            and sum(res) - enc_res <= cloud_mem_gb + 1e-9
        )
        out.append(CutEval(
            cut=0, feasible=feasible,
            edge_gb=enc_res, cloud_gb=sum(res) - enc_res,
            edge_exec_gb=enc_exe, cloud_exec_gb=cloud_exec,
            offload_fraction=1.0,
            edge_ms=edge_ms, cloud_ms=cloud_ms,
            net_ms=net, total_ms=total,
            placement="encoder_edge",
        ))

    return out


def evaluate_cut(
    cfg: ModelConfig,
    cut: int,
    hw: Optional[HardwareModel] = None,
    channel: Optional[ChannelConfig] = None,
    *,
    offload_fraction: float = DEFAULT_OFFLOAD_FRACTION,
    edge_mem_gb: float = DEFAULT_EDGE_MEM_GB,
    cloud_mem_gb: float = float("inf"),
    graph: Optional[InferenceGraph] = None,
    pipelined: bool = False,
    per_cut_fraction: bool = False,
    stale_miss_rate: float = DEFAULT_STALE_MISS_RATE,
) -> CutEval:
    """Re-price one FIXED cut under a (possibly different) offload fraction.

    This is how telemetry feedback closes the planner loop: a plan chosen
    under the global trigger-sim fraction can be re-scored at the fleet's
    *realized* per-robot fraction and compared against
    ``plan_partition(offload_fraction=realized)`` — the re-planned cut is
    never worse, because the planner minimizes over all cuts at that
    fraction (``tests/test_torch_partition_plan.py`` holds it to the
    reference's).
    """

    if graph is None:
        graph = build_graph(cfg)
    if hw is None:
        hw = arch_hardware_model(int(graph.total_param_bytes))
    evals = enumerate_cuts(
        graph, hw, channel or hw.channel,
        offload_fraction=offload_fraction,
        edge_mem_gb=edge_mem_gb,
        cloud_mem_gb=cloud_mem_gb,
        pipelined=pipelined,
        per_cut_fraction=per_cut_fraction,
        stale_miss_rate=stale_miss_rate,
    )
    if not 0 <= cut < len(evals):
        raise ValueError(f"cut {cut} outside [0, {len(evals) - 1}]")
    return evals[cut]


def plan_partition(
    cfg: ModelConfig,
    hw: Optional[HardwareModel] = None,
    channel: Optional[ChannelConfig] = None,
    *,
    offload_fraction: float = DEFAULT_OFFLOAD_FRACTION,
    edge_mem_gb: float = DEFAULT_EDGE_MEM_GB,
    cloud_mem_gb: float = float("inf"),
    prompt_len: Optional[int] = None,
    chunk_tokens: Optional[int] = None,
    graph: Optional[InferenceGraph] = None,
    pipelined: bool = False,
    per_cut_fraction: bool = False,
    stale_miss_rate: float = DEFAULT_STALE_MISS_RATE,
    plan_2d: bool = False,
    executable_only: bool = False,
) -> PartitionPlan:
    """Choose the compatibility-optimal cut for ``cfg``.

    ``hw`` defaults to the calibrated anchor rates scaled to this
    architecture's parameter bytes (``arch_hardware_model``).
    ``pipelined=True`` prices interior cuts with overlapped split decode
    (never worse than the serial ping-pong, so splits only get MORE viable).
    ``per_cut_fraction=True`` grows ``offload_fraction`` into a per-cut
    simulated fraction under each cut's own staleness profile — shallow
    edge prefixes are charged corrective refetches on the replayed share.
    ``plan_2d=True`` plans over (cut layer x placement) via
    ``enumerate_cuts_2d`` — expert offload, monitor-resident prefixes, and
    encoder-stage placement; never worse than the 1-D plan because every
    1-D cut is in the 2-D option set.  ``executable_only`` (2-D only)
    restricts the placements to what the split executor can serve today
    (plain cuts + expert-offload lanes) — what ``plan_fleet_partition``
    realizes on a live fleet.
    """

    if graph is None:
        kw = {}
        if chunk_tokens is not None:
            kw["chunk_tokens"] = chunk_tokens
        graph = build_graph(cfg, prompt_len=prompt_len, **kw)
    if hw is None:
        hw = arch_hardware_model(int(graph.total_param_bytes))
    channel = channel or hw.channel

    kw2d = {"executable_only": executable_only} if plan_2d else {}
    enum = enumerate_cuts_2d if plan_2d else enumerate_cuts
    evals = enum(
        graph, hw, channel,
        offload_fraction=offload_fraction,
        edge_mem_gb=edge_mem_gb,
        cloud_mem_gb=cloud_mem_gb,
        pipelined=pipelined,
        per_cut_fraction=per_cut_fraction,
        stale_miss_rate=stale_miss_rate,
        **kw2d,
    )
    feasible = [e for e in evals if e.feasible]
    if not feasible:
        raise ValueError(
            f"no feasible cut for {cfg.name}: smallest suffix exceeds the "
            f"cloud budget ({cloud_mem_gb} GB)"
        )
    best = min(feasible, key=lambda e: e.total_ms)
    n = len(graph.nodes)
    # the single-device references are always the plain 1-D boundary points
    edge_only = next(e for e in evals if e.cut == n and not e.placement)
    cloud_only = next(e for e in evals if e.cut == 0 and not e.placement)
    if best.placement == "experts_cloud":
        mode = "expert_split"
    elif best.placement == "monitor":
        mode = "monitor_split"
    elif best.placement == "encoder_edge":
        mode = "encoder_split"
    else:
        mode = "cloud_only" if best.cut == 0 else (
            "edge_only" if best.cut == n else "split"
        )
    return PartitionPlan(
        arch=cfg.name,
        cut=best.cut,
        cut_layer=graph.cut_layers(best.cut),
        n_nodes=n,
        mode=mode,
        edge_gb=best.edge_gb,
        cloud_gb=best.cloud_gb,
        edge_exec_gb=best.edge_exec_gb,
        cloud_exec_gb=best.cloud_exec_gb,
        offload_fraction=best.offload_fraction,
        edge_ms=best.edge_ms,
        cloud_ms=best.cloud_ms,
        net_ms=best.net_ms,
        total_ms=best.total_ms,
        edge_only_ms=edge_only.total_ms if edge_only.feasible else None,
        cloud_only_ms=cloud_only.total_ms if cloud_only.feasible else None,
        prompt_len=graph.prompt_len,
        chunk_tokens=graph.chunk_tokens,
        edge_mem_gb=edge_mem_gb,
        channel=dataclasses.asdict(channel),
        pipelined=pipelined,
        per_cut_fraction=per_cut_fraction,
        stale_ms=best.stale_ms,
        sim_fraction=best.sim_fraction,
        plan_2d=plan_2d,
        placement=best.placement,
        expert_offload=tuple(best.expert_offload),
        net_expert_ms=best.net_expert_ms,
    )


# ---------------------------------------------------------------------------
# per-robot cut assignment (heterogeneous fleets)
# ---------------------------------------------------------------------------

# floor applied to realized fractions before assignment: a robot that never
# offloaded still needs the occasional refresh priced in, and f = 0 would
# degenerate interior cuts to prefix-only cost
FRACTION_FLOOR = 0.02


@dataclass(frozen=True)
class CutAssignment:
    """Per-robot cut assignment over a small frontier of concurrent cuts.

    ``cuts[r]`` is robot ``r``'s node-space cut (0 = cloud-only, ``n_nodes``
    = edge-only), ``cut_layers[r]`` the matching edge-resident transformer
    layer count (``-1`` for cloud-only robots, which keep no edge prefix at
    all — not even the stem).  ``frontier`` lists the distinct active cuts,
    at most ``k_max`` of them.  ``total_ms`` sums each robot's expected
    per-chunk latency at its REALIZED offload fraction under per-cut
    staleness pricing; ``best_single_ms`` is the same fleet served on the
    best single global cut — the assignment is never worse (a constant
    assignment is always in the monotone feasible set).
    """

    arch: str
    cuts: Tuple[int, ...]
    cut_layers: Tuple[int, ...]
    fractions: Tuple[float, ...]       # clipped realized per-robot fractions
    frontier: Tuple[int, ...]          # distinct active cuts, ascending
    per_robot_ms: Tuple[float, ...]
    total_ms: float
    best_single_cut: int
    best_single_ms: float
    k_max: int

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def summary(self) -> str:
        by_cut: Dict[int, int] = {}
        for c in self.cuts:
            by_cut[c] = by_cut.get(c, 0) + 1
        lanes = " ".join(f"cut{c}x{by_cut[c]}" for c in sorted(by_cut))
        return (
            f"{self.arch}: {len(self.frontier)} active cut(s) [{lanes}] "
            f"fleet {self.total_ms:.1f}ms vs best single cut "
            f"{self.best_single_cut} @ {self.best_single_ms:.1f}ms "
            f"({self.best_single_ms - self.total_ms:+.1f}ms saved)"
        )


def assign_cuts(
    telemetry: Union[Sequence[float], np.ndarray, "object"],
    k_max: int = 3,
    *,
    cfg: Optional[ModelConfig] = None,
    hw: Optional[HardwareModel] = None,
    channel: Optional[ChannelConfig] = None,
    edge_mem_gb: float = DEFAULT_EDGE_MEM_GB,
    cloud_mem_gb: float = float("inf"),
    graph: Optional[InferenceGraph] = None,
    pipelined: bool = False,
    stale_miss_rate: float = DEFAULT_STALE_MISS_RATE,
    max_cut: Optional[int] = None,
) -> CutAssignment:
    """Map each robot's realized offload fraction to a cut from a frontier.

    ``max_cut`` caps the deepest assignable cut — serving callers pass
    ``len(graph.nodes) - 1`` to exclude the pure edge-only deployment the
    split executor cannot run (the LM head always lives cloud-side), so
    fully-redundant robots land on the deepest EXECUTABLE split and are
    priced with its real ping-pong cost instead of edge-only's zero net.

    ``telemetry`` is a ``FleetTelemetry`` (its ``offload_fractions()`` are
    used) or a plain sequence of per-robot realized fractions.  Every cut is
    priced per robot with ``per_cut_fraction`` staleness pricing at that
    robot's fraction; the fleet assignment is then the exact minimizer of
    the summed per-chunk latency subject to two deployment constraints:

      * **monotone**: a robot with higher realized redundancy (lower
        fraction) never gets a *shallower* edge prefix than a robot with
        lower redundancy — the frontier orders robots by how much they
        lean on their local monitor;
      * **at most ``k_max`` distinct cuts** — each active cut costs a
        sliced parameter set and a suffix pool group on the cloud, so the
        frontier stays small.

    Solved by DP over robots sorted by fraction (descending) with
    non-decreasing cuts; a constant assignment is always feasible, so the
    result is never worse than the best single global cut at the same
    telemetry.
    """

    fractions = np.asarray(
        telemetry.offload_fractions()
        if hasattr(telemetry, "offload_fractions") else telemetry,
        np.float64,
    )
    if fractions.ndim != 1 or fractions.shape[0] == 0:
        raise ValueError("telemetry must carry at least one robot's fraction")
    if k_max < 1:
        raise ValueError("k_max must be >= 1")
    if cfg is None and graph is None:
        raise ValueError("assign_cuts needs cfg= or graph=")
    if graph is None:
        graph = build_graph(cfg)
    if hw is None:
        hw = arch_hardware_model(int(graph.total_param_bytes))
    channel = channel or hw.channel
    arch = cfg.name if cfg is not None else graph.arch

    clipped = np.clip(fractions, FRACTION_FLOOR, 1.0)
    n_cuts = len(graph.nodes) + 1
    n_robots = clipped.shape[0]

    # per-robot cost table (cache identical fractions — evaluation is the
    # expensive part for big graphs)
    cost = np.full((n_robots, n_cuts), np.inf)
    eval_cache: Dict[float, List[CutEval]] = {}
    for r, f in enumerate(clipped):
        key = float(f)
        evals = eval_cache.get(key)
        if evals is None:
            evals = enumerate_cuts(
                graph, hw, channel,
                offload_fraction=key,
                edge_mem_gb=edge_mem_gb,
                cloud_mem_gb=cloud_mem_gb,
                pipelined=pipelined,
                per_cut_fraction=True,
                stale_miss_rate=stale_miss_rate,
            )
            eval_cache[key] = evals
        for e in evals:
            if e.feasible and (max_cut is None or e.cut <= max_cut):
                cost[r, e.cut] = e.total_ms
    if not np.isfinite(cost).any(axis=1).all():
        raise ValueError(f"no feasible cut for some robot of {arch}")

    # DP over robots in DESCENDING fraction order: cuts must be
    # non-decreasing along the order (lower fraction -> deeper-or-equal).
    order = np.argsort(-clipped, kind="stable")
    m = cost[order]
    # dp[c, k]: best cost so far with the current robot on cut c using at
    # most k+1 distinct cuts; parents remember (prev_cut) per (robot, c, k).
    dp = np.tile(m[0][:, None], (1, k_max))
    parent = np.full((n_robots, n_cuts, k_max), -1, np.int64)
    for i in range(1, n_robots):
        ndp = np.full_like(dp, np.inf)
        for k in range(k_max):
            # stay on the same cut (distinct count unchanged)
            stay = dp[:, k]
            ndp[:, k] = stay
            parent[i, :, k] = np.arange(n_cuts)
            if k > 0:
                # move to a strictly deeper cut (one more distinct cut)
                prev = dp[:, k - 1]
                best_prev = np.full(n_cuts, np.inf)
                best_arg = np.full(n_cuts, -1, np.int64)
                run_min, run_arg = np.inf, -1
                for c in range(n_cuts):
                    best_prev[c], best_arg[c] = run_min, run_arg
                    if prev[c] < run_min:
                        run_min, run_arg = prev[c], c
                deeper = best_prev
                take = deeper < ndp[:, k]
                ndp[take, k] = deeper[take]
                parent[i, take, k] = best_arg[take]
        dp = ndp + m[i][:, None]
    # the at-most-k recurrence makes dp[:, k_max-1] the global optimum
    end_c = int(np.argmin(dp[:, k_max - 1]))
    total = float(dp[end_c, k_max - 1])

    # backtrack (re-deriving the distinct-count lane from the parents)
    assigned_sorted = np.empty(n_robots, np.int64)
    c, k = end_c, k_max - 1
    for i in range(n_robots - 1, -1, -1):
        assigned_sorted[i] = c
        if i:
            prev_c = int(parent[i, c, k])
            if prev_c != c:
                k -= 1
            c = prev_c
    cuts = np.empty(n_robots, np.int64)
    cuts[order] = assigned_sorted

    fleet_by_cut = cost.sum(axis=0)       # inf where any robot infeasible
    best_single_cut = int(np.argmin(fleet_by_cut))
    best_single_ms = float(fleet_by_cut[best_single_cut])

    cut_layers = tuple(
        graph.cut_layers(int(c)) if c > 0 else -1 for c in cuts
    )
    per_robot = tuple(float(cost[r, cuts[r]]) for r in range(n_robots))
    return CutAssignment(
        arch=arch,
        cuts=tuple(int(c) for c in cuts),
        cut_layers=cut_layers,
        fractions=tuple(float(f) for f in clipped),
        frontier=tuple(sorted({int(c) for c in cuts})),
        per_robot_ms=per_robot,
        total_ms=total,
        best_single_cut=best_single_cut,
        best_single_ms=best_single_ms,
        k_max=k_max,
    )
