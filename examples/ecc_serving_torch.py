"""End-to-end edge-cloud co-inference with the PyTorch/CUDA port and a real
model in the loop (the port's twin of ``examples/ecc_serving.py``).

The RAPID dispatcher monitors simulated manipulator kinematics; every
dispatch runs a real prefill and greedy action-token decode through the
OpenVLA-style backbone at smoke size (``--arch`` picks the family), on the
card unless ``--device cpu``.  One robot is served by ``CloudPolicy``
(dense per-row caches, or ``--paged`` the page pool), its chunks replayed
as CUDA graphs on the card.

With ``--fleet N`` the same cloud engine serves N robots through the
continuous-batching scheduler: dispatch triggers become requests that join
in-flight decode batches over the paged KV pool, and chunks come back a
few rounds later.  ``--partition auto`` (or an edge layer count) serves
every second robot through the edge-cloud split, the planned cut mapped
onto the smoke stack; ``--plan-2d`` adds an expert-offload lane on MoE
archs; ``--assign-cuts`` serves a second episode with per-robot cuts
assigned from the first's realized offload fractions; ``--arrivals
poisson|bursty`` serves a churning population through the trace-driven
harness instead; ``--sharded`` / ``--disaggregate-prefill`` split the
engine's pool and rows over a mesh and prefill on a stream (or device) of
its own.  ``--profile DIR`` wraps the fleet run in ``torch.profiler`` and
writes its Chrome trace to DIR.  Every mode runs the functions of
``repro_torch.launch.serve`` and ``repro_torch.runtime.fleet``.

    PYTHONPATH=src python examples/ecc_serving_torch.py --task drawer_open
    PYTHONPATH=src python examples/ecc_serving_torch.py --fleet 4 --trigger rapid --scan-rounds 4
    PYTHONPATH=src python examples/ecc_serving_torch.py --fleet 64 --arrivals poisson
    PYTHONPATH=src python examples/ecc_serving_torch.py --partition auto --network lan
    PYTHONPATH=src python examples/ecc_serving_torch.py --fleet 4 --partition auto --network lan
    PYTHONPATH=src python examples/ecc_serving_torch.py --fleet 6 --trigger rapid --assign-cuts
    PYTHONPATH=src python examples/ecc_serving_torch.py --fleet 4 --scan-rounds 4 --profile build/trace
    PYTHONPATH=src python examples/ecc_serving_torch.py --fleet 4 --scan-rounds 4 \\
        --trace-out trace.json --metrics-json metrics.json --device cpu
"""

import argparse
import contextlib
import json

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.data.pipeline import EpisodeTokenizer
from repro_torch.kernels import _lib
from repro_torch.launch.serve import (
    assign_fleet_cuts,
    build_policy,
    engine_placement,
    fleet_lanes,
    replan_from_telemetry,
    serve_episode,
    serve_fleet,
    write_obs,
)
from repro_torch.models.model import Model
from repro_torch.obs import Observability
from repro_torch.partition.planner import NETWORK_PROFILES
from repro_torch.runtime.fleet import make_trace, serve_trace


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="openvla-7b", choices=ARCH_IDS)
    p.add_argument("--task", default="pick_place",
                   choices=["pick_place", "drawer_open", "peg_insertion"])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    p.add_argument("--fleet", type=int, default=0,
                   help="serve N robots through the continuous-batching scheduler")
    p.add_argument("--partition", default="none",
                   help="'none', 'auto' (partition planner), or edge layer count")
    p.add_argument("--network", default="wan", choices=["lan", "wan", "congested"],
                   help="channel regime the partition planner prices")
    p.add_argument("--plan-2d", action="store_true",
                   help="plan over (cut layer x placement); MoE fleets also serve an "
                        "expert-offload lane beside the planned cut")
    p.add_argument("--paged", action="store_true",
                   help="single-robot decode through the paged KV substrate")
    p.add_argument("--arrivals", default=None, choices=["poisson", "bursty"],
                   help="serve --fleet N through the trace-driven churn harness "
                        "(robots join and leave mid-run) instead of a fixed fleet")
    p.add_argument("--mean-dwell", type=float, default=240.0,
                   help="mean episode dwell in ticks for --arrivals runs")
    p.add_argument("--tick", default="vectorized", choices=["vectorized", "legacy"],
                   help="fixed-fleet serving tick implementation")
    p.add_argument("--trigger", default="always", choices=["always", "rapid"],
                   help="fleet dispatch policy: always-offload or the closed-loop "
                        "redundancy-aware RAPID trigger")
    p.add_argument("--assign-cuts", action="store_true",
                   help="re-assign per-robot cuts from episode 1's realized offload "
                        "fractions and serve episode 2 with a heterogeneous cut frontier")
    p.add_argument("--k-max", type=int, default=3,
                   help="max distinct concurrently-active cuts")
    p.add_argument("--defer-hot", type=float, default=None,
                   help="cancellation-aware admission: preempt-rate threshold above "
                        "which a preempting robot's admission is held one round")
    p.add_argument("--scan-rounds", type=int, default=1,
                   help="decode rounds per scan window; >1 keeps the decode loop on the "
                        "device (CUDA-graph replays) between host syncs")
    p.add_argument("--sharded", action="store_true",
                   help="split the engine's page pool and decode rows over the data axis "
                        "of a mesh over the device's cards (one card: one shard)")
    p.add_argument("--disaggregate-prefill", action="store_true",
                   help="prefill admitted prompts on a device group of their own (one "
                        "card: a stream of its own), merged at window boundaries")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="wrap the fleet serve loop in torch.profiler, writing its Chrome "
                        "trace to DIR, and print per-window host-gap time")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write a Chrome-trace/Perfetto JSON of request lifecycles "
                        "(fleet mode)")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="dump the fleet run's metrics registry as flat JSON")
    return p


def profiling(out_dir, device: str):
    """``torch.profiler`` writing a Chrome trace into ``out_dir`` when the
    run ends (the card's kernels too on CUDA), or nothing."""

    if not out_dir:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts,
                                  on_trace_ready=torch.profiler.tensorboard_trace_handler(out_dir))


def churn(model, tok, args):
    """Robots join, dwell and leave; the engine reclaims their pages
    without a reset between episodes."""

    trace = make_trace(args.fleet, args.steps, args.arrivals, mean_dwell=args.mean_dwell, seed=0)
    obs = Observability(trace=False) if args.metrics_json else None
    out = serve_trace(model, tok, trace, args.steps, trigger=args.trigger,
                      channel=NETWORK_PROFILES[args.network], scan_rounds=args.scan_rounds,
                      obs=obs)
    print(f"churn: {out['joined']} joined, {out['left']} left early "
          f"({out['churn_cancels']} in-flight cancels), peak "
          f"{out['peak_active_robots']} active robots")
    print(f"served {out['completions']} chunks at {out['ticks_per_s']:.1f} ticks/s")
    if out["slo"] is not None:
        print(f"chunk latency p99: {out['slo']['chunk_latency_ms']['p99']:.1f} ms")
    print(f"kv pages: high-water {out['pool'].high_water}, "
          f"in use after drain {out['pool'].pages_in_use}")
    write_obs(obs, metrics_json=args.metrics_json)
    return out


def fleet(model, tok, args):
    want_obs = bool(args.trace_out or args.metrics_json)

    def mk_obs():
        return Observability(trace=args.trace_out is not None) if want_obs else None

    executor, split, robot_cuts = fleet_lanes(model, args.arch, args.fleet, args.partition,
                                              args.network, args.plan_2d)
    if split:
        print(f"mixed fleet: robots {split} serve through the split")
    if robot_cuts:
        print(f"expert-offload lane robots: "
              f"{[r for r, c in robot_cuts.items() if isinstance(c, tuple)]}")
    mesh, prefill_group = engine_placement(args.device, args.sharded, args.disaggregate_prefill)
    kw = dict(n_robots=args.fleet, max_steps=args.steps, channel=NETWORK_PROFILES[args.network],
              trigger=args.trigger, defer_hot_admission=args.defer_hot,
              scan_rounds=args.scan_rounds, tick=args.tick, mesh=mesh,
              prefill_group=prefill_group)
    with profiling(args.profile, args.device):
        out = serve_fleet(model, tok, partition_executor=executor, split_robots=split,
                          robot_cuts=robot_cuts, obs=mk_obs(), **kw)
    if args.assign_cuts:
        # close the loop heterogeneously: per-robot cuts from episode 1's
        # realized fractions, served in episode 2 on a cut frontier
        executor2, robot_cuts, _ = assign_fleet_cuts(model, args.arch, out["telemetry"],
                                                     args.network, k_max=args.k_max)
        if robot_cuts:
            out = serve_fleet(model, tok, partition_executor=executor2, robot_cuts=robot_cuts,
                              obs=mk_obs(), **kw)
            print(f"episode 2 robot cuts: {out['robot_cuts']} "
                  f"({len(out['active_cuts'])} distinct; "
                  f"{out['hetero_rounds']} hetero decode rounds)")
    write_obs(out["obs"], args.trace_out, args.metrics_json)
    pool, tel = out["pool"], out["telemetry"]
    print(f"chunks served: {len(out['service_rounds'])} (peak decode batch "
          f"{out['peak_batch']}, {out['decode_rounds']} decode rounds)")
    if args.profile or args.scan_rounds > 1:
        print(f"host orchestration: {out['scan_windows']} scan windows, "
              f"{out['host_gap_ms']:.2f} ms host gap per window "
              f"({args.scan_rounds} rounds/window)")
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    print(f"kv pages: high-water {pool.high_water}/{pool.pages_in_use + pool.pages_free}")
    if args.trigger == "rapid":
        print(f"redundancy-aware loop: {int(tel.replays.sum())} cached-chunk replays, "
              f"{int(tel.cancels.sum())} in-flight cancels, "
              f"realized f_off={tel.fleet_offload_fraction():.2f} "
              f"(per-robot {[round(float(f), 2) for f in tel.offload_fractions()]})")
    if split or out["split_robots"]:
        print(f"rounds with both kinds decoding: {out['mixed_rounds']}")
    if out["deferred"]:
        print(f"cancellation-aware admission: {out['deferred']} deferred")
    print(f"mean offload net: {np.mean(out['offload_ms']):.1f} ms (jittered)"
          if out["offload_ms"] else "no offloads")
    print(f"actions executed: {out['actions'].shape}")
    if args.trigger == "rapid" and args.partition != "none":
        # re-price the cut at the fleet's realized offload fraction
        replan_from_telemetry(args.arch, tel, args.network)
    return out


def single(model, tok, args):
    policy, _ = build_policy(model, tok, args.arch, args.partition, args.network,
                             paged=args.paged, plan_2d=args.plan_2d)
    out = serve_episode(policy, task=args.task, max_steps=args.steps, device=args.device)
    frac = out["offloads"] / max(out["steps"] // 8, 1)
    print(f"offload fraction: {frac:.2f} of chunk decisions")
    net_log = getattr(policy, "net_ms_log", None)
    if net_log:
        print(f"modeled channel cost: {np.mean(net_log):.1f} ms per offload")
    print(f"actions executed: {out['actions'].shape}")
    return out


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = get_smoke_config(args.arch)
    print(f"cloud model: {cfg.name} ({cfg.num_layers}L d={cfg.d_model}) on {args.device}")
    model = Model(cfg, device=args.device)
    tok = EpisodeTokenizer(cfg.vocab_size)
    _lib.reset_launch_counts()
    mode = churn if args.fleet and args.arrivals else fleet if args.fleet else single
    out = mode(model, tok, args)
    # the hand-written kernels this run launched (none on the CPU)
    print(f"kernel launches: {json.dumps(_lib.LAUNCHES)}")
    return out


if __name__ == "__main__":
    main()
