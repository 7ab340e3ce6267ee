"""Trace-driven fleet serving: thousands of robot actors, one real engine;
torch twin of ``repro/runtime/fleet.py``:
``python -m repro_torch.runtime.fleet --fleet 256 --device cuda [--partition 1]``.

Robots are lightweight stepped actors — an index into a small pool of
pre-generated episodes plus a phase offset — while the one heavy inference
server is the real ``ContinuousBatchingScheduler`` (paged KV pool, scan
windows of CUDA-graph decode rounds).

A ``FleetTrace`` drives the population: Poisson or bursty arrival ticks,
plus episode churn — robots leave mid-serve and their in-flight work is
reclaimed through ``cancel_batch`` (queue removal or dead-marking inside
the dispatched scan window), so pages return to the pool without any
engine reset.  Every tick is array-at-a-time: one gather builds the whole
fleet's kinematic frame from the pre-stacked episode pool, one call steps
the batched decision core on the model's device (join resets fused into
the same step as ``torch.where`` over the state's fields), and at most one
``cancel_batch`` + one ``submit_batch`` reaches the scheduler.

With a ``PartitionExecutor`` and ``robot_cuts``, the listed robots serve
through the scheduler's split lanes (one per distinct cut), sharing its
rounds and page pool with the cloud-only robots.

Pass an ``Observability`` and the run returns a full ``SLOReport`` (p50/p99
chunk latency, queue wait, goodput, cancel rate, pool high-water).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.obs import build_slo_report
from repro_torch.obs.clock import clock
from repro_torch.robotics.episodes import generate_episode
from repro_torch.runtime.channel import ChannelConfig, PRNGKey, sample_latency_ms_batch
from repro_torch.runtime.policy import (
    DecisionCore,
    FleetTelemetry,
    TriggerDecision,
    fleet_policy_config,
)
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler

DEFAULT_TASKS = ["pick_place", "drawer_open", "peg_insertion"]


class FleetTrace(NamedTuple):
    """Per-robot arrival/departure schedule plus episode-pool assignment.

    ``join_tick``/``leave_tick`` bound each robot's single live interval
    ``[join, leave)`` (robots do not rejoin); ``leave_tick == horizon``
    means the robot serves to the end.  ``episode`` indexes the pooled
    episode bank and ``offset`` phase-shifts it, so thousands of actors
    stay cheap: no per-robot episode generation, just a gather.
    """

    join_tick: np.ndarray   # [R] int64
    leave_tick: np.ndarray  # [R] int64, exclusive
    episode: np.ndarray     # [R] int64 index into the episode pool
    offset: np.ndarray      # [R] int64 phase offset into the episode

    @property
    def n_robots(self) -> int:
        return int(self.join_tick.shape[0])

    def active_at(self, t: int) -> np.ndarray:
        return (self.join_tick <= t) & (t < self.leave_tick)


def _dwell_and_pool(
    rng: np.random.Generator,
    join: np.ndarray,
    horizon: int,
    mean_dwell: Optional[float],
    n_episodes: int,
) -> FleetTrace:
    n = join.shape[0]
    if mean_dwell is None:
        leave = np.full(n, horizon, np.int64)
    else:
        # exponential dwell with a floor of one chunk-ish interval, so a
        # departing robot has had time to put real work in flight
        dwell = np.maximum(rng.exponential(mean_dwell, n), 8.0)
        leave = np.minimum(join + np.ceil(dwell).astype(np.int64), horizon)
    return FleetTrace(
        join_tick=join.astype(np.int64),
        leave_tick=leave,
        episode=rng.integers(0, n_episodes, n).astype(np.int64),
        offset=rng.integers(0, 4096, n).astype(np.int64),
    )


def poisson_trace(
    n_robots: int,
    horizon: int,
    rate: Optional[float] = None,
    mean_dwell: Optional[float] = None,
    seed: int = 0,
    n_episodes: int = len(DEFAULT_TASKS),
) -> FleetTrace:
    """Poisson arrivals: exponential inter-arrival gaps at ``rate``/tick.

    The default rate lands the whole fleet within the first half of the
    horizon, so steady state (everyone live) is still observed.
    ``mean_dwell`` (ticks) turns on churn: each robot leaves after an
    exponential dwell instead of serving to the end.
    """

    rng = np.random.default_rng(seed)
    if rate is None:
        rate = n_robots / max(horizon * 0.5, 1.0)
    gaps = rng.exponential(1.0 / rate, n_robots)
    join = np.minimum(np.floor(np.cumsum(gaps)), horizon - 1).astype(np.int64)
    return _dwell_and_pool(rng, join, horizon, mean_dwell, n_episodes)


def bursty_trace(
    n_robots: int,
    horizon: int,
    burst_every: int = 32,
    burst_size: Optional[int] = None,
    mean_dwell: Optional[float] = None,
    seed: int = 0,
    n_episodes: int = len(DEFAULT_TASKS),
) -> FleetTrace:
    """Clustered arrivals: ``burst_size`` robots land every ``burst_every``
    ticks (±2 ticks of within-burst jitter) — the thundering-herd shape
    that stresses page-bounded admission much harder than Poisson."""

    rng = np.random.default_rng(seed)
    if burst_size is None:
        n_bursts = max(horizon // (2 * burst_every), 1)
        burst_size = -(-n_robots // n_bursts)
    burst_idx = np.arange(n_robots) // max(burst_size, 1)
    join = burst_idx * burst_every + rng.integers(0, 3, n_robots)
    join = np.minimum(join, horizon - 1).astype(np.int64)
    return _dwell_and_pool(rng, join, horizon, mean_dwell, n_episodes)


def make_trace(n_robots: int, horizon: int, arrivals: str = "poisson", **kw) -> FleetTrace:
    if arrivals == "poisson":
        return poisson_trace(n_robots, horizon, **kw)
    if arrivals == "bursty":
        return bursty_trace(n_robots, horizon, **kw)
    raise ValueError(f"arrivals must be 'poisson' or 'bursty', got {arrivals!r}")


def serve_trace(
    model,
    tokenizer,
    trace: FleetTrace,
    horizon: int,
    chunk_len: int = 8,
    n_joints: int = 7,
    max_slots: int = 32,
    num_pages: Optional[int] = None,
    scan_rounds: int = 1,
    trigger: str = "rapid",
    trigger_cfg=None,
    channel=None,
    partition_executor=None,
    robot_cuts: Optional[Dict[int, int]] = None,
    tasks: Optional[List[str]] = None,
    seed: int = 0,
    obs=None,
    verbose: bool = True,
) -> Dict[str, object]:
    """Serve a ``FleetTrace`` population against the real scheduler.

    Same decision core, scheduler, channel model and SLO layer as
    ``serve_fleet`` — the differences are population dynamics (arrivals +
    churn from ``trace``) and actor weight (episode-pool gathers instead of
    per-robot episodes).  Robots joining at tick t have their decision-core
    rows reset inside the tick's step; robots leaving mid-serve get their
    queued / in-flight work reclaimed with ``cancel_batch`` — reset-free
    page reclamation, the pool never restarts.  ``robot_cuts`` ({robot:
    cut}, with ``partition_executor``) routes robots through split lanes,
    one ``with_cut`` sibling per distinct cut.

    Returns a dict with the SLO report (when ``obs`` is given), churn and
    decision counters, pool stats, the host ticks/s of the run, and the
    live scheduler (``"sched"``), whose tail work a caller may ``drain``.
    """

    pcfg = fleet_policy_config(trigger, chunk_len, n_joints, trigger_cfg)
    n_robots = trace.n_robots
    all_tasks = tasks or DEFAULT_TASKS
    n_pool = int(trace.episode.max()) + 1 if n_robots else 1

    # episode pool: a handful of generated episodes, pre-stacked to
    # [T_pool, E, N] — robot r's frame at tick t is one gather row
    pool_eps = [generate_episode(all_tasks[e % len(all_tasks)], seed=seed + e)
                for e in range(n_pool)]
    t_pool = min(ep.q.shape[0] for ep in pool_eps)
    q_pool = np.stack([ep.q[:t_pool] for ep in pool_eps], axis=1)
    qd_pool = np.stack([ep.qd[:t_pool] for ep in pool_eps], axis=1)
    tau_pool = np.stack([ep.tau[:t_pool] for ep in pool_eps], axis=1)

    core = DecisionCore(pcfg, n_robots, model.device)
    telemetry = FleetTelemetry(n_robots, obs=obs)
    sched = ContinuousBatchingScheduler(
        model, tokenizer, max_slots=max_slots, chunk_len=chunk_len, n_joints=n_joints,
        num_pages=num_pages, scan_rounds=scan_rounds, obs=obs,
    )
    robot_cuts = dict(robot_cuts or {})
    if partition_executor is not None and robot_cuts:
        for c in sorted(set(robot_cuts.values())):
            sched.attach_partition(partition_executor.with_cut(c))
    else:
        robot_cuts = {}
    split_mask = np.zeros(n_robots, bool)
    cut_arr = np.full(n_robots, -1, np.int64)
    for r, c in robot_cuts.items():
        split_mask[r] = True
        cut_arr[r] = c

    channel = channel or ChannelConfig()
    net_key = PRNGKey(seed + 7919)
    cached = np.zeros((n_robots, chunk_len, n_joints), np.float32)
    in_flight = np.zeros(n_robots, bool)
    n_done = np.zeros(n_robots, np.int64)
    offload_ms: List[float] = []
    wait_rounds: List[int] = []
    joined = left = churn_cancels = 0
    peak_active = 0
    rows = np.arange(n_robots)

    t_start = clock()
    for t in range(horizon):
        active = trace.active_at(t)
        peak_active = max(peak_active, int(active.sum()))
        join_mask = trace.join_tick == t
        join_ids = rows[join_mask]
        leave_ids = rows[trace.leave_tick == t]
        joined += join_ids.size
        left += leave_ids.size
        if leave_ids.size:
            # churn: reclaim departing robots' pages without an engine reset
            # — queued requests are removed, in-window sequences dead-marked
            # and released at the boundary
            stale = leave_ids[in_flight[leave_ids]]
            if stale.size:
                hits = sched.cancel_batch(stale)
                telemetry.note_cancels(stale[hits])
                churn_cancels += int(hits.sum())
                in_flight[stale] = False
        if obs is not None and (join_ids.size or leave_ids.size):
            m = obs.metrics
            if join_ids.size:
                m.counter("fleet.joins").inc(int(join_ids.size))
            if leave_ids.size:
                m.counter("fleet.leaves").inc(int(leave_ids.size))
            m.gauge("fleet.active_robots").set(float(active.sum()))

        # one gather builds the whole fleet's frame from the episode pool
        time_idx = (t - trace.join_tick + trace.offset) % t_pool
        dec = core.step(q_pool[time_idx, trace.episode], qd_pool[time_idx, trace.episode],
                        tau_pool[time_idx, trace.episode], join=join_mask)
        off = dec.offload & active
        rep = dec.replayed & active
        pre = dec.preempt & active
        telemetry.observe(TriggerDecision(offload=off, replayed=rep, preempt=pre,
                                          slot=dec.slot, trig=None))
        if trigger == "rapid":
            cancel_ids = np.flatnonzero(off & in_flight)
            if cancel_ids.size:
                hits = sched.cancel_batch(cancel_ids)
                telemetry.note_cancels(cancel_ids[hits])
                in_flight[cancel_ids] = False
            ids = np.flatnonzero(off)
        else:
            ids = np.flatnonzero(off & ~in_flight)
        if ids.size:
            sched.submit_batch(ids, qd_pool[time_idx[ids], trace.episode[ids]],
                               tau_pool[time_idx[ids], trace.episode[ids]],
                               partitioned=split_mask[ids], cuts=cut_arr[ids])
            in_flight[ids] = True
        results = sched.step()
        if results:
            res_ids = np.fromiter((res.robot_id for res in results), np.int64,
                                  count=len(results))
            toks = np.stack([res.tokens for res in results])
            cached[res_ids] = tokenizer.decode_action(toks).reshape(
                len(results), chunk_len, n_joints)
            in_flight[res_ids] = False
            telemetry.note_completions(res_ids)
            wait_rounds.extend(res.completed_round - res.submitted_round for res in results)
            ms = sample_latency_ms_batch(channel, chunk_len, net_key, res_ids, n_done[res_ids])
            n_done[res_ids] += 1
            offload_ms.extend(ms)

    wall_s = clock() - t_start
    pool = sched.pool_stats()
    slo = None
    if obs is not None:
        obs.metrics.gauge("serve.wall_s").set(wall_s)
        slo = build_slo_report(obs.metrics)
    out = {
        "slo": slo.to_json() if slo is not None else None,
        "obs": obs,
        "n_robots": n_robots,
        "ticks": horizon,
        "wall_s": wall_s,
        "ticks_per_s": horizon / wall_s if wall_s > 0 else 0.0,
        "joined": joined,
        "left": left,
        "churn_cancels": churn_cancels,
        "peak_active_robots": peak_active,
        "completions": int(telemetry.completions.sum()),
        "fires": int(telemetry.fires.sum()),
        "replays": int(telemetry.replays.sum()),
        "cancels": int(telemetry.cancels.sum()),
        "service_rounds": wait_rounds,
        "offload_ms": offload_ms,
        "peak_batch": sched.peak_active,
        "decode_rounds": sched.decode_rounds,
        "scan_windows": sched.windows,
        "pool": pool,
        "pending": sched.n_pending,
        "in_flight": int(in_flight.sum()),
        "telemetry": telemetry,
        "trigger": trigger,
        "sched": sched,
    }
    if verbose:
        print(
            f"fleet={n_robots} horizon={horizon} trigger={trigger} "
            f"joined={joined} left={left} churn_cancels={churn_cancels} "
            f"completions={out['completions']} fires={out['fires']} "
            f"peak_active={peak_active} peak_batch={sched.peak_active} "
            f"kv_pages={pool.pages_in_use}/{pool.pages_in_use + pool.pages_free} "
            f"(high-water {pool.high_water}) "
            f"ticks_per_s={out['ticks_per_s']:.1f}"
        )
        if slo is not None:
            for line in slo.lines():
                print(line)
    return out


def main(argv=None):
    """Fleet harness CLI: ``python -m repro_torch.runtime.fleet --fleet 1000``."""

    import argparse
    import json

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import EpisodeTokenizer
    from repro_torch.models.model import Model
    from repro_torch.obs import Observability

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fleet", type=int, default=256, help="number of robots")
    p.add_argument("--horizon", type=int, default=240, help="control ticks")
    p.add_argument("--arrivals", choices=("poisson", "bursty"), default="poisson")
    p.add_argument("--mean-dwell", type=float, default=None,
                   help="mean ticks before a robot churns out (default: robots serve "
                        "to the horizon)")
    p.add_argument("--trigger", choices=("always", "rapid"), default="rapid")
    p.add_argument("--max-slots", type=int, default=16)
    p.add_argument("--scan-rounds", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--partition", type=int, default=None, metavar="CUT",
                   help="serve every second robot split after CUT edge layers")
    p.add_argument("--device", default="cuda",
                   help="where the model and the decision core run (cuda or cpu)")
    p.add_argument("--metrics-json", metavar="PATH", default=None,
                   help="dump the run's metrics registry as JSON")
    args = p.parse_args(argv)

    cfg = get_smoke_config("openvla-7b")
    model = Model(cfg, device=args.device)
    tok = EpisodeTokenizer(cfg.vocab_size)
    trace = make_trace(args.fleet, args.horizon, arrivals=args.arrivals,
                       mean_dwell=args.mean_dwell, seed=args.seed)
    obs = Observability(trace=False)
    executor, robot_cuts = None, None
    if args.partition is not None:
        from repro_torch.partition.executor import PartitionExecutor

        executor = PartitionExecutor(model, args.partition)
        robot_cuts = {r: args.partition for r in range(1, args.fleet, 2)}
    out = serve_trace(model, tok, trace, horizon=args.horizon, max_slots=args.max_slots,
                      scan_rounds=args.scan_rounds, trigger=args.trigger, seed=args.seed,
                      partition_executor=executor, robot_cuts=robot_cuts, obs=obs,
                      verbose=True)
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(obs.metrics.to_json(), f, indent=2)
        print(f"metrics -> {args.metrics_json}")
    return out


if __name__ == "__main__":
    main()
