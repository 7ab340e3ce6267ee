"""Serving entry point of the port:
``python -m repro_torch.launch.serve [--arch openvla-7b] [--paged] [--device cuda]``,
a fleet: ``... --fleet 16 --trigger rapid --scan-rounds 4``, or either split
between edge and cloud: ``... --partition auto|N [--network lan]``.

Counterpart of ``repro/launch/serve.py``; its data shards share one device
and its prefill runs on the decode device (ROADMAP queue I, items 4-5).  Two serving modes:

  * ``serve_episode`` — one robot: the RAPID dispatcher monitors simulated
    robot kinematics tick by tick, and on each dispatch the cloud VLA
    (prefill + greedy decode of an action chunk through the KV cache)
    produces a fresh chunk.  ``CloudPolicy`` decodes through dense per-row
    slabs (``fused``: no host sync per token; or the per-token loop) or
    through the paged KV substrate (``paged=True``); on a CUDA model both
    replay a CUDA graph per shape.  ``build_policy`` may instead return a
    ``PartitionedPolicy``, the same chunk run split after a planned or a
    given edge layer count.
  * ``serve_fleet`` — many robots sharing one cloud engine through the
    continuous-batching scheduler (``runtime/scheduler.py``, decode rounds
    replayed as CUDA graphs): each tick the fleet's decision core
    (``runtime/policy.py`` ``DecisionCore``) decides, triggers become
    requests that join in-flight decode batches, and chunks come back a few
    rounds later.  ``--trigger rapid`` replays cached chunks on redundant
    depletions and cancels in-flight work on contact-phase preemption.
    With a ``PartitionExecutor``, robots listed in ``split_robots`` or
    ``robot_cuts`` serve through the edge-cloud split: their cloud
    suffixes share the rounds and the page pool with the cloud-only robots
    (``plan_fleet_partition``, ``plan_expert_lane``, ``assign_fleet_cuts``,
    ``replan_from_telemetry`` choose the cuts from the partition planner).

The planner's milliseconds (``plan.summary()``, ``net_ms``) come from the
calibrated latency model of ``runtime/latency.py`` and the channel model,
not from the card.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.dispatcher import DispatcherConfig, dispatcher_init, dispatcher_step
from repro_torch.core.kinematics import KinematicFrame
from repro_torch.core.trigger import TriggerConfig
from repro_torch.data.pipeline import EpisodeTokenizer
from repro_torch.launch.mesh import (host_devices, make_host_mesh, make_test_mesh,
                                     split_device_groups)
from repro_torch.models.model import Model
from repro_torch.obs import Observability, build_slo_report
from repro_torch.obs.clock import clock
from repro_torch.robotics.episodes import generate_episode
from repro_torch.runtime.channel import (
    ChannelConfig,
    PRNGKey,
    fold_in,
    sample_latency_ms,
    sample_latency_ms_batch,
)
from repro_torch.runtime.graphs import GraphedCall, owner_call
from repro_torch.runtime.kv_cache import PagedSpec
from repro_torch.runtime.policy import DecisionCore, FleetTelemetry, fleet_policy_config
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler, _lane_order


class CloudPolicy:
    """Batched VLA serving: observation tokens -> k-step action chunk.

    ``fused=True`` (default) decodes the ``chunk_len * n_joints`` tokens with
    ``Model.decode_chunk`` (tokens stay on the device until the chunk is
    done); ``fused=False`` keeps the per-token loop that copies each token
    to the host (the reference's own baseline; always eager).
    ``paged=True`` scatters the prompt KV into a page pool of
    ``page_size``-token pages after prefill and decodes through the paged
    attention kernel.  All three give the same greedy chunks up to
    floating-point ties.

    On a CUDA model the fused and the paged chunk (prefill included) replay
    a CUDA graph built per ``(B, prompt_len)`` (the reference jits per
    shape; ``runtime.graphs.GraphedCall``).  A dense chunk's decode lengths
    are host ints (prompt_len .. prompt_len + n_steps - 1), the same at
    every call of a shape, so the graph holds the whole chunk and the
    decode kernel keeps its host-int length path.  On a CPU model the same
    function runs eagerly (``eager_chunk``).  A recurrent stack (Mamba,
    xLSTM) keeps its state in the same cache, updated in place by the graph.

    An encoder-decoder stack is refused: a chunk's prompt is observation
    tokens only, and its encoder needs frames (the reference's
    ``CloudPolicy`` fails there with ``KeyError: 'frontend'``).
    """

    def __init__(self, model: Model, tokenizer: EpisodeTokenizer, chunk_len: int = 8,
                 n_joints: int = 7, fused: bool = True, paged: bool = False,
                 page_size: int = 16):
        if model.cfg.encoder_decoder:
            raise NotImplementedError(
                f"CloudPolicy serves decoder-only stacks: {model.cfg.name} needs encoder "
                "frames (\"frontend\") that an observation prompt does not carry")
        self.model = model
        self.tok = tokenizer
        self.chunk_len = chunk_len
        self.n_joints = n_joints
        self.fused = fused
        self.paged = paged
        self.page_size = page_size
        self.n_steps = chunk_len * n_joints
        self._graphs = {}  # (B, prompt_len) -> (static tokens, GraphedCall)

    def _page_plan(self, b: int, prompt: int):
        """(spec, page table, caps) of a chunk: ``b`` rows, each with its own
        pages for the prompt and the chunk."""

        page = self.page_size
        maxp = -(-(prompt + self.n_steps) // page)
        spec = PagedSpec(num_pages=b * maxp, page_size=page, max_pages_per_seq=maxp)
        i32 = dict(dtype=torch.int32, device=self.model.device)
        pt = torch.arange(b * maxp, **i32).reshape(b, maxp)
        return spec, pt, torch.full((b,), maxp * page, **i32)

    def _chunk(self, tokens, plan=None):
        """Prefill + greedy decode of one chunk -> (tokens [B, n_steps], the
        next logits [B, 1, V])."""

        m, floor = self.model, self.tok.action_base
        if self.paged:
            spec, pt, caps = plan
            logits, dcache = m.prefill({"tokens": tokens}, extra=0)
            cache = m.cache_to_paged(dcache, m.init_paged_cache(tokens.shape[0], spec), pt, caps)
        else:
            logits, cache = m.prefill({"tokens": tokens}, extra=self.n_steps)
        toks, logits, _ = m.decode_chunk(logits, cache, self.n_steps, floor)
        return toks, logits

    def eager_chunk(self, tokens):
        """The chunk that ``chunk`` replays, run eagerly: ``Model.prefill`` and
        ``Model.decode_chunk`` -> (action tokens [B, n_steps], the next
        logits [B, 1, V])."""

        b, prompt = tokens.shape
        return self._chunk(tokens, self._page_plan(b, prompt) if self.paged else None)

    def chunk(self, tokens):
        """tokens [B, S] on the model's device -> (action tokens [B, n_steps],
        the next logits [B, 1, V]); on a CUDA model a graph replay (its
        outputs hold until the next call), eager over a gloo group."""

        if not self.model.graphs:
            return self.eager_chunk(tokens)
        b, prompt = tokens.shape
        entry = self._graphs.get((b, prompt))
        if entry is None:
            plan = self._page_plan(b, prompt) if self.paged else None
            static = tokens.clone()
            entry = (static, GraphedCall(owner_call(self, "_chunk", static, plan)))
            self._graphs[(b, prompt)] = entry
        static, call = entry
        static.copy_(tokens)
        return call()

    def chunk_tokens(self, qd: np.ndarray, tau: np.ndarray) -> np.ndarray:
        """qd/tau [B, N] -> greedy action tokens [B, chunk_len * n_joints]."""

        obs = np.concatenate([self.tok.encode_state(qd), self.tok.encode_state(tau)], axis=1)
        tokens = torch.as_tensor(obs, device=self.model.device)
        if self.fused or self.paged:
            return self.chunk(tokens)[0].cpu().numpy()
        # per-token loop: mask to the action bins, argmax, sync to host
        logits, cache = self.model.prefill({"tokens": tokens}, extra=self.n_steps)
        floor = torch.arange(logits.shape[-1], device=logits.device) < self.tok.action_base
        acts = []
        for _ in range(self.n_steps):
            tok = logits[:, -1].masked_fill(floor, -1e9).argmax(dim=-1, keepdim=True)
            acts.append(tok.cpu().numpy())
            logits, cache = self.model.decode_step(tok, cache)
        return np.concatenate(acts, axis=1)

    def __call__(self, qd: np.ndarray, tau: np.ndarray) -> np.ndarray:
        """qd/tau [B, N] -> action chunk [B, k, N]."""

        toks = self.chunk_tokens(qd, tau)
        return self.tok.decode_action(toks).reshape(-1, self.chunk_len, self.n_joints)


def serve_episode(policy: CloudPolicy, task: str = "pick_place", seed: int = 0,
                  dcfg: Optional[DispatcherConfig] = None, max_steps: int = 400,
                  verbose: bool = True, device="cuda"):
    """Closed loop: the dispatcher decides on ``device``, the model serves
    chunks.  ``cloud_ms`` times each chunk on the host clock, device work
    included (the chunk is copied to the host before the clock stops)."""

    ep = generate_episode(task, seed=seed)
    dcfg = dcfg or DispatcherConfig(chunk_len=policy.chunk_len, action_dim=policy.n_joints)
    state = dispatcher_init(dcfg, batch_shape=(), device=device)

    def dev(a):
        return torch.as_tensor(a, device=device)

    n_off = 0
    cloud_ms = []
    actions = []
    t_len = min(max_steps, ep.q.shape[0])
    cached_chunk = torch.zeros((dcfg.chunk_len, dcfg.action_dim), dtype=torch.float32,
                               device=device)
    for t in range(t_len):
        frame = KinematicFrame(q=dev(ep.q[t]), qd=dev(ep.qd[t]), tau=dev(ep.tau[t]))
        # peek: would the dispatcher offload?  run the step with the cached
        # chunk; if it dispatched, charge a real cloud inference
        state, out = dispatcher_step(state, frame, cached_chunk, dcfg)
        if bool(out.offloaded):
            t0 = clock()
            fresh = policy(ep.qd[t : t + 1], ep.tau[t : t + 1])[0]
            cloud_ms.append((clock() - t0) * 1e3)
            cached_chunk = dev(fresh)
            n_off += 1
        actions.append(out.action.cpu().numpy())
    if verbose:
        print(f"task={task} steps={t_len} offloads={n_off} "
              f"cloud_ms(host)={np.mean(cloud_ms) if cloud_ms else 0:.1f}")
    return {"offloads": n_off, "steps": t_len, "actions": np.stack(actions),
            "cloud_ms": cloud_ms}


def serve_fleet(
    model: Model,
    tokenizer: EpisodeTokenizer,
    n_robots: int = 4,
    tasks: Optional[List[str]] = None,
    seed: int = 0,
    chunk_len: int = 8,
    n_joints: int = 7,
    max_steps: int = 300,
    max_slots: int = 8,
    channel: Optional[ChannelConfig] = None,
    partition_executor=None,
    split_robots: Optional[List[int]] = None,
    robot_cuts: Optional[Dict[int, object]] = None,
    defer_hot_admission: Optional[float] = None,
    num_pages: Optional[int] = None,
    scan_rounds: int = 1,
    mesh=None,
    prefill_group=None,
    trigger: str = "always",
    trigger_cfg: Optional[TriggerConfig] = None,
    record_streams: bool = False,
    obs: Optional[Observability] = None,
    tick: str = "vectorized",
    verbose: bool = True,
    sched: Optional[ContinuousBatchingScheduler] = None,
):
    """A robot fleet served by one continuous-batching cloud engine.

    Each control tick the fleet's batched decision core runs on the model's
    device (``DecisionCore``: the same ``trigger_step`` the offline
    ``rollout`` walks); triggered robots submit chunk requests, the
    scheduler advances one decode round, and finished chunks land back in
    the robots' queues — possibly several ticks after the trigger, so the
    fleet exercises ragged in-flight batches.

    ``trigger``: ``"always"`` — every queue depletion forces a cloud fetch;
    ``"rapid"`` — redundant steps replay the cached chunk and never touch
    the scheduler, only kinematic trigger fires offload, and a fire while a
    previous request is still decoding cancels it (``cancel_batch`` frees
    its pages) and resubmits against the fresh observation.

    With ``partition_executor`` set, the robots in ``split_robots`` serve
    through the edge-cloud split at its cut: each robot's edge prefix runs
    on its own, and its cloud suffix joins the cloud-only robots' decode
    rounds and page pool.  ``robot_cuts`` generalises it to a heterogeneous
    fleet: ``{robot: lane key}`` (a cut, e.g. from ``assign_fleet_cuts``, or
    ``(cut, expert_offload)`` for an expert-offload lane), one scheduler
    lane per distinct key, each a ``with_cut`` sibling of
    ``partition_executor``; robots absent from the map stay cloud-only.

    ``scan_rounds=R``: the scheduler dispatches R decode rounds a window
    (CUDA-graph replays on a CUDA model); admission, harvest and
    cancellation land at window boundaries.  ``telemetry.scan_windows``
    counts the harvested windows and ``telemetry.host_gap_ms()`` the mean
    host milliseconds the scheduler took over a window.

    ``mesh`` splits the engine's page pool and decode rows over the mesh's
    ``data`` axis (``launch/mesh.py``; shards of one device); a rank mesh
    (``make_rank_mesh``) over a tensor-parallel model's group runs the
    fleet on every rank (call ``serve_fleet`` on each, with the same
    arguments: the decision core and the engine run the same on every rank,
    and every rank returns the same run), the split robots included:
    ``partition_executor`` is then an executor of the rank's model, and
    each lane, heterogeneous cuts and expert-offload lanes too, serves its
    robots' edge prefixes and cloud suffixes on every rank's blocks; over
    a rank grid's mesh (``launch.dist.init_rank_grid``) each data shard is
    a rank, each holding its block of the cloud rows and of every lane's
    rows (a grid with a ``pod`` axis blocks them over every (pod, data)
    rank), and ``prefill_group=grid.handoff`` puts the prefill on the
    grid's prefill rank, the split lanes staying on the decode ranks (call
    ``serve_fleet`` on every rank of the grid; rank (0, 0, 0)'s result is
    the fleet's); ``prefill_group`` disaggregates the prompt prefill (a
    stream of its own on a CUDA model, or that rank), its K/V merged at
    the next window boundary.

    ``defer_hot_admission`` (a preempt-rate threshold, e.g. ``0.2``): a
    robot that fires a mid-chunk preempt while its realized preempt rate is
    at or above the threshold has its resubmitted request's admission held
    back one round.

    ``obs`` (an ``Observability``) turns on request tracing and SLO
    accounting; the run's ``SLOReport`` is returned under ``"slo"``.
    Actions are identical with and without it.

    ``tick``: ``"vectorized"`` (default) — frames sliced from (T, R, N)
    arrays stacked once, one ``cancel_batch`` / ``submit_batch`` per tick,
    one batched decode and jitter draw per harvest; ``"legacy"`` — the
    per-robot loop (per-robot ``submit`` / ``cancel``, an ``in_flight``
    set), kept as the parity reference.  Both give identical actions,
    counters, decision streams and latency draws.

    The wall time splits into ``core_s`` (the decision core, its host read
    included), ``engine_s`` (``sched.step``) and ``host_s`` (the rest);
    ``core_tick_ms`` / ``engine_tick_ms`` [T] and ``close_ticks`` [T] (the
    ticks whose step harvested a window) show where the time falls.

    ``sched``: serve through this scheduler of ``model`` instead of a new
    one — it is ``reset()`` first and keeps its CUDA graphs, so a second run
    is warm; its own ``max_slots``, ``num_pages``, ``scan_rounds``, mesh and
    prefill group stand, and lanes it already has for the fleet's keys are
    kept.
    """

    if tick not in ("vectorized", "legacy"):
        raise ValueError(f"tick must be 'vectorized' or 'legacy', got {tick!r}")
    pcfg = fleet_policy_config(trigger, chunk_len, n_joints, trigger_cfg)
    all_tasks = tasks or ["pick_place", "drawer_open", "peg_insertion"]
    eps = [generate_episode(all_tasks[i % len(all_tasks)], seed=seed + i)
           for i in range(n_robots)]
    t_len = min(max_steps, min(ep.q.shape[0] for ep in eps))

    core = DecisionCore(pcfg, n_robots, model.device)
    telemetry = FleetTelemetry(n_robots, record_streams=record_streams, obs=obs)
    if sched is None:
        sched = ContinuousBatchingScheduler(
            model, tokenizer, max_slots=max_slots, chunk_len=chunk_len, n_joints=n_joints,
            num_pages=num_pages, scan_rounds=scan_rounds, obs=obs, mesh=mesh,
            prefill_group=prefill_group,
        )
    else:
        sched.reset()
        sched.obs = obs
    if robot_cuts is None:
        robot_cuts = ({r: partition_executor.cut_layer for r in (split_robots or [])}
                      if partition_executor is not None else {})
    else:
        robot_cuts = dict(robot_cuts)
    if partition_executor is not None and robot_cuts:
        for c in sorted(set(robot_cuts.values()), key=_lane_order):
            if c in sched._lanes:
                sched._lanes[c].ex.obs = obs
                continue
            if isinstance(c, tuple):
                lane = partition_executor.with_cut(int(c[0]), expert_offload=tuple(c[1]))
            else:
                lane = partition_executor.with_cut(c)
            lane.obs = obs
            sched.attach_partition(lane)
    else:
        robot_cuts = {}
    split_set = set(robot_cuts)

    cached = np.zeros((n_robots, chunk_len, n_joints), np.float32)
    actions = np.zeros((t_len, n_robots, n_joints), np.float32)
    n_off = np.zeros(n_robots, np.int64)
    wait_rounds: List[int] = []
    # stochastic channel: every completed offload draws a jittered latency
    # keyed by (robot id, per-robot offload ordinal), so each robot's stream
    # is reproducible whatever order chunks complete in
    channel = channel or ChannelConfig()
    net_key = PRNGKey(seed + 7919)
    offload_ms: List[float] = []
    offload_ms_by_robot: List[List[float]] = [[] for _ in range(n_robots)]
    rows = np.arange(n_robots)
    engine_s = 0.0
    core_tick_ms = np.zeros(t_len)
    engine_tick_ms = np.zeros(t_len)
    close_ticks = np.zeros(t_len, bool)
    # the scheduler's host time accumulates until a window closes, so a
    # boundary's sample includes the closing call's sync
    window_host_ms = 0.0
    prev_closes = 0

    def engine_step(t):
        nonlocal engine_s, window_host_ms, prev_closes
        t0 = clock()
        results = sched.step()
        step_s = clock() - t0
        engine_s += step_s
        engine_tick_ms[t] = step_s * 1e3
        window_host_ms += step_s * 1e3
        if sched.window_closes > prev_closes:
            close_ticks[t] = True
            telemetry.note_boundary(window_host_ms)
            window_host_ms = 0.0
            prev_closes = sched.window_closes
        return results

    t_start = clock()
    if tick == "legacy":
        in_flight = set()
        for t in range(t_len):
            c0 = clock()
            dec = core.step(np.stack([ep.q[t] for ep in eps]), np.stack([ep.qd[t] for ep in eps]),
                            np.stack([ep.tau[t] for ep in eps]))
            core_tick_ms[t] = (clock() - c0) * 1e3
            trig, pre = dec.offload, dec.preempt
            telemetry.observe(dec)
            # execute before this round's completions land: a chunk arriving
            # in round t is first executable at t+1
            actions[t] = cached[rows, dec.slot]
            for r in np.flatnonzero(trig):
                r = int(r)
                if r in in_flight:
                    if trigger != "rapid":
                        continue  # previous request still decoding
                    # contact-phase preemption: cancel the stale sequence
                    if sched.cancel(r):
                        telemetry.note_cancel(r)
                    in_flight.discard(r)
                defer = int(
                    defer_hot_admission is not None
                    and bool(pre[r])
                    and telemetry.preempts[r] / max(int(telemetry.fires[r]), 1)
                    >= defer_hot_admission
                )
                sched.submit(r, eps[r].qd[t][None], eps[r].tau[t][None],
                             partitioned=r in split_set, cut=robot_cuts.get(r),
                             defer_rounds=defer)
                in_flight.add(r)
                n_off[r] += 1
            for res in engine_step(t):
                cached[res.robot_id] = tokenizer.decode_action(res.tokens).reshape(
                    chunk_len, n_joints)
                in_flight.discard(res.robot_id)
                telemetry.note_completion(res.robot_id)
                wait_rounds.append(res.completed_round - res.submitted_round)
                rkey = fold_in(fold_in(net_key, res.robot_id),
                               len(offload_ms_by_robot[res.robot_id]))
                ms = sample_latency_ms(channel, chunk_len, rkey)
                offload_ms.append(ms)
                offload_ms_by_robot[res.robot_id].append(ms)
    else:
        # the array-at-a-time image of the legacy loop: cancels land before
        # submits within a tick (a cancel only touches that robot's own
        # request), so the queues, FIFO stamps and counters are identical
        q_all = np.stack([ep.q[:t_len] for ep in eps], axis=1)
        qd_all = np.stack([ep.qd[:t_len] for ep in eps], axis=1)
        tau_all = np.stack([ep.tau[:t_len] for ep in eps], axis=1)
        in_flight_mask = np.zeros(n_robots, bool)
        split_mask = np.zeros(n_robots, bool)
        cut_arr = np.full(n_robots, None, object)  # lane keys: ints or (cut, offload)
        for r, c in robot_cuts.items():
            split_mask[r] = True
            cut_arr[r] = c
        n_done = np.zeros(n_robots, np.int64)  # per-robot offload ordinal
        for t in range(t_len):
            c0 = clock()
            dec = core.step(q_all[t], qd_all[t], tau_all[t])
            core_tick_ms[t] = (clock() - c0) * 1e3
            trig, pre = dec.offload, dec.preempt
            telemetry.observe(dec)
            actions[t] = cached[rows, dec.slot]
            if trigger == "rapid":
                cancel_ids = np.flatnonzero(trig & in_flight_mask)
                if cancel_ids.size:
                    hits = sched.cancel_batch(cancel_ids)
                    telemetry.note_cancels(cancel_ids[hits])
                    in_flight_mask[cancel_ids] = False
                ids = np.flatnonzero(trig)
            else:
                # fires landing while a request is in flight are skipped
                ids = np.flatnonzero(trig & ~in_flight_mask)
            if ids.size:
                defer = None
                if defer_hot_admission is not None:
                    defer = (pre[ids] & (telemetry.preempts[ids] / np.maximum(
                        telemetry.fires[ids], 1) >= defer_hot_admission)).astype(np.int64)
                sched.submit_batch(ids, qd_all[t][ids], tau_all[t][ids],
                                   partitioned=split_mask[ids], cuts=cut_arr[ids],
                                   defer_rounds=defer)
                in_flight_mask[ids] = True
                n_off[ids] += 1
            results = engine_step(t)
            if results:
                # at most one outstanding request per robot: no duplicate ids
                res_ids = np.fromiter((res.robot_id for res in results), np.int64,
                                      count=len(results))
                toks = np.stack([res.tokens for res in results])
                cached[res_ids] = tokenizer.decode_action(toks).reshape(
                    len(results), chunk_len, n_joints)
                in_flight_mask[res_ids] = False
                telemetry.note_completions(res_ids)
                wait_rounds.extend(res.completed_round - res.submitted_round for res in results)
                ms = sample_latency_ms_batch(channel, chunk_len, net_key, res_ids,
                                             n_done[res_ids])
                n_done[res_ids] += 1
                offload_ms.extend(ms)
                for i, r in enumerate(res_ids):
                    offload_ms_by_robot[r].append(ms[i])

    wall_s = clock() - t_start
    core_s = float(core_tick_ms.sum()) / 1e3
    pool = sched.pool_stats()
    slo = None
    if obs is not None:
        obs.metrics.gauge("serve.wall_s").set(wall_s)
        slo = build_slo_report(obs.metrics)
    if verbose:
        print(
            f"fleet={n_robots} steps={t_len} trigger={trigger} "
            f"offloads={int(n_off.sum())} "
            f"replays={int(telemetry.replays.sum())} "
            f"cancels={int(telemetry.cancels.sum())} "
            f"f_off={telemetry.fleet_offload_fraction():.2f} "
            f"mean_service_rounds={np.mean(wait_rounds) if wait_rounds else 0:.1f} "
            f"decode_rounds={sched.decode_rounds} "
            f"scan_windows={telemetry.scan_windows} "
            f"host_gap_ms={telemetry.host_gap_ms():.2f} "
            f"peak_batch={sched.peak_active} "
            f"kv_pages={pool.pages_in_use}/{pool.pages_in_use + pool.pages_free} "
            f"(high-water {pool.high_water}) "
            + (f"mixed_rounds={sched.mixed_rounds} " if split_set else "")
            + (f"cuts={sorted(set(robot_cuts.values()), key=_lane_order)} "
               f"hetero_rounds={sched.hetero_rounds} "
               if len(set(robot_cuts.values())) > 1 else "")
            + (f"deferred={sched.deferred} " if sched.deferred else "")
            + f"net_ms={np.mean(offload_ms) if offload_ms else 0:.1f}"
            f"±{np.std(offload_ms) if offload_ms else 0:.1f}"
        )
        if slo is not None:
            for line in slo.lines():
                print(line)
    return {
        "slo": slo.to_json() if slo is not None else None,
        "obs": obs,
        "offloads": n_off,
        "steps": t_len,
        "wall_s": wall_s,
        "core_s": core_s,
        "engine_s": engine_s,
        "host_s": max(wall_s - core_s - engine_s, 0.0),
        "core_tick_ms": core_tick_ms,
        "engine_tick_ms": engine_tick_ms,
        "close_ticks": close_ticks,
        "actions": actions,
        "service_rounds": wait_rounds,
        "offload_ms": offload_ms,
        "offload_ms_by_robot": offload_ms_by_robot,
        "peak_batch": sched.peak_active,
        "pool": pool,
        "mixed_rounds": sched.mixed_rounds,
        "hetero_rounds": sched.hetero_rounds,
        "decode_rounds": sched.decode_rounds,
        "scan_windows": telemetry.scan_windows,
        "host_gap_ms": telemetry.host_gap_ms(),
        "cancelled": sched.cancelled,
        "deferred": sched.deferred,
        "split_robots": sorted(split_set),
        "robot_cuts": dict(sorted(robot_cuts.items())),
        "active_cuts": sorted(set(robot_cuts.values()), key=_lane_order),
        "trigger": trigger,
        "telemetry": telemetry,
        "offload_fraction": telemetry.fleet_offload_fraction(),
        "sched": sched,
    }


def _map_expert_offload(model: Model, cut: int, n_full_offload: int):
    """The trailing ``min(n, #edge MoE layers)`` MoE layers below ``cut``:
    the planner's trailing offloaded blocks mapped onto ``model``'s edge
    prefix (``()`` when it has no MoE layer)."""

    moe_edge = [l for l in range(cut) if model.specs[l][1]]
    j = min(n_full_offload, len(moe_edge))
    return tuple(moe_edge[-j:]) if j else ()


def plan_fleet_partition(model: Model, arch: str, network: str = "wan",
                         verbose: bool = True, plan_2d: bool = False):
    """Plan the full ``arch``'s cut and build a split executor over
    ``model`` -> ``(executor or None, plan)``.

    Only a split plan runs through the executor (cloud-only and edge-only
    are single-device plans; enc-dec stacks do not split): those return
    None.  The plan's layer fraction maps onto ``model`` (possibly a smoke
    stack; node cut 1, a stem-only edge, is layer cut 0).  ``plan_2d``
    plans over (cut layer x placement) and serves the best executable
    plan (plain cuts and expert-offload lanes) when the optimum is a
    priced-only placement; an ``expert_split`` maps its offloaded experts
    onto ``model``'s trailing edge MoE layers."""

    from repro_torch.partition.executor import PartitionExecutor
    from repro_torch.partition.planner import NETWORK_PROFILES, plan_partition

    cfg = model.cfg
    channel = NETWORK_PROFILES[network]
    full_cfg = get_config(arch)
    plan = plan_partition(full_cfg, channel=channel, plan_2d=plan_2d)
    if verbose:
        print(f"partition plan [{network}]:", plan.summary())
    exec_plan = plan
    if plan_2d and plan.placement not in ("", "experts_cloud"):
        exec_plan = plan_partition(full_cfg, channel=channel, plan_2d=True,
                                   executable_only=True)
        if verbose:
            print("  executable 2-D plan:", exec_plan.summary())
    if exec_plan.mode not in ("split", "expert_split") or cfg.encoder_decoder:
        if verbose:
            why = ("encoder-decoder split execution not supported"
                   if exec_plan.mode in ("split", "expert_split")
                   else f"planner chose {exec_plan.mode}")
            print(f"{why}: serving unpartitioned")
        return None, plan
    frac = exec_plan.cut_layer / max(full_cfg.num_layers, 1)
    cut = int(round(frac * cfg.num_layers))
    offload = (_map_expert_offload(model, cut, len(exec_plan.expert_offload))
               if exec_plan.expert_offload else ())
    if verbose:
        off = f", experts of layers {list(offload)} cloud-side" if offload else ""
        print(f"split execution: {cut}/{cfg.num_layers} layers on the edge{off}")
    return PartitionExecutor(model, cut, channel=channel, expert_offload=offload), plan


def plan_expert_lane(model: Model, arch: str, network: str = "wan", base=None,
                     verbose: bool = True):
    """The 2-D plan space's best feasible expert-offload lane of the full
    ``arch``, mapped onto ``model`` -> a ``PartitionExecutor`` keyed
    ``(cut, offload)``, or None when the arch (or the model's edge prefix)
    has no MoE block to offload.  ``base`` shares its weights
    (``with_cut``)."""

    from repro_torch.partition.executor import PartitionExecutor
    from repro_torch.partition.graph import build_graph
    from repro_torch.partition.planner import NETWORK_PROFILES, enumerate_cuts_2d
    from repro_torch.runtime.latency import arch_hardware_model

    cfg = model.cfg
    if cfg.encoder_decoder or cfg.moe is None:
        return None
    channel = NETWORK_PROFILES[network]
    full_cfg = get_config(arch)
    graph = build_graph(full_cfg)
    hw = arch_hardware_model(int(graph.total_param_bytes))
    cand = [e for e in enumerate_cuts_2d(graph, hw, channel)
            if e.feasible and e.placement == "experts_cloud"]
    if not cand:
        return None
    best = min(cand, key=lambda e: e.total_ms)
    full_layers = max(full_cfg.num_layers, 1)
    cut = min(max(int(round(graph.cut_layers(best.cut) / full_layers * cfg.num_layers)), 1),
              cfg.num_layers)
    offload = _map_expert_offload(model, cut, len(best.expert_offload))
    if not offload:
        return None
    if verbose:
        print(f"expert-offload lane [{network}]: cut {cut}, experts of layers "
              f"{list(offload)} cloud-side (full-arch: {len(best.expert_offload)} MoE "
              f"block(s) at cut {best.cut}, {best.total_ms:.1f}ms, "
              f"+{best.net_expert_ms:.1f}ms legs)")
    if base is not None:
        return base.with_cut(cut, expert_offload=offload)
    return PartitionExecutor(model, cut, channel=channel, expert_offload=offload)


def assign_fleet_cuts(model: Model, arch: str, telemetry, network: str = "wan",
                      k_max: int = 3, verbose: bool = True):
    """Per-robot cuts from realized telemetry, mapped onto ``model`` ->
    ``(base executor or None, {robot: cut}, the full arch's CutAssignment)``.

    ``assign_cuts`` plans the full ``arch``'s frontier at each robot's
    realized offload fraction (monotone: a more redundant robot never gets
    a shallower prefix), capped at the deepest cut the executor runs (the
    head stays cloud-side); the assigned edge layer counts map onto
    ``model`` by layer fraction, distinct full cuts kept distinct where the
    stack has room.  Cloud-only robots are absent from the map."""

    from repro_torch.partition.executor import PartitionExecutor
    from repro_torch.partition.graph import build_graph
    from repro_torch.partition.planner import NETWORK_PROFILES, assign_cuts

    channel = NETWORK_PROFILES[network]
    full_cfg = get_config(arch)
    graph = build_graph(full_cfg)
    assignment = assign_cuts(telemetry, k_max=k_max, cfg=full_cfg, graph=graph,
                             channel=channel, max_cut=len(graph.nodes) - 1)
    if verbose:
        print(f"cut assignment [{network}]:", assignment.summary())
    if model.cfg.encoder_decoder:
        if verbose:
            print("encoder-decoder split execution not supported: serving unpartitioned")
        return None, {}, assignment
    n_layers = model.cfg.num_layers
    full_layers = max(full_cfg.num_layers, 1)
    smoke_of: Dict[int, int] = {}
    prev = -1
    for cl in sorted({c for c in assignment.cut_layers if c >= 0}):
        smoke_of[cl] = prev = min(max(int(round(cl / full_layers * n_layers)), prev + 1),
                                  n_layers)
    robot_cuts = {r: smoke_of[cl] for r, cl in enumerate(assignment.cut_layers) if cl >= 0}
    if not robot_cuts:
        if verbose:
            print("assignment is all-cloud: serving unpartitioned")
        return None, {}, assignment
    executor = PartitionExecutor(model, min(robot_cuts.values()), channel=channel)
    if verbose:
        lanes = {c: sum(1 for v in robot_cuts.values() if v == c)
                 for c in sorted(set(robot_cuts.values()))}
        print(f"heterogeneous fleet: {' '.join(f'{n}x{c}-layer-edge' for c, n in lanes.items())} "
              f"(of {n_layers} layers; {len(assignment.cuts) - len(robot_cuts)} cloud-only)")
    return executor, robot_cuts, assignment


def replan_from_telemetry(arch: str, telemetry, network: str = "wan", pipelined: bool = False,
                          verbose: bool = True):
    """Re-plan at the fleet's realized offload fraction (a
    ``FleetTelemetry`` or a float, floored at 0.02) -> ``(plan,
    global_plan, repriced_global)``: the re-planned cut is never worse, at
    that fraction, than the global-fraction cut re-priced."""

    from repro_torch.partition.planner import NETWORK_PROFILES, evaluate_cut, plan_partition

    frac = telemetry if isinstance(telemetry, float) else telemetry.fleet_offload_fraction()
    frac = min(max(frac, 0.02), 1.0)
    cfg = get_config(arch)
    channel = NETWORK_PROFILES[network]
    plan = plan_partition(cfg, channel=channel, offload_fraction=frac, pipelined=pipelined)
    global_plan = plan_partition(cfg, channel=channel, pipelined=pipelined)
    repriced = evaluate_cut(cfg, global_plan.cut, channel=channel, offload_fraction=frac,
                            pipelined=pipelined)
    if verbose:
        print(f"replan @ realized f_off={frac:.3f}:", plan.summary())
        print(f"  global-fraction cut {global_plan.cut} re-priced at realized fraction: "
              f"{repriced.total_ms:.1f}ms (re-planned: {plan.total_ms:.1f}ms)")
    return plan, global_plan, repriced


def fleet_lanes(model: Model, arch: str, n_robots: int, partition: str = "none",
                network: str = "wan", plan_2d: bool = False):
    """The split lanes of a mixed fleet -> ``(executor or None, split
    robots, robot_cuts or None)``: with ``partition`` ``"auto"`` (the
    planned cut, ``plan_fleet_partition``) or an edge layer count, every
    second robot serves through the split; with ``plan_2d`` those robots
    alternate between the planned cut and the 2-D space's best
    expert-offload lane (``plan_expert_lane``) where it differs."""

    if partition == "none":
        return None, [], None
    if partition == "auto":
        executor, _ = plan_fleet_partition(model, arch, network, plan_2d=plan_2d)
    else:
        from repro_torch.partition.executor import PartitionExecutor
        from repro_torch.partition.planner import NETWORK_PROFILES

        executor = PartitionExecutor(model, int(partition), channel=NETWORK_PROFILES[network])
    if executor is None:
        return None, [], None
    split = list(range(1, n_robots, 2))
    robot_cuts = None
    if plan_2d and split:
        lane = plan_expert_lane(model, arch, network, base=executor)
        if lane is not None and lane.lane_key != executor.lane_key:
            robot_cuts = {r: (executor.lane_key if i % 2 == 0 else lane.lane_key)
                          for i, r in enumerate(split)}
    return executor, split, robot_cuts


def engine_placement(device: str = "cuda", sharded: bool = False,
                     disaggregate_prefill: bool = False):
    """``serve_fleet``'s ``(mesh or None, prefill_group or None)``: with
    ``disaggregate_prefill`` the last device prefills (one card: a stream
    of its own); with ``sharded`` the decode shards over the data axis of
    a mesh over its own group, or over every device."""

    mesh = prefill_group = None
    if disaggregate_prefill:
        prefill_group, decode_group = split_device_groups(prefill=1, device=device)
        print(f"disaggregated prefill: {prefill_group[0]}")
    if sharded:
        if prefill_group is not None and len(decode_group) < len(host_devices(device)):
            # decode shards over its own group; prefill keeps its device
            mesh = make_test_mesh(data=len(decode_group), devices=decode_group)
        else:
            mesh = make_host_mesh(device=device)
        print(f"sharded engine: mesh {mesh.shape}")
    return mesh, prefill_group


def write_obs(obs: Optional[Observability], trace_out: Optional[str] = None,
              metrics_json: Optional[str] = None, metrics_prom: Optional[str] = None) -> None:
    """Write a fleet run's request trace (Chrome-trace JSON) and metrics
    registry (flat JSON, Prometheus text) where asked."""

    if obs is None:
        return
    if trace_out:
        obs.trace.write(trace_out)
        print(f"trace: {obs.trace.n_events} events -> {trace_out}")
    if metrics_json:
        with open(metrics_json, "w") as f:
            json.dump(obs.metrics.to_json(), f, indent=1)
        print(f"metrics: -> {metrics_json}")
    if metrics_prom:
        with open(metrics_prom, "w") as f:
            f.write(obs.metrics.to_prometheus())
        print(f"metrics: -> {metrics_prom}")


def build_policy(model: Model, tok: EpisodeTokenizer, arch: str, partition: str = "none",
                 network: str = "wan", paged: bool = False, plan_2d: bool = False,
                 verbose: bool = True):
    """The serving policy, split per the partition planner or not ->
    ``(policy, plan or None)``.

    ``partition``: ``"none"`` (``CloudPolicy``), ``"auto"`` (the full
    ``arch``'s planned cut mapped onto ``model``; ``plan_2d`` as in
    ``plan_fleet_partition``) or an edge layer count.  ``network`` picks
    the channel the planner prices (``lan`` / ``wan`` / ``congested``);
    ``paged`` routes an unpartitioned policy through the page pool."""

    if partition == "none":
        return CloudPolicy(model, tok, paged=paged), None

    from repro_torch.partition.executor import PartitionExecutor, PartitionedPolicy
    from repro_torch.partition.planner import NETWORK_PROFILES, plan_partition

    if partition == "auto":
        executor, plan = plan_fleet_partition(model, arch, network, verbose=verbose,
                                              plan_2d=plan_2d)
        if executor is None:
            return CloudPolicy(model, tok, paged=paged), plan
        return PartitionedPolicy(executor, tok), plan
    channel = NETWORK_PROFILES[network]
    plan = plan_partition(get_config(arch), channel=channel)
    if verbose:
        print(f"partition plan [{network}]:", plan.summary())
    cut = int(partition)
    executor = PartitionExecutor(model, cut, channel=channel)
    if verbose:
        print(f"split execution: {cut}/{model.cfg.num_layers} layers on the edge")
    return PartitionedPolicy(executor, tok), plan


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="openvla-7b", choices=ARCH_IDS,
                   help="the arch whose smoke-size stack serves")
    p.add_argument("--task", default="pick_place")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--paged", action="store_true",
                   help="single-robot decode through the paged KV substrate")
    p.add_argument("--device", default="cuda",
                   help="where the model and the dispatcher run (cuda or cpu)")
    p.add_argument("--fleet", type=int, default=0,
                   help="serve N robots through the continuous-batching scheduler")
    p.add_argument("--trigger", default="always", choices=["always", "rapid"],
                   help="fleet dispatch policy: always-offload or the closed-loop "
                        "redundancy-aware RAPID trigger")
    p.add_argument("--scan-rounds", type=int, default=1,
                   help="decode rounds per scan window (1 = per-round stepping)")
    p.add_argument("--partition", default="none",
                   help="'none', 'auto' (partition planner), or an edge layer count")
    p.add_argument("--network", default="wan", choices=["lan", "wan", "congested"],
                   help="channel regime the partition planner prices")
    p.add_argument("--plan-2d", action="store_true",
                   help="plan over (cut layer x placement); MoE fleets also serve an "
                        "expert-offload lane beside the planned cut")
    p.add_argument("--assign-cuts", action="store_true",
                   help="two episodes: the first gathers realized per-robot offload "
                        "fractions, the second serves each robot at its assigned cut")
    p.add_argument("--max-cuts", "--k-max", dest="max_cuts", type=int, default=3,
                   help="most distinct cuts active at once (--assign-cuts)")
    p.add_argument("--sharded", action="store_true",
                   help="split the fleet engine's page pool and decode rows over the data "
                        "axis of a mesh over the device's cards (one card: one shard)")
    p.add_argument("--disaggregate-prefill", action="store_true",
                   help="prefill admitted prompts on a device group of their own (one card: "
                        "a stream of its own), merged into the paged cache at the next "
                        "window boundary")
    p.add_argument("--defer-hot", type=float, default=None,
                   help="cancellation-aware admission: preempt-rate threshold above "
                        "which a preempting robot's admission is held one round")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write a Chrome-trace/Perfetto JSON of the fleet run's "
                        "request lifecycles")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="dump the run's metrics registry as flat JSON")
    p.add_argument("--metrics-prom", default=None, metavar="PATH",
                   help="dump the metrics in Prometheus text exposition")
    return p


def main(argv=None):
    args = parser().parse_args(argv)

    cfg = get_smoke_config(args.arch)
    model = Model(cfg, device=args.device)
    tok = EpisodeTokenizer(cfg.vocab_size)
    if args.fleet:
        want_obs = bool(args.trace_out or args.metrics_json or args.metrics_prom)

        def mk_obs():
            return Observability(trace=args.trace_out is not None) if want_obs else None

        executor, split, robot_cuts = fleet_lanes(model, args.arch, args.fleet, args.partition,
                                                  args.network, args.plan_2d)
        mesh, prefill_group = engine_placement(args.device, args.sharded,
                                               args.disaggregate_prefill)
        out = serve_fleet(model, tok, n_robots=args.fleet, max_steps=args.steps,
                          partition_executor=executor, split_robots=split,
                          robot_cuts=robot_cuts, trigger=args.trigger,
                          defer_hot_admission=args.defer_hot,
                          scan_rounds=args.scan_rounds, obs=mk_obs(), mesh=mesh,
                          prefill_group=prefill_group)
        if args.assign_cuts:
            # re-assign each robot's cut from the first episode's realized
            # fractions and serve the next episode heterogeneously
            executor2, robot_cuts, _ = assign_fleet_cuts(
                model, args.arch, out["telemetry"], args.network, k_max=args.max_cuts)
            if robot_cuts:
                out = serve_fleet(model, tok, n_robots=args.fleet, max_steps=args.steps,
                                  partition_executor=executor2, robot_cuts=robot_cuts,
                                  trigger=args.trigger, defer_hot_admission=args.defer_hot,
                                  scan_rounds=args.scan_rounds, obs=mk_obs(), mesh=mesh,
                                  prefill_group=prefill_group)
        elif args.trigger == "rapid" and args.partition != "none":
            replan_from_telemetry(args.arch, out["telemetry"], args.network)
        write_obs(out["obs"], args.trace_out, args.metrics_json, args.metrics_prom)
        return out
    policy, _ = build_policy(model, tok, args.arch, args.partition, args.network,
                             paged=args.paged, plan_2d=args.plan_2d)
    return serve_episode(policy, task=args.task, max_steps=args.steps, device=args.device)


if __name__ == "__main__":
    main()
