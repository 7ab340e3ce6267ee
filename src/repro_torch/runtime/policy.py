"""Fleet-level redundancy-aware decision core; torch twin of
``repro/runtime/policy.py``.

``trigger_step`` is the one per-tick decision core: the live fleet
(``launch/serve.py`` ``serve_fleet``) steps it each control tick on the
model's device, and the offline ``rollout`` walks it over a [T, ...] stream
(the reference's ``lax.scan``), so the two take identical decisions.
``queue_replay`` replays the same queue transition over a precomputed
dispatch stream (the offline engine's baselines), and ``FleetTelemetry``
keeps a live run's realized per-robot decisions in numpy counters.

Queue-depletion policy (``PolicyConfig.on_empty``): ``"cloud"`` forces a
cloud dispatch on every depletion (Algorithm 1 line 6); ``"edge"`` lets a
resident edge policy refill; ``"reuse"`` replays the cached chunk, and only
the bootstrap fetch of a never-filled queue is forced cloudward.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import kinematics as kin
from repro_torch.core.trigger import (
    TriggerConfig,
    TriggerOutput,
    TriggerState,
    trigger_init as kin_trigger_init,
    trigger_step as kin_trigger_step,
)

ON_EMPTY_MODES = ("cloud", "edge", "reuse")


@dataclass(frozen=True)
class PolicyConfig:
    trigger: TriggerConfig = field(default_factory=TriggerConfig)
    chunk_len: int = 8  # k — action-chunk horizon
    on_empty: str = "reuse"

    def __post_init__(self):
        if self.on_empty not in ON_EMPTY_MODES:
            raise ValueError(f"on_empty must be one of {ON_EMPTY_MODES}")


class FleetTriggerState(NamedTuple):
    trigger: TriggerState
    head: torch.Tensor    # [...] int32 next chunk index (== k -> empty)
    primed: torch.Tensor  # [...] bool — has ever fetched a chunk


class TriggerDecision(NamedTuple):
    offload: torch.Tensor   # bool — cloud refill this tick (incl. forced)
    replayed: torch.Tensor  # bool — local refill: edge policy or cache replay
    preempt: torch.Tensor   # bool — cloud refill mid-chunk (0 < head < k)
    slot: torch.Tensor      # int32 — chunk index executed this tick
    trig: TriggerOutput


def fleet_policy_config(trigger: str, chunk_len: int, n_joints: int,
                        trigger_cfg: Optional[TriggerConfig] = None) -> PolicyConfig:
    """The fleet's decision-core config for ``trigger`` (``always`` or
    ``rapid``).  The rapid default aligns the dispatch cadence with the chunk
    horizon: the trigger re-arms one step after the cooldown hits zero, so
    C = k-1 makes sustained-contact refreshes land exactly on chunk
    boundaries."""

    if trigger not in ("always", "rapid"):
        raise ValueError(f"trigger must be 'always' or 'rapid', got {trigger!r}")
    if trigger_cfg is None:
        cooldown = max(chunk_len - 1, 1) if trigger == "rapid" else 8
        trigger_cfg = TriggerConfig(n_joints=n_joints, cooldown_steps=cooldown)
    return PolicyConfig(trigger=trigger_cfg, chunk_len=chunk_len,
                        on_empty="cloud" if trigger == "always" else "reuse")


def trigger_init(cfg: PolicyConfig, batch_shape: Tuple[int, ...] = (),
                 device="cuda") -> FleetTriggerState:
    return FleetTriggerState(
        trigger=kin_trigger_init(cfg.trigger, batch_shape, device),
        head=torch.full(batch_shape, cfg.chunk_len, dtype=torch.int32, device=device),
        primed=torch.zeros(batch_shape, dtype=torch.bool, device=device),
    )


def _forced(queue_empty, primed, cfg: PolicyConfig):
    if cfg.on_empty == "cloud":
        return queue_empty
    if cfg.on_empty == "reuse":
        return queue_empty & ~primed
    return torch.zeros_like(queue_empty)


def _queue_transition(head, primed, offload, queue_empty, cfg: PolicyConfig):
    """Algorithm-1 queue semantics given this tick's cloud decision."""

    k = cfg.chunk_len
    offload = offload | _forced(queue_empty, primed, cfg)
    replayed = torch.zeros_like(offload) if cfg.on_empty == "cloud" else queue_empty & ~offload
    preempt = offload & (head > 0) & ~queue_empty
    head = torch.where(offload | replayed, torch.zeros_like(head), head)
    slot = torch.clamp(head, max=k - 1)
    return torch.clamp(head + 1, max=k), primed | offload, offload, replayed, preempt, slot


def trigger_step(state: FleetTriggerState, frame: kin.KinematicFrame, cfg: PolicyConfig):
    """One control tick of the closed-loop decision core (batched)."""

    queue_empty = state.head >= cfg.chunk_len
    forced = _forced(queue_empty, state.primed, cfg)
    trig_state, trig_out = kin_trigger_step(
        state.trigger, frame, cfg.trigger,
        # forced fetches flow through the kinematic step so they reset the
        # cooldown exactly like an organic dispatch (Eq. 8)
        queue_empty=forced if cfg.on_empty != "edge" else None,
    )
    head, primed, offload, replayed, preempt, slot = _queue_transition(
        state.head, state.primed, trig_out.dispatch, queue_empty, cfg
    )
    return (
        FleetTriggerState(trigger=trig_state, head=head, primed=primed),
        TriggerDecision(offload=offload, replayed=replayed, preempt=preempt, slot=slot,
                        trig=trig_out),
    )


def rollout(cfg: PolicyConfig, frames: kin.KinematicFrame,
            state: Optional[FleetTriggerState] = None):
    """The decision core over a [T, ..., N] stream, one ``trigger_step`` a
    tick on the frames' device -> (final state, each decision field stacked
    over T): the offline twin of the fleet loop's per-tick step."""

    if state is None:
        state = trigger_init(cfg, tuple(frames.q.shape[1:-1]), frames.q.device)
    decs = []
    for t in range(frames.q.shape[0]):
        state, dec = trigger_step(state, kin.KinematicFrame(*(f[t] for f in frames)), cfg)
        decs.append(dec)
    trig = TriggerOutput(*(torch.stack(f) for f in zip(*(d.trig for d in decs))))
    return state, TriggerDecision(
        *(torch.stack([getattr(d, n) for d in decs]) for n in TriggerDecision._fields[:-1]),
        trig=trig,
    )


class QueueTrace(NamedTuple):
    """Per-step queue decisions for a precomputed dispatch stream."""

    refill_cloud: np.ndarray   # bool [T]
    refill_local: np.ndarray   # bool [T] — edge refill or cache replay
    preempt: np.ndarray        # bool [T]
    slot: np.ndarray           # int32 [T]


def queue_replay(dispatch: np.ndarray, chunk_len: int, on_empty: str = "edge") -> QueueTrace:
    """Replay the queue transition over an external dispatch stream (host
    accounting: scalar tensors on the CPU through the same
    ``_queue_transition`` the live fleet runs)."""

    cfg = PolicyConfig(chunk_len=chunk_len, on_empty=on_empty)
    head = torch.tensor(chunk_len, dtype=torch.int32)
    primed = torch.tensor(False)
    out = []
    for d in torch.as_tensor(np.asarray(dispatch, bool)):
        head, primed, offload, replayed, preempt, slot = _queue_transition(
            head, primed, d, head >= chunk_len, cfg
        )
        out.append(torch.stack([offload.int(), replayed.int(), preempt.int(), slot]))
    off, rep, pre, slot = (torch.stack(out).numpy().T if out
                           else np.zeros((4, 0), np.int32))
    return QueueTrace(refill_cloud=off.astype(bool), refill_local=rep.astype(bool),
                      preempt=pre.astype(bool), slot=slot.astype(np.int32))


# ---------------------------------------------------------------------------
# realized fleet telemetry
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class FleetTelemetry:
    """Per-robot realized decision statistics from a closed-loop run.

    ``offload_fractions`` is the feedback signal into the partition planner:
    the fraction of *chunk refill decisions* (cloud fetch vs local
    refill/replay) a robot actually sent cloudward.  ``obs`` (an
    ``Observability``) also feeds the decision counters and the per-boundary
    host gap into its registry (``fleet.*`` counters, ``serve.host_gap_ms``).
    """

    n_robots: int
    record_streams: bool = False
    obs: Optional[object] = None
    ticks: int = 0
    fires: np.ndarray = None        # cloud refill DECISIONS (in "always"
    # mode the serving loop skips fires landing while a request is already
    # in flight, so submissions can be fewer; in "rapid" mode every fire
    # submits — stale in-flight work is cancelled first)
    replays: np.ndarray = None      # local refills (edge / cache replay)
    preempts: np.ndarray = None     # mid-chunk cloud refills
    cancels: np.ndarray = None      # in-flight sequences cancelled
    completions: np.ndarray = None  # chunks that arrived back
    offload_stream: List[np.ndarray] = field(default_factory=list)
    replay_stream: List[np.ndarray] = field(default_factory=list)
    preempt_stream: List[np.ndarray] = field(default_factory=list)
    slot_stream: List[np.ndarray] = field(default_factory=list)
    # one entry per harvested scan window: the host milliseconds the serving
    # loop spent in the scheduler over that window (admit + dispatch + sync)
    scan_windows: int = 0
    boundary_ms: List[float] = field(default_factory=list)

    def __post_init__(self):
        z = lambda: np.zeros(self.n_robots, np.int64)  # noqa: E731
        self.fires, self.replays = z(), z()
        self.preempts, self.cancels, self.completions = z(), z(), z()

    def observe(self, dec) -> None:
        """Accumulate one batched control tick's decisions (tensors or
        numpy arrays)."""

        off = _host(dec.offload).astype(bool)
        rep = _host(dec.replayed).astype(bool)
        pre = _host(dec.preempt).astype(bool)
        self.ticks += 1
        self.fires += off
        self.replays += rep
        self.preempts += pre
        if self.obs is not None:
            m = self.obs.metrics
            m.counter("fleet.ticks").inc()
            m.counter("fleet.fires").inc(int(off.sum()))
            m.counter("fleet.replays").inc(int(rep.sum()))
            m.counter("fleet.preempts").inc(int(pre.sum()))
        if self.record_streams:
            self.offload_stream.append(off)
            self.replay_stream.append(rep)
            self.preempt_stream.append(pre)
            self.slot_stream.append(_host(dec.slot).astype(np.int32))

    def note_cancel(self, robot_id: int) -> None:
        self.note_cancels([robot_id])

    def note_cancels(self, robot_ids) -> None:
        """Batched ``note_cancel``: one scatter-add + one counter bump."""

        robot_ids = np.asarray(robot_ids, np.int64)
        if robot_ids.size == 0:
            return
        np.add.at(self.cancels, robot_ids, 1)
        if self.obs is not None:
            self.obs.metrics.counter("fleet.cancels").inc(int(robot_ids.size))

    def note_boundary(self, host_ms: float) -> None:
        """One scan-window boundary crossed; ``host_ms`` is its host gap."""

        self.scan_windows += 1
        self.boundary_ms.append(float(host_ms))
        if self.obs is not None:
            self.obs.metrics.histogram("serve.host_gap_ms").observe(host_ms)

    def host_gap_ms(self) -> float:
        """Mean host milliseconds per window boundary (0 if none seen)."""

        return float(np.mean(self.boundary_ms)) if self.boundary_ms else 0.0

    def note_completion(self, robot_id: int) -> None:
        self.note_completions([robot_id])

    def note_completions(self, robot_ids) -> None:
        """Batched ``note_completion``: one scatter-add + one counter bump."""

        robot_ids = np.asarray(robot_ids, np.int64)
        if robot_ids.size == 0:
            return
        np.add.at(self.completions, robot_ids, 1)
        if self.obs is not None:
            self.obs.metrics.counter("fleet.completions").inc(int(robot_ids.size))

    def streams(self) -> Dict[str, np.ndarray]:
        """[T, R] decision streams (requires ``record_streams=True``)."""

        if not self.record_streams:
            raise ValueError("telemetry was not recording streams")
        return {
            "offload": np.stack(self.offload_stream),
            "replayed": np.stack(self.replay_stream),
            "preempt": np.stack(self.preempt_stream),
            "slot": np.stack(self.slot_stream),
        }

    def robot_trace(self, robot_id: int) -> QueueTrace:
        """One robot's recorded decisions as an engine-scoreable trace."""

        s = self.streams()
        return QueueTrace(
            refill_cloud=s["offload"][:, robot_id],
            refill_local=s["replayed"][:, robot_id],
            preempt=s["preempt"][:, robot_id],
            slot=s["slot"][:, robot_id],
        )

    def offload_fractions(self) -> np.ndarray:
        """Realized per-robot cloud fraction of chunk refill decisions."""

        return self.fires / np.maximum(self.fires + self.replays, 1)

    def fleet_offload_fraction(self) -> float:
        refills = int((self.fires + self.replays).sum())
        return float(self.fires.sum()) / max(refills, 1)

    def summary(self) -> Dict[str, object]:
        return {
            "ticks": self.ticks,
            "fires": self.fires.tolist(),
            "replays": self.replays.tolist(),
            "preempts": self.preempts.tolist(),
            "cancels": self.cancels.tolist(),
            "completions": self.completions.tolist(),
            "offload_fractions": [round(float(f), 4) for f in self.offload_fractions()],
            "fleet_offload_fraction": round(self.fleet_offload_fraction(), 4),
            "scan_windows": self.scan_windows,
            "host_gap_ms": round(self.host_gap_ms(), 3),
        }


# ---------------------------------------------------------------------------
# the live fleet's per-tick decision core
# ---------------------------------------------------------------------------


def _reset_rows(state, init, mask: torch.Tensor):
    """``state`` with the rows where ``mask`` [R] holds taken from ``init``
    (every field's leading axis is the robot axis)."""

    if isinstance(state, torch.Tensor):
        return torch.where(mask.reshape(mask.shape + (1,) * (state.dim() - 1)), init, state)
    return type(state)(*(_reset_rows(s, i, mask) for s, i in zip(state, init)))


class DecisionCore:
    """``trigger_step`` over a fleet of ``n_robots``, stepped once a control
    tick on ``device`` (the reference jits it on the default device).

    On a CUDA device the tick runs on a CUDA stream of its own: the frame's
    copy to the device, the step, and one device-to-host copy of the tick's
    decisions packed as one int32 [4, R] tensor (offload, replayed, preempt,
    slot).  The host read then waits only for the tick's own work, never for
    the scheduler's decode rounds queued on the model's stream, so a scan
    window keeps running on the device while the next ticks are decided.
    """

    def __init__(self, cfg: PolicyConfig, n_robots: int, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.init = trigger_init(cfg, (n_robots,), self.device)
        self.state = self.init
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def _step(self, q, qd, tau, join):
        def dev(a):
            return torch.as_tensor(np.asarray(a), device=self.device)

        state = self.state
        if join is not None and join.any():
            # joining rows snap back to the initial state before stepping
            state = _reset_rows(state, self.init, dev(join))
        self.state, dec = trigger_step(state, kin.KinematicFrame(dev(q), dev(qd), dev(tau)),
                                       self.cfg)
        packed = torch.stack([dec.offload.int(), dec.replayed.int(), dec.preempt.int(), dec.slot])
        return packed.cpu().numpy()

    def step(self, q, qd, tau, join: Optional[np.ndarray] = None) -> TriggerDecision:
        """One tick over host frames q/qd/tau [R, N] (``join`` [R] bool:
        rows reset first) -> the decisions as numpy arrays (``trig`` None)."""

        if self.stream is None:
            packed = self._step(q, qd, tau, join)
        else:
            with torch.cuda.stream(self.stream):
                packed = self._step(q, qd, tau, join)
        off, rep, pre, slot = packed
        return TriggerDecision(offload=off.astype(bool), replayed=rep.astype(bool),
                               preempt=pre.astype(bool), slot=slot, trig=None)
