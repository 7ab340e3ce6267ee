"""SLO report: the serving registry distilled into the numbers that gate
(own copy of ``repro/obs/slo.py``).

ROADMAP item 1 (fleet-scale serving) reports through p50/p99 chunk
latency, queue wait, goodput, cancel rate and page-pool high-water —
this module turns a ``MetricsRegistry`` fed by one serving run into
exactly those lines.  ``serve_fleet`` prints the report at end of
episode and embeds ``to_json()`` in its output dict; the serving bench
merges the percentile fields into ``BENCH_serving.json``.

Canonical metric names (producers must agree with these):

  * ``serve.chunk_latency_ms``  — submit → harvest wall per chunk
  * ``serve.queue_wait_ms``     — submit → admission (batched prefill)
  * ``serve.host_gap_ms``       — host orchestration per window boundary
  * ``sched.window_ms``         — dispatch → harvest per scan window
  * ``sched.submissions/admissions/completions/cancels/...`` — counters
  * ``fleet.fires/replays/preempts`` — decision-core counters
  * ``pool.pages_in_use/high_water/page_allocs_total/...`` — KV pool
  * ``serve.wall_s``            — episode wall seconds (goodput basis)
  * ``channel.bytes_up/down{leg=...}`` — modeled split-serving channel
    bytes per direction and leg (cut-activation, expert-gather,
    expert-scatter)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.obs.metrics import Counter, Gauge, MetricsRegistry


def _pcts(metrics: MetricsRegistry, name: str) -> Dict[str, float]:
    h = metrics.get(name)
    if h is None or h.count == 0:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0,
                "p99": 0.0, "max": 0.0}
    return h.percentiles()


def _count(metrics: MetricsRegistry, name: str) -> int:
    c = metrics.get(name)
    return int(c.value) if isinstance(c, Counter) else 0


def _gauge(metrics: MetricsRegistry, name: str, high: bool = False,
           **labels) -> float:
    g = metrics.get(name, **labels)
    if not isinstance(g, Gauge):
        return 0.0
    return float(g.high if high else g.value)


def _leg_counters(metrics: MetricsRegistry, name: str) -> Dict[str, int]:
    """All ``name{leg="..."}`` counters as ``{leg: value}`` (sorted keys)."""

    prefix = name + '{leg="'
    return {
        key[len(prefix):-2]: int(m.value)
        for key, m in metrics.items()
        if key.startswith(prefix) and isinstance(m, Counter)
    }


@dataclass
class SLOReport:
    """Percentiles + rates for one serving run (all times milliseconds)."""

    chunk_latency_ms: Dict[str, float] = field(default_factory=dict)
    queue_wait_ms: Dict[str, float] = field(default_factory=dict)
    host_gap_ms: Dict[str, float] = field(default_factory=dict)
    window_ms: Dict[str, float] = field(default_factory=dict)
    completions: int = 0
    submissions: int = 0
    cancels: int = 0
    fetches: int = 0
    replays: int = 0
    wall_s: float = 0.0
    goodput_chunks_s: float = 0.0
    cancel_rate: float = 0.0
    replay_fraction: float = 0.0
    pool_high_water: int = 0
    pool_page_allocs: int = 0
    pool_page_frees: int = 0
    # sharded decode only: per-data-shard page occupancy (empty lists when
    # the engine ran single-shard)
    pool_shard_in_use: List[int] = field(default_factory=list)
    pool_shard_high_water: List[int] = field(default_factory=list)
    # split serving only: modeled channel bytes per direction, keyed by leg
    # (cut-activation / expert-gather / expert-scatter); empty dicts when
    # no partitioned robot completed a chunk
    channel_bytes_up: Dict[str, int] = field(default_factory=dict)
    channel_bytes_down: Dict[str, int] = field(default_factory=dict)

    def to_json(self) -> Dict[str, object]:
        rd = lambda d: {k: round(float(v), 4) for k, v in d.items()}
        return {
            "chunk_latency_ms": rd(self.chunk_latency_ms),
            "queue_wait_ms": rd(self.queue_wait_ms),
            "host_gap_ms": rd(self.host_gap_ms),
            "window_ms": rd(self.window_ms),
            "completions": self.completions,
            "submissions": self.submissions,
            "cancels": self.cancels,
            "fetches": self.fetches,
            "replays": self.replays,
            "wall_s": round(self.wall_s, 4),
            "goodput_chunks_s": round(self.goodput_chunks_s, 3),
            "cancel_rate": round(self.cancel_rate, 4),
            "replay_fraction": round(self.replay_fraction, 4),
            "pool_high_water": self.pool_high_water,
            "pool_page_allocs": self.pool_page_allocs,
            "pool_page_frees": self.pool_page_frees,
            "pool_shard_in_use": list(self.pool_shard_in_use),
            "pool_shard_high_water": list(self.pool_shard_high_water),
            "channel_bytes_up": dict(self.channel_bytes_up),
            "channel_bytes_down": dict(self.channel_bytes_down),
        }

    def lines(self) -> List[str]:
        """Human-readable SLO lines (printed at end of ``serve_fleet``)."""

        f = lambda d: (
            f"p50={d['p50']:.2f} p90={d['p90']:.2f} p99={d['p99']:.2f} "
            f"mean={d['mean']:.2f} max={d['max']:.2f} (n={d['count']})"
        )
        return [
            f"SLO chunk_latency_ms: {f(self.chunk_latency_ms)}",
            f"SLO queue_wait_ms:    {f(self.queue_wait_ms)}",
            f"SLO host_gap_ms:      {f(self.host_gap_ms)}",
            f"SLO goodput: {self.goodput_chunks_s:.2f} chunks/s over "
            f"{self.wall_s:.2f}s wall "
            f"({self.completions}/{self.submissions} submitted chunks, "
            f"cancel_rate={self.cancel_rate:.3f}, "
            f"replay_fraction={self.replay_fraction:.3f})",
            f"SLO kv pool: high_water={self.pool_high_water} pages "
            f"(allocs={self.pool_page_allocs} frees={self.pool_page_frees})",
        ] + (
            [f"SLO kv shards: in_use={self.pool_shard_in_use} "
             f"high_water={self.pool_shard_high_water}"]
            if self.pool_shard_in_use else []
        ) + (
            ["SLO channel bytes: up={"
             + ", ".join(f"{k}: {v}" for k, v in self.channel_bytes_up.items())
             + "} down={"
             + ", ".join(f"{k}: {v}"
                         for k, v in self.channel_bytes_down.items())
             + "}"]
            if self.channel_bytes_up or self.channel_bytes_down else []
        )


def build_slo_report(metrics: MetricsRegistry) -> SLOReport:
    """Distill a serving run's registry into an ``SLOReport``."""

    completions = _count(metrics, "sched.completions")
    submissions = _count(metrics, "sched.submissions")
    cancels = _count(metrics, "sched.cancels")
    fetches = _count(metrics, "fleet.fires")
    replays = _count(metrics, "fleet.replays")
    wall_s = _gauge(metrics, "serve.wall_s")
    return SLOReport(
        chunk_latency_ms=_pcts(metrics, "serve.chunk_latency_ms"),
        queue_wait_ms=_pcts(metrics, "serve.queue_wait_ms"),
        host_gap_ms=_pcts(metrics, "serve.host_gap_ms"),
        window_ms=_pcts(metrics, "sched.window_ms"),
        completions=completions,
        submissions=submissions,
        cancels=cancels,
        fetches=fetches,
        replays=replays,
        wall_s=wall_s,
        goodput_chunks_s=completions / wall_s if wall_s > 0 else 0.0,
        cancel_rate=cancels / max(submissions, 1),
        replay_fraction=replays / max(fetches + replays, 1),
        pool_high_water=int(_gauge(metrics, "pool.high_water", high=True)),
        pool_page_allocs=int(_gauge(metrics, "pool.page_allocs_total")),
        pool_page_frees=int(_gauge(metrics, "pool.page_frees_total")),
        pool_shard_in_use=[
            int(_gauge(metrics, "pool.shard_pages_in_use", shard=str(s)))
            for s in range(int(_gauge(metrics, "pool.num_shards")))
        ],
        pool_shard_high_water=[
            int(_gauge(metrics, "pool.shard_high_water", shard=str(s),
                       high=True))
            for s in range(int(_gauge(metrics, "pool.num_shards")))
        ],
        channel_bytes_up=_leg_counters(metrics, "channel.bytes_up"),
        channel_bytes_down=_leg_counters(metrics, "channel.bytes_down"),
    )
