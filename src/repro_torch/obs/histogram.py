"""Streaming fixed-bucket log2 latency histogram
(own copy of ``repro/obs/histogram.py``).

SLO percentiles over an unbounded stream of latencies cannot keep every
sample: a fleet serving millions of chunks needs O(1) memory per metric
and O(1) cost per observation.  The classic answer (HdrHistogram, Prom
native histograms) is exponential buckets; this is the minimal honest
version of it:

  * bucket 0 holds values in ``[0, LO_MS)`` (below 1 microsecond);
  * bucket ``i`` (1-based) holds ``[LO_MS * 2**(i-1), LO_MS * 2**i)`` —
    sixty-four buckets cover 1 us to ~52 days of milliseconds, so no
    serving latency ever saturates the top bucket in practice;
  * ``observe`` is an int bucket bump; ``merge`` adds count arrays, so
    per-shard / per-episode histograms combine losslessly;
  * ``quantile(q)`` selects the nearest-rank sample's bucket and
    interpolates inside it — the returned value's bucket is GUARANTEED
    to contain the true sample quantile (the property the SLO-report
    acceptance test pins against raw trace timestamps).

Exact ``count`` / ``sum`` / ``min`` / ``max`` ride along, so means are
exact even though percentiles are bucket-resolved.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

N_BUCKETS = 64
LO_MS = 1e-3  # bucket 1 lower edge: one microsecond, in milliseconds


def bucket_index(v: float) -> int:
    """Bucket holding value ``v`` (ms); negatives clamp to bucket 0."""

    if v < LO_MS:
        return 0
    return min(int(math.floor(math.log2(v / LO_MS))) + 1, N_BUCKETS - 1)


def bucket_bounds(i: int) -> Tuple[float, float]:
    """``[lo, hi)`` bounds of bucket ``i`` in ms (bucket 0 starts at 0)."""

    if i <= 0:
        return (0.0, LO_MS)
    return (LO_MS * 2.0 ** (i - 1), LO_MS * 2.0 ** i)


class LatencyHistogram:
    """O(1)-memory mergeable latency histogram (values in milliseconds)."""

    __slots__ = ("counts", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.counts = [0] * N_BUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        v = max(float(v), 0.0)
        self.counts[bucket_index(v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into this histogram (lossless on buckets)."""

        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def bucket_of(self, v: float) -> Tuple[float, float]:
        """The ``[lo, hi)`` bucket bounds a value falls in."""

        return bucket_bounds(bucket_index(v))

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile, interpolated within its bucket.

        The nearest-rank sample (rank ``ceil(q * count)``) lies in the
        returned value's bucket by construction, so callers can pin the
        estimate against exact samples via ``bucket_of``.
        """

        if self.count == 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            if c and seen + c >= rank:
                lo, hi = bucket_bounds(i)
                # clamp the interpolation window to observed extremes so a
                # single-sample bucket doesn't report beyond min/max
                lo = max(lo, self.vmin if self.vmin is not math.inf else lo)
                hi = min(hi, self.vmax + 0.0 if self.vmax >= lo else hi)
                frac = (rank - seen - 0.5) / c
                return lo + frac * max(hi - lo, 0.0)
            seen += c
        return self.vmax  # unreachable with count > 0

    def percentiles(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "max": self.vmax if self.count else 0.0,
        }

    def to_json(self) -> Dict[str, object]:
        """Flat JSON: exact moments + sparse nonzero buckets."""

        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "buckets": {
                str(i): c for i, c in enumerate(self.counts) if c
            },
        }

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "LatencyHistogram":
        h = cls()
        h.count = int(d["count"])
        h.total = float(d["sum"])
        if h.count:
            h.vmin = float(d["min"])
            h.vmax = float(d["max"])
        for i, c in dict(d.get("buckets", {})).items():
            h.counts[int(i)] = int(c)
        return h
