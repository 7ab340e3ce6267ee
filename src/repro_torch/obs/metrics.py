"""Metrics registry: named counters, gauges, and latency histograms
(own copy of ``repro/obs/metrics.py``).

The registry is the flat, queryable side of observability (the trace is
the structured side): every serving component — scheduler, page
allocator, partition executor, fleet loop — gets-or-creates metrics by
name (plus optional labels) and bumps them at host-owned boundaries.
Reads are O(1) dict lookups; nothing here touches the device.

Exports:

  * ``to_json()`` — one flat dict (histograms expand to count/sum/
    min/max/p50/p90/p99 + sparse buckets), the ``--metrics-json`` dump;
  * ``to_prometheus()`` — Prometheus text exposition (counters, gauges,
    and cumulative-bucket histograms), the ``--metrics-prom`` dump.

Label sets are folded into the metric key Prometheus-style
(``name{k="v"}``), which keeps the registry a flat dict and makes the
JSON dump grep-able.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Optional, Tuple

from repro_torch.obs.histogram import LatencyHistogram, bucket_bounds


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value; tracks its own high-water mark."""

    __slots__ = ("value", "high")

    def __init__(self):
        self.value = 0.0
        self.high = 0.0

    def set(self, v: float) -> None:
        self.value = v
        if v > self.high:
            self.high = v


def _key(name: str, labels: Dict[str, object]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


def _split_key(key: str) -> Tuple[str, str]:
    """``name{labels}`` -> (name, ``{labels}`` or ``""``)."""

    i = key.find("{")
    return (key, "") if i < 0 else (key[:i], key[i:])


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


class MetricsRegistry:
    """Flat name -> metric map with get-or-create accessors."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, labels: Dict[str, object], factory):
        key = _key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = factory()
            self._metrics[key] = m
        elif not isinstance(m, factory):
            raise TypeError(
                f"metric {key!r} already registered as {type(m).__name__}"
            )
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str, **labels) -> LatencyHistogram:
        return self._get(name, labels, LatencyHistogram)

    def get(self, name: str, **labels):
        """Peek a metric without creating it (None when absent)."""

        return self._metrics.get(_key(name, labels))

    def items(self) -> Iterator[Tuple[str, object]]:
        return iter(sorted(self._metrics.items()))

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry in (histograms merge, counters add,
        gauges take the other's last value)."""

        for key, m in other._metrics.items():
            mine = self._metrics.get(key)
            if mine is None:
                name, _ = _split_key(key)
                mine = self._get(key, {}, type(m))
            if isinstance(m, Counter):
                mine.inc(m.value)
            elif isinstance(m, Gauge):
                mine.set(m.value)
                mine.high = max(mine.high, m.high)
            else:
                mine.merge(m)
        return self

    # ------------------------------------------------------------------
    # exports
    # ------------------------------------------------------------------

    def to_json(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for key, m in self.items():
            if isinstance(m, Counter):
                out[key] = m.value
            elif isinstance(m, Gauge):
                out[key] = {"value": m.value, "high": m.high}
            else:
                out[key] = m.to_json()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one scrape's worth)."""

        lines = []
        seen_types = set()
        for key, m in self.items():
            name, labels = _split_key(key)
            pname = _prom_name(name)
            if isinstance(m, Counter):
                if pname not in seen_types:
                    lines.append(f"# TYPE {pname} counter")
                    seen_types.add(pname)
                lines.append(f"{pname}{labels} {m.value}")
            elif isinstance(m, Gauge):
                if pname not in seen_types:
                    lines.append(f"# TYPE {pname} gauge")
                    seen_types.add(pname)
                lines.append(f"{pname}{labels} {_fmt(m.value)}")
            else:
                if pname not in seen_types:
                    lines.append(f"# TYPE {pname} histogram")
                    seen_types.add(pname)
                inner = labels[1:-1] if labels else ""
                cum = 0
                for i, c in enumerate(m.counts):
                    if not c:
                        continue
                    cum += c
                    _, hi = bucket_bounds(i)
                    le = f'le="{_fmt(hi)}"'
                    lab = f"{{{inner + ',' if inner else ''}{le}}}"
                    lines.append(f"{pname}_bucket{lab} {cum}")
                lab = f'{{{inner + "," if inner else ""}le="+Inf"}}'
                lines.append(f"{pname}_bucket{lab} {m.count}")
                lines.append(f"{pname}_sum{labels} {_fmt(m.total)}")
                lines.append(f"{pname}_count{labels} {m.count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return f"{v:.6g}"
