"""Observability of the port's serving stack (own copy of ``repro/obs``;
the port imports nothing of the JAX package).

``clock`` is the one wall-clock source; ``LatencyHistogram`` a streaming
log2 histogram; ``MetricsRegistry`` named counters, gauges and histograms
with JSON and Prometheus exports; ``TraceRecorder`` request-lifecycle spans
exported as Chrome-trace JSON; ``SLOReport`` the registry distilled into
percentile and rate lines.  Producers take an ``Observability`` handle that
may be ``None`` and stamp only at host-owned boundaries (submission,
admission, window close), so instrumentation adds no device syncs.
"""

from repro_torch.obs.clock import clock
from repro_torch.obs.histogram import LatencyHistogram
from repro_torch.obs.metrics import Counter, Gauge, MetricsRegistry
from repro_torch.obs.slo import SLOReport, build_slo_report
from repro_torch.obs.trace import TraceRecorder, validate_chrome_trace


class Observability:
    """The one handle threaded through the serving stack: a
    ``MetricsRegistry`` (always) and a ``TraceRecorder`` (unless
    ``trace=False``)."""

    def __init__(self, trace: bool = True):
        self.metrics = MetricsRegistry()
        self.trace = TraceRecorder() if trace else None

    clock = staticmethod(clock)

    def slo_report(self) -> SLOReport:
        return build_slo_report(self.metrics)


__all__ = [
    "Observability",
    "clock",
    "LatencyHistogram",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "TraceRecorder",
    "validate_chrome_trace",
    "SLOReport",
    "build_slo_report",
]
