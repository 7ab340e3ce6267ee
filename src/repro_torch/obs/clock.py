"""The serving stack's single wall-clock source (own copy of ``repro.obs.clock``).

``time.perf_counter`` is monotonic with the highest available resolution;
its epoch is arbitrary, so only differences are meaningful.  A span that
times GPU work must synchronise the device before reading the clock.
"""

from __future__ import annotations

import time

clock = time.perf_counter


def clock_ms() -> float:
    """Monotonic milliseconds (convenience for ms-denominated metrics)."""

    return time.perf_counter() * 1e3
