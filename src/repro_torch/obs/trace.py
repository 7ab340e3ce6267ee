"""Request-lifecycle trace recorder with Chrome-trace / Perfetto export
(own copy of ``repro/obs/trace.py``).

The serving stack stamps spans only at boundaries the host already owns
(submission, admission, window dispatch, the window-closing harvest), so
recording a trace adds no host↔device syncs.  Spans land on named
*tracks* — one per robot (request lifetime ⊃ queue wait ⊃ decode), one
per scheduler lane (cloud + each partition cut: decode-window spans),
and one host-boundary track (the per-window host orchestration gap) —
exported as Chrome-trace JSON, loadable in Perfetto (ui.perfetto.dev)
or ``chrome://tracing``.

Timestamps are ``obs.clock()`` (monotonic ``perf_counter``) seconds,
rebased to the recorder's start and exported in microseconds, the
Chrome-trace unit.  Producers that share one clock read (e.g. every
completion harvested at a window boundary) therefore land on exactly
the same exported timestamp — the alignment the acceptance test pins.

``validate_chrome_trace`` is the CI-side checker: the JSON must parse,
carry a non-empty ``traceEvents`` list, and every track's event starts
must be monotone non-decreasing in emission order.  Run it as
``python -m repro_torch.obs.trace trace.json``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.clock import clock


class TraceRecorder:
    """Append-only span/instant recorder on named tracks."""

    def __init__(self):
        self.t0 = clock()
        # (track, name, ts_us, dur_us or None for instants, args or None)
        self._events: List[tuple] = []
        self._tracks: Dict[str, int] = {}

    def _us(self, t: float) -> float:
        return (t - self.t0) * 1e6

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = len(self._tracks) + 1
            self._tracks[track] = tid
        return tid

    def complete(self, track: str, name: str, t_start: float, t_end: float,
                 args: Optional[dict] = None) -> None:
        """One span ``[t_start, t_end]`` (clock() seconds) on ``track``."""

        self._events.append(
            (self._tid(track), name, self._us(t_start),
             max(self._us(t_end) - self._us(t_start), 0.0), args)
        )

    def instant(self, track: str, name: str, t: float,
                args: Optional[dict] = None) -> None:
        self._events.append((self._tid(track), name, self._us(t), None, args))

    @property
    def n_events(self) -> int:
        return len(self._events)

    def to_chrome(self) -> dict:
        """Chrome-trace JSON object (one process, one thread per track)."""

        events: List[dict] = [
            {
                "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                "args": {"name": "repro-serving"},
            }
        ]
        for track, tid in self._tracks.items():
            events.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                "args": {"name": track},
            })
            events.append({
                "name": "thread_sort_index", "ph": "M", "pid": 1, "tid": tid,
                "args": {"sort_index": tid},
            })
        for tid, name, ts, dur, args in self._events:
            ev = {"name": name, "pid": 1, "tid": tid, "ts": ts}
            if dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = dur
            if args:
                ev["args"] = args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


def validate_chrome_trace(obj: dict) -> Tuple[int, List[str]]:
    """Check a Chrome-trace object; returns (n_real_events, errors).

    Validates the contract the CI smoke gates on: ``traceEvents`` exists
    and holds at least one non-metadata event; every X/i event carries a
    finite non-negative ``ts`` (X also a non-negative ``dur``); and each
    track's event starts are monotone non-decreasing in file order.
    """

    errors: List[str] = []
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return 0, ["traceEvents missing or not a list"]
    last_ts: Dict[tuple, float] = {}
    n_real = 0
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            continue
        if ph not in ("X", "i", "B", "E"):
            errors.append(f"event {i}: unsupported phase {ph!r}")
            continue
        n_real += 1
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0 or ts != ts:
            errors.append(f"event {i} ({ev.get('name')!r}): bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(
                    f"event {i} ({ev.get('name')!r}): bad dur {dur!r}"
                )
        key = (ev.get("pid"), ev.get("tid"))
        if ts < last_ts.get(key, 0.0) - 1e-6:
            errors.append(
                f"event {i} ({ev.get('name')!r}): ts {ts} not monotone on "
                f"track {key} (last {last_ts[key]})"
            )
        last_ts[key] = max(last_ts.get(key, 0.0), ts)
    if n_real == 0:
        errors.append("trace holds no events (metadata only)")
    return n_real, errors


def main(argv=None):
    import argparse
    import sys

    p = argparse.ArgumentParser(
        description="Validate a Chrome-trace JSON written by --trace-out"
    )
    p.add_argument("path")
    args = p.parse_args(argv)
    with open(args.path) as f:
        obj = json.load(f)
    n, errors = validate_chrome_trace(obj)
    for e in errors:
        print(f"INVALID: {e}", file=sys.stderr)
    if errors:
        sys.exit(1)
    tracks = {
        ev["args"]["name"]
        for ev in obj["traceEvents"]
        if ev.get("ph") == "M" and ev.get("name") == "thread_name"
    }
    print(f"OK: {n} events on {len(tracks)} tracks "
          f"({', '.join(sorted(tracks))})")


if __name__ == "__main__":
    main()
