"""Low-overhead serving trace recorder with Chrome/Perfetto export.

A copy of the JAX package's ``flexflow_tpu/obs/trace.py`` (host-side
Python only), its imports re-pointed at this package, which never
imports the JAX one.  Mentions of jitted programs below describe
the reference; here the same holds for the eager CUDA launches.

The serving stack's latency story spans a host-side orchestration loop
(RequestManager), async jit dispatches (InferenceManager), and per-stage
pipeline hops (PipelinedInferenceManager) — none of which an XLA/XProf trace
attributes to *requests*.  This recorder captures that host-side story as
typed spans/instants/counters on named tracks, exportable as
``chrome://tracing`` / Perfetto ``trace_event`` JSON (one track per pipeline
stage, so a pp run shows the stage interleave visually) and as JSONL for
``scripts/trace_report.py``.

Overhead contract (the reason this exists as its own layer instead of
piggybacking on ``jax.profiler``):

* **host-side only** — events are Python dicts appended to a ring buffer;
  nothing is ever passed into (or read back from) a jitted program, so
  recording cannot perturb compiled executables or their outputs.  Serve
  results are bit-identical with tracing on or off (pinned by
  tests/test_obs.py).
* **bounded memory** — a ``deque(maxlen=capacity)`` ring: long serving runs
  drop the *oldest* events rather than growing; ``dropped`` counts what fell
  off the ring.
* **hermetically testable** — the clock is injectable (any 0-arg seconds
  callable, default ``time.perf_counter``), so virtual-clock tests pin exact
  timestamps, span nesting, and wraparound behavior.

Timestamps are kept in SECONDS internally (matching the injectable clock)
and scaled to the trace_event format's microseconds at export.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Dict, List, Optional


class _Span:
    """Context manager recording one complete ("X" phase) event.

    The event is emitted at ``__exit__`` with the entry timestamp, so buffer
    order is completion order; Perfetto sorts by ``ts`` and infers nesting
    from containment on a track, which entry/exit pairing here guarantees
    for same-track spans.
    """

    __slots__ = ("_rec", "_name", "_cat", "_track", "_args", "_t0")

    def __init__(self, rec, name, cat, track, args):
        self._rec = rec
        self._name = name
        self._cat = cat
        self._track = track
        self._args = args

    def __enter__(self):
        self._t0 = self._rec._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = self._rec
        rec._emit("X", self._name, self._cat, self._track, self._t0,
                  rec._clock() - self._t0, self._args)
        return False


class TraceRecorder:
    """Ring-buffered trace-event recorder (see module docstring)."""

    def __init__(self, capacity: int = 65536,
                 clock: Optional[Callable[[], float]] = None, pid: int = 1):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._clock = clock or time.perf_counter
        self._events: deque = deque(maxlen=capacity)
        self._tracks: Dict[str, int] = {}
        self.capacity = capacity
        self.pid = pid
        self.emitted = 0  # lifetime count, incl. events the ring dropped

    # ------------------------------------------------------------------
    def now(self) -> float:
        return self._clock()

    @property
    def dropped(self) -> int:
        return self.emitted - len(self._events)

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = len(self._tracks) + 1
            self._tracks[track] = tid
        return tid

    def _emit(self, ph, name, cat, track, ts, dur, args):
        ev = {"ph": ph, "name": name, "cat": cat, "tid": self._tid(track),
              "ts": ts}
        if dur is not None:
            ev["dur"] = dur
        if args:
            ev["args"] = args
        self._events.append(ev)
        self.emitted += 1

    # ------------------------------------------------------------------
    def span(self, name: str, cat: str = "serve", track: str = "serve",
             **args) -> _Span:
        """``with rec.span("decode_stretch", steps=8): ...`` — a complete
        event covering the body's wall time on ``track``."""
        return _Span(self, name, cat, track, args)

    def instant(self, name: str, cat: str = "serve", track: str = "serve",
                **args) -> float:
        """Zero-duration event; returns its timestamp (callers reuse it for
        derived duration bookkeeping without a second clock read)."""
        ts = self._clock()
        self._emit("i", name, cat, track, ts, None, args)
        return ts

    def counter(self, name: str, value: float,
                track: str = "counters") -> None:
        """Counter-series sample ("C" phase) — Perfetto renders these as a
        stepped line chart (batch occupancy, KV utilization, ...)."""
        self._emit("C", name, "metric", track, self._clock(), None,
                   {"value": float(value)})

    # ------------------------------------------------------------------
    def trace_events(self) -> List[Dict]:
        """Events in ``trace_event`` JSON form (ts/dur in microseconds),
        prefixed with thread_name metadata naming each track."""
        out = []
        for track, tid in self._tracks.items():
            out.append({"ph": "M", "name": "thread_name", "pid": self.pid,
                        "tid": tid, "args": {"name": track}})
        for ev in self._events:
            e = {"name": ev["name"], "cat": ev["cat"], "ph": ev["ph"],
                 "pid": self.pid, "tid": ev["tid"],
                 "ts": round(ev["ts"] * 1e6, 3)}
            if "dur" in ev:
                e["dur"] = round(ev["dur"] * 1e6, 3)
            if ev["ph"] == "i":
                e["s"] = "t"  # thread-scoped instant
            if "args" in ev:
                e["args"] = ev["args"]
            out.append(e)
        return out

    def to_chrome_json(self) -> Dict:
        """The ``chrome://tracing`` / Perfetto-loadable document.

        ``metadata`` carries the ring accounting (lifetime ``emitted`` vs
        ``dropped``): a trace whose oldest events fell off the ring must
        not masquerade as a complete record — viewers ignore the extra
        top-level key, ``scripts/trace_report.py`` warns on it.
        """
        return {
            "traceEvents": self.trace_events(),
            "displayTimeUnit": "ms",
            "metadata": {"trace_events_emitted": self.emitted,
                         "trace_events_dropped": self.dropped,
                         "ring_capacity": self.capacity},
        }

    def export_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_json(), f)
        return path

    def clear(self) -> None:
        self._events.clear()
        # emitted/dropped keep counting across clears (lifetime telemetry)
