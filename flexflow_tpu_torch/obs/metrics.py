"""Serving metrics registry: counters, gauges, histograms.

A copy of the JAX package's ``flexflow_tpu/obs/metrics.py`` (host-side
Python only), its imports re-pointed at this package, which never
imports the JAX one.  Mentions of jitted programs below describe
the reference; here the same holds for the eager CUDA launches.

One process-local registry per :class:`~flexflow_tpu_torch.obs.telemetry.Telemetry`
handle, snapshotable to a plain dict — the shared accounting layer that
``bench.py``'s serving sections, ``RequestManager.serve_with_arrivals``, and
``scripts/trace_report.py`` consume instead of each keeping bespoke stat
code.  Pure host-side Python (no jax import): updating a metric can never
touch a jitted program.

Percentile convention matches the bench's historical reduction
(``sorted[min(int(q*n), n-1)]`` — nearest-rank, err-low), so numbers are
comparable across BENCH rounds that predate the registry.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence


def percentile(sorted_xs: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of an already-sorted sequence (None if
    empty) — the one convention every consumer shares."""
    if not sorted_xs:
        return None
    return sorted_xs[min(int(q * len(sorted_xs)), len(sorted_xs) - 1)]


class Counter:
    """Monotonic count (requests admitted, tokens generated, hops...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: float = 1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins scalar (batch occupancy, KV utilization...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self):
        return self.value


class Histogram:
    """Distribution over a sliding sample window.

    Running count/sum/min/max cover the full lifetime; percentiles come
    from the newest ``window`` observations (a bounded deque, so unbounded
    serving runs cannot grow host memory — consistent with the trace ring).
    """

    __slots__ = ("count", "total", "vmin", "vmax", "_window")

    def __init__(self, window: int = 8192):
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self._window: deque = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        self._window.append(v)

    def percentile(self, q: float) -> Optional[float]:
        return percentile(sorted(self._window), q)

    def tail(self, since_count: int) -> List[float]:
        """Observations that arrived AFTER lifetime count ``since_count``
        (clipped to the sliding window).  Lets a consumer that polls on
        its own cadence — e.g. the brownout controller's per-window SLO
        attainment (serve/slo.py) — evaluate only FRESH evidence: a
        single old breach must not pin a recovering signal forever."""
        fresh = self.count - max(int(since_count), 0)
        if fresh <= 0:
            return []
        fresh = min(fresh, len(self._window))
        return list(self._window)[len(self._window) - fresh:]

    def snapshot(self) -> Dict:
        xs = sorted(self._window)
        return {
            "count": self.count,
            "mean": (self.total / self.count) if self.count else None,
            "min": self.vmin,
            "max": self.vmax,
            "p50": percentile(xs, 0.50),
            "p95": percentile(xs, 0.95),
        }


class MetricsRegistry:
    """Name -> metric, get-or-create; a name keeps one type for its life."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(*args)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, "
                f"requested as {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 8192) -> Histogram:
        return self._get(name, Histogram, window)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict:
        """Plain-dict state: counters/gauges as scalars, histograms as
        their summary dicts — JSON-ready for bench lines and JSONL export."""
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}
