"""Workload characterization + drift detection for the serving planner.

A copy of the JAX package's ``flexflow_tpu/obs/drift.py`` (host-side
Python only), its imports re-pointed at this package, which never
imports the JAX one.  Mentions of jitted programs below describe
the reference; here the same holds for the eager CUDA launches.

A serve plan is priced for ONE traffic mix — the prompt/output lengths,
arrival rate, and occupancy the search saw — and silently degrades when
live traffic walks away from it (ROADMAP: "re-search when telemetry shows
the traffic mix drifted").  This module gives that drift a number:

* :class:`WorkloadProfile` — windowed histograms over the serving
  dimensions the cost model is sensitive to (prompt length, output
  length, inter-arrival gap, slot occupancy, speculative acceptance),
  maintained by the :class:`~flexflow_tpu_torch.obs.telemetry.Telemetry` handle
  from the SAME ``request_*`` lifecycle calls the serving stack already
  makes — no new instrumentation sites, bounded memory (deque windows).
* :func:`psi` — population-stability-index distance between two
  histograms (the standard scorecard-monitoring drift statistic:
  ``sum((p-q) * ln(p/q))`` over smoothed bucket frequencies; 0 for
  identical distributions, ~0.1 "shifting", >0.25 "shifted").
* :class:`DriftDetector` — compares a REFERENCE profile (the one the
  executing plan was searched for) against the live window, emits a
  ``workload_drift_score`` gauge + per-dimension gauges, and an
  edge-triggered ``drift_detected`` instant when the score crosses the
  threshold.

Everything here is host-side arithmetic on Python scalars — nothing can
enter a jitted program, so the bit-identity contract (serve outputs
identical with observability on or off) extends to the drift layer by
construction.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# bucket edges per dimension: lengths are log-spaced (a doubling of the
# prompt-length mix should move mass whole buckets, not fractions of one),
# fractions are deciles, inter-arrival gaps log-spaced in seconds
LEN_EDGES = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
IAT_EDGES = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0)
FRAC_EDGES = tuple(i / 10 for i in range(1, 10))

PROFILE_DIMS = ("prompt_len", "output_len", "interarrival_s", "occupancy",
                "spec_acceptance")
_DIM_EDGES = {
    "prompt_len": LEN_EDGES,
    "output_len": LEN_EDGES,
    "interarrival_s": IAT_EDGES,
    "occupancy": FRAC_EDGES,
    "spec_acceptance": FRAC_EDGES,
}


class _Window:
    """One dimension: bounded sample window + fixed-edge bucket counts."""

    __slots__ = ("edges", "count", "total", "_xs")

    def __init__(self, edges: Sequence[float], window: int):
        self.edges = tuple(edges)
        self.count = 0      # lifetime observations
        self.total = 0.0    # lifetime sum (for the lifetime mean)
        self._xs: deque = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self._xs.append(v)

    def _bucket(self, v: float) -> int:
        for i, e in enumerate(self.edges):
            if v <= e:
                return i
        return len(self.edges)

    def counts(self) -> List[int]:
        out = [0] * (len(self.edges) + 1)
        for v in self._xs:
            out[self._bucket(v)] += 1
        return out

    def mean(self) -> Optional[float]:
        if not self._xs:
            return None
        return sum(self._xs) / len(self._xs)

    def snapshot(self) -> Dict:
        return {"n": len(self._xs), "count": self.count,
                "mean": self.mean(), "edges": list(self.edges),
                "counts": self.counts()}


class WorkloadProfile:
    """Windowed histograms over the serving-traffic dimensions.

    ``window`` bounds per-dimension memory; the live window is what drift
    compares — a profile is "what traffic looked like recently", not a
    lifetime average that old traffic anchors forever.
    """

    def __init__(self, window: int = 512):
        from collections import deque

        self.window = window
        self._dims: Dict[str, _Window] = {
            d: _Window(_DIM_EDGES[d], window) for d in PROFILE_DIMS
        }
        self._last_arrival: Optional[float] = None
        # paged-KV prefix sharing: the windowed fraction of binds that hit
        # the prefix cache (serve/kv_paged.py).  Not a PSI drift dimension
        # — it feeds the serve search's sharing discount (the fraction of
        # offered prefill work the page pool absorbs).
        self._prefix_hits = deque(maxlen=window)

    # ---- observation hooks (fed by Telemetry.request_* et al.) --------
    def observe_enqueue(self, prompt_len: int,
                        ts: Optional[float] = None) -> None:
        """A request arrived: prompt-length sample + inter-arrival gap.
        ``ts`` is the enqueue instant's OWN timestamp (the caller already
        read the clock for the trace event — reuse it, never re-read)."""
        self._dims["prompt_len"].observe(prompt_len)
        if ts is not None:
            if self._last_arrival is not None and ts >= self._last_arrival:
                self._dims["interarrival_s"].observe(ts - self._last_arrival)
            self._last_arrival = ts

    def observe_finish(self, n_tokens: int) -> None:
        self._dims["output_len"].observe(n_tokens)

    def observe_occupancy(self, occ: float) -> None:
        self._dims["occupancy"].observe(occ)

    def observe_spec_acceptance(self, frac: float) -> None:
        self._dims["spec_acceptance"].observe(frac)

    def observe_prefix(self, hit: bool) -> None:
        """One paged-KV bind's prefix-cache outcome (Telemetry
        .prefix_cache_hit/miss feed this)."""
        self._prefix_hits.append(bool(hit))

    # ---- views ---------------------------------------------------------
    def snapshot(self) -> Dict:
        """JSON-ready per-dimension histograms (the drift comparand and
        the ``{"kind": "workload"}`` JSONL export line)."""
        return {"window": self.window,
                "dims": {d: w.snapshot() for d, w in self._dims.items()}}

    def features(self) -> Dict[str, float]:
        """Plan-facing scalars for ``search_serve_plan(workload=...)``.

        ``arrival_rate_per_s`` derives from the mean inter-arrival gap;
        dimensions with no samples fall back to neutral values (0 rates,
        full occupancy) so a cold profile never mis-steers the search.
        """
        d = self._dims
        mean_iat = d["interarrival_s"].mean()
        occ = d["occupancy"].mean()
        acc = d["spec_acceptance"].mean()
        return {
            "mean_prompt_len": d["prompt_len"].mean() or 0.0,
            "mean_output_len": d["output_len"].mean() or 0.0,
            "arrival_rate_per_s": (1.0 / mean_iat
                                   if mean_iat and mean_iat > 0 else 0.0),
            "mean_occupancy": occ if occ is not None else 1.0,
            "mean_spec_acceptance": acc if acc is not None else 0.0,
            # fraction of recent binds whose prompt prefix was already
            # cached (0.0 cold / unpaged — neutral: no sharing discount)
            "shared_prefix_frac": (sum(self._prefix_hits)
                                   / len(self._prefix_hits)
                                   if self._prefix_hits else 0.0),
            "n_requests": len(d["prompt_len"]._xs),
        }


def psi(p_counts: Iterable[float], q_counts: Iterable[float],
        eps: float = 1e-4) -> float:
    """Population stability index between two bucket-count vectors.

    Counts are normalized to frequencies with ``eps`` smoothing (an empty
    bucket on one side must not produce an infinite log-ratio).  Symmetric
    by construction; 0.0 iff the smoothed frequencies match.
    """
    p = [max(float(x), 0.0) for x in p_counts]
    q = [max(float(x), 0.0) for x in q_counts]
    if len(p) != len(q):
        raise ValueError(f"bucket mismatch: {len(p)} vs {len(q)}")
    sp, sq = sum(p) or 1.0, sum(q) or 1.0
    import math

    score = 0.0
    for a, b in zip(p, q):
        fa = a / sp + eps
        fb = b / sq + eps
        score += (fa - fb) * math.log(fa / fb)
    return score


def drift_score(reference: Dict, live: Dict,
                min_samples: int = 16) -> Dict:
    """Per-dimension PSI between two :meth:`WorkloadProfile.snapshot`
    docs, plus the aggregate ``score`` (the worst dimension — one
    dimension drifting alone is already a mispriced plan).

    Dimensions with fewer than ``min_samples`` live-or-reference samples
    are skipped (reported under ``skipped``) — a 3-sample histogram says
    nothing about the population.
    """
    per_dim: Dict[str, float] = {}
    skipped: List[str] = []
    rdims = reference.get("dims", {})
    ldims = live.get("dims", {})
    for d in PROFILE_DIMS:
        r, l = rdims.get(d), ldims.get(d)
        if r is None or l is None:
            continue
        if r.get("n", 0) < min_samples or l.get("n", 0) < min_samples:
            skipped.append(d)
            continue
        per_dim[d] = round(psi(r["counts"], l["counts"]), 4)
    score = max(per_dim.values()) if per_dim else 0.0
    worst = max(per_dim, key=per_dim.get) if per_dim else None
    return {"score": round(score, 4), "per_dim": per_dim,
            "worst_dim": worst, "skipped": skipped}


class DriftDetector:
    """Reference-vs-live drift with telemetry emission.

    ``reference`` is the profile snapshot the EXECUTING plan was searched
    for (capture it with ``profile.snapshot()`` at plan time).  Each
    :meth:`check` scores the live window against it, sets the
    ``workload_drift_score`` gauge (+ ``workload_psi_<dim>`` per
    dimension), and emits ONE ``drift_detected`` instant per excursion
    above ``threshold`` (edge-triggered; re-arms when the score falls
    back below).
    """

    def __init__(self, reference: Dict, threshold: float = 0.25,
                 min_samples: int = 16):
        if hasattr(reference, "snapshot"):
            reference = reference.snapshot()
        self.reference = reference
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.tripped = False

    def check(self, live, telemetry=None) -> Dict:
        if hasattr(live, "snapshot"):
            live = live.snapshot()
        rep = drift_score(self.reference, live,
                          min_samples=self.min_samples)
        rep["threshold"] = self.threshold
        rep["drifted"] = rep["score"] >= self.threshold
        if telemetry is not None and getattr(telemetry, "enabled", False):
            telemetry.metrics.gauge("workload_drift_score").set(rep["score"])
            telemetry.counter("workload_drift_score", rep["score"])
            for d, s in rep["per_dim"].items():
                telemetry.metrics.gauge(f"workload_psi_{d}").set(s)
            if rep["drifted"] and not self.tripped:
                telemetry.instant(
                    "drift_detected", cat="plan", track="plan_health",
                    score=rep["score"], threshold=self.threshold,
                    worst_dim=rep["worst_dim"])
        self.tripped = rep["drifted"]
        return rep
