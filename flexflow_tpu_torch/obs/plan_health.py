"""Plan-health monitoring: is the executing serve plan still the right one?

A copy of the JAX package's ``flexflow_tpu/obs/plan_health.py`` (host-side
Python only), its imports re-pointed at this package, which never
imports the JAX one.  Mentions of jitted programs below describe
the reference; here the same holds for the eager CUDA launches.

Closes the last third of the observe->calibrate->re-plan loop (
ROADMAP "online re-planning"): the search predicted a TPOT/TTFT for the
plan it picked, the operator has SLO targets, and the plan was priced for
one workload profile — this monitor watches all three and, when any
breaks, re-runs the serve search on the DRIFTED profile and emits a
``replan_recommended`` instant carrying the candidate plan.  With a
:class:`~flexflow_tpu_torch.serve.kv_allocator.KVAllocator` attached it also
watches the BYTE side: projected KV growth from the live workload
profile vs the allocator's real headroom, breaching as
``memory_pressure`` (the memory-observability layer) — capacity is the
binding constraint for serving, so running out of HBM is a plan-health
failure exactly like missing an SLO.

**The monitor recommends; the MigrationController acts.**  Everything
here is host-side arithmetic over the metrics registry and the workload
profile — attaching a monitor cannot change serve outputs (bit-identity
pinned in tests/test_plan_health.py, including a pp2 virtual-mesh
config).  A :class:`~flexflow_tpu_torch.serve.migration.MigrationController`
attached to the serving RequestManager consumes ``recommendation``
(which carries the full candidate plan dict) and executes the live plan
switch over the preemption-and-recompute path — drain/rebuild/
readmit with rollback; see ``serve/migration.py``.  After a completed
switch the controller calls :meth:`PlanHealthMonitor.rebase` so the
monitor watches the NEW plan against a fresh reference window.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from .drift import DriftDetector
from .telemetry import telemetry_or_null


@dataclasses.dataclass
class PlanHealthConfig:
    """Thresholds for the three health checks.

    * SLO targets (``slo_ttft_p95_s`` / ``slo_tpot_p95_s``): None disables
      that check — not every deployment has an explicit SLO.
    * ``max_tpot_error_frac``: tolerated |measured - predicted| / predicted
      on the plan's own TPOT prediction before the cost model is declared
      out of touch with reality (the calibration loop should be shrinking
      this; a breach means the search ranked candidates with a broken
      ruler).
    * ``drift_threshold`` / ``drift_min_samples``: forwarded to the
      :class:`~flexflow_tpu_torch.obs.drift.DriftDetector` (PSI units: >0.25 is
      the classic "population has shifted" line).
    * ``min_requests``: finished requests before latency checks engage —
      percentile comparisons over a handful of requests are noise.
    * ``replan_cooldown_ticks``: checks that must pass after a
      ``replan_recommended`` emission before ANOTHER may fire — the flap
      guard.  The historical dedup is "once per distinct candidate",
      which an OSCILLATING candidate pair defeats (A, B, A, B … each
      differs from its predecessor, so every check emits); the cooldown
      suppresses both the instant and the ``recommendation`` update for
      that many checks, so a downstream MigrationController cannot be
      whipsawed between two plans.  0 keeps the historical behavior.
    * ``memory_pressure_frac``: the OOM-risk line — breach when the
      PROJECTED live KV (current occupied positions + every live request
      growing by the workload profile's mean output length) exceeds this
      fraction of the :class:`~flexflow_tpu_torch.serve.kv_allocator.
      KVAllocator`'s byte capacity.  The projection deliberately errs
      high (each live request is priced at the FULL mean output, not the
      remainder) — for OOM risk, a false alarm costs a re-search, a miss
      costs the deployment.  1.0 = breach only when projected past
      capacity; lower it to leave admission headroom.
    """

    slo_ttft_p95_s: Optional[float] = None
    slo_tpot_p95_s: Optional[float] = None
    max_tpot_error_frac: float = 0.5
    drift_threshold: float = 0.25
    drift_min_samples: int = 16
    min_requests: int = 8
    replan_cooldown_ticks: int = 0
    memory_pressure_frac: float = 1.0


class PlanHealthMonitor:
    """Compare live latencies/traffic against the executing plan.

    ``plan``: the dict ``search_serve_plan`` returned for the incumbent
    (``plan_key`` + predicted ``tpot_ms``/``ttft_ms`` are read).
    ``reference``: the workload-profile snapshot the plan was searched for
    (default: the telemetry handle's CURRENT window — capture the monitor
    right after planning so "reference" really is the planned-for mix).
    ``search_fn``: 0-arg callable re-running the serve search on the LIVE
    profile, returning a plan dict — injected so hermetic tests (and
    deployments with custom search wiring) control it; None degrades to
    report-only health checks.
    ``kv_allocator``: the deployment's
    :class:`~flexflow_tpu_torch.serve.kv_allocator.KVAllocator` — or a LIST of
    allocators for multi-deployment serving (the spec manager wires
    [target, draft] so projection and capacity cover both caches) —
    enables the OOM-risk check (projected KV growth vs real headroom).
    The RequestManager wires its manager's allocator in automatically
    when the monitor is attached without one; None skips the memory
    check.

    :meth:`check` returns the health report and, when any check fails AND
    the re-search returns a plan whose key differs from the incumbent,
    emits ``replan_recommended`` (once per distinct candidate while the
    condition persists — a monitor polled every few ticks must not spam
    the ring with identical recommendations).
    """

    def __init__(self, telemetry, plan: Dict, reference=None,
                 config: Optional[PlanHealthConfig] = None,
                 search_fn: Optional[Callable[[], Dict]] = None,
                 kv_allocator=None, slo=None, brownout=None):
        # None degrades to the no-op handle: checks still run (drift
        # against an empty window, latencies unavailable), nothing emits
        self.telemetry = telemetry_or_null(telemetry)
        self.plan = dict(plan)
        self.config = config or PlanHealthConfig()
        self._reset_reference(reference)
        self.search_fn = search_fn
        self.kv_allocator = kv_allocator
        # SLO-class lanes (serve/slo.py): with an attached SLOPolicy the
        # monitor ALSO checks each class's own p95s against the class's
        # targets — a breach on a NON-degradable (latency-critical)
        # class joins the replan reasons, while a degradable-class
        # breach escalates an attached BrownoutController FIRST
        # (degrading batch work is cheaper than a plan switch; only a
        # ladder already at its max level lets the breach recommend
        # replan).
        self.slo = slo
        self.brownout = brownout
        self.checks = 0
        self.recommendation: Optional[Dict] = None
        # the most recent check() report — the fleet router's least-load
        # dispatch reads it (via health_score) so an unhealthy replica's
        # routing weight degrades without re-running the checks per tick
        self.last_report: Optional[Dict] = None
        self._last_candidate_key: Optional[str] = None
        self._last_emit_check: Optional[int] = None
        self._mem_pressure_active = False

    def _reset_reference(self, reference) -> None:
        """(Re)build the drift detector against ``reference`` (None = the
        handle's CURRENT workload window) — shared by __init__ and
        :meth:`rebase` so their wiring cannot diverge."""
        if reference is None and self.telemetry.enabled:
            reference = self.telemetry.workload.snapshot()
        self.detector = DriftDetector(
            reference or {"dims": {}},
            threshold=self.config.drift_threshold,
            min_samples=self.config.drift_min_samples)

    def rebase(self, plan: Dict, reference=None, kv_allocator=None) -> None:
        """Re-point the monitor at a NEW executing plan (the
        MigrationController calls this after a completed switch): the
        candidate becomes the incumbent, the drift reference resets to
        the CURRENT workload window (the plan was searched on the live
        profile, so "planned-for" is exactly now), the stale
        recommendation/dedup/edge-trigger/cooldown state clears (a NEW
        plan's first recommendation must not be suppressed by the OLD
        plan's emission window), and — when the rebuild swapped
        allocators — the OOM-risk check re-wires to the new deployment's
        caches."""
        self.plan = dict(plan)
        self._reset_reference(reference)
        if kv_allocator is not None:
            self.kv_allocator = kv_allocator
        self.recommendation = None
        self._last_candidate_key = None
        self._last_emit_check = None
        self._mem_pressure_active = False

    # ------------------------------------------------------------------
    def _hist(self, name: str) -> Dict:
        snap = self.telemetry.metrics.histogram(name).snapshot() \
            if self.telemetry.enabled else {}
        return snap or {}

    def check(self) -> Dict:
        """One health evaluation: latency vs prediction, latency vs SLO,
        live workload vs reference.  Host-side only."""
        cfg = self.config
        tel = self.telemetry
        self.checks += 1
        plan_key = self.plan.get("plan_key", "?")
        report: Dict = {"plan": plan_key, "checks": self.checks,
                        "reasons": []}
        reasons = report["reasons"]

        ttft = self._hist("ttft_s")
        tpot = self._hist("tpot_s")
        enough = (tpot.get("count") or 0) >= cfg.min_requests

        # 1. predicted-vs-measured TPOT (the plan's own fidelity)
        pred_tpot_s = (self.plan.get("tpot_ms") or 0.0) / 1e3
        meas_tpot_s = tpot.get("p50")
        report["tpot_predicted_ms"] = round(pred_tpot_s * 1e3, 4)
        report["tpot_measured_p50_ms"] = (
            round(meas_tpot_s * 1e3, 4) if meas_tpot_s is not None else None)
        if enough and pred_tpot_s > 0 and meas_tpot_s is not None:
            err = (meas_tpot_s - pred_tpot_s) / pred_tpot_s
            report["tpot_error_frac"] = round(err, 4)
            if tel.enabled:
                tel.metrics.gauge("plan_tpot_error_frac").set(err)
            if abs(err) > cfg.max_tpot_error_frac:
                reasons.append("prediction_error")

        # 2. SLO targets on the live p95s
        if enough and cfg.slo_ttft_p95_s is not None \
                and ttft.get("p95") is not None \
                and ttft["p95"] > cfg.slo_ttft_p95_s:
            report["ttft_p95_s"] = round(ttft["p95"], 6)
            reasons.append("slo_ttft")
        if enough and cfg.slo_tpot_p95_s is not None \
                and tpot.get("p95") is not None \
                and tpot["p95"] > cfg.slo_tpot_p95_s:
            report["tpot_p95_s"] = round(tpot["p95"], 6)
            reasons.append("slo_tpot")

        # 2b. PER-CLASS SLO targets (serve/slo.py): each class's own
        # p95s vs the class's targets.  Routing is class-aware — a
        # latency-critical breach recommends replan; a degradable
        # (batch) breach escalates the brownout ladder first and only
        # recommends replan once the ladder is maxed out (degradation
        # has nothing left to give).
        if self.slo is not None:
            from ..serve.slo import MAX_LEVEL

            escalated = []
            for name, cls in sorted(self.slo.classes.items()):
                breaches = []
                for metric, target in (("ttft_s", cls.ttft_p95_s),
                                       ("tpot_s", cls.tpot_p95_s)):
                    if target is None:
                        continue
                    snap = self._hist(f"{metric}_cls_{name}")
                    if (snap.get("count") or 0) < cfg.min_requests:
                        continue
                    p95 = snap.get("p95")
                    if p95 is not None and p95 > target:
                        breaches.append(metric)
                        report[f"{metric}_cls_{name}_p95_s"] = round(p95, 6)
                if not breaches:
                    continue
                bo = self.brownout
                if (cls.degradable and bo is not None
                        and bo.level < MAX_LEVEL):
                    bo.note_slo_breach(name)
                    escalated.append(name)
                else:
                    for metric in breaches:
                        reasons.append(f"slo_class_{metric}:{name}")
            if escalated:
                report["brownout_escalated"] = escalated

        # 3. workload drift vs the planned-for reference
        drift = self.detector.check(
            tel.workload if tel.enabled else {"dims": {}},
            telemetry=tel)
        report["drift"] = drift
        if drift["drifted"]:
            reasons.append("workload_drift")

        # 4. OOM risk (the byte-side check): project the live KV forward
        # by the workload profile's mean output length per live request
        # and compare against the allocator's REAL byte capacity — the
        # one arithmetic admission and preemption already share.  Errs
        # high by design (full mean output per request, not the
        # remainder); a breach rides the same replan machinery as the
        # time-side checks, and the edge-triggered ``memory_pressure``
        # instant carries the projection so the report can show how close
        # the deployment came.
        kvs = self.kv_allocator
        kvs = (list(kvs) if isinstance(kvs, (list, tuple))
               else [kvs] if kvs is not None else [])
        per_toks = [kv.bytes_per_token() for kv in kvs]
        if kvs and all(per_toks):
            # one buffer walk per allocator per check; each deployment's
            # cache prices at its OWN bytes/token (target and draft
            # differ), composed by summing bytes
            cap_b = sum(kv.capacity_tokens * p
                        for kv, p in zip(kvs, per_toks))
            live_tok = sum(kv.live_tokens() for kv in kvs)
            live_b = sum(kv.live_tokens() * p
                         for kv, p in zip(kvs, per_toks))
            mean_out = (tel.workload.features().get("mean_output_len", 0.0)
                        if tel.enabled else 0.0)
            # every live request grows EVERY cache it holds by the
            # expected remaining output
            n_live = max((kv.live_requests() for kv in kvs), default=0)
            projected = live_b + sum(n_live * mean_out * p
                                     for p in per_toks)
            proj_frac = projected / cap_b if cap_b else 0.0
            report["memory"] = {
                "live_tokens": live_tok,
                "live_bytes": round(live_b, 1),
                "projected_bytes": round(projected, 1),
                "capacity_bytes": round(cap_b, 1),
                "projected_frac": round(proj_frac, 4),
            }
            # host-tier occupancy view (serve/kv_paged.py HostPageTier):
            # spilled pages waiting off-device are recoverable state the
            # projection above doesn't count (restores re-enter via the
            # page pool's own admission) — surfaced so the report shows
            # how much of the deployment's KV is parked in host DRAM
            tiers = [kv.host_tier for kv in kvs
                     if getattr(kv, "host_tier", None) is not None]
            if tiers:
                report["memory"]["host_tier"] = {
                    "bytes": sum(t.bytes_used for t in tiers),
                    "capacity_bytes": sum(t.capacity_bytes for t in tiers),
                    "pages": sum(t.pages_held() for t in tiers),
                    "spilled_requests": sum(len(t._spills) for t in tiers),
                    "evictions": sum(t.evictions for t in tiers),
                }
            if tel.enabled:
                tel.metrics.gauge("kv_projected_frac").set(proj_frac)
            if cap_b and proj_frac > cfg.memory_pressure_frac:
                reasons.append("memory_pressure")
                if tel.enabled and not self._mem_pressure_active:
                    tel.instant(
                        "memory_pressure", cat="plan", track="plan_health",
                        projected_bytes=round(projected, 1),
                        capacity_bytes=round(cap_b, 1),
                        live_tokens=live_tok,
                        headroom_bytes=round(cap_b - live_b, 1))
                    tel.metrics.counter("memory_pressure_events").inc()
                self._mem_pressure_active = True
            else:
                self._mem_pressure_active = False
        else:
            # a skipped memory check (caches freed/unallocated) must not
            # carry a stale edge-trigger into the next allocated epoch —
            # a fresh excursion there is a NEW event
            self._mem_pressure_active = False

        report["healthy"] = not reasons
        if tel.enabled:
            tel.metrics.gauge("plan_health_ok").set(0.0 if reasons else 1.0)

        # 5. unhealthy -> re-search on the live profile (recommendation
        # only; the candidate must actually differ to be worth emitting)
        if reasons and self.search_fn is not None:
            try:
                candidate = self.search_fn()
            except Exception as e:  # a failed re-search must not kill serving
                report["replan_error"] = f"{type(e).__name__}: {e}"[:120]
                candidate = None
            if candidate is not None:
                cand_key = candidate.get("plan_key", "?")
                report["candidate"] = {
                    "plan_key": cand_key,
                    "tpot_ms": candidate.get("tpot_ms"),
                    "ttft_ms": candidate.get("ttft_ms"),
                }
                if cand_key != plan_key:
                    # flap guard (``replan_cooldown_ticks``): a NEW
                    # candidate inside the cooldown window after the last
                    # emission is suppressed entirely — no instant, no
                    # ``recommendation`` update — so an oscillating
                    # candidate pair cannot whipsaw a downstream
                    # MigrationController (re-recommending the SAME
                    # candidate stays allowed: it refreshes the payload
                    # without emitting, the historical dedup)
                    cooling = (cfg.replan_cooldown_ticks > 0
                               and self._last_emit_check is not None
                               and self.checks - self._last_emit_check
                               < cfg.replan_cooldown_ticks
                               and cand_key != self._last_candidate_key)
                    if cooling:
                        report["replan_suppressed"] = True
                    else:
                        self.recommendation = {
                            "incumbent": plan_key, "candidate": cand_key,
                            "reasons": list(reasons),
                            "candidate_tpot_ms": candidate.get("tpot_ms"),
                            "drift_score": drift["score"],
                            # the full plan dict, so a MigrationController
                            # can rebuild without re-running the search
                            "candidate_plan": dict(candidate),
                        }
                        report["replan_recommended"] = True
                        if cand_key != self._last_candidate_key:
                            self._last_emit_check = self.checks
                            if tel.enabled:
                                tel.instant(
                                    "replan_recommended", cat="plan",
                                    track="plan_health",
                                    incumbent=plan_key, candidate=cand_key,
                                    reasons=",".join(reasons),
                                    candidate_tpot_ms=candidate.get(
                                        "tpot_ms"),
                                    drift_score=drift["score"])
                                tel.metrics.counter(
                                    "replans_recommended").inc()
                        self._last_candidate_key = cand_key
                else:
                    report["incumbent_reaffirmed"] = True
        if not reasons:
            # condition cleared: a future excursion may re-emit
            self._last_candidate_key = None
        self.last_report = report
        return report


def health_score(report: Optional[Dict]) -> float:
    """Routing penalty derived from a health report (None/healthy = 0.0;
    +1 per breached check reason).  The fleet router
    (``serve/fleet.py``) adds it to a replica's least-load score so a
    replica whose attached monitor reports SLO misses, drift, or memory
    pressure attracts fewer new dispatches — host-side arithmetic only,
    no effect without an attached monitor."""
    if not report:
        return 0.0
    return float(len(report.get("reasons", ()) or ()))
