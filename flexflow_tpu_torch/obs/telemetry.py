"""The single ``Telemetry`` handle the serving stack is instrumented behind.

A copy of the JAX package's ``flexflow_tpu/obs/telemetry.py`` (host-side
Python only), its imports re-pointed at this package, which never
imports the JAX one.  Mentions of jitted programs below describe
the reference; here the same holds for the eager CUDA launches.

One handle bundles the three observability primitives:

* ``trace`` — a :class:`~flexflow_tpu_torch.obs.trace.TraceRecorder` (request
  lifecycle, batch composition, scan quanta, per-stage pipeline dispatch);
* ``metrics`` — a :class:`~flexflow_tpu_torch.obs.metrics.MetricsRegistry`
  (TTFT/TPOT/queue-wait histograms, occupancy/KV-utilization gauges,
  token/hop counters, pp bubble fraction);
* ``calibration`` — a :class:`~flexflow_tpu_torch.obs.calibration.CalibrationLedger`
  (predicted-vs-measured cost accounting per executed plan).

``RequestManager(im, gen, telemetry=Telemetry())`` shares the handle with
the InferenceManager (and, for pipeline serving, every stage dispatch) —
one handle, one clock, one export.

**Serving lifecycle schema.**  The ``request_*`` methods are the canonical
event vocabulary: ``RequestManager`` emits through them, ``bench.py
--dry-run`` synthesizes through them, and ``scripts/trace_report.py``
parses exactly their names/args — adding a lifecycle event means adding a
method here, so the three cannot drift apart.

**Disabled = no-op, guaranteed.**  ``NULL_TELEMETRY`` (a
:class:`NullTelemetry`) answers every instrumentation call with a constant
no-op; ``enabled`` is False so hot paths can skip even argument
construction.  Telemetry is host-side only — nothing here is ever traced
into a jitted program — so serve outputs are bit-identical with telemetry
on or off (pinned by tests/test_obs.py).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

from .calibration import CalibrationLedger
from .drift import WorkloadProfile
from .memory import KV_OCCUPANCY_HIST, MEMORY_GAUGE_KEYS, MemoryLedger
from .metrics import MetricsRegistry
from .trace import TraceRecorder

# the resilience counter vocabulary (emitted by the request_rejected/
# cancelled/timed_out/preempted/failed + dispatch_retry/fault_observed
# methods below) — report.summarize_jsonl and bench's dry-run section both
# import THIS tuple, so a renamed counter cannot silently drop from either
RESILIENCE_COUNTERS = (
    "requests_rejected", "requests_cancelled", "requests_timeout",
    "requests_preempted", "requests_failed", "recompute_tokens",
    "dispatch_retries", "dispatch_faults",
)

# the typed-instant event schema: name -> (category, required arg keys).
# Telemetry's methods emit exactly these; report.summarize_jsonl parses
# them; scripts/trace_report.py --check validates exported JSONLs against
# THIS table — adding a lifecycle/plan event means adding a row here, so
# the three cannot drift apart (bench and
# trace_report schemas can never diverge silently).
EVENT_SCHEMA = {
    "request_enqueue": ("request", ("trace_id",)),
    "request_admit": ("request", ("trace_id",)),
    "request_prefill_start": ("request", ("trace_id",)),
    "request_first_token": ("request", ("trace_id",)),
    "request_finish": ("request", ("trace_id", "n_tokens")),
    "request_reject": ("request", ("trace_id",)),
    "request_cancel": ("request", ("trace_id",)),
    "request_timeout": ("request", ("trace_id",)),
    "request_preempt": ("request", ("trace_id",)),
    "request_fail": ("request", ("trace_id",)),
    "dispatch_retry": ("dispatch", ("site", "attempt")),
    "dispatch_fault": ("dispatch", ("site",)),
    # the observe->calibrate->re-plan loop (obs/drift.py, obs/plan_health.py)
    "drift_detected": ("plan", ("score",)),
    "replan_recommended": ("plan", ("incumbent", "candidate")),
    # memory observability (obs/memory.py, serve/kv_allocator.py): the
    # OOM-risk breach PlanHealthMonitor emits when projected KV growth
    # from the live workload profile eats the allocator's headroom
    "memory_pressure": ("plan", ("projected_bytes", "capacity_bytes")),
    # paged KV prefix sharing (serve/kv_paged.py): did a request's bind
    # reuse registered prefix pages (skipping that much prefill) or not
    "prefix_hit": ("request", ("trace_id",)),
    "prefix_miss": ("request", ("trace_id",)),
    # speculative serving as a production mode (serve/spec_infer.py): a
    # request's speculation mode flipped at runtime (``set_spec_mode``) —
    # ``args.spec`` carries the new mode
    "spec_mode_changed": ("request", ("trace_id", "spec")),
    # live plan migration (serve/migration.py): the MigrationController
    # acting on ``replan_recommended`` (or an operator request) —
    # started at the drain boundary; completed carries the preempted
    # count + admission-closed downtime; rolled_back names the failed
    # phase and the incumbent every request readmitted on
    "migration_started": ("plan", ("incumbent", "candidate")),
    "migration_completed": ("plan", ("incumbent", "candidate")),
    "migration_rolled_back": ("plan", ("incumbent", "candidate")),
    # step-level cost attribution (obs/profiler.py): one per serve tick,
    # emitted by StepProfiler.tick_end when a Telemetry handle is bound —
    # args carry the tick index plus the tick's deterministic work-counter
    # deltas (flops, kv_bytes_touched, dispatches, ...)
    "step_profile": ("profile", ("tick",)),
    # fault-tolerant fleet serving (serve/fleet.py): the per-replica
    # health state machine's transitions (HEALTHY -> DEGRADED ->
    # QUARANTINED -> DEAD, plus readmission back to HEALTHY after a
    # successful quarantine re-probe) and the failover of one request off
    # a failed replica onto a survivor (original rid preserved — the
    # recompute is bit-identical by the sample-fold contract)
    "replica_up": ("fleet", ("replica",)),
    "replica_degraded": ("fleet", ("replica",)),
    "replica_quarantined": ("fleet", ("replica",)),
    "replica_dead": ("fleet", ("replica",)),
    "request_failed_over": ("request", ("trace_id", "from_replica",
                                        "to_replica")),
    # SLO-class lanes + brownout (serve/slo.py): the BrownoutController
    # walked the degradation ladder one level (args carry both endpoints
    # + the pressure reason), and one degradable-class request was shed
    # by the ladder (explicit REJECTED — never FAILED)
    "brownout_level_changed": ("slo", ("level", "from_level")),
    "lane_shed": ("slo", ("slo_class",)),
    # time-travel serving (obs/replay.py): a traffic-trace artifact
    # landed on disk (trace_recorded), a ReplayHarness run started /
    # finished (mode carries fidelity|what_if), and one per-request
    # fidelity violation (replay_mismatch names the request and the
    # field — tokens/outcome/failovers — that diverged from the
    # recording; a bit-identical replay emits ZERO of these)
    "trace_recorded": ("replay", ("arrivals",)),
    "replay_started": ("replay", ("mode",)),
    "replay_completed": ("replay", ("mode",)),
    "replay_mismatch": ("replay", ("trace_id", "field")),
    # host-tier KV spill/restore (serve/kv_paged.py HostPageTier): one
    # request's mapped pages moved off device (kv_spill — preemption /
    # page-pressure / brownout SPILL), moved back at readmission
    # (kv_restore — tokens_resumed is the write frontier the decode
    # resumes at, tokens_saved the prefill recompute avoided), or a
    # restore degraded to the recompute feed (kv_restore_failed —
    # checksum corruption or swap-in retry exhaustion; never corruption)
    "kv_spill": ("tier", ("trace_id", "pages", "nbytes", "tokens")),
    "kv_restore": ("tier", ("trace_id", "pages", "nbytes",
                            "tokens_resumed", "tokens_saved")),
    "kv_restore_failed": ("tier", ("trace_id", "reason")),
}

# migration counter/gauge vocabulary (report.py folds these into the
# ``migrations`` summary section; the dry-run section and trace_report
# share THIS tuple so a renamed metric cannot silently drop from either).
# The first two are exact cumulative counters; the downtime/preempted
# entries are gauges holding the LAST migration's values — per-migration
# numbers ride the migration_completed event args
MIGRATION_COUNTERS = (
    "migrations_completed", "migrations_rolled_back",
    "migration_downtime_ticks", "migration_preempted_requests",
)

# fleet counter/gauge vocabulary (serve/fleet.py; report.py folds these
# into the ``fleet`` summary section — one tuple shared by the emitters,
# the report, and the bench dry-run so a renamed metric cannot silently
# drop from any of them).  The ``replica_*``/``failovers_total`` entries
# are exact cumulative counters; ``fleet_replicas_healthy`` /
# ``fleet_replicas_alive`` / ``fleet_queue_depth`` are gauges the router
# publishes every fleet tick.
FLEET_COUNTERS = (
    "failovers_total", "replica_ups", "replica_degradations",
    "replica_quarantines", "replica_deaths",
    "fleet_replicas_healthy", "fleet_replicas_alive",
    "fleet_replicas_total", "fleet_queue_depth",
)

# the monotone bad-if-increasing subset scripts/bench_compare.py treats
# like deterministic WORK_COUNTERS (exact compare, any increase between
# two runs of the same workload is a regression — more replicas failing
# per served token); the health gauges stay out (a gauge's direction is
# not monotone-bad, so exact-compare semantics would invert)
FLEET_REGRESSION_COUNTERS = (
    "failovers_total", "replica_degradations", "replica_quarantines",
    "replica_deaths",
)

# SLO-lane / brownout counter vocabulary (serve/slo.py; report.py folds
# these into the ``slo`` summary section — one tuple shared by the
# emitters, the report, and the bench dry-run).  All are exact cumulative
# counters except ``brownout_level``, a gauge holding the ladder's
# current level.
SLO_COUNTERS = (
    "lane_deferred_total", "lane_shed_total", "lane_degraded_total",
    "brownout_escalations", "brownout_deescalations", "brownout_level",
)

# the monotone bad-if-increasing subset that joins bench_compare's exact
# class (deterministic on the seeded virtual clock): more shed /
# deferred requests or more ladder escalations for the same workload
# means the lanes got less graceful.  De-escalations and the level gauge
# stay out (non-monotone direction).
SLO_REGRESSION_COUNTERS = (
    "lane_shed_total", "lane_deferred_total", "lane_degraded_total",
    "brownout_escalations",
)

# Host-tick elimination ratios (on-device continuous batching,
# serve/request_manager.py chained decode stretches).  Raw ``dispatches``
# and ``host_syncs`` are already exact-class via WORK_COUNTERS; these are
# the DERIVED per-unit ratios the ``host_tick`` bench section emits —
# deterministic on the virtual clock and monotone bad-if-increasing
# (more dispatches per token or host syncs per stretch means the host
# tick crept back in), so bench_compare compares them exactly too.
# ``stretch_joins`` (mid-stretch slot joins) is reported but stays out
# of the regression class — its direction depends on the arrival mix.
HOST_TICK_REGRESSION_COUNTERS = (
    "dispatches_per_token", "host_syncs_per_stretch",
)

# Trace-replay counter vocabulary (obs/replay.py; report.py folds these
# into the ``replay`` summary section — one tuple shared by the
# emitters, the report, and the bench ``trace_replay`` dry-run).  All
# exact cumulative counters.
REPLAY_COUNTERS = (
    "traces_recorded", "replays_run", "replay_mismatches",
)

# the monotone bad-if-increasing subset joining bench_compare's exact
# class: ANY replay mismatch means a recorded run stopped replaying
# bit-identically — the strongest determinism regression signal the
# repo has, so the threshold is exactly zero.
REPLAY_REGRESSION_COUNTERS = (
    "replay_mismatches",
)

# Trace-drop hardening: the TraceRecorder ring buffer's dropped-event
# count was only a stderr WARNING in trace_report; as an exact-class
# counter, a bench section that silently starts losing telemetry events
# (capacity regression, emit storm) fails bench_compare instead.
# report.py stamps it into every summary from the telemetry_meta line.
TRACE_REGRESSION_COUNTERS = (
    "telemetry_events_dropped",
)

# Host-tier KV spill/restore counter vocabulary (serve/kv_paged.py;
# report.py folds these into the ``tier`` summary section — one tuple
# shared by the emitters, the report, and the bench ``kv_tiering``
# dry-run).  All exact cumulative counters on the seeded virtual clock.
TIER_COUNTERS = (
    "kv_pages_spilled", "kv_pages_restored", "kv_swap_bytes",
    "kv_restore_failures", "recompute_tokens_saved",
)

# the monotone bad-if-increasing subset joining bench_compare's exact
# class: a restore failure means a checksum-verified swap-in degraded to
# recompute — correct but strictly worse, so the clean-path threshold is
# exactly zero (kv_spilled/kv_restored materialize it at 0 so a healthy
# baseline exports the field and the guard arms).  The volume counters
# stay out: more spills for the same workload can mean better brownout
# behavior, not worse — direction is not monotone.
TIER_REGRESSION_COUNTERS = (
    "kv_restore_failures",
)


class Telemetry:
    enabled = True

    def __init__(self, capacity: int = 65536,
                 clock: Optional[Callable[[], float]] = None,
                 workload_window: int = 512):
        self._clock = clock or time.perf_counter
        self.trace = TraceRecorder(capacity=capacity, clock=self._clock)
        self.metrics = MetricsRegistry()
        self.calibration = CalibrationLedger()
        # windowed traffic-mix characterization, fed by the request_* /
        # batch_composition / spec_acceptance calls below — the live side
        # of drift detection (obs/drift.py).  It reuses the trace events'
        # timestamps, so enabling it costs no extra clock reads.
        self.workload = WorkloadProfile(window=workload_window)
        # the byte-side ledger (obs/memory.py): predicted-vs-allocated HBM
        # per plan component + live watermarks — the analog of
        # ``calibration`` for memory.  Fed by the managers' publish_memory
        # and the KVAllocator's per-tick kv_usage observations.
        self.memory = MemoryLedger()
        # optional persisted CalibrationStore: attach one to have export()
        # write its applied scales alongside the ledger report
        self.store = None
        # optional StepProfiler (obs/profiler.py), bound via
        # StepProfiler.bind(telemetry): export() then writes the phase
        # time budget + deterministic work counters as a "profile" line
        self.profiler = None

    # ---- primitive delegation -----------------------------------------
    def now(self) -> float:
        return self._clock()

    def span(self, name, cat="serve", track="serve", **args):
        return self.trace.span(name, cat, track, **args)

    def instant(self, name, cat="serve", track="serve", **args):
        return self.trace.instant(name, cat, track, **args)

    def counter(self, name, value, track="counters"):
        """Counter-series trace event ("C" phase) only — registry metrics
        are updated explicitly by callers (a name like ``decode_tokens``
        may be a registry Counter; auto-registering a Gauge here would
        type-clash it)."""
        self.trace.counter(name, value, track)

    # ---- serving lifecycle (see module docstring) ---------------------
    def request_enqueued(self, trace_id: str, prompt_len: int = 0) -> float:
        self.metrics.counter("requests_enqueued").inc()
        ts = self.trace.instant("request_enqueue", "request", "requests",
                                trace_id=trace_id, prompt_len=prompt_len)
        self.workload.observe_enqueue(prompt_len, ts=ts)
        return ts

    def request_admitted(self, trace_id: str,
                         queue_wait_s: Optional[float] = None) -> float:
        self.metrics.counter("requests_admitted").inc()
        if queue_wait_s is not None:
            self.metrics.histogram("queue_wait_s").observe(queue_wait_s)
        return self.trace.instant("request_admit", "request", "requests",
                                  trace_id=trace_id,
                                  queue_wait_s=queue_wait_s)

    def request_prefill_started(self, trace_id: str) -> float:
        return self.trace.instant("request_prefill_start", "request",
                                  "requests", trace_id=trace_id)

    def request_first_token(self, trace_id: str,
                            ttft_s: Optional[float] = None,
                            slo_class: Optional[str] = None) -> float:
        if ttft_s is not None:
            self.metrics.histogram("ttft_s").observe(ttft_s)
            if slo_class:
                # per-class attainment: the brownout controller and the
                # plan-health per-class checks read these windows
                self.metrics.histogram(
                    f"ttft_s_cls_{slo_class}").observe(ttft_s)
        return self.trace.instant("request_first_token", "request",
                                  "requests", trace_id=trace_id,
                                  ttft_s=ttft_s)

    def request_finished(self, trace_id: str, n_tokens: int,
                         tpot_s: Optional[float] = None,
                         kv_bytes: Optional[float] = None,
                         slo_class: Optional[str] = None) -> float:
        """``kv_bytes``: the KVAllocator's per-request attribution (peak
        cache bytes the request held) — the byte-side cost of serving it."""
        self.metrics.counter("requests_finished").inc()
        self.metrics.counter("tokens_generated").inc(n_tokens)
        if tpot_s is not None:
            self.metrics.histogram("tpot_s").observe(tpot_s)
            if slo_class:
                self.metrics.histogram(
                    f"tpot_s_cls_{slo_class}").observe(tpot_s)
        if kv_bytes is not None:
            self.metrics.histogram("request_kv_bytes").observe(kv_bytes)
        self.workload.observe_finish(n_tokens)
        return self.trace.instant("request_finish", "request", "requests",
                                  trace_id=trace_id, n_tokens=n_tokens,
                                  tpot_s=tpot_s, kv_bytes=kv_bytes)

    # ---- resilient serving (serve/resilience.py) ----------------------
    def request_rejected(self, trace_id: str, reason: str = "") -> float:
        """Admission control refused the request (bounded queue / KV
        headroom / invalid shape) — an explicit terminal outcome."""
        self.metrics.counter("requests_rejected").inc()
        return self.trace.instant("request_reject", "request", "requests",
                                  trace_id=trace_id, reason=reason)

    def request_cancelled(self, trace_id: str, n_tokens: int = 0) -> float:
        self.metrics.counter("requests_cancelled").inc()
        return self.trace.instant("request_cancel", "request", "requests",
                                  trace_id=trace_id, n_tokens=n_tokens)

    def request_timed_out(self, trace_id: str, n_tokens: int = 0) -> float:
        self.metrics.counter("requests_timeout").inc()
        return self.trace.instant("request_timeout", "request", "requests",
                                  trace_id=trace_id, n_tokens=n_tokens)

    def request_preempted(self, trace_id: str,
                          recompute_tokens: int = 0) -> float:
        """Slot/KV-pressure eviction; ``recompute_tokens`` is the
        prompt+generated length the readmission will re-prefill."""
        self.metrics.counter("requests_preempted").inc()
        self.metrics.counter("recompute_tokens").inc(recompute_tokens)
        return self.trace.instant("request_preempt", "request", "requests",
                                  trace_id=trace_id,
                                  recompute_tokens=recompute_tokens)

    def request_failed(self, trace_id: str, site: str = "") -> float:
        self.metrics.counter("requests_failed").inc()
        return self.trace.instant("request_fail", "request", "requests",
                                  trace_id=trace_id, site=site)

    def dispatch_retry(self, site: str, attempt: int = 1,
                       backoff_s: float = 0.0) -> float:
        self.metrics.counter("dispatch_retries").inc()
        return self.trace.instant("dispatch_retry", "dispatch", "dispatch",
                                  site=site, attempt=attempt,
                                  backoff_s=backoff_s)

    def fault_observed(self, site: str, detail: str = "") -> float:
        """A transient dispatch/hop fault was caught (injected or real)."""
        self.metrics.counter("dispatch_faults").inc()
        return self.trace.instant("dispatch_fault", "dispatch", "dispatch",
                                  site=site, detail=detail)

    # ---- paged KV prefix sharing (serve/kv_paged.py) ------------------
    def prefix_cache_hit(self, trace_id: str, tokens_reused: int = 0,
                         pages: int = 0) -> float:
        """A bind reused ``tokens_reused`` positions of registered prefix
        pages — that much prefill is skipped (TTFT collapses to the
        unshared suffix)."""
        self.metrics.counter("prefix_hits").inc()
        self.metrics.counter("prefix_tokens_reused").inc(tokens_reused)
        self.workload.observe_prefix(True)
        return self.trace.instant("prefix_hit", "request", "requests",
                                  trace_id=trace_id,
                                  tokens_reused=tokens_reused, pages=pages)

    def prefix_cache_miss(self, trace_id: str) -> float:
        self.metrics.counter("prefix_misses").inc()
        self.workload.observe_prefix(False)
        return self.trace.instant("prefix_miss", "request", "requests",
                                  trace_id=trace_id)

    def batch_composition(self, decode_tokens: int, prefill_tokens: int,
                          active_requests: int, max_requests: int,
                          kv_tokens: int, kv_capacity: int) -> None:
        """Per-step batch mix: token split, slot occupancy, KV utilization."""
        m = self.metrics
        m.counter("decode_tokens").inc(decode_tokens)
        m.counter("prefill_tokens").inc(prefill_tokens)
        occ = active_requests / max_requests if max_requests else 0.0
        util = kv_tokens / kv_capacity if kv_capacity else 0.0
        m.gauge("batch_slot_occupancy").set(occ)
        m.gauge("kv_cache_utilization").set(util)
        self.workload.observe_occupancy(occ)
        self.trace.counter("batch_slot_occupancy", occ)
        self.trace.counter("kv_cache_utilization", util)

    def spec_mode_changed(self, trace_id: str, spec: bool) -> float:
        """A request's speculation mode flipped at runtime
        (``RequestManager.set_spec_mode``): spec rows draft+verify
        multi-token per macro step, plain rows decode one token — in the
        SAME mixed batch under a SpecInferManager."""
        self.metrics.counter("spec_mode_changes").inc()
        return self.trace.instant("spec_mode_changed", "request", "requests",
                                  trace_id=trace_id, spec=bool(spec))

    # ---- live plan migration (serve/migration.py) ---------------------
    def migration_started(self, incumbent: str, candidate: str,
                          reasons: str = "") -> float:
        """A live plan switch began: admission is closed and the drain is
        about to preempt the in-flight requests onto the recompute path."""
        return self.trace.instant("migration_started", "plan", "migration",
                                  incumbent=incumbent, candidate=candidate,
                                  reasons=reasons)

    def migration_completed(self, incumbent: str, candidate: str,
                            mode: str = "rebuild",
                            preempted_requests: int = 0,
                            downtime_ticks: int = 0,
                            downtime_s: Optional[float] = None) -> float:
        """The candidate plan is serving: ``preempted_requests`` rode the
        recompute path across the switch, ``downtime_ticks`` serve ticks
        ran with admission closed (the drain grace window), and
        ``mode="spec_flip"`` marks the rebuild-free fast path."""
        m = self.metrics
        m.counter("migrations_completed").inc()
        m.gauge("migration_downtime_ticks").set(downtime_ticks)
        m.gauge("migration_preempted_requests").set(preempted_requests)
        return self.trace.instant(
            "migration_completed", "plan", "migration",
            incumbent=incumbent, candidate=candidate, mode=mode,
            preempted_requests=preempted_requests,
            downtime_ticks=downtime_ticks, downtime_s=downtime_s)

    def migration_rolled_back(self, incumbent: str, candidate: str,
                              phase: str = "", reason: str = "") -> float:
        """The switch failed in ``phase`` (drain/rebuild/readmit):
        admission reopened on the incumbent and every drained request
        readmitted there — zero lost requests by contract."""
        self.metrics.counter("migrations_rolled_back").inc()
        return self.trace.instant(
            "migration_rolled_back", "plan", "migration",
            incumbent=incumbent, candidate=candidate, phase=phase,
            reason=reason)

    # ---- fault-tolerant fleet serving (serve/fleet.py) -----------------
    def replica_up(self, replica: str, reason: str = "") -> float:
        """A replica joined (or re-joined, after a successful quarantine
        re-probe) the dispatch rotation in the HEALTHY state."""
        self.metrics.counter("replica_ups").inc()
        return self.trace.instant("replica_up", "fleet", "fleet",
                                  replica=replica, reason=reason)

    def replica_degraded(self, replica: str, reason: str = "") -> float:
        """Dispatch failures pushed a replica to DEGRADED: it keeps
        serving its in-flight requests but new dispatches avoid it."""
        self.metrics.counter("replica_degradations").inc()
        return self.trace.instant("replica_degraded", "fleet", "fleet",
                                  replica=replica, reason=reason)

    def replica_quarantined(self, replica: str, reason: str = "") -> float:
        """Consecutive failures quarantined a replica: its in-flight
        requests failed over to survivors and it leaves the rotation
        until a re-probe succeeds (or probes exhaust into DEAD)."""
        self.metrics.counter("replica_quarantines").inc()
        return self.trace.instant("replica_quarantined", "fleet", "fleet",
                                  replica=replica, reason=reason)

    def replica_dead(self, replica: str, reason: str = "",
                     failed_over: int = 0) -> float:
        """A replica is terminally dead (quarantine probes exhausted, or
        an operator kill): its KV tore down (refcount no-leak asserted by
        the chaos tests) and ``failed_over`` in-flight requests moved to
        survivors through the recompute path."""
        self.metrics.counter("replica_deaths").inc()
        return self.trace.instant("replica_dead", "fleet", "fleet",
                                  replica=replica, reason=reason,
                                  failed_over=failed_over)

    def request_failed_over(self, trace_id: str, from_replica: str,
                            to_replica: str) -> float:
        """A request left a failed replica and re-dispatched onto a
        survivor with its ORIGINAL rid — the recompute re-prefills
        prompt+generated there, bit-identical for greedy AND seeded
        sampling (the (rid, token_index) fold crosses replicas)."""
        self.metrics.counter("failovers_total").inc()
        return self.trace.instant("request_failed_over", "request",
                                  "requests", trace_id=trace_id,
                                  from_replica=from_replica,
                                  to_replica=to_replica)

    def fleet_health(self, healthy: int, alive: int, total: int,
                     queue_depth: int) -> None:
        """Per-fleet-tick health gauges: HEALTHY replicas, alive
        (HEALTHY + DEGRADED) replicas, the built fleet size, and the
        shared admission queue's depth."""
        m = self.metrics
        m.gauge("fleet_replicas_healthy").set(healthy)
        m.gauge("fleet_replicas_alive").set(alive)
        m.gauge("fleet_replicas_total").set(total)
        m.gauge("fleet_queue_depth").set(queue_depth)
        self.trace.counter("fleet_replicas_healthy", healthy)
        self.trace.counter("fleet_queue_depth", queue_depth)

    # ---- SLO-class lanes + brownout (serve/slo.py) ---------------------
    def brownout_level_changed(self, level: int, from_level: int,
                               level_name: str = "",
                               reason: str = "") -> float:
        """The BrownoutController stepped the degradation ladder one
        level (up on ``escalate_after`` pressured windows, down on
        ``deescalate_after`` clean ones — the hysteresis contract)."""
        m = self.metrics
        if level > from_level:
            m.counter("brownout_escalations").inc()
        else:
            m.counter("brownout_deescalations").inc()
        m.gauge("brownout_level").set(level)
        return self.trace.instant("brownout_level_changed", "slo", "slo",
                                  level=level, from_level=from_level,
                                  level_name=level_name, reason=reason)

    def lane_shed(self, slo_class: str, trace_id: str = "",
                  reason: str = "") -> float:
        """The ladder shed one degradable-class request (queued or — at
        CRITICAL_ONLY — live) as an explicit ``REJECTED``."""
        self.metrics.counter("lane_shed_total").inc()
        return self.trace.instant("lane_shed", "slo", "slo",
                                  slo_class=slo_class, trace_id=trace_id,
                                  reason=reason)

    def lane_deferred(self, slo_class: str, count: int = 1) -> None:
        """``count`` queued requests of a degradable class were held out
        of engine slots this brownout window (DEFER_BATCH semantics)."""
        self.metrics.counter("lane_deferred_total").inc(count)

    def lane_degraded(self, slo_class: str, count: int = 1) -> None:
        """``count`` live requests had speculation flipped off and/or
        their output capped (DEGRADE_BATCH semantics)."""
        self.metrics.counter("lane_degraded_total").inc(count)

    def lane_depths(self, depths: Dict[str, int]) -> None:
        """Per-class pending-queue depth gauges, published each brownout
        evaluation window (``lane_pending_depth_<class>``)."""
        for name, depth in depths.items():
            self.metrics.gauge(f"lane_pending_depth_{name}").set(depth)
            self.trace.counter(f"lane_pending_depth_{name}", depth)

    def trace_recorded(self, arrivals: int, path: str = "",
                       requests: int = 0) -> float:
        """A traffic-trace artifact (obs/replay.py JSONL) landed on
        disk: ``arrivals`` offered requests, ``requests`` finished
        outcome lines."""
        self.metrics.counter("traces_recorded").inc()
        return self.trace.instant("trace_recorded", "replay", "replay",
                                  arrivals=arrivals, path=path,
                                  requests=requests)

    def replay_started(self, mode: str, driver: str = "",
                       arrivals: int = 0) -> float:
        """A ReplayHarness run began re-driving a recorded trace
        (``mode`` is fidelity|what_if)."""
        return self.trace.instant("replay_started", "replay", "replay",
                                  mode=mode, driver=driver,
                                  arrivals=arrivals)

    def replay_completed(self, mode: str, bit_identical=None,
                         mismatches: int = 0) -> float:
        """A ReplayHarness run finished (``bit_identical`` is the
        fidelity verdict; None for what-if runs, which price a DIFFERENT
        plan and have no bit-identity contract)."""
        self.metrics.counter("replays_run").inc()
        # materialize the mismatch counter at 0 even on a clean run: the
        # exact-class guard only fires when the REFERENCE artifact
        # carries the field, so a healthy baseline must export it
        self.metrics.counter("replay_mismatches").inc(0)
        return self.trace.instant("replay_completed", "replay", "replay",
                                  mode=mode, bit_identical=bit_identical,
                                  mismatches=mismatches)

    def replay_mismatch(self, trace_id: str, field: str) -> float:
        """One per-request fidelity violation: ``field`` (tokens /
        outcome / failovers / presence) diverged from the recording.
        Exact-class regression counter — any increase fails
        bench_compare."""
        self.metrics.counter("replay_mismatches").inc()
        return self.trace.instant("replay_mismatch", "replay", "replay",
                                  trace_id=trace_id, field=field)

    # ---- host-tier KV spill/restore (serve/kv_paged.py) ----------------
    def kv_spilled(self, trace_id: str, pages: int = 0, nbytes: int = 0,
                   tokens: int = 0) -> float:
        """One request's mapped KV pages moved to the host tier
        (preemption, page pressure, or the brownout SPILL action)."""
        m = self.metrics
        m.counter("kv_pages_spilled").inc(pages)
        m.counter("kv_swap_bytes").inc(nbytes)
        # materialize the failure counter at 0 on the clean path: the
        # exact-class guard only fires when the reference artifact
        # carries the field, so a healthy baseline must export it
        m.counter("kv_restore_failures").inc(0)
        return self.trace.instant("kv_spill", "tier", "tier",
                                  trace_id=trace_id, pages=pages,
                                  nbytes=nbytes, tokens=tokens)

    def kv_restored(self, trace_id: str, pages: int = 0, nbytes: int = 0,
                    tokens_resumed: int = 0, tokens_saved: int = 0) -> float:
        """A readmitted request's pages came back from the host tier —
        ``tokens_resumed`` is the restored write frontier, ``tokens_saved``
        the prefill recompute the restore avoided."""
        m = self.metrics
        m.counter("kv_pages_restored").inc(pages)
        m.counter("kv_swap_bytes").inc(nbytes)
        m.counter("recompute_tokens_saved").inc(tokens_saved)
        m.counter("kv_restore_failures").inc(0)
        return self.trace.instant("kv_restore", "tier", "tier",
                                  trace_id=trace_id, pages=pages,
                                  nbytes=nbytes,
                                  tokens_resumed=tokens_resumed,
                                  tokens_saved=tokens_saved)

    def kv_restore_failed(self, trace_id: str, reason: str = "") -> float:
        """One restore degraded to the recompute feed (checksum
        corruption or swap-in retry exhaustion).  Exact-class regression
        counter — any increase on a clean-path workload fails
        bench_compare."""
        self.metrics.counter("kv_restore_failures").inc()
        return self.trace.instant("kv_restore_failed", "tier", "tier",
                                  trace_id=trace_id, reason=reason)

    def spec_batch_mix(self, spec_requests: int, plain_requests: int) -> None:
        """One mixed verify macro-step's request composition: how many
        rows shipped a draft tree (multi-token verify) vs a root-only
        tree (single-token decode).  The mixed-batch composition gauge —
        the observable that a heterogeneous mix really shares one step."""
        m = self.metrics
        m.gauge("spec_batch_spec_requests").set(spec_requests)
        m.gauge("spec_batch_plain_requests").set(plain_requests)
        total = spec_requests + plain_requests
        frac = spec_requests / total if total else 0.0
        m.gauge("spec_batch_spec_frac").set(frac)
        m.counter("spec_verify_rounds").inc()
        self.trace.counter("spec_batch_spec_frac", frac)

    def spec_acceptance(self, accepted: int, drafted: int) -> float:
        """One speculative verify round's accept result for a request:
        ``accepted`` of ``drafted`` tree tokens survived the walk.  Feeds
        the acceptance-rate histogram the workload profile tracks (spec
        pricing is acceptance-sensitive) and the cumulative counters.
        Returns the acceptance fraction."""
        frac = accepted / drafted if drafted > 0 else 0.0
        m = self.metrics
        m.counter("spec_tokens_drafted").inc(drafted)
        m.counter("spec_tokens_accepted").inc(accepted)
        m.histogram("spec_acceptance_frac").observe(frac)
        self.workload.observe_spec_acceptance(frac)
        return frac

    # ---- predicted-vs-measured ----------------------------------------
    def record_plan_prediction(self, plan_key: str, **fields) -> None:
        self.calibration.predict(plan_key, **fields)

    def record_plan_measured(self, plan_key: str, **fields) -> None:
        self.calibration.measure(plan_key, **fields)

    # ---- memory observability (obs/memory.py) -------------------------
    def kv_usage(self, snap: Dict) -> None:
        """One KVAllocator occupancy observation (see
        :meth:`~flexflow_tpu_torch.serve.kv_allocator.KVAllocator.observe` for
        the snapshot fields): publishes the live-side gauge vocabulary
        (``MEMORY_GAUGES``), the occupancy histogram/counter series, and
        folds the watermark into the memory ledger."""
        m = self.metrics
        occ = snap.get("occupancy_frac", 0.0)
        for gauge, key in MEMORY_GAUGE_KEYS.items():
            m.gauge(gauge).set(snap.get(key, 0.0))
        if "pages_live" in snap:  # paged allocator: page-pool vocabulary
            from .memory import PAGED_GAUGE_KEYS

            for gauge, key in PAGED_GAUGE_KEYS.items():
                m.gauge(gauge).set(snap.get(key, 0.0))
        if "host_pages" in snap:  # host tier attached: occupancy view
            from .memory import HOST_TIER_GAUGE_KEYS

            for gauge, key in HOST_TIER_GAUGE_KEYS.items():
                m.gauge(gauge).set(snap.get(key, 0.0))
        m.histogram(KV_OCCUPANCY_HIST).observe(occ)
        self.trace.counter("kv_occupancy_frac", occ)
        self.memory.observe_live(snap.get("live_bytes", 0.0),
                                 snap.get("capacity_bytes", 0.0),
                                 snap.get("live_tokens", 0))

    def memory_plan_predicted(self, plan_key: str, **fields) -> None:
        """``plan_memory_parts``' per-component prediction (GB fields)."""
        self.memory.predict(plan_key, **fields)

    def memory_plan_allocated(self, plan_key: str, **fields) -> None:
        """The deployment's REAL allocation, same components/units."""
        self.memory.allocated(plan_key, **fields)

    # ---- snapshot / export --------------------------------------------
    def snapshot(self) -> Dict:
        """One JSON-ready dict of everything the handle accumulated."""
        snap = {
            "metrics": self.metrics.snapshot(),
            "calibration": self.calibration.report(),
            "memory": self.memory.report(),
            "workload": self.workload.features(),
            "trace": {"events": self.trace.emitted,
                      "dropped": self.trace.dropped},
        }
        if self.profiler is not None:
            snap["profile"] = self.profiler.report()
        return snap

    def export(self, out_dir: str, prefix: str = "telemetry") -> Dict[str, str]:
        """Write ``<prefix>.trace.json`` (Chrome/Perfetto) and
        ``<prefix>.jsonl`` under ``out_dir``; returns both paths.

        The JSONL is the machine-readable artifact ``scripts/trace_report.py``
        consumes: a meta line, one ``{"kind": "event", ...}`` line per trace
        event (trace_event fields, ts/dur in microseconds), then a metrics
        snapshot line and a calibration report line.
        """
        os.makedirs(out_dir, exist_ok=True)
        trace_path = os.path.join(out_dir, f"{prefix}.trace.json")
        jsonl_path = os.path.join(out_dir, f"{prefix}.jsonl")
        self.trace.export_json(trace_path)
        with open(jsonl_path, "w") as f:
            f.write(json.dumps({
                "kind": "telemetry_meta", "version": 1, "ts_unit": "us",
                "events": self.trace.emitted, "dropped": self.trace.dropped,
            }) + "\n")
            for ev in self.trace.trace_events():
                f.write(json.dumps({"kind": "event", **ev}) + "\n")
            f.write(json.dumps({"kind": "metrics",
                                "snapshot": self.metrics.snapshot()}) + "\n")
            f.write(json.dumps({"kind": "calibration",
                                "report": self.calibration.report()}) + "\n")
            f.write(json.dumps({"kind": "memory",
                                "report": self.memory.report()}) + "\n")
            f.write(json.dumps({"kind": "workload",
                                "snapshot": self.workload.snapshot()}) + "\n")
            if self.profiler is not None:
                f.write(json.dumps({"kind": "profile",
                                    "report": self.profiler.report()})
                        + "\n")
            if self.store is not None:
                f.write(json.dumps({"kind": "calibration_store",
                                    "path": self.store.path,
                                    "components": self.store.as_dict()
                                    ["components"],
                                    "applied_scales": self.store.scales()})
                        + "\n")
        return {"trace_json": trace_path, "jsonl": jsonl_path}


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class NullTelemetry:
    """No-op stand-in: every hook returns a constant; ``enabled`` is False
    so instrumented code can skip argument computation entirely."""

    enabled = False

    def now(self):
        return 0.0

    def span(self, *a, **k):
        return _NULL_SPAN

    def instant(self, *a, **k):
        return 0.0

    def counter(self, *a, **k):
        return None

    def request_enqueued(self, *a, **k):
        return 0.0

    def request_admitted(self, *a, **k):
        return 0.0

    def request_prefill_started(self, *a, **k):
        return 0.0

    def request_first_token(self, *a, **k):
        return 0.0

    def request_finished(self, *a, **k):
        return 0.0

    def request_rejected(self, *a, **k):
        return 0.0

    def request_cancelled(self, *a, **k):
        return 0.0

    def request_timed_out(self, *a, **k):
        return 0.0

    def request_preempted(self, *a, **k):
        return 0.0

    def request_failed(self, *a, **k):
        return 0.0

    def prefix_cache_hit(self, *a, **k):
        return 0.0

    def prefix_cache_miss(self, *a, **k):
        return 0.0

    def dispatch_retry(self, *a, **k):
        return 0.0

    def fault_observed(self, *a, **k):
        return 0.0

    def batch_composition(self, *a, **k):
        return None

    def spec_mode_changed(self, *a, **k):
        return 0.0

    def migration_started(self, *a, **k):
        return 0.0

    def migration_completed(self, *a, **k):
        return 0.0

    def migration_rolled_back(self, *a, **k):
        return 0.0

    def replica_up(self, *a, **k):
        return 0.0

    def replica_degraded(self, *a, **k):
        return 0.0

    def replica_quarantined(self, *a, **k):
        return 0.0

    def replica_dead(self, *a, **k):
        return 0.0

    def request_failed_over(self, *a, **k):
        return 0.0

    def fleet_health(self, *a, **k):
        return None

    def brownout_level_changed(self, *a, **k):
        return 0.0

    def lane_shed(self, *a, **k):
        return 0.0

    def lane_deferred(self, *a, **k):
        return None

    def lane_degraded(self, *a, **k):
        return None

    def lane_depths(self, *a, **k):
        return None

    def trace_recorded(self, *a, **k):
        return 0.0

    def replay_started(self, *a, **k):
        return 0.0

    def replay_completed(self, *a, **k):
        return 0.0

    def replay_mismatch(self, *a, **k):
        return 0.0

    def kv_spilled(self, *a, **k):
        return 0.0

    def kv_restored(self, *a, **k):
        return 0.0

    def kv_restore_failed(self, *a, **k):
        return 0.0

    def spec_batch_mix(self, *a, **k):
        return None

    def spec_acceptance(self, *a, **k):
        return 0.0

    def record_plan_prediction(self, *a, **k):
        return None

    def record_plan_measured(self, *a, **k):
        return None

    def kv_usage(self, *a, **k):
        return None

    def memory_plan_predicted(self, *a, **k):
        return None

    def memory_plan_allocated(self, *a, **k):
        return None

    def snapshot(self):
        return {}

    def export(self, *a, **k):
        return {}


NULL_TELEMETRY = NullTelemetry()


def telemetry_or_null(telemetry) -> "Telemetry":
    """Normalize an optional handle: None -> the shared no-op singleton."""
    return telemetry if telemetry is not None else NULL_TELEMETRY
