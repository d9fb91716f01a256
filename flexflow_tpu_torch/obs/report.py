"""Reductions over telemetry artifacts: JSONL summaries + serving records.

A copy of the JAX package's ``flexflow_tpu/obs/report.py`` (host-side
Python only), its imports re-pointed at this package, which never
imports the JAX one.  Mentions of jitted programs below describe
the reference; here the same holds for the eager CUDA launches.

Two consumers share this module:

* ``scripts/trace_report.py`` — CLI over :func:`summarize_jsonl`: p50/p95
  TTFT/TPOT/queue-wait derived from the request-lifecycle events a
  ``Telemetry`` export carries, per-track span totals (the pp stage
  interleave), the pipeline bubble fraction, and the per-plan
  predicted-vs-measured error table.
* ``bench.py`` — :func:`under_load_summary` is the ``serving_under_load``
  section's record reduction (moved here from bench so the bench, the
  hermetic tests, and the report CLI all run the SAME accounting).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from .metrics import percentile

# request-lifecycle event names (the Telemetry.request_* schema)
_ENQ = "request_enqueue"
_ADMIT = "request_admit"
_PREFILL = "request_prefill_start"
_FIRST = "request_first_token"
_FINISH = "request_finish"
# resilient-serving lifecycle (terminal outcomes + dispatch events)
_TERMINAL_EVENTS = {
    "request_reject": "rejected",
    "request_cancel": "cancelled",
    "request_timeout": "timeout",
    "request_fail": "failed",
}
_PREEMPT = "request_preempt"
_RETRY = "dispatch_retry"
_FAULT = "dispatch_fault"
# paged-KV prefix sharing (serve/kv_paged.py)
_PREFIX_HIT = "prefix_hit"
_PREFIX_MISS = "prefix_miss"
# speculative production mode (serve/spec_infer.py): runtime mode flips
_SPEC_MODE = "spec_mode_changed"
# observe->calibrate->re-plan loop events (obs/drift.py, obs/plan_health.py)
_DRIFT = "drift_detected"
_REPLAN = "replan_recommended"
# memory observability (obs/memory.py): the OOM-risk breach instant
_MEMPRESS = "memory_pressure"
# live plan migration (serve/migration.py): the controller acting on
# replan_recommended — start / completion / rollback of a plan switch
_MIG_EVENTS = ("migration_started", "migration_completed",
               "migration_rolled_back")
# fault-tolerant fleet serving (serve/fleet.py): replica health-state
# transitions + per-request failover onto a survivor
_FLEET_EVENTS = ("replica_up", "replica_degraded", "replica_quarantined",
                 "replica_dead")
_FAILOVER = "request_failed_over"
# SLO-class lanes + brownout (serve/slo.py): ladder transitions and
# explicit lane sheds
_BROWNOUT = "brownout_level_changed"
_LANE_SHED = "lane_shed"
# time-travel serving (obs/replay.py).  replay_mismatch carries a
# trace_id, so these MUST be intercepted before the per-request
# trace_id branch — a mismatch instant is about a replay, not a new
# request, and must not inflate the request count.
_REPLAY_EVENTS = ("trace_recorded", "replay_started", "replay_completed",
                  "replay_mismatch")
# host-tier KV spill/restore (serve/kv_paged.py HostPageTier).  All three
# carry a trace_id, so — like replay_mismatch — they MUST be intercepted
# before the per-request trace_id branch: a spill instant is about an
# already-tracked request's pages, and must not inflate the request count.
_TIER_EVENTS = ("kv_spill", "kv_restore", "kv_restore_failed")


def _pct_ms(xs: List[float], q: float) -> Optional[float]:
    v = percentile(sorted(xs), q)
    return None if v is None else round(v * 1e3, 2)


def summarize_events(events: Sequence[Dict]) -> Dict:
    """Per-request latency distributions from lifecycle events (ts in
    microseconds, trace_event form) + per-track span time.

    ``span_ms_by_track`` sums complete-span durations per track, so it is
    only a wall-time total where spans on one track don't nest/overlap —
    the instrumentation keeps serve-loop, dispatch, pp-macro, and stage
    spans on separate tracks for exactly this reason.
    """
    reqs: Dict[str, Dict] = {}
    track_spans: Dict[int, float] = {}
    track_names: Dict[int, str] = {}
    outcomes: Dict[str, int] = {}
    preemptions = retries = faults = 0
    prefix_hits = prefix_misses = 0
    spec_mode_changes: List[Dict] = []
    drift_events: List[Dict] = []
    replans: List[Dict] = []
    mem_pressure: List[Dict] = []
    migrations: Dict[str, List[Dict]] = {n: [] for n in _MIG_EVENTS}
    fleet_events: Dict[str, List[Dict]] = {n: [] for n in _FLEET_EVENTS}
    failovers: List[Dict] = []
    brownout_changes: List[Dict] = []
    lane_sheds: List[Dict] = []
    replay_events: Dict[str, List[Dict]] = {n: [] for n in _REPLAY_EVENTS}
    tier_events: Dict[str, List[Dict]] = {n: [] for n in _TIER_EVENTS}
    for ev in events:
        ph = ev.get("ph")
        if ph == "M" and ev.get("name") == "thread_name":
            track_names[ev.get("tid")] = ev.get("args", {}).get("name")
            continue
        if ph == "X":
            tid = ev.get("tid")
            track_spans[tid] = track_spans.get(tid, 0.0) \
                + ev.get("dur", 0.0) / 1e6
            continue
        name = ev.get("name")
        if name == _RETRY:
            retries += 1
            continue
        if name == _FAULT:
            faults += 1
            continue
        if name == _PREFIX_HIT:
            prefix_hits += 1
            continue
        if name == _PREFIX_MISS:
            prefix_misses += 1
            continue
        if name == _SPEC_MODE:
            spec_mode_changes.append(ev.get("args", {}))
            continue
        if name == _DRIFT:
            drift_events.append(ev.get("args", {}))
            continue
        if name == _REPLAN:
            replans.append(ev.get("args", {}))
            continue
        if name == _MEMPRESS:
            mem_pressure.append(ev.get("args", {}))
            continue
        if name in migrations:
            migrations[name].append(ev.get("args", {}))
            continue
        if name in fleet_events:
            fleet_events[name].append(ev.get("args", {}))
            continue
        if name == _FAILOVER:
            failovers.append(ev.get("args", {}))
            continue
        if name == _BROWNOUT:
            brownout_changes.append(ev.get("args", {}))
            continue
        if name == _LANE_SHED:
            lane_sheds.append(ev.get("args", {}))
            continue
        if name in replay_events:
            replay_events[name].append(ev.get("args", {}))
            continue
        if name in tier_events:
            tier_events[name].append(ev.get("args", {}))
            continue
        args = ev.get("args", {})
        trace_id = args.get("trace_id")
        if trace_id is None:
            continue
        rec = reqs.setdefault(trace_id, {})
        if name in (_ENQ, _ADMIT, _PREFILL, _FIRST, _FINISH):
            rec[name] = ev.get("ts", 0.0) / 1e6  # -> seconds
            if name == _FINISH:
                rec["n_tokens"] = args.get("n_tokens", 0)
        elif name in _TERMINAL_EVENTS:
            out = _TERMINAL_EVENTS[name]
            rec["outcome"] = out
            outcomes[out] = outcomes.get(out, 0) + 1
        elif name == _PREEMPT:
            preemptions += 1

    ttft, tpot, queue_wait, prefill = [], [], [], []
    completed = 0
    for rec in reqs.values():
        enq = rec.get(_ENQ)
        first = rec.get(_FIRST)
        fin = rec.get(_FINISH)
        if fin is not None:
            outcomes["ok"] = outcomes.get("ok", 0) + 1
        if enq is not None and first is not None:
            ttft.append(first - enq)
            # queue wait ends where prefill begins (fall back to admission
            # when no prefill-start stamp was emitted)
            start = rec.get(_PREFILL, rec.get(_ADMIT))
            if start is not None:
                queue_wait.append(start - enq)
                prefill.append(first - start)
        if fin is not None:
            completed += 1
            if first is not None:
                tpot.append((fin - first) / max(rec.get("n_tokens", 1) - 1, 1))

    spans_by_track = {
        track_names.get(tid, f"track{tid}"): round(total * 1e3, 3)
        for tid, total in sorted(track_spans.items())
    }
    return {
        "requests": len(reqs),
        "completed": completed,
        "ttft_p50_ms": _pct_ms(ttft, 0.50),
        "ttft_p95_ms": _pct_ms(ttft, 0.95),
        "queue_wait_p50_ms": _pct_ms(queue_wait, 0.50),
        "queue_wait_p95_ms": _pct_ms(queue_wait, 0.95),
        "prefill_p50_ms": _pct_ms(prefill, 0.50),
        "tpot_p50_ms": _pct_ms(tpot, 0.50),
        "tpot_p95_ms": _pct_ms(tpot, 0.95),
        "span_ms_by_track": spans_by_track,
        # resilient serving: terminal-outcome mix + recovery activity
        "outcomes": outcomes,
        "preemptions": preemptions,
        "dispatch_retries": retries,
        "dispatch_faults": faults,
        # paged-KV prefix sharing: binds that reused registered pages
        "prefix_hits": prefix_hits,
        "prefix_misses": prefix_misses,
        # speculative production mode: runtime spec on/off flips
        "spec_mode_changes": spec_mode_changes,
        # plan feedback loop: drift excursions + replan recommendations
        "drift_detected": drift_events,
        "replan_recommended": replans,
        # memory observability: OOM-risk breach instants (obs/plan_health.py)
        "memory_pressure": mem_pressure,
        # live plan migration: started/completed/rolled_back event args
        "migrations": {
            "started": migrations["migration_started"],
            "completed": migrations["migration_completed"],
            "rolled_back": migrations["migration_rolled_back"],
        },
        # fault-tolerant fleet serving: replica health transitions +
        # per-request failovers (serve/fleet.py)
        "fleet": {
            "replica_events": {n.replace("replica_", ""): fleet_events[n]
                               for n in _FLEET_EVENTS},
            "failed_over": failovers,
        },
        # SLO-class lanes + brownout (serve/slo.py): degradation-ladder
        # transitions and explicit lane sheds
        "slo": {
            "brownout_changes": brownout_changes,
            "lane_shed": lane_sheds,
        },
        # time-travel serving (obs/replay.py): trace artifacts saved,
        # replay runs, and per-request fidelity violations
        "replay": {
            "recorded": replay_events["trace_recorded"],
            "started": replay_events["replay_started"],
            "completed": replay_events["replay_completed"],
            "mismatches": replay_events["replay_mismatch"],
        },
        # host-tier KV spill/restore (serve/kv_paged.py): per-request
        # swap instants + restore-degraded-to-recompute fallbacks
        "tier": {
            "spills": tier_events["kv_spill"],
            "restores": tier_events["kv_restore"],
            "restore_failures": tier_events["kv_restore_failed"],
        },
    }


def summarize_jsonl(path: str) -> Dict:
    """Summarize a ``Telemetry.export`` JSONL: lifecycle distributions,
    bubble fraction, events/dropped, and per-plan prediction error."""
    events: List[Dict] = []
    meta: Dict = {}
    metrics: Dict = {}
    calibration: Dict = {}
    memory: Dict = {}
    workload: Dict = {}
    store: Dict = {}
    profile: Dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            kind = doc.get("kind")
            if kind == "event":
                events.append(doc)
            elif kind == "telemetry_meta":
                meta = doc
            elif kind == "metrics":
                metrics = doc.get("snapshot", {})
            elif kind == "calibration":
                calibration = doc.get("report", {})
            elif kind == "memory":
                memory = doc.get("report", {})
            elif kind == "workload":
                workload = doc.get("snapshot", {})
            elif kind == "calibration_store":
                store = doc
            elif kind == "profile":
                profile = doc.get("report", {})

    summary = summarize_events(events)
    summary["events"] = meta.get("events", len(events))
    summary["dropped"] = meta.get("dropped", 0)
    summary["bubble_frac"] = metrics.get("pp_bubble_frac")
    # plan feedback loop: live drift score (gauge = last value), the
    # workload window the handle accumulated, and the persisted scales the
    # next search will auto-apply
    summary["workload_drift_score"] = metrics.get("workload_drift_score")
    summary["workload"] = {
        d: {"n": w.get("n"), "mean": (round(w["mean"], 4)
                                      if w.get("mean") is not None else None)}
        for d, w in sorted(workload.get("dims", {}).items())
        if w.get("n")}
    summary["applied_scales"] = store.get("applied_scales", {})
    # registry view of the resilience counters (the trace ring can drop
    # events under pressure; the counters are exact)
    from .telemetry import MIGRATION_COUNTERS, RESILIENCE_COUNTERS

    summary["robustness"] = {
        k: metrics[k] for k in RESILIENCE_COUNTERS if k in metrics}
    # registry view: migrations_completed/rolled_back are exact cumulative
    # counters (survive trace-ring drops, like the resilience counters);
    # the downtime/preempted entries are GAUGES carrying the LAST
    # migration's values — per-migration history lives in the event lists
    # above, not here
    summary["migrations"]["counters"] = {
        k: metrics[k] for k in MIGRATION_COUNTERS if k in metrics}
    # fleet view: the replica health transitions summarize_events already
    # collected, joined with the exact registry counters/gauges
    # (FLEET_COUNTERS — failovers_total and the replica_* counters are
    # cumulative and survive trace-ring drops; the fleet_replicas_*
    # gauges carry the LAST fleet tick's values)
    from .telemetry import FLEET_COUNTERS

    summary["fleet"]["counters"] = {
        k: metrics[k] for k in FLEET_COUNTERS if k in metrics}
    # SLO-lane view: the events summarize_events collected + the exact
    # registry counters (SLO_COUNTERS — deferral/shed/degrade totals and
    # the ladder's escalation counters; brownout_level is a gauge holding
    # the final level) and the per-class pending-depth gauges
    from .telemetry import SLO_COUNTERS

    summary["slo"]["counters"] = {
        k: metrics[k] for k in SLO_COUNTERS if k in metrics}
    summary["slo"]["lane_depths"] = {
        k: metrics[k] for k in sorted(metrics)
        if k.startswith("lane_pending_depth_")}
    # time-travel serving view: the replay events summarize_events
    # collected + the exact registry counters (REPLAY_COUNTERS —
    # replay_mismatches joins bench_compare's exact class at threshold
    # zero: any mismatch means determinism regressed)
    from .telemetry import REPLAY_COUNTERS

    summary["replay"]["counters"] = {
        k: metrics[k] for k in REPLAY_COUNTERS if k in metrics}
    # host-tier view: the swap events summarize_events collected + the
    # exact registry counters (TIER_COUNTERS — kv_restore_failures joins
    # bench_compare's exact class at threshold zero: a clean-path restore
    # must never degrade to recompute)
    from .telemetry import TIER_COUNTERS

    summary["tier"]["counters"] = {
        k: metrics[k] for k in TIER_COUNTERS if k in metrics}
    # trace-drop hardening: surface the ring buffer's dropped-event
    # count under the exact-class regression counter name, so every
    # bench section that embeds a summary carries it into bench_compare
    # (a section silently losing telemetry events fails CI, not just a
    # stderr warning in trace_report)
    summary["telemetry_events_dropped"] = summary["dropped"]

    pred_err: Dict[str, Dict] = {}
    for plan, fields in calibration.get("plans", {}).items():
        row = {f: {"predicted": e.get("predicted"),
                   "measured": e.get("measured"),
                   "error_frac": e.get("error_frac")}
               for f, e in fields.items()}
        pred_err[plan] = row
    summary["prediction_error"] = pred_err
    summary["calibration_components"] = calibration.get("components", {})
    summary["memory"] = memory_section(memory, metrics)
    summary["memory"]["pressure_events"] = summary.pop("memory_pressure")
    # step-level cost attribution (obs/profiler.py): the phase time
    # budget + deterministic work counters + the per-component
    # predicted-vs-executed decomposition — None when no profiler was
    # bound to the exporting handle
    summary["time_budget"] = (time_budget_section(profile, calibration)
                              if profile else None)
    return summary


def time_budget_section(profile: Dict, calibration: Dict) -> Dict:
    """The time-budget view: a StepProfiler report (phases + work
    counters) joined with the calibration ledger's per-component
    ``*_ms`` decomposition (attention / mlp / lm_head / kv_stream /
    comms / hop / host_overhead — the vocabulary
    ``obs.profiler.TIME_COMPONENT_FIELDS`` and
    ``search.serve_search.pp_serve_cost`` share), so the report shows
    WHICH component a whole-plan prediction error lives in."""
    from .profiler import TIME_COMPONENT_FIELDS

    comp_fields = set(TIME_COMPONENT_FIELDS)
    per_plan: Dict[str, Dict] = {}
    for plan, fields in calibration.get("plans", {}).items():
        rows = {f: {"predicted": e.get("predicted"),
                    "measured": e.get("measured"),
                    "error_frac": e.get("error_frac")}
                for f, e in fields.items() if f in comp_fields}
        if rows:
            per_plan[plan] = rows
    scales = {f: c for f, c in calibration.get("components", {}).items()
              if f in comp_fields}
    return {
        "ticks": profile.get("ticks"),
        "phases": profile.get("phases", {}),
        "work": profile.get("work", {}),
        "components": per_plan,
        "component_scales": scales,
    }


def memory_section(memory: Dict, metrics: Dict) -> Dict:
    """The byte-side summary: live watermarks + occupancy distribution +
    the current gauge values + the per-component predicted-vs-allocated
    error table (the memory ledger's analog of ``prediction_error``).

    ``memory`` is a :meth:`~flexflow_tpu_torch.obs.memory.MemoryLedger.report`
    dict (the ``{"kind": "memory"}`` JSONL line); ``metrics`` a registry
    snapshot — the gauge/histogram names come from ``MEMORY_GAUGES`` /
    ``KV_OCCUPANCY_HIST`` so the emitter and this reduction share one
    vocabulary.  Shared by ``bench.py --dry-run``'s ``memory_ledger``
    section and the trace-report CLI (one accounting, two consumers).
    """
    from .memory import (HOST_TIER_GAUGES, KV_OCCUPANCY_HIST, MEMORY_GAUGES,
                         PAGED_GAUGES)

    occ = metrics.get(KV_OCCUPANCY_HIST) or {}
    section: Dict = {
        "live": memory.get("live", {}),
        "occupancy_p50": occ.get("p50"),
        "occupancy_p95": occ.get("p95"),
        "gauges": {g: metrics[g] for g in MEMORY_GAUGES if g in metrics},
        "request_kv_bytes": metrics.get("request_kv_bytes"),
    }
    # paged-KV view (serve/kv_paged.py): page-pool gauges + the prefix
    # cache's hit/reuse counters — present only when a paged allocator
    # published them
    paged = {g: metrics[g] for g in PAGED_GAUGES if g in metrics}
    if paged:
        section["paged"] = paged
        section["prefix_cache"] = {
            k: metrics[k] for k in ("prefix_hits", "prefix_misses",
                                    "prefix_tokens_reused")
            if k in metrics}
    # host-tier view (serve/kv_paged.py HostPageTier): host-DRAM
    # occupancy gauges — present only when a tier was attached
    host = {g: metrics[g] for g in HOST_TIER_GAUGES if g in metrics}
    if host:
        section["host_tier"] = host
    alloc_err: Dict[str, Dict] = {}
    for plan, fields in memory.get("plans", {}).items():
        alloc_err[plan] = {
            f: {"predicted": e.get("predicted"),
                "allocated": e.get("measured"),
                "error_frac": e.get("error_frac")}
            for f, e in fields.items()}
    section["allocation_error"] = alloc_err
    # the per-component suggested_scale table that feeds MachineModel
    # memory-constant calibration (same geometry as the time components)
    section["components"] = memory.get("components", {})
    return section


# JSONL line kinds Telemetry.export writes -> fields each must carry
_REQUIRED_BY_KIND = {
    "telemetry_meta": ("version", "ts_unit", "events", "dropped"),
    "event": (),                      # per-phase rules below
    "metrics": ("snapshot",),
    "calibration": ("report",),
    "memory": ("report",),
    "workload": ("snapshot",),
    "profile": ("report",),
    "calibration_store": ("components", "applied_scales"),
}


def validate_jsonl(path: str) -> List[str]:
    """Validate a ``Telemetry.export`` JSONL against the event schema.

    Returns the list of violations (empty = valid).  The contract checked
    is exactly what :func:`summarize_jsonl` consumes: known line kinds
    with their required fields, well-formed trace events per phase, and —
    for the typed ``request``/``dispatch``/``plan`` categories — names and
    required args from ``telemetry.EVENT_SCHEMA``, the single vocabulary
    the emitters share.  ``bench.py --dry-run``'s export is validated by a
    tier-1 test, so the bench-side emitters and this parser cannot drift
    apart silently (``scripts/trace_report.py --check`` is the CLI).

    Free-form spans/counters on other categories are NOT constrained —
    instrumentation may add tracks freely; only the typed vocabulary is
    load-bearing for the report.
    """
    from .telemetry import EVENT_SCHEMA

    errors: List[str] = []
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError as e:
        return [f"unreadable: {e}"]
    if not lines:
        return ["empty file"]

    def err(i, msg):
        if len(errors) < 100:  # bounded output on pathological files
            errors.append(f"line {i}: {msg}")

    saw_meta = False
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except ValueError as e:
            err(i, f"not JSON: {e}")
            continue
        kind = doc.get("kind")
        if kind not in _REQUIRED_BY_KIND:
            err(i, f"unknown kind {kind!r}")
            continue
        missing = [k for k in _REQUIRED_BY_KIND[kind] if k not in doc]
        if missing:
            err(i, f"{kind} missing fields {missing}")
        if kind == "telemetry_meta":
            saw_meta = True
            continue
        if kind != "event":
            continue
        # trace-event phase rules
        ph = doc.get("ph")
        base_missing = [k for k in ("name", "ph", "pid", "tid")
                        if k not in doc]
        if base_missing:
            err(i, f"event missing fields {base_missing}")
            continue
        if ph not in ("M", "X", "i", "C"):
            err(i, f"unknown event phase {ph!r}")
            continue
        if ph == "M":
            if doc.get("name") != "thread_name" \
                    or "name" not in doc.get("args", {}):
                err(i, "metadata event must be thread_name with args.name")
            continue
        if "ts" not in doc:
            err(i, f"{ph!r} event missing ts")
        if ph == "X" and "dur" not in doc:
            err(i, "complete span missing dur")
        if ph == "C" and "value" not in doc.get("args", {}):
            err(i, "counter event missing args.value")
        # typed vocabulary: the categories the report parses semantically
        cat = doc.get("cat")
        if ph == "i" and cat in ("request", "dispatch", "plan", "profile",
                                 "fleet", "slo", "replay", "tier"):
            name = doc["name"]
            schema = EVENT_SCHEMA.get(name)
            if schema is None:
                err(i, f"unknown {cat} event {name!r}")
                continue
            want_cat, want_args = schema
            if cat != want_cat:
                err(i, f"{name} has cat {cat!r}, schema says {want_cat!r}")
            args = doc.get("args", {})
            missing = [a for a in want_args if a not in args]
            if missing:
                err(i, f"{name} missing args {missing}")
    if not saw_meta:
        errors.insert(0, "no telemetry_meta line")
    return errors


def under_load_summary(records: Dict, makespan_s: Optional[float] = None,
                       per_replica: bool = True,
                       per_class: bool = True) -> Dict:
    """Reduce ``RequestManager.serve_with_arrivals`` records to the
    ``serving_under_load`` fields: TTFT distribution (split into queue wait
    vs prefill where the records carry the split), per-request TPOT
    p50/p95, goodput.  Pure host-side math — the hermetic small-shape test
    (tests/test_serving_under_load.py) runs it on a virtual clock.

    Multi-worker records (``FleetRouter.serve_with_arrivals`` stamps the
    serving replica into each record's ``replica`` field, plus
    per-request ``failovers``) additionally get a ``per_replica``
    breakdown — the same reduction per serving replica, sharing the
    fleet-wide makespan so per-replica goodputs SUM to the fleet
    aggregate — and a total ``failovers`` count.

    SLO-lane records (``slo_class`` stamped when an
    :class:`~flexflow_tpu_torch.serve.slo.SLOPolicy` was attached) get the
    same-shaped ``per_class`` breakdown — per-class goodput / TTFT /
    TPOT p50/p95 / outcome mix on the shared makespan, the view the
    per-class SLO attainment claims are checked against — plus a
    ``deferred_requests`` count (requests that spent at least one
    brownout window queue-held)."""
    recs = list(records.values())
    outcomes: Dict[str, int] = {}
    for r in recs:
        out = r.get("outcome", "ok")
        outcomes[out] = outcomes.get(out, 0) + 1
    # "completed" = ok finishes only; cancelled/timed-out/rejected/failed
    # requests are terminal but not completions
    done = [r for r in recs
            if "finish_s" in r and r.get("outcome", "ok") == "ok"]
    ttft = [r["first_token_s"] - r["arrival_s"]
            for r in recs if "first_token_s" in r]
    tpot = [(r["finish_s"] - r["first_token_s"])
            / max(len(r["tokens"]) - 1, 1)
            for r in done if "first_token_s" in r]
    queue_wait = [r["queue_wait_s"] for r in recs if "queue_wait_s" in r]
    prefill = [r["prefill_s"] for r in recs if "prefill_s" in r]

    makespan = makespan_s
    if makespan is None and done:
        makespan = (max(r["finish_s"] for r in done)
                    - min(r["arrival_s"] for r in recs))
    total_tokens = sum(len(r["tokens"]) for r in done)
    # deterministic work counters (obs/profiler.py): records carry a
    # per-request "work" dict when a StepProfiler was attached — the
    # totals give bench_compare device-free regression fields
    work_recs = [r["work"] for r in recs if isinstance(r.get("work"), dict)]
    work = None
    if work_recs:
        from .profiler import REQUEST_WORK_COUNTERS

        work = {k: sum(w.get(k, 0) for w in work_recs)
                for k in REQUEST_WORK_COUNTERS}
    # fleet breakdown: group by the serving replica (rejected-before-
    # placement records group under ""), reduce each group with the SAME
    # accounting and the fleet-wide makespan
    replica_summary = None
    failover_total = None
    if per_replica and any("replica" in r for r in recs):
        groups: Dict[str, Dict] = {}
        for rid, r in records.items():
            groups.setdefault(r.get("replica", ""), {})[rid] = r
        replica_summary = {
            name: under_load_summary(group, makespan_s=makespan,
                                     per_replica=False, per_class=False)
            for name, group in sorted(groups.items())}
        failover_total = sum(r.get("failovers", 0) for r in recs)
    # SLO-lane breakdown: group by the stamped class (records without a
    # class — no policy attached when they registered — group under "")
    class_summary = None
    deferred_total = None
    if per_class and any("slo_class" in r for r in recs):
        cgroups: Dict[str, Dict] = {}
        for rid, r in records.items():
            cgroups.setdefault(r.get("slo_class", ""), {})[rid] = r
        class_summary = {
            name: under_load_summary(group, makespan_s=makespan,
                                     per_replica=False, per_class=False)
            for name, group in sorted(cgroups.items())}
        deferred_total = sum(1 for r in recs
                             if r.get("deferred_ticks", 0) > 0)
    return {
        "requests": len(recs),
        "completed": len(done),
        "ttft_p50_ms": _pct_ms(ttft, 0.50),
        "ttft_p95_ms": _pct_ms(ttft, 0.95),
        "ttft_max_ms": _pct_ms(ttft, 1.0),
        "queue_wait_p50_ms": _pct_ms(queue_wait, 0.50),
        "queue_wait_p95_ms": _pct_ms(queue_wait, 0.95),
        "prefill_p50_ms": _pct_ms(prefill, 0.50),
        "tpot_p50_ms": _pct_ms(tpot, 0.50),
        "tpot_p95_ms": _pct_ms(tpot, 0.95),
        "goodput_tokens_per_sec": (round(total_tokens / makespan, 1)
                                   if makespan else None),
        "outcomes": outcomes,
        **({"work": work} if work is not None else {}),
        **({"per_replica": replica_summary}
           if replica_summary is not None else {}),
        **({"failovers": failover_total}
           if failover_total is not None else {}),
        **({"per_class": class_summary}
           if class_summary is not None else {}),
        **({"deferred_requests": deferred_total}
           if deferred_total is not None else {}),
    }
