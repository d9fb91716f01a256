"""Fault-tolerant serving over several replicas: the :class:`FleetRouter`.

A copy of the JAX package's ``flexflow_tpu/serve/fleet.py`` (host-side
Python only), its imports re-pointed at this package, which never imports
the JAX one.  The router composes the single-deployment pieces into a
fleet:

* **N replica deployments** — each an ordinary manager built through the
  :func:`~.migration.build_deployment` contract live migration's rebuild
  uses, each with its own KV allocator, all sharing ONE
  GenerationConfig, Telemetry handle, ResilienceConfig, FaultInjector,
  clock and StepProfiler (replicas of one model may share its weight
  tensors: the KV lives in each InferenceManager's allocator);
* **a shared admission queue** — requests register with the FLEET (one
  rid space over every replica) and dispatch to the least loaded
  replica: its queue depth + KV occupancy fraction − open slots, plus a
  penalty for DEGRADED health and for an attached PlanHealthMonitor's
  breached checks
  (:func:`~flexflow_tpu_torch.obs.plan_health.health_score`);
* **a health state machine per replica** — ``HEALTHY → DEGRADED →
  QUARANTINED → DEAD``, driven by dispatch faults of the seeded
  :class:`~.resilience.FaultInjector` (sites ``fleet_dispatch:<replica>``
  and ``fleet_health:<replica>``) and by retry exhaustions inside a
  replica's own dispatches (``RequestManager.on_exhausted`` hands them to
  the fleet instead of a terminal ``FAILED``).  A QUARANTINED replica
  re-probes on a period; exhausted probes mark it DEAD (its KV torn down,
  refcount no-leak);
* **failover with bit-identical recompute** — a replica dying mid-decode
  re-dispatches its in-flight requests onto survivors under their
  original rids through preemption's recompute path (re-prefill
  ``prompt + generated``); greedy and seeded streams equal a run without
  the failure, since every sample keys on ``(seed, rid, token index)``;
* **degradation as the fleet shrinks** — admission re-gates against the
  surviving replicas' KV capacity, so shed load ends ``REJECTED``, never
  ``FAILED``;
* **rolling plan migration** — :meth:`FleetRouter.
  request_rolling_migration` drains and rebuilds ONE replica at a time
  through its :class:`~.migration.MigrationController`, so all but one
  replica keep admission open at every tick.

All of it is host orchestration over the managers' own primitives; no
fleet decision reaches a CUDA launch, so the router cannot change what a
replica computes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs.plan_health import health_score
from ..obs.profiler import profiler_or_null
from ..obs.telemetry import telemetry_or_null
from .migration import MigrationConfig, MigrationController, build_deployment
from .request_manager import (
    OUTCOMES,
    TERMINAL_STATUSES,
    GenerationConfig,
    Request,
    RequestManager,
    RequestStatus,
    parse_arrival_options,
)
from .resilience import ResilienceConfig, TransientServeError

# requests currently occupying an engine slot on a replica (the failover
# reclaim's preempt set — same tuple the migration drain uses)
_RUNNING = (RequestStatus.PREFILLING, RequestStatus.DECODING)


class ReplicaState(enum.Enum):
    """The per-replica health state machine.

    ``HEALTHY`` serves and takes new dispatches; ``DEGRADED`` keeps
    serving its in-flight requests but new dispatches avoid it (one
    success readmits it to HEALTHY); ``QUARANTINED`` holds no live
    requests (everything failed over on entry) and re-probes every
    ``FleetConfig.probe_every`` fleet ticks; ``DEAD`` is terminal — KV
    torn down, never probed again."""

    HEALTHY = 0
    DEGRADED = 1
    QUARANTINED = 2
    DEAD = 3


ALIVE_STATES = (ReplicaState.HEALTHY, ReplicaState.DEGRADED)


@dataclasses.dataclass
class FleetConfig:
    """Policy knobs for the fleet router.

    * ``degraded_after`` / ``quarantine_after``: consecutive dispatch
      failures (fleet-site faults or in-replica retry exhaustions)
      before a replica drops to DEGRADED / QUARANTINED.  One successful
      tick resets the streak (and readmits DEGRADED to HEALTHY).
    * ``probe_every``: fleet ticks between a QUARANTINED replica's
      re-probes (the seeded ``fleet_health:<name>`` injector site).
    * ``dead_after_probes``: failed probes before QUARANTINED becomes
      DEAD (KV teardown; terminal).
    * ``degraded_penalty``: least-load score penalty for DEGRADED
      replicas — new work prefers healthy ones but a degraded replica
      still beats an unbounded queue when it is all that remains.
    * ``max_failovers_per_request``: failovers one request may ride
      before it goes terminally FAILED — the bound that keeps a request
      from looping forever across a fleet whose every replica keeps
      failing (the fleet-level analog of ``max_requeues``).
    * ``starvation_bound_ticks``: bounded aging for the dispatch queue's
      stable priority sort — a request queued longer than this many
      fleet ticks becomes OVERDUE and sorts ahead of every priority
      band (FIFO among overdue), so a lower-priority class held behind a
      sustained higher-priority stream is starved only up to this bound
      (pinned by the starvation test).  None disables aging.  A
      brownout DEFER hold is exempt: that is an explicit policy state
      with its own hysteresis-bounded exit, not priority competition.
    """

    degraded_after: int = 1
    quarantine_after: int = 3
    probe_every: int = 4
    dead_after_probes: int = 2
    degraded_penalty: float = 1000.0
    max_failovers_per_request: int = 8
    starvation_bound_ticks: Optional[int] = 256


@dataclasses.dataclass
class Replica:
    """One deployment in the rotation (router bookkeeping only — the
    serving state lives in ``rm``)."""

    name: str
    index: int
    rm: RequestManager
    state: ReplicaState = ReplicaState.HEALTHY
    failures: int = 0         # consecutive dispatch failures/exhaustions
    probe_failures: int = 0   # consecutive failed quarantine re-probes
    next_probe: int = 0       # fleet tick of the next re-probe
    had_exhaustion: bool = False  # set by the on_exhausted hook per tick
    ctrl: Optional[MigrationController] = None
    leaked: Optional[List[int]] = None  # teardown's no-leak check (DEAD)
    dispatched: int = 0       # requests ever placed here


def _allocators(rm: RequestManager) -> List:
    kvs = [getattr(rm.im, "kv", None)]
    ssm = getattr(rm, "ssm", None)
    if ssm is not None:
        kvs.append(getattr(ssm, "kv", None))
    return [kv for kv in kvs if kv is not None]


class FleetRouter:
    """Routes one request stream over N replica deployments.

    ``replicas``: deployments in the :func:`~.migration.build_deployment`
    contract — each a ready :class:`~.request_manager.RequestManager`, a
    single InferenceManager-like object, or an ``(llm_im, ssm_im)`` pair.
    Non-manager deployments are wrapped sharing the fleet's
    gen/telemetry/resilience/injector/clock/profiler, which is what makes
    seeded bit-identity hold across replicas by construction.  For
    bit-identity with a single-replica run, replicas of one model must be
    built with IDENTICAL weights (same init seed / checkpoint).

    The router owns the rid space: :meth:`register` validates and
    admission-gates against the surviving fleet, :meth:`serve_all` /
    :meth:`generate` / :meth:`serve_with_arrivals` drive the replicas
    round-robin (one replica tick each per fleet tick), and
    :meth:`kill_replica` / :meth:`schedule_kill` are the chaos levers
    (an operator's, or a seeded chaos run's).
    """

    def __init__(self, replicas: Sequence, gen: Optional[GenerationConfig]
                 = None, telemetry=None,
                 resilience: Optional[ResilienceConfig] = None,
                 fault_injector=None, clock=None, profiler=None,
                 config: Optional[FleetConfig] = None,
                 names: Optional[Sequence[str]] = None,
                 slo=None, brownout=None):
        import time as _time

        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.gen = gen or GenerationConfig()
        self.telemetry = telemetry_or_null(telemetry)
        self.res = resilience or ResilienceConfig()
        self.injector = fault_injector
        self.clock = clock or _time.perf_counter
        self.profiler = profiler_or_null(profiler)
        self.config = config or FleetConfig()
        # SLO-class lanes + brownout (serve/slo.py): the FLEET owns the
        # policy and the one ladder over the whole fleet.  Replicas get
        # references to both (queue-hold/preemption gates) but the
        # ladder is EVALUATED only here — never double-driven, see the
        # replica loop below.  Attaching a policy without a controller
        # builds one on the fleet's clock/telemetry: configuring lanes
        # opts into graceful degradation.
        self.slo = slo
        if brownout is None and slo is not None:
            from .slo import BrownoutController

            brownout = BrownoutController(slo, telemetry=telemetry,
                                          clock=self.clock)
        self.brownout = brownout
        if brownout is not None and slo is None:
            self.slo = brownout.policy
        # per-class committed-need high-watermarks (same units as the
        # admission budget) — the observable the reservation contract is
        # asserted against ("batch never dipped into the lc reservation")
        self.lane_committed_hwm: Dict[str, float] = {}
        self._enqueue_tick: Dict[int, int] = {}  # rid -> fleet tick queued
        self.replicas: List[Replica] = []
        for i, dep in enumerate(replicas):
            name = names[i] if names else f"replica{i}"
            if isinstance(dep, RequestManager):
                rm = dep
                rm.clock = self.clock
            else:
                rm = build_deployment(
                    dep, self.gen, telemetry=telemetry,
                    resilience=self.res, fault_injector=fault_injector,
                    clock=self.clock,
                    profiler=profiler if self.profiler.enabled else None)
            rm.on_exhausted = self._on_replica_exhausted
            # replica-level bounded aging: the starvation bound applies
            # wherever the priority sort actually queues —
            # the fleet dispatch queue AND each replica's pending queue
            rm.starvation_bound_ticks = self.config.starvation_bound_ticks
            # the lane policy + ladder reach the replica's OWN queue
            # gates (_pop_pending holds, preemption eligibility) so a
            # DEFER really holds replica-pending work too; the ladder is
            # still EVALUATED only by the fleet — RequestManager's
            # _maybe_brownout runs from its own serve loops, which the
            # fleet never drives
            rm.slo = self.slo
            rm.brownout = self.brownout
            self.replicas.append(Replica(name=name, index=i, rm=rm))
            if self.telemetry.enabled:
                self.telemetry.replica_up(name, reason="fleet start")
        # fleet-owned request bookkeeping: ONE rid space over every
        # replica (the (rid, token_index) sample fold crosses replicas,
        # so a failed-over request's stream is bit-identical wherever it
        # lands); ``requests[rid]`` always points at the LIVE object —
        # re-pointed when a placement converts the record class
        self.requests: Dict[int, Request] = {}
        self.queue: List[int] = []       # fleet admission queue (rids)
        self.placement: Dict[int, str] = {}   # rid -> serving replica
        self._next_rid = 0
        self._tstamps: Dict[int, Dict[str, float]] = {}
        self._live: set = set()          # non-terminal rids (O(live) scans)
        self._spec_pref: Dict[int, Optional[bool]] = {}
        self._failover_from: Dict[int, str] = {}   # rid -> failed replica
        self._failover_counts: Dict[int, int] = {}
        self.ticks = 0
        self.history: List[Dict] = []    # fleet-level event log
        self._rolling: Optional[Dict] = None
        self._kills: Dict[str, int] = {}  # name -> fleet tick to kill at

    # ------------------------------------------------------------------
    # replica lookup / health accounting
    # ------------------------------------------------------------------
    def _by_name(self, name: str) -> Replica:
        for rep in self.replicas:
            if rep.name == name:
                return rep
        raise KeyError(f"no replica named {name!r}")

    def _alive(self) -> List[Replica]:
        return [rep for rep in self.replicas if rep.state in ALIVE_STATES]

    def _rep_of(self, rm) -> Optional[Replica]:
        for rep in self.replicas:
            if rep.rm is rm:
                return rep
        return None

    def replicas_serving(self) -> int:
        """Alive replicas with admission OPEN — the rolling-migration
        invariant the tests pin is that this never drops below
        ``len(alive) - 1`` (one replica drains at a time)."""
        return sum(1 for rep in self._alive()
                   if not rep.rm.admission_closed)

    def fleet_snapshot(self) -> Dict:
        """The router's live view (pure read): per-replica state/load +
        fleet aggregates."""
        return {
            "replicas": {
                rep.name: {
                    "state": rep.state.name,
                    "queue_depth": len(rep.rm.pending),
                    "open_slots": sum(1 for s in rep.rm.slots if s is None),
                    "admission_closed": rep.rm.admission_closed,
                    "dispatched": rep.dispatched,
                    "failures": rep.failures,
                } for rep in self.replicas},
            "healthy": sum(1 for r in self.replicas
                           if r.state is ReplicaState.HEALTHY),
            "alive": len(self._alive()),
            "queue_depth": len(self.queue),
            "ticks": self.ticks,
        }

    # ------------------------------------------------------------------
    # registration / shared admission queue
    # ------------------------------------------------------------------
    def _need(self, req: Request) -> int:
        """Worst-case cache positions a request commits — fleet-level
        arithmetic (a spec replica may need more; the per-replica gates
        still apply at its own ``_seq_len_needed``)."""
        return len(req.prompt) + req.max_new_tokens

    def _admission_reason(self, req: Request) -> Optional[str]:
        """The fleet capacity gate: rejection reason, or None to admit.

        Re-derives the budget from the SURVIVING replicas on every call —
        after a fleet shrink the same arrival stream gates against the
        smaller aggregate KV capacity, so shed load ends in an explicit
        ``REJECTED``, never a ``FAILED`` (the graceful-degradation
        contract)."""
        res = self.res
        alive = self._alive()
        if res.max_pending is not None:
            backlog = len(self.queue) + sum(len(rep.rm.pending)
                                            for rep in alive)
            if backlog >= res.max_pending:
                return (f"pending queue full ({backlog} >= "
                        f"{res.max_pending})")
        reason = self._lane_admission_reason(req)
        if reason is not None:
            return reason
        if res.kv_gate:
            cap_tokens = 0
            per_toks = []
            for rep in alive:
                kv = getattr(rep.rm.im, "kv", None)
                cap_tokens += (kv.capacity_tokens if kv is not None
                               else rep.rm.im.max_requests
                               * rep.rm.im.max_seq_len)
                pt = kv.bytes_per_token() if kv is not None else None
                if pt:
                    per_toks.append(pt)
            live = [self.requests[r] for r in self._live
                    if self.requests[r].status not in TERMINAL_STATUSES]
            need = sum(self._need(r) for r in live) + self._need(req)
            if res.kv_budget_bytes is not None:
                if not per_toks:
                    return ("kv_budget_bytes is a byte cap but no "
                            "surviving replica has allocated KV caches")
                # price at the PRICIEST surviving replica's bytes/token —
                # placement is not known at admission time, so the gate
                # errs high (fail-safe, as the managers' capacity gate)
                per_tok = max(per_toks)
                if need * per_tok > res.kv_budget_bytes:
                    return (f"KV headroom: {need * per_tok / 2**20:.2f} "
                            f"MiB committed > "
                            f"{res.kv_budget_bytes / 2**20:.2f} MiB budget")
                budget, price = res.kv_budget_bytes, per_tok
            else:
                if need > res.kv_headroom_frac * cap_tokens:
                    return (f"KV headroom: {need} tokens committed > "
                            f"{res.kv_headroom_frac * cap_tokens:.0f} "
                            f"across {len(alive)} surviving replicas")
                budget, price = res.kv_headroom_frac * cap_tokens, 1.0
            # reserved-lane gate (serve/slo.py): same fleet-aggregate
            # budget and worst-case-need arithmetic — each class's
            # committed charges its own reservation first, only overflow
            # competes for the shared pool, so batch traffic can never
            # consume the latency-critical lane's reservation whatever
            # the arrival order (the hwm tracking in _maybe_brownout is
            # the observable this contract is asserted against)
            reason = self._lane_reservation_reason(req, live, budget,
                                                   price)
            if reason is not None:
                return reason
        return None

    def _lane_reservation_reason(self, req: Request, live, budget: float,
                                 per_tok: float) -> Optional[str]:
        slo = self.slo
        if slo is None or not any(c.kv_reservation_frac
                                  for c in slo.classes.values()):
            return None
        cls = slo.resolve(req.slo_class)
        if cls is None:
            return None
        from .slo import reservation_reason

        by_cls: Dict[str, float] = {}
        for r in live:
            rc = slo.resolve(r.slo_class)
            key = rc.name if rc is not None else r.slo_class
            by_cls[key] = by_cls.get(key, 0.0) + self._need(r) * per_tok
        return reservation_reason(slo, by_cls, cls,
                                  self._need(req) * per_tok, budget)

    def _lane_admission_reason(self, req: Request) -> Optional[str]:
        """Lane-level fleet admission: the brownout ladder's gate for
        degradable classes + the per-class bounded pending queue
        (fleet queue and replica pendings count together — one lane
        spans the fleet)."""
        if self.slo is None:
            return None
        cls = self.slo.resolve(req.slo_class)
        if cls is None:
            return None
        bo = self.brownout
        if bo is not None and not bo.admits(cls.name):
            if self.telemetry.enabled:
                self.telemetry.lane_shed(cls.name, trace_id=req.trace_id,
                                         reason=f"brownout:{bo.level.name}")
            return (f"brownout {bo.level.name}: class {cls.name!r} "
                    "admissions shed")
        if cls.max_pending is not None:
            depth = sum(
                1 for rid in self.queue
                if self.requests[rid].slo_class == cls.name)
            for rep in self._alive():
                depth += sum(1 for rid in rep.rm.pending
                             if rep.rm.requests[rid].slo_class == cls.name)
            if depth >= cls.max_pending:
                return (f"class {cls.name!r} pending queue full "
                        f"({depth} >= {cls.max_pending})")
        return None

    def register(self, prompt_tokens: Sequence[int],
                 max_new_tokens: Optional[int] = None, *,
                 priority: int = 0, ttl_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 reject_invalid: bool = False,
                 reject_reason: Optional[str] = None,
                 spec: Optional[bool] = None,
                 slo_class: Optional[str] = None) -> int:
        """Register a request with the fleet; returns its rid.

        Mirrors :meth:`RequestManager.register_new_request` semantics: a
        shape no SURVIVING replica can hold raises (or, with
        ``reject_invalid`` — the arrival loop's mode — registers a
        terminal ``REJECTED`` record); capacity rejections always take
        the explicit ``REJECTED`` path; ``max_new_tokens=0`` completes
        immediately.  ``spec`` is the request's speculation preference,
        applied when (and only when) it lands on a spec-capable replica.
        ``slo_class`` names the request's lane under an attached
        :class:`~.slo.SLOPolicy` (None/"" = the default class; unknown
        names reject) — the class's priority band, bounded queue, KV
        reservation, and brownout gates apply at the FLEET gate.
        """
        req = Request(
            -1, [int(t) for t in prompt_tokens],
            self.gen.max_new_tokens if max_new_tokens is None
            else int(max_new_tokens))
        band = 0
        if self.slo is not None:
            cls = self.slo.resolve(slo_class)
            if cls is None:
                req.slo_class = str(slo_class)
            else:
                req.slo_class = cls.name
                band = cls.priority_band
        alive = self._alive()
        err = reject_reason
        if err is None:
            if not alive:
                err = "no surviving replica"
            else:
                errs = [rep.rm._validate_request(req) for rep in alive]
                if all(e is not None for e in errs):
                    err = errs[0]
        if err is None and self.slo is not None \
                and self.slo.resolve(slo_class) is None:
            err = f"unknown slo_class {slo_class!r}"
        if err is not None and not reject_invalid:
            raise ValueError(err)
        rid = self._next_rid
        self._next_rid += 1
        req.rid = rid
        req.trace_id = f"r{rid:05d}"
        req.priority = int(priority) + band
        self.requests[rid] = req
        self._spec_pref[rid] = spec
        tel = self.telemetry
        if tel.enabled:
            self._tstamps[rid] = {
                "enqueue": tel.request_enqueued(
                    req.trace_id, prompt_len=len(req.prompt))}
        reason = err if err is not None else self._admission_reason(req)
        if reason is not None:
            self._terminate(req, RequestStatus.REJECTED, reason=reason)
            return rid
        if req.max_new_tokens == 0:
            req.status = RequestStatus.COMPLETED
            req.outcome = "ok"
            if tel.enabled:
                tel.request_finished(req.trace_id, n_tokens=0,
                                     slo_class=req.slo_class or None)
            return rid
        if self.brownout is not None and self.brownout.degrades(
                req.slo_class):
            # DEGRADE_BATCH in force: admitted, but speculation off and
            # the class output cap applied (prefix truncation only).
            # Counted only on real change (exact-compare counter)
            changed = bool(self._spec_pref.get(rid))
            self._spec_pref[rid] = False
            cap = self.brownout.output_cap(req.slo_class)
            if cap is not None and cap < req.max_new_tokens:
                req.max_new_tokens = max(cap, 1)
                changed = True
            if changed and tel.enabled:
                tel.lane_degraded(req.slo_class)
        if deadline_s is not None:
            req.deadline_s = float(deadline_s)
        else:
            ttl = ttl_s if ttl_s is not None else self.res.default_ttl_s
            if ttl is not None:
                req.deadline_s = self.clock() + float(ttl)
        self.queue.append(rid)
        self._live.add(rid)
        self._enqueue_tick[rid] = self.ticks
        return rid

    def cancel(self, rid: int) -> bool:
        """Fleet-wide cancel: reaped at the owning replica's next step
        boundary (or immediately if still fleet-queued).  Returns whether
        the request was live."""
        req = self.requests.get(rid)
        if req is None or req.status in TERMINAL_STATUSES:
            return False
        req.cancel_requested = True
        return True

    def _terminate(self, req: Request, status: RequestStatus,
                   reason: str = "") -> None:
        """Terminal transition for a request the FLEET holds (queued or
        reclaimed — never slotted; slotted requests terminate through
        their replica's own paths)."""
        if req.rid in self.queue:
            self.queue.remove(req.rid)
        self._live.discard(req.rid)
        self._enqueue_tick.pop(req.rid, None)
        req.status = status
        req.outcome = OUTCOMES[status]
        req.prefill_src = None
        tel = self.telemetry
        if status is RequestStatus.REJECTED:
            # shed load must not grow host memory: the
            # retained record is a small fixed-size stub
            req.prompt = []
            if tel.enabled:
                tel.request_rejected(req.trace_id, reason=reason)
        elif tel.enabled:
            n = len(req.generated)
            if status is RequestStatus.CANCELLED:
                tel.request_cancelled(req.trace_id, n_tokens=n)
            elif status is RequestStatus.TIMED_OUT:
                tel.request_timed_out(req.trace_id, n_tokens=n)
            elif status is RequestStatus.FAILED:
                tel.request_failed(req.trace_id, site=reason)

    def _check_lifecycle(self) -> None:
        """Step-boundary reaping for FLEET-QUEUED requests (replica-held
        requests are reaped by their own manager's ``_check_lifecycle``
        each replica tick)."""
        expirable = [self.requests[rid] for rid in self.queue]
        expirable = [r for r in expirable
                     if r.cancel_requested or r.deadline_s is not None]
        if not expirable:
            return
        now = self.clock()
        for req in expirable:
            if req.cancel_requested:
                self._terminate(req, RequestStatus.CANCELLED)
            elif req.deadline_s is not None and now >= req.deadline_s:
                self._terminate(req, RequestStatus.TIMED_OUT)

    def _reap_terminal(self) -> None:
        for rid in list(self._live):
            if self.requests[rid].status in TERMINAL_STATUSES:
                self._live.discard(rid)

    def _swap_clock(self, new_clock):
        """Switch the fleet's deadline clock, re-basing armed deadlines
        of FLEET-QUEUED requests (replica-held ones re-base through
        their own manager's ``_swap_clock``).  Returns the previous
        clock for the symmetric restore."""
        old = self.clock
        if new_clock is old:
            return old
        armed = [self.requests[r] for r in self.queue
                 if self.requests[r].deadline_s is not None]
        if armed:
            old_now, new_now = old(), new_clock()
            for req in armed:
                req.deadline_s = new_now + (req.deadline_s - old_now)
        self.clock = new_clock
        return old

    # ------------------------------------------------------------------
    # least-load dispatch
    # ------------------------------------------------------------------
    def _load(self, rep: Replica) -> float:
        """Telemetry-driven least-load score: replica queue depth + KV
        occupancy fraction − open slots, plus DEGRADED and plan-health
        penalties.  Lower dispatches first; ties break on replica index
        (deterministic routing — the chaos tests replay it)."""
        rm = rep.rm
        open_slots = sum(1 for s in rm.slots if s is None)
        kv = getattr(rm.im, "kv", None)
        occ = 0.0
        if kv is not None and kv.capacity_tokens:
            occ = kv.live_tokens() / kv.capacity_tokens
        score = float(len(rm.pending)) + occ - float(open_slots)
        if rep.state is ReplicaState.DEGRADED:
            score += self.config.degraded_penalty
        mon = getattr(rm, "plan_health", None)
        if mon is not None:
            score += health_score(getattr(mon, "last_report", None))
        return score

    def _place(self, rid: int, rep: Replica) -> None:
        """Transplant a fleet-held request onto a replica, preserving its
        rid, recompute feed, deadline, and telemetry stamps (the
        migration ``_readmit`` pattern — record class converted when the
        replica's manager extends it)."""
        req = self.requests[rid]
        rm = rep.rm
        if type(req) is not rm.request_cls:
            nr = rm.request_cls(req.rid, list(req.prompt),
                                req.max_new_tokens)
            for f in ("trace_id", "priority", "deadline_s",
                      "cancel_requested", "preemptions", "requeues",
                      "kv_bytes", "n_prefed", "status", "slo_class",
                      "deferred_ticks"):
                setattr(nr, f, getattr(req, f))
            nr.generated = list(req.generated)
            nr.prefill_src = (list(req.prefill_src)
                              if req.prefill_src is not None else None)
            req = nr
            self.requests[rid] = nr
        pref = self._spec_pref.get(rid)
        req.spec = (bool(getattr(rm, "default_spec_mode", False))
                    if pref is None else bool(pref)) \
            if hasattr(rm, "ssm") else False
        req.slot = -1
        req.starved_steps = 0
        rm.requests[rid] = req
        rm.pending.append(rid)
        rm._pending_since[rid] = rm.steps
        rm._next_rid = max(rm._next_rid, self._next_rid)
        rm._tstamps[rid] = self._tstamps.setdefault(rid, {})
        self.placement[rid] = rep.name
        self._enqueue_tick.pop(rid, None)
        rep.dispatched += 1
        frm = self._failover_from.pop(rid, None)
        if frm is not None:
            # host-tier KV failover: the reclaim's preempt spilled this
            # request's pages into the FAILED replica's host tier (which
            # survives its KV teardown — host copies stay valid, KV is a
            # pure function of the fed tokens).  Adopt them onto the
            # survivor so readmission restores instead of re-prefilling;
            # a shape-mismatched survivor (adopt_spills signature check)
            # falls back to the recompute feed the reclaim preserved.
            src_rm = self._by_name(frm).rm
            for src_kv, dst_kv in zip(_allocators(src_rm),
                                      _allocators(rm)):
                dst_kv.adopt_spills(src_kv, [rid])
            if self.telemetry.enabled:
                self.telemetry.request_failed_over(req.trace_id, frm,
                                                   rep.name)

    def _dispatch_queue(self) -> None:
        if not self.queue:
            return
        alive = self._alive()
        if not alive:
            if all(rep.state is ReplicaState.DEAD
                   for rep in self.replicas):
                # total fleet loss: every queued request sheds EXPLICITLY
                for rid in list(self.queue):
                    self._terminate(self.requests[rid],
                                    RequestStatus.REJECTED,
                                    reason="no surviving replica")
            # otherwise QUARANTINED replicas may still re-probe and
            # readmit: an already-admitted request waits (its TTL and
            # the bounded probe schedule keep the wait finite) — only
            # the truly terminal all-DEAD fleet sheds it
            return
        # priority order, FIFO within a class (stable sort — the same
        # rule RequestManager._pop_pending applies per replica), with
        # BOUNDED AGING: a request queued past
        # ``config.starvation_bound_ticks`` becomes OVERDUE and sorts
        # ahead of every priority band (FIFO among overdue, by enqueue
        # tick), so a sustained higher-priority stream can starve a
        # lower class only up to the bound
        bound = self.config.starvation_bound_ticks

        def overdue(rid: int) -> bool:
            return (bound is not None
                    and self.ticks - self._enqueue_tick.get(rid, self.ticks)
                    >= bound)

        self.queue.sort(key=lambda rid: (
            (0, self._enqueue_tick.get(rid, 0)) if overdue(rid)
            else (1, -self.requests[rid].priority)))
        takers = [rep for rep in alive if not rep.rm.admission_closed]
        remaining: List[int] = []
        bo = self.brownout
        # snapshot: _terminate mutates self.queue (rejection path), and
        # iterating the live list would silently skip the next entry
        for rid in list(self.queue):
            req = self.requests[rid]
            if bo is not None and bo.holds(req.slo_class):
                # DEFER_BATCH: held in the fleet queue — an explicit
                # policy hold with its own hysteresis-bounded exit
                # (aging does not override it; TTLs still apply).  The
                # hold time is EXEMPT from aging: re-stamp so the held
                # backlog does not come out of a long brownout overdue
                # and jump the latency-critical lane at recovery
                self._enqueue_tick[rid] = self.ticks
                remaining.append(rid)
                continue
            cands = [rep for rep in takers
                     if rep.rm._validate_request(req) is None]
            if not cands:
                # shed only when NO non-dead replica could ever hold it
                # (a quarantined holder may readmit; a draining one
                # reopens) — explicit REJECTED, never FAILED
                if not any(rep.rm._validate_request(req) is None
                           for rep in self.replicas
                           if rep.state is not ReplicaState.DEAD):
                    self._terminate(
                        req, RequestStatus.REJECTED,
                        reason="no surviving replica can hold request")
                else:
                    remaining.append(rid)
                continue
            rep = min(cands, key=lambda p: (self._load(p), p.index))
            self._place(rid, rep)
        self.queue = remaining

    # ------------------------------------------------------------------
    # failover + the health state machine
    # ------------------------------------------------------------------
    def _reclaim(self, rep: Replica, rids: Sequence[int],
                 reason: str) -> List[int]:
        """Pull live requests OFF a replica back into the shared queue
        for failover: running ones preempt (slot + KV release, recompute
        feed built — the preemption path), queued ones just move.  Requests past
        the per-request failover bound go terminally FAILED."""
        rm = rep.rm
        moved: List[int] = []
        for rid in rids:
            req = rm.requests.get(rid)
            if req is None or req.status in TERMINAL_STATUSES:
                continue
            if req.status in _RUNNING:
                rm.preempt(rid)
            if rid in rm.pending:
                rm.pending.remove(rid)
            rm._pending_since.pop(rid, None)
            rm.requests.pop(rid, None)
            rm._tstamps.pop(rid, None)
            self.requests[rid] = req
            self._failover_from[rid] = rep.name
            self._failover_counts[rid] = \
                self._failover_counts.get(rid, 0) + 1
            moved.append(rid)
        kept: List[int] = []
        for rid in moved:
            if (self._failover_counts[rid]
                    > self.config.max_failovers_per_request):
                self._terminate(self.requests[rid], RequestStatus.FAILED,
                                reason=reason)
            else:
                kept.append(rid)
                # the wait clock restarts on failover: aging measures
                # time queued for THIS dispatch
                self._enqueue_tick[rid] = self.ticks
        self.queue.extend(kept)
        return kept

    def _live_rids_on(self, rm: RequestManager) -> List[int]:
        slotted = [r.rid for r in rm._active()
                   if r.status not in TERMINAL_STATUSES]
        return list(rm.pending) + [r for r in slotted
                                   if r not in rm.pending]

    def _failover_all(self, rep: Replica, reason: str) -> List[int]:
        return self._reclaim(rep, self._live_rids_on(rep.rm), reason)

    def _note_failure(self, rep: Replica, site: str) -> None:
        cfg = self.config
        rep.failures += 1
        tel = self.telemetry
        if (rep.state is ReplicaState.HEALTHY
                and rep.failures >= cfg.degraded_after):
            rep.state = ReplicaState.DEGRADED
            if tel.enabled:
                tel.replica_degraded(rep.name, reason=site)
        if (rep.state is ReplicaState.DEGRADED
                and rep.failures >= cfg.quarantine_after):
            self._quarantine(rep, site)

    def _note_success(self, rep: Replica) -> None:
        rep.failures = 0
        if rep.state is ReplicaState.DEGRADED:
            rep.state = ReplicaState.HEALTHY
            if self.telemetry.enabled:
                self.telemetry.replica_up(rep.name, reason="recovered")

    def _quarantine(self, rep: Replica, reason: str) -> None:
        rep.state = ReplicaState.QUARANTINED
        rep.probe_failures = 0
        rep.next_probe = self.ticks + self.config.probe_every
        if self.telemetry.enabled:
            self.telemetry.replica_quarantined(rep.name, reason=reason)
        moved = self._failover_all(rep, reason)
        self.history.append({"event": "replica_quarantined",
                             "replica": rep.name, "reason": reason,
                             "failed_over": len(moved),
                             "tick": self.ticks})

    def _mark_dead(self, rep: Replica, reason: str) -> List[int]:
        """Terminal replica death: fail over whatever still lives there,
        tear down its KV ownership (the refcount no-leak check — after
        the failover every binding released on its slot-leaving path),
        and retire it from the rotation."""
        moved = self._failover_all(rep, reason)
        leaked: List[int] = []
        for kv in _allocators(rep.rm):
            leaked.extend(kv.teardown())
        rep.leaked = sorted(set(leaked))
        rep.state = ReplicaState.DEAD
        rep.rm.admission_closed = True
        rep.rm.pending = []
        # release the dead deployment from the profiler's poll (the
        # migration-commit pattern)
        prof = self.profiler
        if prof.enabled:
            prof.uninstall(rep.rm.im)
            ssm = getattr(rep.rm, "ssm", None)
            if ssm is not None:
                prof.uninstall(ssm)
        if self.telemetry.enabled:
            self.telemetry.replica_dead(rep.name, reason=reason,
                                        failed_over=len(moved))
        self.history.append({"event": "replica_dead", "replica": rep.name,
                             "reason": reason, "failed_over": len(moved),
                             "kv_leaked_rids": rep.leaked,
                             "tick": self.ticks})
        return moved

    def _maybe_probe(self, rep: Replica) -> None:
        """Quarantine re-probe on the seeded ``fleet_health:<name>``
        site: success readmits the replica HEALTHY; ``dead_after_probes``
        consecutive failures retire it DEAD."""
        if self.ticks < rep.next_probe:
            return
        site = f"fleet_health:{rep.name}"
        tel = self.telemetry
        try:
            if self.injector is not None:
                self.injector.maybe_fail(site)
        except TransientServeError as e:
            if tel.enabled:
                tel.fault_observed(site, detail=str(e))
            rep.probe_failures += 1
            if rep.probe_failures >= self.config.dead_after_probes:
                self._mark_dead(rep, "quarantine probes exhausted")
            else:
                rep.next_probe = self.ticks + self.config.probe_every
            return
        rep.state = ReplicaState.HEALTHY
        rep.failures = 0
        rep.probe_failures = 0
        if tel.enabled:
            tel.replica_up(rep.name, reason="probe ok")
        self.history.append({"event": "replica_readmitted",
                             "replica": rep.name, "tick": self.ticks})

    def _on_replica_exhausted(self, rm, site, exc, affected_fn) -> bool:
        """The ``RequestManager.on_exhausted`` hook: a replica dispatch
        exhausted its retry budget.  Instead of the single-manager
        requeue-or-FAIL, the affected requests fail over — preempted off
        the replica (recompute feeds built) and re-queued for
        dispatch to a survivor — and the exhaustion counts against the
        replica's health streak.  Returns True (handled)."""
        rep = self._rep_of(rm)
        if rep is None or rep.state is ReplicaState.DEAD:
            return False  # not (or no longer) ours: the manager's recovery
        if affected_fn is not None:
            affected = list(affected_fn())
        else:
            affected = [r.rid for r in rm._active() if r.status in _RUNNING]
        self._reclaim(rep, affected, site)
        rep.had_exhaustion = True
        self._note_failure(rep, site)
        return True

    # ------------------------------------------------------------------
    # chaos levers
    # ------------------------------------------------------------------
    def kill_replica(self, name: str, reason: str = "operator kill"
                     ) -> List[int]:
        """Immediately kill a replica (chaos/operator lever): in-flight
        requests fail over to survivors mid-decode with their original
        rids, the dead replica's KV tears down refcount-clean, and the
        failovers re-dispatch without waiting for the next fleet tick.
        Returns the failed-over rids."""
        rep = self._by_name(name)
        if rep.state is ReplicaState.DEAD:
            return []
        if rep.ctrl is not None and rep.ctrl._staged is not None:
            # a migration staged on a dying replica can never execute
            rep.ctrl._staged = None
        moved = self._mark_dead(rep, reason)
        self._dispatch_queue()
        return moved

    def schedule_kill(self, name: str, at_tick: int) -> None:
        """Arrange :meth:`kill_replica` at fleet tick ``at_tick`` —
        deterministic on a virtual clock (a seeded chaos run stages a
        mid-decode death with it)."""
        self._kills[name] = int(at_tick)

    # ------------------------------------------------------------------
    # rolling plan migration (one replica at a time)
    # ------------------------------------------------------------------
    def request_rolling_migration(self, candidate, build_manager: Callable,
                                  migration_config: Optional[
                                      MigrationConfig] = None) -> None:
        """Stage a fleet-wide plan switch executed as a ROLLING migration:
        each alive replica in turn drains/rebuilds/readmits through its
        own :class:`~.migration.MigrationController` (rollback included),
        strictly one at a time — so at every tick all but one replica
        keep admission open and the fleet never stops serving.  A
        rollback on any replica ABORTS the remaining rollout (the
        candidate plan demonstrably cannot build)."""
        if self._rolling is not None:
            raise ValueError("a rolling migration is already in progress")
        if isinstance(candidate, str):
            candidate = {"plan_key": candidate}
        self._rolling = {
            "candidate": dict(candidate),
            "build": build_manager,
            "config": migration_config
            or MigrationConfig(auto=False, drain_grace_ticks=1),
            "remaining": [rep.name for rep in self.replicas
                          if rep.state is not ReplicaState.DEAD],
            "active": None,
            "records": [],
        }

    def _ensure_controller(self, rep: Replica, build: Callable,
                           config: MigrationConfig) -> MigrationController:
        if rep.ctrl is None:
            def on_switch(new_rm, _rep=rep):
                self._adopt_successor(_rep, new_rm)

            rep.ctrl = MigrationController(rep.rm, build, config=config,
                                           on_switch=on_switch)
        else:
            rep.ctrl.build_manager = build
            rep.ctrl.config = config
        return rep.ctrl

    def _advance_rolling(self) -> None:
        r = self._rolling
        if r is None:
            return
        if r["active"] is not None:
            rep = self._by_name(r["active"])
            ctrl = rep.ctrl
            if rep.state is ReplicaState.DEAD:
                # the draining replica died mid-migration: its requests
                # already failed over; drop its slot in the schedule
                if ctrl is not None:
                    ctrl._staged = None
                r["records"].append({"replica": rep.name,
                                     "outcome": "died_mid_migration"})
                r["active"] = None
            elif ctrl is not None and ctrl._staged is not None:
                return  # in flight: ONE replica at a time
            else:
                rec = (ctrl.history[-1] if ctrl and ctrl.history
                       else {"outcome": "unknown"})
                r["records"].append({
                    "replica": rep.name,
                    **{k: rec.get(k) for k in
                       ("outcome", "candidate", "downtime_ticks",
                        "preempted_requests", "phase", "reason")
                       if k in rec}})
                r["active"] = None
                if rec.get("outcome") == "rolled_back":
                    self.history.append({
                        "event": "rolling_migration_aborted",
                        "candidate": r["candidate"].get("plan_key"),
                        "failed_replica": rep.name,
                        "replicas": r["records"], "tick": self.ticks})
                    self._rolling = None
                    return
        while r["active"] is None and r["remaining"]:
            name = r["remaining"].pop(0)
            rep = self._by_name(name)
            if rep.state not in ALIVE_STATES:
                r["records"].append({
                    "replica": name,
                    "outcome": f"skipped_{rep.state.name.lower()}"})
                continue
            ctrl = self._ensure_controller(rep, r["build"], r["config"])
            ctrl.request_migration(dict(r["candidate"]))
            r["active"] = name
        if r["active"] is None and not r["remaining"]:
            self.history.append({
                "event": "rolling_migration_completed",
                "candidate": r["candidate"].get("plan_key"),
                "replicas": r["records"], "tick": self.ticks})
            self._rolling = None

    # ------------------------------------------------------------------
    # the fleet serve loop
    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.queue) or any(rep.rm.has_work()
                                       for rep in self._alive())

    def _adopt_successor(self, rep: Replica, new_rm) -> None:
        rep.rm = new_rm
        new_rm.on_exhausted = self._on_replica_exhausted
        new_rm.starvation_bound_ticks = self.config.starvation_bound_ticks
        new_rm.slo = self.slo
        new_rm.brownout = self.brownout
        # a live migration transplants requests into NEW record objects
        # (rids preserved) — re-point the fleet registry at the live
        # ones, or results/records would freeze at the drain snapshot
        for rid, req in new_rm.requests.items():
            if rid in self.requests:
                self.requests[rid] = req

    def _tick_replica(self, rep: Replica) -> None:
        """One replica's serve tick under the fleet's fault envelope:
        the seeded ``fleet_dispatch:<name>`` site models router→replica
        connectivity (a fault skips the tick and counts against the
        health streak), in-replica retry exhaustion arrives through the
        ``on_exhausted`` hook, and a clean tick resets the streak."""
        rm = rep.rm
        rm._check_lifecycle()
        if not rm.has_work():
            new_rm = rm._maybe_migrate(idle=True)
            if new_rm is not None:
                self._adopt_successor(rep, new_rm)
            return
        site = f"fleet_dispatch:{rep.name}"
        try:
            if self.injector is not None:
                self.injector.maybe_fail(site)
        except TransientServeError as e:
            if self.telemetry.enabled:
                self.telemetry.fault_observed(site, detail=str(e))
            self._note_failure(rep, site)
            return
        rep.had_exhaustion = False
        self.profiler.tick_begin()
        rm._tick()
        self.profiler.tick_end()
        rm._sync_kv()
        rm._maybe_check_health()
        if not rep.had_exhaustion and rep.state is not ReplicaState.DEAD:
            self._note_success(rep)
        new_rm = rm._maybe_migrate()
        if new_rm is not None:
            self._adopt_successor(rep, new_rm)

    def _maybe_brownout(self) -> None:
        """Evaluate the fleet-level BrownoutController every
        ``config.check_every`` fleet ticks and apply the ladder's
        actions across the whole fleet (see serve/slo.py): DEFER holds
        the fleet queue's degradable classes (``_dispatch_queue``),
        DEGRADE flips speculation off and caps output for LIVE
        degradable requests on every replica (the ``set_spec_mode``
        path), SHED rejects their queued work fleet-wide, CRITICAL_ONLY
        also evicts their slotted work — every shed is an explicit
        ``REJECTED``, never ``FAILED``."""
        bo = self.brownout
        if bo is None:
            return
        if self.ticks % bo.config.check_every:
            return
        slo = self.slo
        tel = self.telemetry
        alive = self._alive()
        # signals: latency-critical lane depth (fleet queue + replica
        # pendings) and fleet-aggregate KV occupancy
        depths: Dict[str, int] = {c: 0 for c in slo.classes}
        lc_depth = 0
        held_queued: List[Request] = []

        def note(req: Request, queued: bool) -> None:
            nonlocal lc_depth
            cls = slo.resolve(req.slo_class)
            if cls is None:
                return
            depths[cls.name] = depths.get(cls.name, 0) + 1
            if not cls.degradable:
                lc_depth += 1
            elif queued:
                held_queued.append(req)

        for rid in self.queue:
            note(self.requests[rid], queued=True)
        live_tok = cap_tok = 0
        committed: Dict[str, float] = {}
        for rep in alive:
            for rid in rep.rm.pending:
                note(rep.rm.requests[rid], queued=True)
            kv = getattr(rep.rm.im, "kv", None)
            if kv is not None:
                live_tok += kv.live_tokens()
                cap_tok += kv.capacity_tokens
        # per-class committed-need high-watermark (token units — the
        # reservation contract's observable): replica-HELD requests
        # only, the same population the admission gate prices
        for rid in self._live:
            req = self.requests[rid]
            if req.status in TERMINAL_STATUSES or rid in self.queue:
                continue
            key = req.slo_class or ""
            committed[key] = committed.get(key, 0.0) + self._need(req)
        for key, tot in committed.items():
            if tot > self.lane_committed_hwm.get(key, 0.0):
                self.lane_committed_hwm[key] = tot
        if tel.enabled:
            tel.lane_depths(depths)
        bo.evaluate(lc_queue_depth=lc_depth,
                    kv_occupancy_frac=(live_tok / cap_tok if cap_tok
                                       else 0.0))
        if bo.level == 0:
            return
        # --- apply the level's actions fleet-wide ----------------------
        deferred: Dict[str, int] = {}
        for req in held_queued:
            if req.status in TERMINAL_STATUSES:
                continue
            if bo.sheds_queued(req.slo_class):
                if tel.enabled:
                    tel.lane_shed(req.slo_class, trace_id=req.trace_id,
                                  reason=f"brownout:{bo.level.name}")
                if req.rid in self.queue:
                    self._terminate(req, RequestStatus.REJECTED,
                                    reason="brownout shed")
                else:
                    # replica-pending: pull it off, then shed at the fleet
                    rep = self._by_name(self.placement[req.rid])
                    rep.rm.pending.remove(req.rid)
                    rep.rm._pending_since.pop(req.rid, None)
                    rep.rm.requests.pop(req.rid, None)
                    rep.rm._tstamps.pop(req.rid, None)
                    self._live.add(req.rid)
                    self._terminate(req, RequestStatus.REJECTED,
                                    reason="brownout shed")
            elif bo.holds(req.slo_class):
                req.deferred_ticks += 1
                deferred[req.slo_class] = deferred.get(req.slo_class, 0) + 1
        if tel.enabled:
            for cname, cnt in deferred.items():
                tel.lane_deferred(cname, count=cnt)
        # --- SPILL: the rung between DEFER and DEGRADE -----------------
        # on pressured replicas with a host tier attached, push
        # degradable decoding requests' pages to host DRAM (each
        # preempt() spills first) BEFORE any capping or shedding below —
        # readmission restores them, so this rung only trades latency
        # for headroom, never tokens.  An ACTION of DEFER_BATCH and
        # above, not a ladder level — the `bo.level < 2` gate right
        # after stays the untouched DEGRADE boundary.
        frac = bo.config.kv_pressure_frac
        for rep in alive:
            rm = rep.rm
            kv = getattr(rm.im, "kv", None)
            if kv is None or kv.host_tier is None or not kv.capacity_tokens:
                continue
            if kv.live_tokens() / kv.capacity_tokens < frac:
                continue
            victims = [r for r in rm._active()
                       if r.status is RequestStatus.DECODING
                       and bo.spills(r.slo_class)
                       and r.preemptions < rm.res.max_preemptions]
            victims.sort(key=lambda r: (r.priority, -r.rid))
            for req in victims:
                if kv.live_tokens() / kv.capacity_tokens < frac:
                    break
                rm.preempt(req.rid)
        if bo.level < 2:  # below DEGRADE_BATCH: nothing touches live work
            return
        for rep in alive:
            rm = rep.rm
            for req in list(rm._active()):
                if req.status in TERMINAL_STATUSES:
                    continue
                if bo.sheds_live(req.slo_class):
                    # CRITICAL_ONLY: evict + shed slotted degradable work
                    rm.preempt(req.rid)
                    rm.pending.remove(req.rid)
                    rm._pending_since.pop(req.rid, None)
                    rm.requests.pop(req.rid, None)
                    rm._tstamps.pop(req.rid, None)
                    self.requests[req.rid] = req
                    self._live.add(req.rid)
                    if tel.enabled:
                        tel.lane_shed(req.slo_class, trace_id=req.trace_id,
                                      reason="brownout:CRITICAL_ONLY")
                    self._terminate(req, RequestStatus.REJECTED,
                                    reason="brownout shed")
                elif bo.degrades(req.slo_class):
                    changed = False
                    if req.spec:
                        changed = rm.set_spec_mode(req.rid, False) \
                            or changed
                    cap = bo.output_cap(req.slo_class)
                    if cap is not None:
                        changed = rm.apply_output_cap(req.rid, cap) \
                            or changed
                    if changed and tel.enabled:
                        tel.lane_degraded(req.slo_class)

    def _fleet_tick(self) -> None:
        """One routing pass: scheduled kills, rolling-migration advance,
        brownout evaluation, queue dispatch, one tick per serving
        replica, quarantine re-probes, health gauges."""
        self.ticks += 1
        for name, at in list(self._kills.items()):
            if at <= self.ticks:
                del self._kills[name]
                self.kill_replica(name, reason="scheduled kill")
        self._advance_rolling()
        self._maybe_brownout()
        self._dispatch_queue()
        for rep in self.replicas:
            if rep.state is ReplicaState.DEAD:
                continue
            if rep.state is ReplicaState.QUARANTINED:
                self._maybe_probe(rep)
                continue
            self._tick_replica(rep)
        self._reap_terminal()
        if self.telemetry.enabled:
            self.telemetry.fleet_health(
                sum(1 for r in self.replicas
                    if r.state is ReplicaState.HEALTHY),
                len(self._alive()), len(self.replicas), len(self.queue))

    def serve_all(self) -> Dict[int, List[int]]:
        """Serve until every registered request reaches a terminal
        outcome (and any staged rolling migration finishes)."""
        while True:
            self._check_lifecycle()
            if not self.has_work():
                if self._rolling is not None:
                    self._fleet_tick()
                    continue
                break
            self._fleet_tick()
        return {rid: r.generated for rid, r in self.requests.items()}

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None) -> List[List[int]]:
        rids = [self.register(p, max_new_tokens) for p in prompts]
        out = self.serve_all()
        return [out[rid] for rid in rids]

    def trace_run_meta(self) -> Dict:
        """Provenance header a traffic trace (obs/replay.py) records for
        this fleet: the shared gen config + fault schedule like a single
        manager's, plus the topology (replica names + per-replica plan
        shapes) and the scheduled-kill schedule — what makes a recorded
        chaos run (replica death mid-stream) replayable from the
        artifact alone."""
        from ..obs.replay import engine_shape_of, injector_meta

        meta: Dict = {
            "driver": type(self).__name__,
            "gen": dataclasses.asdict(self.gen),
            # the fleet-level plan slot carries replica0's engine shape
            # (capacity fields the what-if simulator scales by fleet
            # size); per-replica shapes ride the fleet section
            "plan": (engine_shape_of(self.replicas[0].rm.im)
                     if self.replicas else {}),
            "fault": injector_meta(self.injector),
            "fleet": {
                "replicas": len(self.replicas),
                "names": [rep.name for rep in self.replicas],
                "plans": {rep.name: engine_shape_of(rep.rm.im)
                          for rep in self.replicas},
                "kills": {name: int(tick)
                          for name, tick in self._kills.items()},
            },
        }
        if self.slo is not None and hasattr(self.slo, "snapshot"):
            meta["slo"] = self.slo.snapshot()
        return meta

    def serve_with_arrivals(self, arrivals, clock=None, quantum: int = 8,
                            record_trace=None) -> Dict[int, Dict]:
        """Arrival-driven fleet serving — the multi-worker extension of
        :meth:`RequestManager.serve_with_arrivals` (same arrival tuple /
        options-dict contract, same record fields) plus the fleet
        stamps: ``replica`` (the serving replica — the LAST placement
        when a request failed over) and ``failovers`` (how many replica
        failures it rode).  ``obs.report.under_load_summary`` reduces
        the records to fleet-aggregate AND per-replica goodput / TTFT /
        TPOT / outcome mixes."""
        import time as _time

        clock = clock or _time.perf_counter
        saved_clock = self._swap_clock(clock)
        saved_chunks = {rep.name: rep.rm.scan_chunk
                        for rep in self.replicas}
        for rep in self.replicas:
            rep.rm._swap_clock(clock)
        t0 = clock()
        if record_trace is not None:
            record_trace.begin_run(self.trace_run_meta())
        pending = sorted(arrivals, key=lambda a: a[0])
        records: Dict[int, Dict] = {}
        open_rids: set = set()
        tel = self.telemetry

        def admit_due():
            now = clock() - t0
            while pending and pending[0][0] <= now:
                off, prompt, mnt, *rest = pending.pop(0)
                if record_trace is not None:
                    # RAW options element — a malformed dict replays its
                    # rejection identically
                    record_trace.record_arrival(
                        off, prompt, mnt, rest[0] if rest else None)
                opts, reject = parse_arrival_options(rest)
                rid = self.register(prompt, mnt, reject_invalid=True,
                                    reject_reason=reject, **opts)
                records[rid] = {"arrival_s": off, "admitted_s": now,
                                "prompt_len": len(prompt),
                                "trace_id": self.requests[rid].trace_id}
                open_rids.add(rid)
            return clock() - t0

        def stamp(now):
            for rid in list(open_rids):
                rec, req = records[rid], self.requests[rid]
                if "first_token_s" not in rec and req.generated:
                    rec["first_token_s"] = now
                if ("finish_s" not in rec
                        and req.status in TERMINAL_STATUSES):
                    rec["finish_s"] = now
                if "finish_s" in rec:
                    open_rids.discard(rid)

        try:
            while pending or self.has_work() or self._rolling is not None:
                now = admit_due()
                self._check_lifecycle()
                stamp(clock() - t0)
                if not self.has_work() and self._rolling is None:
                    if pending:
                        _time.sleep(min(1e-3,
                                        max(0.0, pending[0][0] - now)))
                    continue
                for rep in self._alive():
                    rep.rm.scan_chunk = (quantum if pending
                                         else saved_chunks.get(
                                             rep.name, quantum))
                starters = [
                    rid for rid in open_rids
                    if "prefill_start_s" not in records[rid]
                    and self.requests[rid].prefill_offset == 0
                    and self.requests[rid].status not in TERMINAL_STATUSES]
                self._fleet_tick()
                for rid in starters:
                    if self.requests[rid].prefill_offset > 0:
                        records[rid]["prefill_start_s"] = now
                        if tel.enabled:
                            tel.request_prefill_started(
                                self.requests[rid].trace_id)
                stamp(clock() - t0)
        finally:
            self._swap_clock(saved_clock)
            for rep in self.replicas:
                rep.rm.scan_chunk = saved_chunks.get(rep.name,
                                                     rep.rm.scan_chunk)
                rep.rm._swap_clock(saved_clock)
        end = clock() - t0
        for rid, rec in records.items():
            req = self.requests[rid]
            rec["tokens"] = req.generated
            rec["outcome"] = req.outcome or OUTCOMES.get(req.status, "ok")
            if req.slo_class:
                rec["slo_class"] = req.slo_class
            if req.deferred_ticks:
                rec["deferred_ticks"] = req.deferred_ticks
            rec["kv_bytes"] = req.kv_bytes
            rec["replica"] = self.placement.get(rid, "")
            rec["failovers"] = self._failover_counts.get(rid, 0)
            if self.profiler.enabled:
                rec["work"] = self.profiler.request_work(rid)
            start = rec.get("prefill_start_s",
                            rec.get("admitted_s", rec["arrival_s"]))
            stop = rec.get("first_token_s", rec.get("finish_s", end))
            rec["queue_wait_s"] = max(start - rec["arrival_s"], 0.0)
            rec["prefill_s"] = max(stop - start, 0.0)
        if record_trace is not None:
            record_trace.finalize(records)
        return records
