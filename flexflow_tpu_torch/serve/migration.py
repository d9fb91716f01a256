"""Live plan migration: act on a plan-health ``replan_recommended``.

A copy of the JAX package's ``flexflow_tpu/serve/migration.py`` (host-side
Python only), its imports re-pointed at this package, which never imports
the JAX one.  A :class:`MigrationController` attached to a serving
:class:`~.request_manager.RequestManager` consumes the recommendation of a
:class:`~flexflow_tpu_torch.obs.plan_health.PlanHealthMonitor` (or an
operator's :meth:`MigrationController.request_migration`) and switches the
live plan without losing a request:

* **drain** — admission to the slots closes (requests still queue), a
  bounded grace window lets near-finished requests complete, a
  speculative manager's pending commits flush, and every request still
  running is preempted through the recompute path
  (``RequestManager.preempt``: its slot and KV release at once and it
  requeues with its ``prompt + generated`` recompute feed);
* **rebuild** — the candidate deployment comes from the caller's
  ``build_manager`` hook, through the ordinary
  :class:`~.inference_manager.InferenceManager` and
  :class:`~.spec_infer.SpecInferManager` constructors (a change of KV
  dtype, paging or speculation is another constructor call), with fresh
  KV from a new :class:`~.kv_allocator.KVAllocator` or
  :class:`~.kv_paged.PagedKVAllocator`;
* **readmit** — the drained requests register on the candidate under
  their original rids.  Streams are bit-identical across the switch,
  greedy and seeded, because recovery is preemption's recompute path
  and every sample keys on ``(seed, rid, token index)``, which the rid
  carries across managers;
* **commit and teardown** — the incumbent gives up its cache
  (:meth:`~.kv_allocator.KVAllocator.teardown`: the buffers drop, so the
  card's memory is freed, and the returned leak list must be empty) and
  the successor takes over the serve loop in place
  (``RequestManager._maybe_migrate``).

Every phase consults the deployment's seeded
:class:`~.resilience.FaultInjector` (sites ``migration_drain``,
``migration_rebuild``, ``migration_readmit``) and retries transient faults
with the dispatches' backoff.  A rebuild or readmit that fails past the
budget, or any other error, ROLLS BACK: the candidate's buffers are torn
down, admission reopens on the incumbent and the drained requests readmit
there (``migration_rolled_back``).  A cooldown, with the monitor's own
``replan_cooldown_ticks``, keeps two candidates from flapping.

**The spec flip fast path.**  A candidate that differs from the
incumbent only in the ``_spec_w{w}d{d}`` suffix, on a SpecInferManager of
that tree shape, needs no rebuild: ``set_spec_mode`` flips every live
request and ``default_spec_mode`` the later admissions.

All of it is host orchestration over the managers' own primitives; no
migration decision reaches a CUDA launch.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

from ..obs.telemetry import telemetry_or_null
from .request_manager import (
    RequestManager,
    RequestStatus,
    TERMINAL_STATUSES,
)
from .resilience import RetryPolicy, TransientServeError

_SPEC_SUFFIX = re.compile(r"_spec_w(\d+)d(\d+)$")
_PLAN_SHAPE = re.compile(r"^tp(\d+)_pp(\d+)_m(\d+)(?:_|$)")

# requests currently occupying an engine slot (the drain's preempt set)
_RUNNING = (RequestStatus.PREFILLING, RequestStatus.DECODING)


def base_plan_key(key: str) -> str:
    """A plan key with its ``_spec_w{w}d{d}`` suffix stripped — two keys
    with equal bases name the same tp×pp×m shape and differ only in the
    speculation mode."""
    return _SPEC_SUFFIX.sub("", key or "")


def spec_shape(key: str) -> Optional[Tuple[int, int]]:
    """(width, depth) of a ``_spec_w{w}d{d}`` plan key, None if non-spec."""
    m = _SPEC_SUFFIX.search(key or "")
    return (int(m.group(1)), int(m.group(2))) if m else None


def plan_shape(key: str) -> Dict[str, int]:
    """``{"tp", "pp", "m"}`` of a ``tp{t}_pp{p}_m{m}...`` plan key (the
    port's builders: ``LLM.plan_builder``; ``pp > 1`` is a pipelined
    deployment of ``m`` micro-batches, ``pp = 1`` has one)."""
    m = _PLAN_SHAPE.match(key or "")
    if m is None:
        raise ValueError(f"plan key {key!r} is not tp{{t}}_pp{{p}}_m{{m}}")
    tp, pp, mb = (int(g) for g in m.groups())
    if tp < 1 or pp < 1 or mb < 1 or (pp == 1 and mb != 1):
        raise ValueError(f"plan key {key!r}: tp, pp and m at least 1, and "
                         "one micro-batch without pipeline stages")
    return {"tp": tp, "pp": pp, "m": mb}


class MigrationRollback(Exception):
    """A non-transient migration failure: roll back to the incumbent
    (never retried — retry is for :class:`TransientServeError` only)."""


def build_deployment(built, gen, telemetry=None, resilience=None,
                     fault_injector=None, clock=None, profiler=None,
                     spec: Optional[Dict] = None, plan_key: str = "",
                     default_shape: Optional[Tuple[int, int]] = None,
                     slo=None, brownout=None):
    """Wrap a ``build_manager``-style result into a serving manager.

    THE one wrapping contract shared by :class:`MigrationController`'s
    rebuild phase and the fleet router's replica construction
    (``serve/fleet.py``) — a deployment is a ready
    :class:`~.request_manager.RequestManager` (returned as-is), a single
    InferenceManager-like object (wrapped in a ``RequestManager``), or an
    ``(llm_im, ssm_im)`` pair (wrapped in a
    :class:`~.spec_infer.SpecInferManager`, tree shape resolved PER FIELD
    from the ``spec`` dict, then the ``plan_key``'s ``_spec_w{w}d{d}``
    suffix, then ``default_shape``).  Sharing gen/telemetry/resilience/
    injector/clock/profiler here is what makes seeded bit-identity hold
    by construction across managers — every wrapped deployment samples
    through the same (seed, rid, token_index) schedule.
    """
    if isinstance(built, RequestManager):
        return built
    if isinstance(built, (tuple, list)):
        from .spec_infer import SpecInferManager

        llm_im, ssm_im = built
        shape = dict(spec or {})
        key_wd = spec_shape(plan_key)
        base_wd = key_wd or default_shape or (2, 3)
        width = shape.get("width") or base_wd[0]
        depth = shape.get("depth") or base_wd[1]
        return SpecInferManager(
            llm_im, ssm_im, gen, width=width, depth=depth,
            telemetry=telemetry, resilience=resilience,
            fault_injector=fault_injector, clock=clock, profiler=profiler,
            slo=slo, brownout=brownout)
    return RequestManager(built, gen, telemetry=telemetry,
                          resilience=resilience,
                          fault_injector=fault_injector, clock=clock,
                          profiler=profiler, slo=slo, brownout=brownout)


@dataclasses.dataclass
class MigrationConfig:
    """Policy knobs for the live-migration controller.

    * ``auto``: consume the attached
      :class:`~flexflow_tpu_torch.obs.plan_health.PlanHealthMonitor`'s
      ``replan_recommended`` automatically (False = operator-driven
      :meth:`MigrationController.request_migration` only).
    * ``cooldown_ticks``: serve ticks after a completed OR rolled-back
      migration during which new auto-recommendations are ignored — the
      controller-side hysteresis against plan flapping (the monitor has
      its own emission-side ``replan_cooldown_ticks``; both guards
      compose).  Manual ``request_migration`` bypasses it.
    * ``defer_ticks``: ticks a staged migration waits (admission still
      OPEN) before the drain begins — lets an operator schedule "migrate
      in ~N ticks" and gives tests a deterministic mid-flight window.
    * ``drain_grace_ticks``: admission-closed ticks the incumbent keeps
      serving before the survivors are force-preempted — a request one
      token from finishing completes instead of paying a full recompute.
      Each grace tick counts toward the ``migration_downtime_ticks``
      gauge ("ticks with admission closed").
    * ``spec_flip_fast_path``: recognize candidates differing only in the
      spec suffix and flip ``set_spec_mode`` instead of rebuilding.
    * ``retry``: backoff policy for transient faults inside the migration
      phases; None uses the manager's own ``res.retry``.
    """

    auto: bool = True
    cooldown_ticks: int = 64
    defer_ticks: int = 0
    drain_grace_ticks: int = 2
    spec_flip_fast_path: bool = True
    retry: Optional[RetryPolicy] = None


class MigrationController:
    """Executes live plan switches for one serving session.

    ``manager``: the incumbent (attaches as ``manager.migration``, the
    hook the serve loops poll at every tick boundary).
    ``build_manager``: ``candidate_plan_dict -> deployment`` — the rebuild
    hook.  It may return a ready :class:`RequestManager` (the hook
    then owns gen/telemetry wiring — the controller still transplants
    requests and syncs the clock), a single InferenceManager-like object
    (wrapped in a ``RequestManager`` sharing the incumbent's
    GenerationConfig/telemetry/resilience/injector/clock, so seeded
    bit-identity holds by construction), or an ``(llm_im, ssm_im)`` pair
    (wrapped in a :class:`~.spec_infer.SpecInferManager`; tree
    width/depth from the candidate's ``spec`` dict / plan-key suffix,
    falling back to the incumbent's).  It must build AROUND fresh
    InferenceManagers — reusing the incumbent's ``im`` is invalid (its
    buffers are torn down on commit).
    ``plan``: the incumbent's plan dict (default: the attached
    plan-health monitor's, else inferred from the manager).
    ``on_switch``: optional callback ``new_manager -> None`` fired after
    a successful commit — the hook ``LLM.attach_migration`` uses to keep
    ``llm.rm``/``llm.im`` pointing at the active deployment.

    ``controller.rm`` is always the ACTIVE manager; ``history`` records
    every completed/rolled-back migration.
    """

    def __init__(self, manager: RequestManager,
                 build_manager: Callable[[Dict], object],
                 plan: Optional[Dict] = None,
                 config: Optional[MigrationConfig] = None,
                 on_switch: Optional[Callable] = None):
        self.rm = manager
        self.build_manager = build_manager
        self.config = config or MigrationConfig()
        self.on_switch = on_switch
        self.plan = dict(plan) if plan is not None else self._infer_plan(manager)
        self.history: List[Dict] = []
        self._staged: Optional[Dict] = None
        self._ticks = 0
        self._cooldown_until = 0
        if getattr(manager, "migration", None) is not None:
            # silently replacing an attached controller would orphan it:
            # its staged migrations would never execute (the manager polls
            # exactly one controller per tick boundary)
            raise ValueError(
                "manager already has a MigrationController attached")
        manager.migration = self

    # ------------------------------------------------------------------
    @staticmethod
    def _infer_plan(rm: RequestManager) -> Dict:
        mon = getattr(rm, "plan_health", None)
        if mon is not None and getattr(mon, "plan", None):
            return dict(mon.plan)
        key = getattr(rm.im, "plan_key", "?")
        if hasattr(rm, "ssm") and getattr(rm, "default_spec_mode", False):
            key += f"_spec_w{rm.width}d{rm.depth}"
        return {"plan_key": key}

    @property
    def telemetry(self):
        return telemetry_or_null(getattr(self.rm, "telemetry", None))

    def _has_running(self, rm: RequestManager) -> bool:
        return any(r.status in _RUNNING for r in rm._active())

    def _live_rids(self, rm: RequestManager) -> List[int]:
        """Non-terminal rids, pending-queue order first then slotted —
        after a full drain this is exactly the pending queue."""
        slotted = [r.rid for r in rm._active()
                   if r.status not in TERMINAL_STATUSES]
        return list(rm.pending) + [r for r in slotted if r not in rm.pending]

    # ------------------------------------------------------------------
    # staging
    # ------------------------------------------------------------------
    def request_migration(self, candidate, reasons=(), *,
                          defer_ticks: Optional[int] = None,
                          drain_grace_ticks: Optional[int] = None) -> None:
        """Stage a migration to ``candidate`` (a plan dict from
        ``search_serve_plan``, or a bare plan-key string).  Executes at a
        serve-tick boundary: ``defer_ticks`` of normal serving, then the
        admission-closed drain window, then the switch.  Manual staging
        bypasses the auto-path cooldown; one migration at a time."""
        if self._staged is not None:
            raise ValueError("a migration is already staged/in progress")
        if isinstance(candidate, str):
            candidate = {"plan_key": candidate}
        cfg = self.config
        grace = cfg.drain_grace_ticks if drain_grace_ticks is None \
            else int(drain_grace_ticks)
        if cfg.spec_flip_fast_path and self._spec_flip_applicable(
                self.rm, self.plan.get("plan_key", "?"),
                candidate.get("plan_key", "?")):
            # a flip preempts nothing: paying an admission-closed grace
            # window for it would be pure downtime
            grace = 0
        self._staged = {
            "candidate": dict(candidate),
            "reasons": list(reasons),
            "defer_left": cfg.defer_ticks if defer_ticks is None
            else int(defer_ticks),
            "grace_left": grace,
            "downtime_ticks": 0,
            "t_closed": None,
        }

    def _poll(self, rm: RequestManager) -> None:
        """Consume a fresh plan-health recommendation (auto path)."""
        if not self.config.auto:
            return
        mon = getattr(rm, "plan_health", None)
        rec = getattr(mon, "recommendation", None) if mon is not None else None
        if not rec:
            return
        if self._ticks < self._cooldown_until:
            return
        cand = rec.get("candidate_plan") or {"plan_key": rec.get("candidate")}
        if cand.get("plan_key") == self.plan.get("plan_key"):
            mon.recommendation = None  # incumbent reaffirmed: nothing to do
            return
        self.request_migration(cand, reasons=rec.get("reasons", ()))
        # consumed: the monitor may re-recommend later excursions fresh
        mon.recommendation = None

    # ------------------------------------------------------------------
    # the tick-boundary hook (RequestManager._maybe_migrate drives this)
    # ------------------------------------------------------------------
    def tick(self, rm: RequestManager, idle: bool = False):
        """One tick-boundary slot.  Returns the manager the serve loop
        should continue on — the successor after a completed switch, or
        ``rm`` itself (staging / grace / rollback / nothing to do)."""
        if rm is not self.rm:
            return rm  # a retired manager's loop unwinding; ignore
        if not idle:
            self._ticks += 1
        st = self._staged
        if st is None:
            if idle:
                return rm
            self._poll(rm)
            st = self._staged
            if st is None:
                return rm
        if idle:
            # the loop drained: execute now — the zero-preemption window
            # (defer/grace exist to bound in-flight disruption; idle has
            # none).  Close admission for the switch itself.
            if st["t_closed"] is None:
                rm.admission_closed = True
                st["t_closed"] = rm.clock()
            return self._execute(rm)
        if st["defer_left"] > 0:
            st["defer_left"] -= 1
            return rm
        if st["t_closed"] is None:
            rm.admission_closed = True
            st["t_closed"] = rm.clock()
        else:
            st["downtime_ticks"] += 1  # a serve tick ran admission-closed
        if st["grace_left"] > 0 and self._has_running(rm):
            st["grace_left"] -= 1
            return rm
        return self._execute(rm)

    # ------------------------------------------------------------------
    # guarded phases
    # ------------------------------------------------------------------
    def _phase(self, rm: RequestManager, site: str, fn):
        """Run one migration phase under the seeded fault injector and the
        retry policy.  Returns ``(True, value)`` or ``(False, reason)`` —
        transient faults retry with backoff; :class:`MigrationRollback`
        (and any other non-transient error) fails the phase immediately."""
        pol = self.config.retry or rm.res.retry
        tel = self.telemetry
        attempt = 0
        while True:
            try:
                if rm.injector is not None:
                    rm.injector.maybe_fail(site)
                return True, fn()
            except TransientServeError as e:
                if tel.enabled:
                    tel.fault_observed(site, detail=str(e))
                if attempt >= pol.max_retries:
                    return False, f"{site}: retries exhausted ({e})"
                attempt += 1
                delay = pol.backoff(attempt)
                if tel.enabled:
                    tel.dispatch_retry(site, attempt=attempt, backoff_s=delay)
                if delay > 0:
                    rm._sleep(delay)
            except MigrationRollback as e:
                return False, f"{site}: {e}"
            except Exception as e:  # constructor/validation failures
                return False, f"{site}: {type(e).__name__}: {e}"

    # ------------------------------------------------------------------
    # the switch
    # ------------------------------------------------------------------
    def _execute(self, rm: RequestManager):
        st, self._staged = self._staged, None
        cfg = self.config
        tel = self.telemetry
        candidate = st["candidate"]
        cand_key = candidate.get("plan_key", "?")
        inc_key = self.plan.get("plan_key", "?")
        reasons = ",".join(st["reasons"])
        if tel.enabled:
            tel.migration_started(inc_key, cand_key, reasons=reasons)

        # ---- spec flip fast path (no drain, no rebuild) ----------------
        if (cfg.spec_flip_fast_path
                and self._spec_flip_applicable(rm, inc_key, cand_key)):
            spec_on = spec_shape(cand_key) is not None
            flipped = 0
            for rid in self._live_rids(rm):
                if rm.set_spec_mode(rid, spec_on):
                    flipped += 1
            rm.default_spec_mode = spec_on
            return self._commit(rm, rm, st, candidate, mode="spec_flip",
                                preempted=0, flipped=flipped)

        # ---- drain -----------------------------------------------------
        ok, drained = self._phase(rm, "migration_drain",
                                  lambda: self._drain(rm))
        if not ok:
            return self._rollback(rm, st, candidate, "drain", drained)
        # ---- rebuild ---------------------------------------------------
        ok, new_rm = self._phase(rm, "migration_rebuild",
                                 lambda: self._build(rm, candidate))
        if not ok:
            return self._rollback(rm, st, candidate, "rebuild", new_rm)
        # ---- readmit ---------------------------------------------------
        ok, moved = self._phase(
            rm, "migration_readmit",
            lambda: self._readmit(rm, new_rm, candidate))
        if not ok:
            return self._rollback(rm, st, candidate, "readmit", moved,
                                  new_rm=new_rm)
        # ---- commit: tear down the incumbent, swap the active manager --
        return self._commit(rm, new_rm, st, candidate, mode="rebuild",
                            preempted=drained)

    def _spec_flip_applicable(self, rm, inc_key: str, cand_key: str) -> bool:
        if cand_key == inc_key or base_plan_key(cand_key) \
                != base_plan_key(inc_key):
            return False
        if not hasattr(rm, "ssm"):  # needs a live draft model to flip onto
            return False
        shape = spec_shape(cand_key)
        # flipping OFF works for any shape; flipping ON must match the
        # manager's compiled tree capacity
        return shape is None or shape == (rm.width, rm.depth)

    def _drain(self, rm: RequestManager) -> int:
        """Flush pending spec commits, then preempt every still-running
        request through the recompute path.  Idempotent — a retried
        drain re-preempts only what is still slotted."""
        flush = getattr(rm, "flush_pending_commits", None)
        if flush is not None:
            # a flush failure already requeued/failed its affected rows
            # via the manager's own retry guard; the drain proceeds
            flush()
        count = 0
        for req in list(rm._active()):
            if req.status in _RUNNING:
                rm.preempt(req.rid)
                count += 1
        return count

    def _build(self, rm: RequestManager, candidate: Dict):
        """Construct the candidate deployment (see class docstring for
        the ``build_manager`` contract)."""
        built = self.build_manager(candidate)
        if built is None:
            raise MigrationRollback("build_manager returned None")
        # the freshness check runs BEFORE any manager wraps the result:
        # wrapping the incumbent's own InferenceManager would reset its
        # attribution, and tearing the "candidate" down on rollback would
        # destroy the buffers the incumbent still serves from
        incumbent_ims = {id(x) for x in (rm.im, getattr(rm, "ssm", None))
                         if x is not None}
        parts = (built,) if not isinstance(built, (tuple, list)) else built
        for part in parts:
            for x in (part, getattr(part, "im", None),
                      getattr(part, "ssm", None)):
                if x is not None and id(x) in incumbent_ims:
                    raise MigrationRollback(
                        "build_manager must construct a FRESH deployment "
                        "(the incumbent's buffers are torn down on commit)")
        tel = rm.telemetry if rm.telemetry.enabled else None
        # the StepProfiler handle crosses the switch like telemetry: rids
        # are preserved, so the per-request work attribution keeps
        # accumulating in ONE table across managers (and the successor
        # joins the profiler's poll via install()).  Tree
        # shape for a spec pair: candidate's spec dict, then the plan-key
        # suffix, then the incumbent's shape (build_deployment resolves
        # PER FIELD so a partial spec dict still fills in sanely).
        prof = rm.profiler if getattr(rm, "profiler", None) is not None \
            and rm.profiler.enabled else None
        return build_deployment(
            built, rm.gen, telemetry=tel, resilience=rm.res,
            fault_injector=rm.injector, clock=rm.clock, profiler=prof,
            spec=candidate.get("spec"),
            plan_key=candidate.get("plan_key", ""),
            default_shape=((rm.width, rm.depth) if hasattr(rm, "width")
                           else None),
            # the lane policy + ladder cross the switch like the
            # telemetry handle — a migration must not silently
            # deactivate SLO lanes on the successor
            slo=getattr(rm, "slo", None),
            brownout=getattr(rm, "brownout", None))

    def _readmit(self, rm: RequestManager, new_rm: RequestManager,
                 candidate: Dict) -> int:
        """Transplant every request onto the candidate manager, preserving
        rids (the sample-key fold) and recompute feeds.  Non-destructive
        for the incumbent until :meth:`_commit` — a readmit failure rolls
        back with the incumbent's queue intact."""
        new_rm.admission_closed = True  # until commit reopens it
        new_rm.clock = rm.clock  # deadlines stay on one time base
        # decode pacing crosses the switch: an operator who pinned
        # tick-paced decode (chain_segments off) or a custom stretch
        # bound must not silently revert to the defaults mid-session
        new_rm.chain_segments = rm.chain_segments
        new_rm.scan_chunk = rm.scan_chunk
        new_rm.lifecycle_quantum = rm.lifecycle_quantum
        spec_on = (spec_shape(candidate.get("plan_key", "")) is not None
                   or bool(candidate.get("spec")))
        is_spec_mgr = hasattr(new_rm, "ssm")
        live = self._live_rids(rm)
        converted = {}
        for rid in live:
            old = rm.requests[rid]
            req = new_rm.request_cls(rid, list(old.prompt),
                                     old.max_new_tokens)
            req.trace_id = old.trace_id
            req.priority = old.priority
            req.deadline_s = old.deadline_s
            req.cancel_requested = old.cancel_requested
            req.preemptions = old.preemptions
            req.requeues = old.requeues
            req.kv_bytes = old.kv_bytes
            # SLO-lane identity crosses the switch: losing the class
            # would resolve a latency_critical request to the DEFAULT
            # (degradable) lane on the successor and let a brownout
            # shed it — violating its shed_policy="never" contract
            req.slo_class = old.slo_class
            req.deferred_ticks = old.deferred_ticks
            req.generated = list(old.generated)
            req.prefill_src = (list(old.prefill_src)
                               if old.prefill_src is not None else None)
            req.n_prefed = old.n_prefed
            req.status = old.status  # PENDING or PREEMPTED post-drain
            req.spec = bool(spec_on) if is_spec_mgr else False
            err = new_rm._validate_request(req)
            if err is not None:
                # the candidate cannot hold this request (e.g. a smaller
                # max_seq_len): losing it is not an option — roll back
                raise MigrationRollback(
                    f"request {rid} does not fit the candidate: {err}")
            converted[rid] = req
        # terminal/history records carry over as-is (result lookup joins
        # pre- and post-migration outcomes under one rid space)
        for rid, old in rm.requests.items():
            if rid not in converted:
                new_rm.requests[rid] = old
        new_rm.requests.update(converted)
        new_rm.pending = list(live)
        new_rm._next_rid = max(new_rm._next_rid, rm._next_rid)
        new_rm._tstamps.update(rm._tstamps)  # admission fired once per rid
        if is_spec_mgr:
            new_rm.default_spec_mode = bool(spec_on)
        # host-tier KV crosses the switch: the drain's preempts spilled
        # every running request's pages into the incumbent's host tier —
        # adopt them onto the successor's allocators so readmission
        # restores instead of re-prefilling.  adopt_spills() moves
        # entries ONLY when the swap signatures (page geometry + buffer
        # shapes/dtypes) match; a reshaped candidate silently falls back
        # to the recompute feed, which the transplant above preserved.
        for old_kv, new_kv in zip(self._allocators(rm),
                                  self._allocators(new_rm)):
            new_kv.adopt_spills(old_kv, live)
        return len(live)

    @staticmethod
    def _allocators(rm: RequestManager) -> List:
        kvs = [getattr(rm.im, "kv", None)]
        ssm = getattr(rm, "ssm", None)
        if ssm is not None:
            kvs.append(getattr(ssm, "kv", None))
        return [kv for kv in kvs if kv is not None]

    def _teardown(self, rm: RequestManager) -> List[int]:
        """Release a manager's cache ownership: every allocator tears
        down (attribution released, buffers dropped, page pools reset).
        Returns rids that still held attribution — the refcount no-leak
        contract says this is empty after a full drain."""
        leaked: List[int] = []
        for kv in self._allocators(rm):
            leaked.extend(kv.teardown())
        return sorted(set(leaked))

    def _rollback(self, rm: RequestManager, st: Dict, candidate: Dict,
                  phase: str, reason, new_rm=None):
        """The switch failed: discard the candidate (tearing down any
        buffers it allocated), reopen admission on the incumbent, and let
        the drained requests readmit there — zero lost requests."""
        if new_rm is not None:
            # never tear down an allocator the incumbent still serves
            # from (defense in depth; _build already rejects shared ims)
            inc = {id(kv) for kv in self._allocators(rm)}
            for kv in self._allocators(new_rm):
                if id(kv) not in inc:
                    kv.teardown()
        rm.admission_closed = False
        tel = self.telemetry
        cand_key = candidate.get("plan_key", "?")
        inc_key = self.plan.get("plan_key", "?")
        if tel.enabled:
            tel.migration_rolled_back(inc_key, cand_key, phase=phase,
                                      reason=str(reason)[:200])
        mon = getattr(rm, "plan_health", None)
        if mon is not None:
            mon.recommendation = None  # consumed; a fresh excursion re-emits
        self._cooldown_until = self._ticks + self.config.cooldown_ticks
        self.history.append({
            "outcome": "rolled_back", "incumbent": inc_key,
            "candidate": cand_key, "phase": phase, "reason": str(reason),
            "downtime_ticks": st["downtime_ticks"], "tick": self._ticks,
        })
        return rm

    def _commit(self, rm: RequestManager, new_rm: RequestManager, st: Dict,
                candidate: Dict, mode: str, preempted: int,
                flipped: Optional[int] = None):
        tel = self.telemetry
        cand_key = candidate.get("plan_key", "?")
        inc_key = self.plan.get("plan_key", "?")
        leaked: List[int] = []
        if new_rm is not rm:
            # the incumbent's queue moved wholesale; retire it so a stray
            # loop reference drains immediately instead of double-serving
            rm.pending = []
            rm.admission_closed = True
            rm.migration = None
            leaked = self._teardown(rm)
            # release the retired deployment from the profiler's polls —
            # without this, every migration would pin the incumbent's
            # InferenceManager (and its weights' owner) through the poll
            # list
            prof = getattr(rm, "profiler", None)
            if prof is not None and prof.enabled:
                prof.uninstall(rm.im)
                ssm = getattr(rm, "ssm", None)
                if ssm is not None:
                    prof.uninstall(ssm)
            new_rm.migration = self
            self.rm = new_rm
        new_rm.admission_closed = False
        downtime_s = (new_rm.clock() - st["t_closed"]
                      if st["t_closed"] is not None else 0.0)
        # re-point the plan-health monitor at the NEW executing plan
        mon = getattr(rm, "plan_health", None)
        if mon is not None and getattr(new_rm, "plan_health", None) is None:
            new_rm.plan_health = mon
        mon = getattr(new_rm, "plan_health", None)
        if mon is not None and hasattr(mon, "rebase"):
            kvs = self._allocators(new_rm)
            mon.rebase(candidate,
                       kv_allocator=(kvs[0] if len(kvs) == 1 else kvs)
                       if kvs else None)
        self.plan = dict(candidate)
        self._cooldown_until = self._ticks + self.config.cooldown_ticks
        record = {
            "outcome": "completed", "mode": mode, "incumbent": inc_key,
            "candidate": cand_key, "preempted_requests": preempted,
            "downtime_ticks": st["downtime_ticks"],
            "downtime_s": downtime_s, "kv_leaked_rids": leaked,
            "tick": self._ticks,
        }
        if flipped is not None:
            record["flipped_requests"] = flipped
        self.history.append(record)
        if tel.enabled:
            tel.migration_completed(
                inc_key, cand_key, mode=mode, preempted_requests=preempted,
                downtime_ticks=st["downtime_ticks"], downtime_s=downtime_s)
        if self.on_switch is not None and new_rm is not rm:
            self.on_switch(new_rm)
        return new_rm
