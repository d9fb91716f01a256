"""RequestManager: request queue, continuous batching, decode stretches,
and the resilient request lifecycle.

Port of ``flexflow_tpu/serve/request_manager.py`` for the incremental
path: ``Request`` and its nine ``RequestStatus`` values,
``GenerationConfig``, ``register_new_request`` with admission control
(:506), slot admission by priority with preemption (:933-1031),
``_build_next_batch`` (:1063) with its tiled pure-prefill branch and
tile-aligned prefill chunking, the prefill stretch (:1414), the chained
decode stretch (:1526) and the unchained one (:1864),
``serve_incr_decoding`` (:2574), ``serve_with_arrivals`` (:2342) and
``generate`` (:2610).  A prefill stretch feeds whole prompts as tiled
chunks of one ``prefill_scan`` dispatch, their LM head gated to the
completing prompts' last tokens when the InferenceManager's
``gate_lm_head`` is on (the default); a decode stretch is a chain of
``decode_scan_async`` segments issued back to back, which arrivals join
at segment boundaries while a slot is free (``chain_segments``; off: one
``decode_scan``); each reads back once at its end (``readbacks`` counts
the host's waits for results).

The lifecycle (reference :621-903): ``cancel`` and deadlines (``ttl_s``,
``deadline_s``) are reaped at step boundaries (``_check_lifecycle``);
``preempt`` releases a running request's slot and KV and requeues it to
recompute ``prompt + generated`` (``Request.prefill_tokens``), which gives
its uninterrupted stream, greedy or seeded; a strictly higher-priority
arrival preempts under slot pressure (``_try_preempt``) and a page
shortfall under page pressure (``_kv_prepare``).  Under a paged cache with
a host tier (``ResilienceConfig.host_tier_bytes``) a preempted request's
written pages spill to host memory and its readmission restores them
(``_kv_spill``, ``_kv_restore``), recomputing only the unrestored tail.
Every dispatch runs under the retry policy (``_guarded``); a fault past
the budget requeues or fails the requests in that dispatch only.

Each request carries a speculation mode (``register_new_request(spec=
...)``, the ``spec`` arrival option, ``set_spec_mode``) that only the
speculative manager reads.  The hooks it builds on (``request_cls``,
``_seq_len_needed``, ``_kv_bind``, ``_release_slot``, ``preempt``,
``_on_spec_flip``, ``_sync_kv``, ``_tick``) leave this path as it is.
Once a tick, ``_sync_kv`` observes every live request's cache depth into
the allocator, whose ``snapshot`` gauges (occupancy, headroom,
fragmentation, watermarks) ``kv_snapshot`` returns.

The control plane (reference :179-315): one ``Telemetry`` handle and one
``StepProfiler`` shared with the InferenceManager take every ``request_*``
lifecycle event, the batch mix, prefix hits, preemption, spill and
restore, retries and faults, the KV gauges, and per tick the profiler's
phases (``host_admit``, ``host_prepare``, ``dispatch``, ``readback``) and
deterministic work counters; neither reads a device value.  An
``SLOPolicy`` resolves each request's ``slo_class`` lane (a priority band,
a per-class queue bound and KV reservation); a ``BrownoutController`` is
evaluated every ``check_every`` ticks and defers, degrades (speculation
off, output caps), spills or sheds degradable lanes (``_maybe_brownout``);
a ``PlanHealthMonitor`` is checked every ``health_check_every`` ticks and
once when a loop drains.

Live migration and the fleet (reference :282-288, :813-822, :2311-2571):
an attached :class:`~.migration.MigrationController` (``migration``) gets
a slot at every tick boundary of both serve loops (``_maybe_migrate``),
which hand the rest of the run to the successor manager once a plan
switch commits; while it drains, ``admission_closed`` keeps new work out
of the slots (requests still queue).  ``on_exhausted`` is the fleet
router's failover hook, consulted when a dispatch exhausts its retries
before the requests are requeued or failed here.  ``serve_with_arrivals``
records a traffic trace (``record_trace``, :mod:`..obs.replay`) headed by
``trace_run_meta``.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import time
from typing import Counter, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.profiler import profiler_or_null
from ..obs.telemetry import telemetry_or_null
from ..utils.platform import host_to_device
from .batch_config import BatchConfig, PrefillBatchConfig
from .inference_manager import EXIT_NOT_IN_BATCH
from .kv_paged import HostTierCorruption, PagePoolExhausted
from .resilience import (
    ResilienceConfig,
    TransientServeError,
    kv_bytes_per_token,
)
from .slo import reservation_reason


class RequestStatus(enum.Enum):
    PENDING = 0
    PREFILLING = 1
    DECODING = 2
    COMPLETED = 3
    # PREEMPTED requests wait in the pending queue and recompute prompt +
    # generated on readmission; the rest are terminal
    PREEMPTED = 4
    CANCELLED = 5
    TIMED_OUT = 6
    REJECTED = 7
    FAILED = 8


TERMINAL_STATUSES = frozenset({
    RequestStatus.COMPLETED, RequestStatus.CANCELLED,
    RequestStatus.TIMED_OUT, RequestStatus.REJECTED, RequestStatus.FAILED,
})

# terminal status -> the ``outcome`` tag serving records carry
OUTCOMES = {
    RequestStatus.COMPLETED: "ok",
    RequestStatus.CANCELLED: "cancelled",
    RequestStatus.TIMED_OUT: "timeout",
    RequestStatus.REJECTED: "rejected",
    RequestStatus.FAILED: "failed",
}

# the options an arrival tuple's 4th element may carry
ARRIVAL_OPTION_KEYS = frozenset({"priority", "ttl_s", "deadline_s", "spec",
                                 "slo_class"})


def parse_arrival_options(rest) -> Tuple[Dict, Optional[str]]:
    """An arrival tuple's optional options dict as
    ``register_new_request`` kwargs: ``(opts, reject_reason)``, the reason
    set for a malformed dict (unknown keys, values that do not coerce), so
    one bad arrival registers as ``REJECTED`` instead of ending the serve
    loop (reference :65)."""
    if not rest:
        return {}, None
    if not isinstance(rest[0], dict) or set(rest[0]) - ARRIVAL_OPTION_KEYS:
        return {}, f"bad arrival options {rest[0]!r}"
    try:
        return {k: (int(v) if k == "priority"
                    else bool(v) if k == "spec"
                    else str(v) if k == "slo_class"
                    else float(v))
                for k, v in rest[0].items() if v is not None}, None
    except (TypeError, ValueError):
        return {}, f"bad arrival options {rest[0]!r}"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 64
    status: RequestStatus = RequestStatus.PENDING
    generated: List[int] = dataclasses.field(default_factory=list)
    prefill_offset: int = 0     # prefill tokens already fed to the model
    slot: int = -1
    trace_id: str = ""
    # consecutive mixed steps whose tiled budget rounded this request's
    # prefill take to zero (the starvation fallback below)
    starved_steps: int = 0
    # prompt tokens a paged cache's prefix index held at admission (the
    # prefill started there)
    prefix_cached: int = 0
    # the lifecycle: admission priority (preemption only evicts strictly
    # lower), an absolute deadline on the manager's clock, the cancel flag
    # reaped at the next step boundary, and the terminal outcome tag
    priority: int = 0
    deadline_s: Optional[float] = None
    cancel_requested: bool = False
    outcome: str = ""
    preemptions: int = 0
    requeues: int = 0
    # after preemption the request re-prefills ``prefill_src`` = prompt +
    # generated (None: the prompt); ``n_prefed`` generated tokens are in
    # that feed, the correction ``seq_len`` needs while it is fed
    prefill_src: Optional[List[int]] = None
    n_prefed: int = 0
    # this binding's cache was (partly) restored from the host tier; the
    # lifecycle scan retires the recompute feed once the catch-up
    # prefill is done
    kv_restored: bool = False
    # the largest committed-KV bytes any of its slot bindings held
    kv_bytes: float = 0.0
    # speculation mode, set at registration (``register_new_request(spec=
    # ...)``) and flipped by ``set_spec_mode``: a SpecInferManager drafts
    # and verifies a spec row's tree and decodes a plain row one token a
    # macro step; the plain RequestManager ignores it
    spec: bool = False
    # the SLO lane the request resolved to at registration ("": no policy)
    # and the brownout windows it spent held in the queue
    slo_class: str = ""
    deferred_ticks: int = 0

    @property
    def prefill_tokens(self) -> List[int]:
        """The token sequence prefill feeds: the prompt, or prompt +
        generated while recovering from preemption."""
        return self.prompt if self.prefill_src is None else self.prefill_src

    @property
    def seq_len(self) -> int:
        """Tokens currently in the KV cache (after the last step)."""
        return self.prefill_offset + len(self.generated) - self.n_prefed


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    stop_on_eos: bool = True
    temperature: float = 0.0    # <= 0: exact greedy argmax
    top_p: float = 1.0
    seed: int = 0


class RequestManager:
    request_cls = Request  # subclasses (SpecInferManager) extend the record
    scan_chunk = 32        # most decode steps per stretch (one read-back)
    # mixed steps whose tiled budget rounds a prefill take to 0 before
    # the starved request takes an unaligned flat chunk
    starvation_limit = 4
    # the decode-stretch cap while an active request has a deadline or a
    # pending cancel: reaping happens at step boundaries
    lifecycle_quantum = 8
    # serve steps after which a pending request jumps every priority band
    # (FIFO among the overdue); None: strict priority
    starvation_bound_ticks: Optional[int] = None
    # chain decode segments back to back up to scan_chunk steps, joining
    # arrivals at segment boundaries; False: one decode_scan a stretch
    chain_segments = True
    # serve_with_arrivals' hooks into the chain: the pump registers the
    # arrivals due at a segment boundary, the stamp records a joiner's
    # prefill start
    _arrival_pump = None
    _join_stamp = None
    # rid -> EXIT_* code of the last chained stretch, and its shape
    # (steps, segments, joins); rebound per stretch
    last_exit_codes: Dict[int, int] = {}
    last_stretch: Dict[str, int] = {}
    # the speculation mode of a request registered with ``spec=None``
    # (the SpecInferManager's is True)
    default_spec_mode = False
    # serve ticks between plan-health checks (reference :1387)
    health_check_every = 16
    # the fleet router's failover hook (reference :813-822):
    # ``on_exhausted(rm, site, exc, affected_fn)`` is consulted when a
    # dispatch exhausts its retries; True means it took the affected
    # requests over (the fleet preempts them and fails them over to a
    # surviving replica), False or no hook keeps this manager's requeue
    # or FAILED
    on_exhausted = None

    def __init__(self, im, gen_config: Optional[GenerationConfig] = None,
                 telemetry=None, resilience: Optional[ResilienceConfig] = None,
                 fault_injector=None, clock=None, plan_health=None,
                 profiler=None, slo=None, brownout=None):
        """``telemetry``: a :class:`~..obs.telemetry.Telemetry` handle
        (None: the no-op one), shared with the InferenceManager.
        ``resilience``: the admission, deadline, preemption, retry and
        host-tier policy (None: every knob off).  ``fault_injector``: a
        seeded :class:`~.resilience.FaultInjector` the InferenceManager
        consults at its dispatch sites.  ``clock``: the deadlines' clock
        (default ``time.perf_counter``; ``serve_with_arrivals`` swaps in
        its own for its duration).  ``plan_health``: a
        :class:`~..obs.plan_health.PlanHealthMonitor`, given the KV
        allocator, the lane policy and the brownout controller unless it
        has its own.  ``profiler``: a :class:`~..obs.profiler.StepProfiler`
        shared with the InferenceManager.  ``slo``: an
        :class:`~.slo.SLOPolicy`; ``brownout``: a
        :class:`~.slo.BrownoutController` (its policy when ``slo`` is
        None)."""
        self.im = im
        self.gen = gen_config or GenerationConfig()
        self.requests: Dict[int, Request] = {}
        self.pending: List[int] = []
        # serve-step stamp of each rid's entry into ``pending`` (the
        # starvation bound's age)
        self._pending_since: Dict[int, int] = {}
        self.slots: List[Optional[int]] = [None] * im.max_requests
        self._next_rid = 0
        self.steps = 0
        self.tokens_decoded = 0
        self.scan_runs = 0
        self.readbacks = 0
        # one telemetry handle and one profiler across the stack, always
        # synced onto the InferenceManager (reference :197-232)
        self.telemetry = telemetry_or_null(telemetry)
        im.telemetry = self.telemetry
        self._tstamps: Dict[int, Dict[str, float]] = {}   # rid -> stamps
        self.profiler = profiler_or_null(profiler)
        im.profiler = self.profiler
        if self.profiler.enabled:
            self.profiler.install(im)
            self.profiler.bind(self.telemetry)
        # a fresh manager restarts rids from 0: no attribution left by an
        # earlier manager on this deployment may alias them
        im.kv.reset_attribution()
        if self.telemetry.enabled:
            im.publish_memory(self.telemetry)
        self.res = resilience or ResilienceConfig()
        if (self.res.kv_gate and self.res.kv_budget_bytes is not None
                and kv_bytes_per_token(im) is None):
            # a byte cap cannot price requests without allocated caches
            raise ValueError(
                "kv_budget_bytes needs allocated KV caches to price "
                "requests in bytes; call init_operators_inference() "
                "before building the RequestManager (or use "
                "kv_headroom_frac, which gates in position units)")
        # set on the InferenceManager every time, so a manager built
        # without one never inherits an earlier manager's
        self.injector = fault_injector
        im.fault_injector = fault_injector
        if self.res.host_tier_bytes:
            im.kv.attach_host_tier(self.res.host_tier_bytes)
        self.clock = clock or time.perf_counter
        self._sleep = time.sleep    # the retry backoff's wait
        # retries by site family ("step", "decode_scan", "kv_swap_in", ...)
        self.retries: Counter = collections.Counter()
        self.plan_health = plan_health
        if (plan_health is not None
                and getattr(plan_health, "kv_allocator", None) is None):
            plan_health.kv_allocator = im.kv
        self._health_ticks = 0
        self.slo = slo
        self.brownout = brownout
        if brownout is not None and slo is None:
            self.slo = brownout.policy
        self._brownout_ticks = 0
        if plan_health is not None:
            if getattr(plan_health, "slo", None) is None:
                plan_health.slo = self.slo
            if getattr(plan_health, "brownout", None) is None:
                plan_health.brownout = self.brownout
        # live plan migration (serve/migration.py): the controller polled
        # at every tick boundary, and the drain's gate that keeps new work
        # out of the slots while requests still queue
        self.migration = None
        self.admission_closed = False

    # ------------------------------------------------------------------
    def _sample_for(self, points, n_rows: int):
        """The sampling argument of a step: ``(seed, temperature, top_p,
        folds)`` with ``folds[row] = (rid, index of the token to draw)``
        for each sample point ``(row, rid)`` or ``(row, rid, offset)``,
        the index being ``len(generated)`` plus the offset (a verify
        row's tree depth, a chained segment's uncommitted tokens); None
        for greedy.  The key depends only on (seed, rid, token index), so
        a sampled stream does not depend on batching, preemption, retries
        or speculation (reference :324)."""
        if self.gen.temperature <= 0.0:
            return None
        folds = np.zeros((n_rows, 2), np.int32)
        for row, rid, *off in points:
            req = self.requests[rid]
            folds[row] = (req.rid & 0x7FFFFFFF,
                          len(req.generated) + (off[0] if off else 0))
        return (self.gen.seed, float(self.gen.temperature),
                float(self.gen.top_p), host_to_device(folds, self.im.device))

    def _read_back(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        """The host's wait for the device: ``tensors`` (integer or bool
        device values) copied back in one transfer, as int32 arrays of
        their shapes, counted in ``readbacks`` and as the profiler's
        ``host_syncs``, timed under its ``readback`` phase."""
        with self.profiler.phase("readback"):
            out = self._fetch(*tensors)
        self.profiler.host_sync()
        return out

    def _fetch(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        """The body of :meth:`_read_back`: one wait, counted in
        ``readbacks``."""
        self.readbacks += 1
        host = torch.cat([t.reshape(-1).to(torch.int32)
                          for t in tensors]).cpu().numpy()
        out, at = [], 0
        for t in tensors:
            out.append(host[at: at + t.numel()].reshape(tuple(t.shape)))
            at += t.numel()
        return out

    def kv_snapshot(self) -> Dict:
        """The deployment's KV view (reference :2169): the allocator's
        ``snapshot`` over the last observed depths."""
        return self.im.kv.snapshot()

    def _sync_kv(self) -> None:
        """Observe every live request's cache depth once a serve tick
        (reference :2178): the per-request peaks, the watermarks and the
        snapshot's gauges, published as ``kv_usage`` to live telemetry."""
        self.im.kv.observe(
            {r.rid: r.seq_len for r in self._active()
             if r.status in (RequestStatus.PREFILLING,
                             RequestStatus.DECODING)}, self.telemetry)

    def _seq_len_needed(self, req: Request) -> int:
        """Cache depth a request may reach (speculation adds headroom)."""
        return len(req.prompt) + req.max_new_tokens

    def _validate_request(self, req: Request) -> Optional[str]:
        if not req.prompt:
            return "empty prompt"
        if req.max_new_tokens < 0:
            return f"max_new_tokens {req.max_new_tokens} < 0"
        if len(req.prompt) > self.im.max_seq_len:
            return (f"prompt length {len(req.prompt)} exceeds max_seq_len "
                    f"{self.im.max_seq_len}")
        need = self._seq_len_needed(req)
        if need > self.im.max_seq_len:
            return (f"request needs {need} cache slots (prompt "
                    f"{len(req.prompt)} + max_new_tokens "
                    f"{req.max_new_tokens}), exceeds max_seq_len "
                    f"{self.im.max_seq_len}")
        return None

    def _admission_reason(self, req: Request) -> Optional[str]:
        """The capacity gate (reference :394): a bounded pending queue,
        and the worst-case cache need of every live request plus this one
        (whole pages under a paged cache) against the KV budget.  The
        rejection reason, or None to admit."""
        res = self.res
        if (res.max_pending is not None
                and len(self.pending) >= res.max_pending):
            return (f"pending queue full ({len(self.pending)} >= "
                    f"{res.max_pending})")
        reason = self._lane_admission_reason(req)
        if reason is not None:
            return reason
        if not res.kv_gate:
            return None
        per_tok = kv_bytes_per_token(self.im)
        if per_tok is None and res.kv_budget_bytes is not None:
            return ("kv_budget_bytes is a byte cap but the KV caches are "
                    "unallocated (no byte price); re-allocate caches or "
                    "gate with kv_headroom_frac")
        per_tok = per_tok or 1.0   # position units for the fraction gate
        kv = self.im.kv
        live = [self.requests[r] for r in self.pending] + [
            r for r in self._active()
            if r.status in (RequestStatus.PREFILLING, RequestStatus.DECODING)]
        committed = sum(kv.round_need(self._seq_len_needed(r))
                        for r in live + [req])
        cap_bytes = (res.kv_budget_bytes if res.kv_budget_bytes is not None
                     else res.kv_headroom_frac * kv.capacity_tokens * per_tok)
        if committed * per_tok > cap_bytes:
            return (f"KV headroom: {committed * per_tok / 2**20:.2f} MiB "
                    f"committed > {cap_bytes / 2**20:.2f} MiB budget")
        # the reserved lanes: each class's need charges its own
        # reservation first, only the overflow shares the pool
        return self._lane_reservation_reason(
            req, live, cap_bytes,
            lambda r: kv.round_need(self._seq_len_needed(r)) * per_tok)

    def _lane_reservation_reason(self, req: Request, live, budget: float,
                                 price) -> Optional[str]:
        """The per-class reserved-KV check (reference :461); None without
        a policy or when no class reserves anything."""
        slo = self.slo
        if slo is None or not any(c.kv_reservation_frac
                                  for c in slo.classes.values()):
            return None
        cls = slo.resolve(req.slo_class)
        if cls is None:
            return None
        by_cls: Dict[str, float] = {}
        for r in live:
            rc = slo.resolve(r.slo_class)
            key = rc.name if rc is not None else r.slo_class
            by_cls[key] = by_cls.get(key, 0.0) + price(r)
        return reservation_reason(slo, by_cls, cls, price(req), budget)

    def _lane_admission_reason(self, req: Request) -> Optional[str]:
        """The lane gates (reference :482): the brownout ladder's
        admission gate for degradable classes (a ``lane_shed``) and the
        per-class bounded queue; None without a policy."""
        if self.slo is None:
            return None
        cls = self.slo.resolve(req.slo_class)
        if cls is None:
            return None   # an unknown class is the caller's invalidity
        bo = self.brownout
        if bo is not None and not bo.admits(cls.name):
            if self.telemetry.enabled:
                self.telemetry.lane_shed(cls.name, trace_id=req.trace_id,
                                         reason=f"brownout:{bo.level.name}")
            return (f"brownout {bo.level.name}: class {cls.name!r} "
                    "admissions shed")
        if cls.max_pending is not None:
            depth = sum(1 for rid in self.pending
                        if self.requests[rid].slo_class == cls.name)
            if depth >= cls.max_pending:
                return (f"class {cls.name!r} pending queue full "
                        f"({depth} >= {cls.max_pending})")
        return None

    def register_new_request(self, prompt_tokens: Sequence[int],
                             max_new_tokens: Optional[int] = None, *,
                             priority: int = 0, ttl_s: Optional[float] = None,
                             deadline_s: Optional[float] = None,
                             reject_invalid: bool = False,
                             reject_reason: Optional[str] = None,
                             spec: Optional[bool] = None,
                             slo_class: Optional[str] = None) -> int:
        """Queue a request; returns its rid.

        An invalid shape (empty prompt, negative ``max_new_tokens``, a
        prompt or prompt + ``max_new_tokens`` past ``max_seq_len``) raises
        ``ValueError``, unless ``reject_invalid`` (the arrival loop's),
        which registers it ``REJECTED`` instead, as ``reject_reason`` does;
        admission control always rejects that way.  A rejected request
        keeps no prompt.  ``ttl_s`` (relative) or ``deadline_s`` (on the
        manager's clock) arm a deadline; ``max_new_tokens=0`` completes at
        once with an ``ok`` outcome.  ``priority``: higher admits first and
        may preempt lower under ``ResilienceConfig.preemption``.
        ``spec``: the request's speculation mode (None: the manager's
        ``default_spec_mode``), which only a SpecInferManager reads.
        ``slo_class``: its lane under an attached policy (None or "": the
        policy's default class; an unknown name is rejected like a bad
        shape); the class's priority band adds to ``priority``, and an
        in-force DEGRADE output cap truncates ``max_new_tokens``.
        """
        req = self.request_cls(-1, [int(t) for t in prompt_tokens],
                               self.gen.max_new_tokens
                               if max_new_tokens is None
                               else int(max_new_tokens))
        req.spec = bool(self.default_spec_mode if spec is None else spec)
        band = 0
        if self.slo is not None:
            cls = self.slo.resolve(slo_class)
            if cls is None:
                req.slo_class = str(slo_class)
            else:
                req.slo_class = cls.name
                band = cls.priority_band
        err = (reject_reason if reject_reason is not None
               else self._validate_request(req))
        if (err is None and self.slo is not None
                and self.slo.resolve(slo_class) is None):
            err = f"unknown slo_class {slo_class!r}"
        if err is not None and not reject_invalid:
            raise ValueError(err)
        req.rid = self._next_rid
        self._next_rid += 1
        req.trace_id = f"r{req.rid:05d}"
        req.priority = int(priority) + band
        self.requests[req.rid] = req
        tel = self.telemetry
        if tel.enabled:
            self._tstamps[req.rid] = {"enqueue": tel.request_enqueued(
                req.trace_id, prompt_len=len(req.prompt))}
        reason = err if err is not None else self._admission_reason(req)
        if reason is not None:
            req.status = RequestStatus.REJECTED
            req.outcome = "rejected"
            req.prompt = []   # shed load must not grow host memory
            if tel.enabled:
                tel.request_rejected(req.trace_id, reason=reason)
            return req.rid
        if req.max_new_tokens == 0:
            req.status = RequestStatus.COMPLETED
            req.outcome = "ok"
            if tel.enabled:
                tel.request_finished(req.trace_id, n_tokens=0,
                                     slo_class=req.slo_class or None)
            return req.rid
        if self.brownout is not None and self.brownout.degrades(
                req.slo_class):
            # DEGRADE in force: speculation off and the class's output cap
            # up front; counted only when something changed
            changed = req.spec
            req.spec = False
            cap = self.brownout.output_cap(req.slo_class)
            if cap is not None and cap < req.max_new_tokens:
                req.max_new_tokens = cap
                changed = True
            if changed and tel.enabled:
                tel.lane_degraded(req.slo_class)
        if deadline_s is not None:
            req.deadline_s = float(deadline_s)
        else:
            ttl = ttl_s if ttl_s is not None else self.res.default_ttl_s
            if ttl is not None:
                req.deadline_s = self.clock() + float(ttl)
        self.pending.append(req.rid)
        self._pending_since[req.rid] = self.steps
        return req.rid

    # ------------------------------------------------------------------
    # the lifecycle: cancel, deadlines, preemption, dispatch failure
    # ------------------------------------------------------------------
    def cancel(self, rid: int) -> bool:
        """Ask for ``rid``'s cancellation; returns whether it was live.  It
        lands at the next step boundary (``_check_lifecycle``), keeping the
        tokens already committed; a stretch in flight runs to its end
        (stretches are capped at ``lifecycle_quantum`` steps once the flag
        is visible)."""
        req = self.requests.get(rid)
        if req is None or req.status in TERMINAL_STATUSES:
            return False
        req.cancel_requested = True
        return True

    def set_spec_mode(self, rid: int, enabled: bool) -> bool:
        """Flip a live request's speculation mode (reference :639); returns
        whether it was live.  It takes effect at the next tick, so no
        committed token changes.  Inert under this manager; the
        SpecInferManager reacts in :meth:`_on_spec_flip`."""
        req = self.requests.get(rid)
        if req is None or req.status in TERMINAL_STATUSES:
            return False
        enabled = bool(enabled)
        if req.spec != enabled:
            req.spec = enabled
            self._on_spec_flip(req)
            if self.telemetry.enabled:
                self.telemetry.spec_mode_changed(req.trace_id, spec=enabled)
        return True

    def _on_spec_flip(self, req: Request) -> None:
        """Hook for a manager with per-mode state (reference :658)."""

    def _release_slot(self, req: Request) -> None:
        """Every slot-leaving path (completion, cancel, timeout, failure,
        preemption) releases the request's KV here; a request that never
        took a slot has nothing to release."""
        if req.slot < 0:
            return
        self.slots[req.slot] = None
        req.slot = -1
        req.kv_bytes = max(req.kv_bytes,
                           self.im.kv.release(req.rid, req.seq_len))

    def _terminate(self, req: Request, status: RequestStatus,
                   site: str = "") -> None:
        """Move a request to a terminal status, releasing its queue entry,
        slot, KV and host-tier pages; ``site`` names the dispatch site
        whose retries a ``FAILED`` request exhausted."""
        if req.rid in self.pending:
            self.pending.remove(req.rid)
        self._pending_since.pop(req.rid, None)
        self._release_slot(req)
        req.prefill_src = None
        self.im.kv.drop_spill(req.rid)
        req.status = status
        req.outcome = OUTCOMES[status]
        if status is RequestStatus.REJECTED:
            req.prompt = []
        tel = self.telemetry
        if tel.enabled:
            n = len(req.generated)
            if status is RequestStatus.CANCELLED:
                tel.request_cancelled(req.trace_id, n_tokens=n)
            elif status is RequestStatus.TIMED_OUT:
                tel.request_timed_out(req.trace_id, n_tokens=n)
            elif status is RequestStatus.REJECTED:
                tel.request_rejected(req.trace_id,
                                     reason=site or "brownout shed")
            elif status is RequestStatus.FAILED:
                tel.request_failed(req.trace_id, site=site)

    def _swap_clock(self, new_clock):
        """Switch the deadline clock, rebasing every live armed deadline so
        its remaining budget is kept; returns the previous clock."""
        old = self.clock
        if new_clock is old:
            return old
        live = [self.requests[r] for r in self.pending] + self._active()
        armed = [r for r in live if r.deadline_s is not None]
        if armed:
            old_now, new_now = old(), new_clock()
            for req in armed:
                req.deadline_s = new_now + (req.deadline_s - old_now)
        self.clock = new_clock
        return old

    def _check_lifecycle(self) -> None:
        """Step-boundary reaping of cancellations and expired deadlines
        over the live requests (queue and slots), and the retirement of a
        restored request's recompute feed once its catch-up prefill is
        done (``prefill_offset - n_prefed`` is the prompt-only offset an
        uninterrupted run would hold, so ``seq_len`` is unchanged)."""
        live = [self.requests[r] for r in self.pending] + self._active()
        for r in live:
            if (r.kv_restored and r.prefill_src is not None
                    and r.prefill_offset >= len(r.prefill_src)):
                r.prefill_offset -= r.n_prefed
                r.n_prefed = 0
                r.prefill_src = None
                r.kv_restored = False
        expirable = [r for r in live
                     if r.cancel_requested or r.deadline_s is not None]
        if not expirable:
            return
        now = self.clock()
        for req in expirable:
            if req.cancel_requested:
                self._terminate(req, RequestStatus.CANCELLED)
            elif now >= req.deadline_s:
                self._terminate(req, RequestStatus.TIMED_OUT)

    def preempt(self, rid: int) -> None:
        """Evict a running request: its written pages spill to the host
        tier when there is one, its slot and KV release, and it requeues
        (``PREEMPTED``) to re-prefill ``prompt + generated`` at
        readmission, after which it streams what an uninterrupted run
        streams."""
        req = self.requests[rid]
        if req.status not in (RequestStatus.PREFILLING,
                              RequestStatus.DECODING):
            raise ValueError(
                f"cannot preempt request {rid} in status {req.status.name}")
        self._kv_spill(req)
        self._release_slot(req)
        req.prefill_src = list(req.prompt) + list(req.generated)
        req.n_prefed = len(req.generated)
        req.prefill_offset = 0
        req.starved_steps = 0
        req.kv_restored = False
        req.status = RequestStatus.PREEMPTED
        req.preemptions += 1
        self.pending.append(rid)
        self._pending_since[rid] = self.steps
        if self.telemetry.enabled:
            self.telemetry.request_preempted(
                req.trace_id, recompute_tokens=len(req.prefill_src))

    def _rids_in_batch(self, bc) -> List[int]:
        """The rids with tokens in a built batch (a slotted request can
        sit a step out)."""
        base = bc.base if hasattr(bc, "base") else bc
        n = int(base.num_tokens)
        slots = {int(s) for s in base.request_index[:n].tolist() if s >= 0}
        return [self.slots[s] for s in sorted(slots)
                if self.slots[s] is not None]

    def _fail_inflight(self, site: str, affected_fn=None) -> None:
        """A dispatch exhausted its retries: requeue the affected requests
        for recompute (``on_dispatch_failure="requeue"``, at most
        ``max_requeues`` times each) or fail them; everyone else keeps
        serving.  ``affected_fn``: the rids in the failed dispatch
        (default: every running slotted request, exact for a stretch)."""
        affected = ([self.requests[rid] for rid in affected_fn()]
                    if affected_fn is not None else self._active())
        for req in affected:
            if req.status not in (RequestStatus.PREFILLING,
                                  RequestStatus.DECODING):
                continue
            if (self.res.on_dispatch_failure == "requeue"
                    and req.requeues < self.res.max_requeues):
                req.requeues += 1
                self.preempt(req.rid)
            else:
                self._terminate(req, RequestStatus.FAILED, site=site)

    def _guarded(self, site: str, fn, affected_fn=None, on_exhausted=None):
        """Run one dispatch under the retry policy (reference :863): a
        ``TransientServeError`` is retried with backoff up to
        ``res.retry.max_retries`` times, each retry counted in
        ``retries[site family]``.  Faults raise before any device work and
        KV writes are positional, so a retry replays identical compute.
        Returns ``fn()``, or None once the budget is spent, after
        ``on_exhausted()`` (default: the manager's ``on_exhausted`` hook,
        then, unless the hook took them, the affected requests are
        requeued or failed by ``_fail_inflight``); the serve loop goes
        on.  Each fault is a ``dispatch_fault`` event, each retry a
        ``dispatch_retry``."""
        pol = self.res.retry
        tel = self.telemetry
        attempt = 0
        while True:
            try:
                return fn()
            except TransientServeError as e:
                if tel.enabled:
                    tel.fault_observed(site, detail=str(e))
                if attempt >= pol.max_retries:
                    if on_exhausted is not None:
                        on_exhausted()
                    elif not (self.on_exhausted is not None
                              and self.on_exhausted(self, site, e,
                                                    affected_fn)):
                        self._fail_inflight(site, affected_fn)
                    return None
                attempt += 1
                self.retries[site.split(":")[0]] += 1
                delay = pol.backoff(attempt)
                if tel.enabled:
                    tel.dispatch_retry(site, attempt=attempt,
                                       backoff_s=delay)
                if delay > 0:
                    self._sleep(delay)

    def _prof_account(self, spans, passes: int = 1, logit_rows=None,
                      im=None) -> None:
        """The profiler's work for one dispatch (reference :900): each
        ``(rid, lo, hi)`` span feeds ``hi - lo`` tokens and reads the
        ``hi``-deep live prefix.  Host arithmetic only."""
        prof = self.profiler
        if not prof.enabled or not spans:
            return
        prof.account(prof.card_for(im or self.im),
                     [(rid, hi - lo, hi) for rid, lo, hi in spans],
                     passes=passes, logit_rows=logit_rows)

    # ------------------------------------------------------------------
    # admission: priority queue, slot-pressure preemption
    # ------------------------------------------------------------------
    def _held(self, req: Request) -> bool:
        """Is this queued request held out of the slots by the brownout
        ladder (DEFER, reference :925)?"""
        return (self.brownout is not None
                and self.brownout.holds(req.slo_class))

    def _eligible(self) -> List[int]:
        """The pending rids no brownout hold keeps out of the slots."""
        return [rid for rid in self.pending
                if not self._held(self.requests[rid])]

    def _pop_pending(self) -> Optional[int]:
        """The highest-priority eligible pending rid, FIFO within a
        priority; a request pending ``starvation_bound_ticks`` steps or
        more jumps every band (oldest first).  A held request's age
        restarts (a hold is not priority starvation).  None when every
        pending request is held."""
        cands = []
        for i, rid in enumerate(self.pending):
            if self._held(self.requests[rid]):
                self._pending_since[rid] = self.steps
            else:
                cands.append(i)
        if not cands:
            return None
        bound = self.starvation_bound_ticks
        if bound is not None:
            overdue = [i for i in cands
                       if self.steps - self._pending_since.setdefault(
                           self.pending[i], self.steps) >= bound]
            if overdue:
                best = min(overdue, key=lambda i: (
                    self._pending_since[self.pending[i]], i))
                self._pending_since.pop(self.pending[best], None)
                return self.pending.pop(best)
        best = max(cands,
                   key=lambda i: (self.requests[self.pending[i]].priority, -i))
        self._pending_since.pop(self.pending[best], None)
        return self.pending.pop(best)

    def _fill_slots(self) -> None:
        for i, occupant in enumerate(self.slots):
            if occupant is None and self.pending:
                rid = self._pop_pending()
                if rid is None:
                    break   # everything pending is brownout-held
                req = self.requests[rid]
                req.slot = i
                req.status = RequestStatus.PREFILLING
                self.slots[i] = req.rid
                self._kv_bind(req.rid)
                tel = self.telemetry
                if tel.enabled:
                    # once a request: a readmission is not an admission
                    ts = self._tstamps.setdefault(rid, {})
                    if "admit" not in ts:
                        ts["admit"] = tel.request_admitted(
                            req.trace_id,
                            queue_wait_s=(tel.now() - ts["enqueue"]
                                          if "enqueue" in ts else None))

    def _victims(self, priority: int, exclude: int = -1) -> List[Request]:
        """Decoding requests preemption may evict for one of
        ``priority``: strictly lower priority, under ``max_preemptions``."""
        return [r for r in self._active()
                if r.status is RequestStatus.DECODING and r.rid != exclude
                and r.priority < priority
                and r.preemptions < self.res.max_preemptions]

    def _try_preempt(self) -> bool:
        """Preempt the lowest-priority decoding request (newest first among
        equals) when a strictly higher-priority request waits and no slot
        is free; returns whether one was evicted."""
        if not self.pending or any(s is None for s in self.slots):
            return False
        eligible = self._eligible()   # a held request evicts no one
        if not eligible:
            return False
        victims = self._victims(max(self.requests[r].priority
                                    for r in eligible))
        if not victims:
            return False
        self.preempt(min(victims, key=lambda r: (r.priority, -r.rid)).rid)
        return True

    def _admit(self) -> None:
        """Fill free slots by priority; with preemption on, evict for a
        higher-priority request while one waits (each round admits into
        the freed slot or stops).  Nothing takes a slot while a migration
        drains (``admission_closed``)."""
        if self.admission_closed:
            return
        self._fill_slots()
        if self.res.preemption:
            for _ in range(len(self.slots)):
                if not self._try_preempt():
                    break
                self._fill_slots()

    def _active(self) -> List[Request]:
        return [self.requests[rid] for rid in self.slots if rid is not None]

    def has_work(self) -> bool:
        return bool(self.pending) or any(
            r.status in (RequestStatus.PREFILLING, RequestStatus.DECODING)
            for r in self._active())

    def _seq_lens(self) -> np.ndarray:
        seq_lens = np.zeros(self.im.max_requests, np.int32)
        for req in self._active():
            seq_lens[req.slot] = req.seq_len
        return seq_lens

    # ------------------------------------------------------------------
    # the KV cache: bind, prepare, spill and restore
    # ------------------------------------------------------------------
    def _kv_bind(self, rid: int) -> None:
        """A request took a slot.  Under a paged cache this is the
        prefix-reuse hook (reference :1982): ``bind`` maps the registered
        pages its feed matches and returns the tile-aligned cached offset,
        where the prefill starts (a readmitted request matches its own
        released pages); then a host-tier restore may move the start
        further."""
        req = self.requests[rid]
        kv = self.im.kv
        align = self.im.prefill_tile
        info = kv.bind(rid, slot=req.slot, tokens=req.prefill_tokens,
                       need=self._seq_len_needed(req), align=align)
        if info is None:
            return   # the slot-contiguous cache: nothing to reuse
        cached = info["cached_tokens"]
        if cached:
            req.prefill_offset = req.prefix_cached = cached
        restored = self._kv_restore(req, align)
        if restored > cached:
            req.prefill_offset = restored
            req.kv_restored = True
        tel = self.telemetry
        if tel.enabled:
            if cached:
                tel.prefix_cache_hit(req.trace_id, tokens_reused=cached,
                                     pages=int(info.get("hit_pages", 0)))
            else:
                tel.prefix_cache_miss(req.trace_id)

    def _kv_spill(self, req: Request) -> None:
        """Copy a victim's written pages to the host tier before its slot
        releases, under the retry policy at ``kv_swap_out:<rid>``; a spill
        that exhausts its retries is skipped (recompute covers it)."""
        kv = self.im.kv
        if kv.host_tier is None or req.slot < 0:
            return
        site = f"kv_swap_out:{req.rid}"
        tokens = list(req.prompt) + list(req.generated)

        def spill():
            if self.injector is not None:
                self.injector.maybe_fail(site)
            return kv.spill(req.rid, tokens)

        info = self._guarded(site, spill,
                             on_exhausted=lambda: kv.drop_spill(req.rid))
        if info and self.telemetry.enabled:
            self.telemetry.kv_spilled(req.trace_id, pages=info["pages"],
                                      nbytes=info["nbytes"],
                                      tokens=info["tokens"])

    def _kv_restore(self, req: Request, align: int) -> int:
        """Upload ``req``'s spilled pages after its readmission bind;
        returns the restored write frontier (0: nothing restored, the
        recompute feed covers everything).  Retried at
        ``kv_swap_in:<rid>``; a checksum miss
        (:class:`~.kv_paged.HostTierCorruption`) is not retried."""
        kv = self.im.kv
        if kv.host_tier is None or not kv.has_spill(req.rid):
            return 0
        site = f"kv_swap_in:{req.rid}"

        def restore():
            if self.injector is not None:
                self.injector.maybe_fail(site)
            return kv.restore(req.rid, align=align)

        tel = self.telemetry

        def exhausted():
            kv.drop_spill(req.rid)
            if tel.enabled:
                tel.kv_restore_failed(
                    req.trace_id, reason=f"retry budget exhausted at {site}")

        try:
            info = self._guarded(site, restore, on_exhausted=exhausted)
        except HostTierCorruption as e:
            kv.drop_spill(req.rid)   # the damaged copy goes: recompute
            if tel.enabled:
                tel.kv_restore_failed(req.trace_id, reason=str(e))
            return 0
        if not info:
            return 0
        if tel.enabled:
            tel.kv_restored(req.trace_id, pages=info["pages"],
                            nbytes=info["nbytes"],
                            tokens_resumed=info["restored_tokens"],
                            tokens_saved=info["tokens_saved"])
        return int(info["restored_tokens"])

    def _kv_prepare(self, spans, kv=None) -> None:
        """Make the cache writable at every ``(rid, lo, hi)`` span the
        next dispatch writes, before it runs (reference :2120): a paged
        allocator maps missing pages and copy-on-writes shared ones here,
        so the table is constant while the device works; a no-op for the
        slot-contiguous allocator.  An exhausted pool preempts the
        lowest-priority decoding request strictly below the span's owner
        (newest first among equals) and retries; with no such victim the
        exhaustion propagates."""
        kv = kv if kv is not None else self.im.kv
        if not kv.paged:
            return
        for rid, lo, hi in spans:
            for _ in range(len(self.slots) + 1):
                try:
                    kv.prepare_write(rid, lo, hi)
                    break
                except PagePoolExhausted:
                    victim = self._page_pressure_victim(rid)
                    if victim is None:
                        raise
                    self.preempt(victim.rid)

    def _page_pressure_victim(self, needer_rid: int) -> Optional[Request]:
        """The request page pressure evicts for ``needer_rid`` (reference
        :2149): as slot pressure, strictly lower priority only; None when
        preemption is off or nothing qualifies."""
        if not self.res.preemption:
            return None
        victims = self._victims(self.requests[needer_rid].priority,
                                exclude=needer_rid)
        if not victims:
            return None
        return min(victims, key=lambda r: (r.priority, -r.rid))

    # ------------------------------------------------------------------
    def prepare_next_batch(self) -> Tuple[object, List[Tuple[int, int]]]:
        """Admit, then build the next step's batch.  Returns ``(bc,
        sample_points)`` with ``sample_points = [(flat index, rid)]`` the
        slots whose output is that request's next token.  The
        profiler times admission as ``host_admit`` and the build as
        ``host_prepare``."""
        with self.profiler.phase("host_admit"):
            self._admit()
        with self.profiler.phase("host_prepare"):
            return self._build_next_batch()

    def _build_next_batch(self):
        im = self.im
        tokens: List[int] = []
        req_idx: List[int] = []
        positions: List[int] = []
        sample_points: List[Tuple[int, int]] = []
        budget = im.max_tokens

        # decode tokens first: one per DECODING request
        for req in self._active():
            if req.status is RequestStatus.DECODING and budget > 0:
                tokens.append(req.generated[-1])
                req_idx.append(req.slot)
                positions.append(req.seq_len - 1)
                sample_points.append((len(tokens) - 1, req.rid))
                budget -= 1
        n_decode = len(tokens)

        # a pure-prefill step ships tile-aligned chunks to the tiled
        # prefill kernel; mixed decode+prefill steps keep the flat layout
        tile = im.prefill_tile
        prefilling = [r for r in self._active()
                      if r.status is RequestStatus.PREFILLING]
        if (not tokens and tile > 1 and prefilling
                and all(r.prefill_offset % tile == 0 for r in prefilling)):
            segments, spans = [], []
            for req in prefilling:
                if budget < tile:
                    continue
                feed = req.prefill_tokens
                take = min((budget // tile) * tile,
                           len(feed) - req.prefill_offset)
                start = req.prefill_offset
                segments.append((req.slot, feed[start: start + take], start))
                spans.append((req.rid, start, start + take))
                req.prefill_offset += take
                req.starved_steps = 0
                budget -= -(-take // tile) * tile
                if req.prefill_offset == len(feed):
                    sample_points.append((req.slot, req.rid))
            self._kv_prepare(spans)
            # a gated chunk's results are indexed by slot (reference
            # :1115-1135)
            gate = im.gate_lm_head
            seq_lens = self._seq_lens()
            pbc, last_flat = PrefillBatchConfig.build(
                segments, seq_lens, tile,
                max_tokens=im.max_tokens, max_requests=im.max_requests,
                device=im.device,
                gate_slots=([slot for slot, _ in sample_points] if gate
                            else None))
            self._prof_account(
                spans, logit_rows=len(sample_points) if gate else None)
            self._note_batch(0, sum(len(s[1]) for s in segments), seq_lens)
            return pbc, [(slot if gate else last_flat[slot], rid)
                         for slot, rid in sample_points]

        # then prefill chunks fill the remaining budget; mid-prompt cuts
        # keep prefill_offset tile-aligned so later pure-prefill steps can
        # take the tiled path (completing takes need no rounding)
        for req in prefilling:
            if budget <= 0:
                continue
            feed = req.prefill_tokens
            remaining = len(feed) - req.prefill_offset
            if remaining <= budget:
                take = remaining
            elif tile > 1 and req.prefill_offset % tile == 0:
                take = (budget // tile) * tile
                if take == 0:
                    # less than a tile of budget: wait to keep alignment,
                    # unless decode tokens leave less than a tile every
                    # step — then take an unaligned flat chunk after
                    # starvation_limit dry steps so the prompt progresses
                    req.starved_steps += 1
                    if req.starved_steps < self.starvation_limit:
                        continue
                    take = budget
            else:
                take = budget
                if tile > 1 and budget >= tile:
                    # an off-tile offset blocks the tiled path for every
                    # prefilling request: round this take so the offset
                    # lands back on a tile boundary
                    over = (req.prefill_offset + take) % tile
                    if 0 < over < take:
                        take -= over
            start = req.prefill_offset
            tokens.extend(feed[start: start + take])
            req_idx.extend([req.slot] * take)
            positions.extend(range(start, start + take))
            req.prefill_offset += take
            req.starved_steps = 0
            budget -= take
            if req.prefill_offset == len(feed):
                sample_points.append((len(tokens) - 1, req.rid))

        written: Dict[int, Tuple[int, int]] = {}   # slot -> [lo, hi)
        for slot, p in zip(req_idx, positions):
            lo, hi = written.get(slot, (p, p + 1))
            written[slot] = (min(lo, p), max(hi, p + 1))
        # the depths are read before the prepare: a page-pressure victim
        # leaves its slot there, and its row's output is dropped
        seq_lens = self._seq_lens()
        spans = [(self.slots[slot], lo, hi)
                 for slot, (lo, hi) in written.items()]
        self._kv_prepare(spans)
        bc = BatchConfig.build(tokens, req_idx, positions, seq_lens,
                               max_tokens=im.max_tokens,
                               max_requests=im.max_requests, device=im.device)
        self._prof_account(spans)
        self._note_batch(n_decode, len(tokens) - n_decode, seq_lens)
        return bc, sample_points

    def _note_batch(self, n_decode: int, n_prefill: int, seq_lens) -> None:
        """One step's batch mix for the telemetry (reference :1217):
        token split, slot occupancy, KV utilization."""
        tel = self.telemetry
        if not tel.enabled:
            return
        tel.batch_composition(
            n_decode, n_prefill,
            active_requests=sum(1 for s in self.slots if s is not None),
            max_requests=self.im.max_requests,
            kv_tokens=int(np.sum(seq_lens)),
            kv_capacity=self.im.max_requests * self.im.max_seq_len)

    # ------------------------------------------------------------------
    def _append_token(self, req: Request, tok: int) -> None:
        """Commit one generated token: the one place the first-token
        (TTFT) stamp lives, whatever path produced it."""
        req.generated.append(tok)
        self.tokens_decoded += 1
        tel = self.telemetry
        if tel.enabled and len(req.generated) == 1:
            ts = self._tstamps.setdefault(req.rid, {})
            ts["first_token"] = tel.request_first_token(
                req.trace_id,
                ttft_s=(tel.now() - ts["enqueue"]
                        if "enqueue" in ts else None),
                slo_class=req.slo_class or None)

    def process_result(self, result, sample_points) -> None:
        if not sample_points:
            return   # mid-prompt step: nothing to read back
        token_ids, = self._read_back(result.token_ids)
        for flat_idx, rid in sample_points:
            req = self.requests[rid]
            if req.status not in (RequestStatus.PREFILLING,
                                  RequestStatus.DECODING):
                # it left its slot between batch build and read-back (page
                # pressure preempted it): the readmission recomputes it
                continue
            if req.status is RequestStatus.PREFILLING:
                req.status = RequestStatus.DECODING
            self._append_token(req, int(token_ids[flat_idx]))
            self._maybe_finish(req)

    def _maybe_finish(self, req: Request) -> None:
        eos = self.gen.eos_token_id
        if (len(req.generated) >= req.max_new_tokens
                or (self.gen.stop_on_eos and eos is not None
                    and req.generated[-1] == eos)):
            req.status = RequestStatus.COMPLETED
            req.outcome = "ok"
            req.prefill_src = None
            self._release_slot(req)
            tel = self.telemetry
            if tel.enabled:
                ts = self._tstamps.get(req.rid, {})
                now = tel.now()
                first = ts.get("first_token")
                tel.request_finished(
                    req.trace_id, n_tokens=len(req.generated),
                    tpot_s=((now - first) / max(len(req.generated) - 1, 1)
                            if first is not None else None),
                    kv_bytes=req.kv_bytes or None,
                    slo_class=req.slo_class or None)

    # ------------------------------------------------------------------
    def _scan_steps_possible(self) -> int:
        """Decode steps the next stretch (or its first segment) may run on
        the device: > 1 only when every active request decodes and
        pending work could not be admitted now anyway: no slot is free
        and no preemption would fire (reference :1308-1323; unchained,
        any pending work blocks).  Bounded by the smallest remaining
        budget (a chain extends it to the largest), the cache's room, and
        ``lifecycle_quantum`` while a deadline or cancel is armed, and
        rounded down to a power of two, as the reference's (its compile
        classes): eager launches compile nothing, but the same rounding
        gives the same schedule, so every telemetry event and work
        counter equals the reference's tick for tick."""
        active = self._active()
        if (not active
                or any(r.status is not RequestStatus.DECODING
                       for r in active)):
            return 0
        chained = self.chain_segments and not self.admission_closed
        if self._eligible() and (not chained
                                 or any(s is None for s in self.slots)
                                 or self._preempt_would_fire()):
            return 0   # (a brownout-held queue waits regardless)
        n = min(r.max_new_tokens - len(r.generated) for r in active)
        n = min(n, self.scan_chunk,
                self.im.max_seq_len - max(r.seq_len for r in active) + 1)
        if any(r.deadline_s is not None or r.cancel_requested
               for r in active):
            n = min(n, self.lifecycle_quantum)
        if n > 1:
            n = 1 << (n.bit_length() - 1)
        return n

    def _preempt_would_fire(self) -> bool:
        """Would ``_try_preempt`` evict a row for the queue now (reference
        :1343)?  Such work goes to the per-step path: a chained stretch
        must not preempt a row the device is decoding."""
        eligible = self._eligible()
        if not self.res.preemption or not eligible:
            return False
        return bool(self._victims(max(self.requests[r].priority
                                      for r in eligible)))

    def _prefill_stretch_possible(self) -> bool:
        """Can the whole prefill wave run as tiled steps (reference
        :1400-1411)?  True when the manager has a ``prefill_scan`` (a
        pipelined one has none: it prefills chunk by chunk through
        ``step``), every active request is prefilling at a tile-aligned
        offset (no decode latency to protect) and some still has prompt
        left."""
        with self.profiler.phase("host_admit"):
            self._admit()
        active = self._active()
        tile = self.im.prefill_tile
        return (tile > 1 and hasattr(self.im, "prefill_scan")
                and bool(active)
                and all(r.status is RequestStatus.PREFILLING
                        and r.prefill_offset % tile == 0 for r in active)
                and any(r.prefill_offset < len(r.prefill_tokens)
                        for r in active))

    def _prefill_stretch(self) -> None:
        """Feed every active request's remaining prefill as single-request
        tiled chunks (reference :1414): ``prefill_scan`` dispatches of a
        power of two chunks each, issued back to back, then the first
        tokens read back at the end, one read-back a dispatch.  The
        offsets advance only after every dispatch succeeds, so a retry
        replays a dispatch from its first chunk."""
        im = self.im
        tile = im.prefill_tile
        active = self._active()
        self._kv_prepare([(r.rid, r.prefill_offset, len(r.prefill_tokens))
                          for r in active])
        # gated chunks compute logits at their completing prompt's last
        # token only, results indexed by slot (reference :1428-1490)
        gate = im.gate_lm_head
        n_rows = im.max_requests if gate else im.max_tokens
        seq = self._seq_lens()
        chunks, samples = [], []
        points = []   # (req, its last chunk, result index)
        for req in active:
            feed = req.prefill_tokens
            start = req.prefill_offset
            while start < len(feed):
                take = min((im.max_tokens // tile) * tile, len(feed) - start)
                seq[req.slot] = start + take
                done = start + take == len(feed)
                pbc, last_flat = PrefillBatchConfig.build(
                    [(req.slot, feed[start: start + take], start)],
                    seq, tile, max_tokens=im.max_tokens,
                    max_requests=im.max_requests, device=im.device,
                    gate_slots=([req.slot] if done else []) if gate
                    else None)
                # one model pass a chunk; a gated chunk's logits only at
                # its completing prompt's slot
                self._prof_account(
                    [(req.rid, start, start + take)],
                    logit_rows=(1 if done else 0) if gate else None)
                start += take
                idx = req.slot if gate else last_flat[req.slot]
                samples.append(self._sample_for(
                    [(idx, req.rid)] if done else [], n_rows))
                chunks.append(pbc)
                if done:
                    points.append((req, len(chunks) - 1, idx))
        # segments of a power of two chunks (at most 64), one dispatch
        # each, as the reference's scans (:1480): the same dispatches and
        # the same telemetry
        outs, at = [], 0
        while at < len(chunks):
            seg = 1 << (min(len(chunks) - at, 64).bit_length() - 1)
            toks = self._guarded(
                "prefill_scan",
                lambda a=at, n=seg: im.prefill_scan(chunks[a: a + n],
                                                    samples[a: a + n]))
            if toks is None:
                return   # requeued or failed: their offsets never moved
            outs.append((at, toks))
            at += seg
        self.steps += len(chunks)
        for req in active:
            req.prefill_offset = len(req.prefill_tokens)
        # every segment's first tokens are read back at the end, a
        # segment at a time: one phase, a host sync each (reference :1512)
        firsts = []
        with self.profiler.phase("readback"):
            for a, toks in outs:
                mine = [(c - a, f) for _, c, f in points
                        if a <= c < a + toks.shape[0]]
                vals, = self._fetch(toks[[c for c, _ in mine],
                                         [f for _, f in mine]])
                firsts += list(vals)
        self.profiler.host_sync(len(outs))
        for (req, _, _), tok in zip(points, firsts):
            req.status = RequestStatus.DECODING
            self._append_token(req, int(tok))
            self._maybe_finish(req)

    def _decode_stretch(self, n: int) -> None:
        """One decode stretch, one read-back (reference :1526).  With
        ``chain_segments`` it is a chain of ``decode_scan_async``
        segments issued back to back, ``n`` steps first, extended while
        any row has budget left, up to ``scan_chunk`` steps in all:

        * rows of unequal budgets ride one stretch: each freezes on the
          device at its own budget and reports an exit code
          (``last_exit_codes``);
        * cancels and armed deadlines are checked on the host's clock
          between segments, which ``lifecycle_quantum`` bounds;
        * arrivals the pump registers join the running batch at a
          segment boundary while a slot is free (``_stretch_join``);
        * a later segment's pages are prepared without preemption
          (``_kv_prepare_nopreempt``); a shortfall ends the stretch.

        Everything is read back once, at the end, and committed in
        dispatch order, with the per-step loop's folds and masks: the
        streams are the unchained streams."""
        if not self.chain_segments:
            return self._decode_stretch_single(n)
        im = self.im
        eos = self.gen.eos_token_id if self.gen.stop_on_eos else None
        # the first segment's spans before the batch is built: a
        # page-pressure victim leaves it
        self._kv_prepare([(r.rid, r.seq_len - 1, r.seq_len - 1 + n)
                          for r in self._active()])
        active = [r for r in self._active()
                  if r.status is RequestStatus.DECODING]
        if not active:
            return
        prof = self.profiler
        with prof.phase("host_prepare"):
            rows = [(req, flat) for flat, req in enumerate(active)]
            sched = {r.rid: 0 for r in active}   # tokens issued, uncommitted
            dev_seq = {r.rid: r.seq_len for r in active}   # device depth
            bc = BatchConfig.build(
                [r.generated[-1] for r in active], [r.slot for r in active],
                [r.seq_len - 1 for r in active], self._seq_lens(),
                max_tokens=im.max_tokens, max_requests=im.max_requests,
                device=im.device)

        def remaining(req):
            return req.max_new_tokens - len(req.generated) - sched[req.rid]

        # ("scan", steps, [(flat, rid)], tokens, live, codes) per segment,
        # ("join", req, token source, index) per joiner: device values
        # until the read-back
        commits: List[Tuple] = []
        total = segments = 0
        seg = n
        while True:
            allowed = np.zeros(im.max_tokens, np.int32)
            ks = {}
            for req, flat in rows:
                ks[req.rid] = max(min(seg, remaining(req)), 0)
                # the row's whole budget, not the segment's: a row that
                # outlives the segment ends it running, not at its budget
                allowed[flat] = max(remaining(req), 0)
            if prof.enabled:
                # k decode steps a row: each streams the weights and reads
                # the growing live prefix
                prof.account(
                    prof.card_for(im),
                    [(req.rid, ks[req.rid],
                      ks[req.rid] * dev_seq[req.rid]
                      + ks[req.rid] * (ks[req.rid] - 1) // 2)
                     for req, _ in rows if ks[req.rid] > 0],
                    passes=seg)
            smp = self._sample_for(
                [(flat, req.rid, sched[req.rid]) for req, flat in rows],
                im.max_tokens)
            max_pos = max(dev_seq[r.rid] - 1 + ks[r.rid]
                          for r, _ in rows) - seg
            this_seg = seg
            out = self._guarded("decode_scan", lambda: im.decode_scan_async(
                bc, this_seg, eos=eos, sample=smp,
                allowed=host_to_device(allowed, im.device),
                max_position=max_pos))
            if out is None:
                # nothing was committed: the requeued requests recompute
                # every token of the stretch
                self.scan_runs += 1
                return
            toks, live, codes, bc = out
            commits.append(("scan", this_seg,
                            [(flat, req.rid) for req, flat in rows],
                            toks, live, codes))
            for req, _ in rows:
                sched[req.rid] += ks[req.rid]
                dev_seq[req.rid] += ks[req.rid]
            total += this_seg
            segments += 1

            # ---- segment boundary: stop, join, or extend ----
            reqs = [req for req, _ in rows]
            if any(r.cancel_requested for r in reqs):
                break                 # reaped at the tick boundary
            if any(r.slot < 0 or self.slots[r.slot] != r.rid for r in reqs):
                break                 # a clock callback took a row out
            if self._arrival_pump is not None:
                with prof.phase("host_admit"):
                    self._arrival_pump()
            rem_cap = self.scan_chunk - total
            if rem_cap < 2:
                break
            if (self.pending and not self.admission_closed
                    and len(rows) < im.max_tokens
                    and any(s is None for s in self.slots)
                    and self._eligible()):
                bc = self._stretch_join(bc, rows, sched, dev_seq, commits,
                                        eos)
            armed = [r.deadline_s for r, _ in rows if r.deadline_s is not None]
            if armed and self.clock() >= min(armed):
                break
            rem_max = max(remaining(req) for req, _ in rows)
            if rem_max < 2:
                break   # a one-step trailer rides the next tick
            # rounded to a power of two as the reference's segments are
            # (see _scan_steps_possible)
            seg = min(rem_cap, rem_max)
            if armed:
                seg = min(seg, self.lifecycle_quantum)
            seg = 1 << (seg.bit_length() - 1)
            if seg < 2:
                break
            spans = [(req.rid, dev_seq[req.rid] - 1,
                      dev_seq[req.rid] - 1 + min(seg, remaining(req)))
                     for req, _ in rows if remaining(req) > 0]
            if not self._kv_prepare_nopreempt(spans):
                break   # page pressure resolves on the per-step path

        # ---- the one read-back, then the commits in dispatch order ----
        values = []
        for item in commits:
            values += (list(item[3:]) if item[0] == "scan"
                       else [item[2][item[3]]])
        host = iter(self._read_back(*values))
        codes_by_rid: Dict[int, int] = {}
        for item in commits:
            if item[0] == "join":
                req, tok = item[1], int(next(host))
                if req.status not in (RequestStatus.PREFILLING,
                                      RequestStatus.DECODING):
                    continue   # left its slot: the readmission recomputes
                req.status = RequestStatus.DECODING
                self._append_token(req, tok)
                self._maybe_finish(req)
                continue
            steps, pts = item[1], item[2]
            toks, live, codes = next(host), next(host), next(host)
            for s in range(steps):
                for flat, rid in pts:
                    req = self.requests[rid]
                    if req.status is RequestStatus.DECODING and live[s, flat]:
                        self._append_token(req, int(toks[s, flat]))
                        self._maybe_finish(req)
            for flat, rid in pts:
                if codes[flat] != EXIT_NOT_IN_BATCH:
                    codes_by_rid[rid] = int(codes[flat])
        self.last_exit_codes = codes_by_rid
        self.last_stretch = {
            "steps": total, "segments": segments,
            "joins": sum(item[0] == "join" for item in commits)}
        self.steps += total
        self.scan_runs += 1
        if prof.enabled:
            prof.note(decode_quantum=n, stretch_steps=total,
                      stretch_segments=segments,
                      stretch_joins=self.last_stretch["joins"])

    def _stretch_join(self, bc, rows, sched, dev_seq, commits, eos):
        """Admit pending arrivals into the running stretch (reference
        :1737): fill the free slots, prefill each joiner's prompt as flat
        steps whose results stay on the device, and splice its first
        token into the batch with ``join_slot``; the device decodes it
        from the next segment on.  A joiner whose pages or prefill fail
        goes back to the queue (``_unjoin``)."""
        im = self.im
        with self.profiler.phase("host_admit"):
            before = set(self.slots)
            self._fill_slots()
            newly = [r for r in self.slots
                     if r is not None and r not in before]
        joined = []
        for rid in newly:
            req = self.requests[rid]
            if len(rows) >= im.max_tokens:
                continue   # stays slotted: it prefills on the next tick
            out = self._stretch_prefill(req, rows, dev_seq)
            if out is None:
                if (req.status is RequestStatus.PREFILLING and req.slot >= 0
                        and self.slots[req.slot] == req.rid):
                    self._unjoin(req)
                continue
            tok_src, src = out
            joined.append(rid)
            commits.append(("join", req, tok_src, src))
            if req.max_new_tokens - len(req.generated) <= 1:
                continue   # its first token is its whole budget
            n_prompt = len(req.prefill_tokens)
            dst = len(rows)
            bc = im.join_slot(bc, tok_src, src, dst, req.slot, n_prompt,
                              n_prompt + 1, dst + 1, eos=eos)
            rows.append((req, dst))
            sched[req.rid] = 1
            dev_seq[req.rid] = n_prompt + 1
        if joined:
            if self._join_stamp is not None:
                self._join_stamp(joined)
            if self.telemetry.enabled:
                self.telemetry.metrics.counter("stretch_joins").inc(
                    len(joined))
        return bc

    def _stretch_prefill(self, req: Request, rows, dev_seq):
        """Feed a joiner's remaining prompt as flat steps (reference
        :1787); returns ``(token_ids, index)`` of its first generated
        token, a device value, or None when its pages or a dispatch
        failed (the retry guard has then requeued or failed it)."""
        im = self.im
        feed = req.prefill_tokens
        if not self._kv_prepare_nopreempt(
                [(req.rid, req.prefill_offset, len(feed))]):
            return None
        out = None
        while req.prefill_offset < len(feed):
            start = req.prefill_offset
            take = min(im.max_tokens, len(feed) - start)
            with self.profiler.phase("host_prepare"):
                # the running rows' depths are the device's, ahead of the
                # host
                seq_lens = np.zeros(im.max_requests, np.int32)
                for r2, _ in rows:
                    seq_lens[r2.slot] = dev_seq[r2.rid]
                seq_lens[req.slot] = start + take
                bc = BatchConfig.build(
                    feed[start: start + take], [req.slot] * take,
                    range(start, start + take), seq_lens,
                    max_tokens=im.max_tokens, max_requests=im.max_requests,
                    device=im.device)
            smp = (self._sample_for([(take - 1, req.rid)], im.max_tokens)
                   if start + take == len(feed) else None)
            self._prof_account([(req.rid, start, start + take)])
            res = self._guarded(
                "step", lambda b=bc, s=smp: im.step(b, sample=s),
                affected_fn=lambda: [req.rid])
            if res is None:
                return None
            req.prefill_offset = start + take
            out = (res.token_ids, take - 1)
        return out

    def _unjoin(self, req: Request) -> None:
        """Back a failed join out to the head of the queue (reference
        :1834): the per-step path readmits it with the preemption the
        stretch must not run."""
        self._release_slot(req)
        req.prefill_offset = 0
        req.status = (RequestStatus.PREEMPTED if req.preemptions
                      else RequestStatus.PENDING)
        self.pending.insert(0, req.rid)
        self._pending_since.setdefault(req.rid, self.steps)

    def _kv_prepare_nopreempt(self, spans) -> bool:
        """Pages for a dispatch inside a running chain (reference :1846):
        no preemption (its victim would be a row the device decodes);
        False when the pool runs out."""
        kv = self.im.kv
        if not kv.paged:
            return True
        try:
            for rid, lo, hi in spans:
                kv.prepare_write(rid, lo, hi)
        except PagePoolExhausted:
            return False
        return True

    def _decode_stretch_single(self, n: int) -> None:
        """``n`` decode steps as one ``decode_scan``, one read-back: the
        ``chain_segments=False`` stretch (reference :1864).  The stretch
        writes n positions per request with no host boundary in between,
        so the whole span is prepared up front, before the batch is
        built: a page-pressure victim leaves it."""
        im = self.im
        self._kv_prepare([(r.rid, r.seq_len - 1, r.seq_len - 1 + n)
                          for r in self._active()])
        active = [r for r in self._active()
                  if r.status is RequestStatus.DECODING]
        if not active:
            return
        prof = self.profiler
        with prof.phase("host_prepare"):
            rids = [r.rid for r in active]
            bc = BatchConfig.build(
                [r.generated[-1] for r in active], [r.slot for r in active],
                [r.seq_len - 1 for r in active], self._seq_lens(),
                max_tokens=im.max_tokens, max_requests=im.max_requests,
                device=im.device)
        if prof.enabled:
            # n decode steps: each streams the weights and reads the
            # growing live prefix
            prof.account(prof.card_for(im),
                         [(r.rid, n, n * r.seq_len + n * (n - 1) // 2)
                          for r in active], passes=n)
        eos = self.gen.eos_token_id if self.gen.stop_on_eos else None
        allowed = np.zeros(im.max_tokens, np.int32)
        allowed[:len(active)] = [r.max_new_tokens - len(r.generated)
                                 for r in active]
        smp = self._sample_for(enumerate(rids), im.max_tokens)
        out = self._guarded("decode_scan", lambda: im.decode_scan(
            bc, n, eos=eos, sample=smp,
            max_position=max(r.seq_len - 1 for r in active),
            allowed=host_to_device(allowed, im.device)))
        self.scan_runs += 1
        if out is None:
            return
        toks, live = self._read_back(out[0], out[1])
        for s in range(n):
            for flat, rid in enumerate(rids):
                req = self.requests[rid]
                if req.status is RequestStatus.DECODING and live[s, flat]:
                    self._append_token(req, int(toks[s, flat]))
                    self._maybe_finish(req)
        self.steps += n
        if prof.enabled:
            prof.note(decode_quantum=n, stretch_steps=n,
                      stretch_segments=1, stretch_joins=0)

    def _serve_tick(self) -> None:
        """One scheduling decision: a prefill stretch, a decode stretch,
        or one mixed step, each under the retry guard and in its telemetry
        span (reference :1932)."""
        tel = self.telemetry
        if self._prefill_stretch_possible():
            with tel.span("prefill_stretch", cat="serve"):
                self._prefill_stretch()
            return
        n = self._scan_steps_possible()
        if n > 1:
            with tel.span("decode_stretch", cat="serve", steps=n):
                self._decode_stretch(n)
            return
        with tel.span("serve_step", cat="serve"):
            bc, sample_points = self.prepare_next_batch()
            gated = getattr(bc, "logit_slots", None) is not None
            smp = self._sample_for(sample_points, self.im.max_requests
                                   if gated else self.im.max_tokens)
            result = self._guarded(
                "step", lambda: self.im.step(bc, sample=smp),
                affected_fn=lambda: self._rids_in_batch(bc))
            if result is not None:
                self.process_result(result, sample_points)
            self.steps += 1

    def _tick(self) -> None:
        """One serving tick (the speculative manager overrides it)."""
        self._serve_tick()

    def serve_incr_decoding(self) -> Dict[int, List[int]]:
        """Serve until every request is terminal, reaping cancellations
        and deadlines at every step boundary; ``{rid: tokens}``.  Each
        tick is the profiler's, then the KV gauges, the plan-health check
        and the brownout ladder run at its boundary (reference :2574)."""
        while True:
            self._check_lifecycle()
            if not self.has_work():
                new_rm = self._maybe_migrate(idle=True)
                if new_rm is not None:
                    return new_rm.serve_incr_decoding()
                break
            self.profiler.tick_begin()
            self._tick()
            self.profiler.tick_end()
            self._sync_kv()
            self._maybe_check_health()
            self._maybe_brownout()
            new_rm = self._maybe_migrate()
            if new_rm is not None:
                return new_rm.serve_incr_decoding()
        self._maybe_check_health(force=True)
        return {rid: r.generated for rid, r in self.requests.items()}

    def _maybe_migrate(self, idle: bool = False):
        """The attached migration controller's slot at a tick boundary
        (reference :2311): the successor manager when a plan switch
        committed here (the serve loop hands the run over to it), else
        None.  ``idle``: the loop has no work, so a staged migration runs
        at once (nothing to preempt)."""
        if self.migration is None:
            return None
        new_rm = self.migration.tick(self, idle=idle)
        return new_rm if new_rm is not None and new_rm is not self else None

    def trace_run_meta(self) -> Dict:
        """The header a traffic trace (:mod:`..obs.replay`) records for
        this deployment (reference :2323): the generation config with its
        seed, the plan key and engine shape, the fault injector's
        schedule and the SLO policy, what a replay needs to rebuild the
        same run."""
        from ..obs.replay import engine_shape_of, injector_meta

        meta: Dict = {
            "driver": type(self).__name__,
            "gen": dataclasses.asdict(self.gen),
            "plan": engine_shape_of(self.im),
            "fault": injector_meta(self.injector),
        }
        if self.slo is not None and hasattr(self.slo, "snapshot"):
            meta["slo"] = self.slo.snapshot()
        return meta

    def _maybe_check_health(self, force: bool = False) -> None:
        """Check the attached plan-health monitor every
        ``health_check_every`` ticks, and once when a loop drains
        (``force``; reference :2191)."""
        if self.plan_health is None:
            return
        self._health_ticks += 1
        if force or self._health_ticks % self.health_check_every == 0:
            self.plan_health.check()

    def apply_output_cap(self, rid: int, cap: int) -> bool:
        """Cap a live request's ``max_new_tokens`` (DEGRADE, reference
        :2201): its stream stays a prefix of the uncapped one; a request
        at or past the cap completes here with an ``ok`` outcome.
        Returns whether the cap shortened it."""
        req = self.requests.get(rid)
        if req is None or req.status in TERMINAL_STATUSES:
            return False
        new_max = max(int(cap), len(req.generated))
        if new_max >= req.max_new_tokens:
            return False
        req.max_new_tokens = new_max
        if (req.status is RequestStatus.DECODING
                and len(req.generated) >= req.max_new_tokens):
            self._maybe_finish(req)
        return True

    def _maybe_brownout(self) -> None:
        """Evaluate the attached BrownoutController every
        ``config.check_every`` ticks and apply its level at this tick
        boundary (reference :2219): shed or hold queued degradable work,
        spill degradable decoders' pages under KV pressure (host tier
        attached), shed live degradable work at CRITICAL_ONLY, or turn
        speculation off and cap outputs at DEGRADE."""
        bo = self.brownout
        if bo is None:
            return
        self._brownout_ticks += 1
        if self._brownout_ticks % bo.config.check_every:
            return
        slo = self.slo
        tel = self.telemetry
        kv = self.im.kv
        occ = (kv.live_tokens() / kv.capacity_tokens
               if kv.capacity_tokens else 0.0)
        depths: Dict[str, int] = {c: 0 for c in slo.classes}
        lc_depth = 0
        for rid in self.pending:
            cls = slo.resolve(self.requests[rid].slo_class)
            if cls is None:
                continue
            depths[cls.name] = depths.get(cls.name, 0) + 1
            if not cls.degradable:
                lc_depth += 1
        if tel.enabled:
            tel.lane_depths(depths)
        bo.evaluate(lc_queue_depth=lc_depth, kv_occupancy_frac=occ)
        if bo.level == 0:
            return
        deferred: Dict[str, int] = {}
        for rid in list(self.pending):
            req = self.requests[rid]
            if req.status in TERMINAL_STATUSES:
                continue
            if bo.sheds_queued(req.slo_class):
                if tel.enabled:
                    tel.lane_shed(req.slo_class, trace_id=req.trace_id,
                                  reason=f"brownout:{bo.level.name}")
                self._terminate(req, RequestStatus.REJECTED)
            elif self._held(req):
                req.deferred_ticks += 1
                deferred[req.slo_class] = deferred.get(req.slo_class, 0) + 1
        if tel.enabled:
            for cname, cnt in deferred.items():
                tel.lane_deferred(cname, count=cnt)
        if kv.host_tier is not None and occ >= bo.config.kv_pressure_frac:
            # spill degradable decoders while the pressure holds: each
            # preemption spills first, so readmission restores
            victims = sorted(
                (r for r in self._active()
                 if r.status is RequestStatus.DECODING
                 and bo.spills(r.slo_class)
                 and r.preemptions < self.res.max_preemptions),
                key=lambda r: (r.priority, -r.rid))
            cap_toks = max(kv.capacity_tokens, 1)
            for req in victims:
                if kv.live_tokens() / cap_toks < bo.config.kv_pressure_frac:
                    break
                self.preempt(req.rid)
        for req in list(self._active()):
            if bo.sheds_live(req.slo_class):
                # CRITICAL_ONLY: live degradable work ends REJECTED, its
                # committed tokens kept
                self._release_slot(req)
                if tel.enabled:
                    tel.lane_shed(req.slo_class, trace_id=req.trace_id,
                                  reason="brownout:CRITICAL_ONLY")
                self._terminate(req, RequestStatus.REJECTED)
            elif bo.degrades(req.slo_class):
                changed = False
                if req.spec:
                    changed = self.set_spec_mode(req.rid, False) or changed
                cap = bo.output_cap(req.slo_class)
                if cap is not None:
                    changed = self.apply_output_cap(req.rid, cap) or changed
                if changed and tel.enabled:
                    tel.lane_degraded(req.slo_class)

    def serve_with_arrivals(self, arrivals, clock=None, quantum: int = 8,
                            record_trace=None, _t0=None, _records=None,
                            _open=None) -> Dict[int, Dict]:
        """Arrival-driven serving (reference :2342): requests join the
        admit/retire loop at their offered times.

        ``arrivals``: ``(t_offset_s, prompt_tokens, max_new_tokens or
        None[, options])`` tuples, admitted once the clock passes their
        offset; ``options`` is a dict of ``priority``, ``ttl_s``,
        ``deadline_s`` and ``spec`` (a malformed one, like a malformed
        prompt, registers ``REJECTED``).  ``clock``: a 0-argument seconds
        callable (default ``time.perf_counter``), also the deadlines'
        clock for the loop's duration; ``options`` may also name an
        ``slo_class``.  ``quantum``: the decode stretch's
        cap while arrivals are outstanding, unchained only
        (``chain_segments`` False): the chained stretch registers due
        arrivals at its segment boundaries and joins them into the running
        batch while a slot is free.

        Returns ``{rid: record}`` with ``arrival_s``, ``admitted_s``,
        ``prompt_len``, ``trace_id``, ``prefill_start_s`` (the start of the
        step whose batch held the first prefill token), ``first_token_s``,
        ``finish_s``, ``tokens``, a terminal ``outcome``, ``kv_bytes``, the
        request's ``slo_class`` and ``deferred_ticks`` (when set), its
        profiler ``work`` (with a profiler), and
        the TTFT decomposition ``queue_wait_s`` (arrival to prefill start)
        and ``prefill_s`` (prefill start to first token, or to the
        terminal stamp when no token came): for ``ok`` requests,
        ``queue_wait_s + prefill_s == first_token_s - arrival_s``.  Stamps
        are taken at step boundaries; a joiner's prefill start at the
        segment boundary where it joined.

        ``record_trace``: a :class:`~..obs.replay.TrafficTraceRecorder`
        that takes the run's header on entry, every offered arrival as it
        is admitted (its raw options) and every finished record at the
        end; it only appends, so a recorded run equals an unrecorded one.
        ``_t0``, ``_records`` and ``_open`` carry a run across a live
        migration: the successor manager re-enters this loop with the
        arrivals left, on the first manager's time base and records.
        """
        clock = clock or time.perf_counter
        t0 = clock() if _t0 is None else _t0
        if record_trace is not None:
            # a successor's header lands as a continuation
            record_trace.begin_run(self.trace_run_meta())
        queue = sorted(arrivals, key=lambda a: a[0])
        records: Dict[int, Dict] = {} if _records is None else _records
        # records still waiting for a stamp
        open_rids = set() if _open is None else _open

        def admit_due():
            now = clock() - t0
            while queue and queue[0][0] <= now:
                off, prompt, mnt, *rest = queue.pop(0)
                if record_trace is not None:
                    # the raw options: a malformed dict replays its
                    # rejection
                    record_trace.record_arrival(
                        off, prompt, mnt, rest[0] if rest else None)
                opts, reject = parse_arrival_options(rest)
                rid = self.register_new_request(
                    prompt, mnt, reject_invalid=True, reject_reason=reject,
                    **opts)
                records[rid] = {"arrival_s": off, "admitted_s": now,
                                "prompt_len": len(prompt),
                                "trace_id": self.requests[rid].trace_id}
                open_rids.add(rid)
            return clock() - t0

        tel = self.telemetry

        def stamp_joined(rids):
            now = clock() - t0
            for rid in rids:
                rec = records.get(rid)
                if rec is not None and "prefill_start_s" not in rec:
                    rec["prefill_start_s"] = now
                    if tel.enabled:
                        tel.request_prefill_started(
                            self.requests[rid].trace_id)

        def stamp(now):
            for rid in list(open_rids):
                rec, req = records[rid], self.requests[rid]
                if "first_token_s" not in rec and req.generated:
                    rec["first_token_s"] = now
                if req.status in TERMINAL_STATUSES:
                    rec.setdefault("finish_s", now)
                    open_rids.discard(rid)

        def continue_on(new_rm):
            # a plan switch committed: the successor holds every request
            # under its rid and serves the arrivals left
            return new_rm.serve_with_arrivals(
                queue, clock=clock, quantum=quantum,
                record_trace=record_trace, _t0=t0, _records=records,
                _open=open_rids)

        saved_chunk = self.scan_chunk
        saved_clock = self._swap_clock(clock)
        chained = self.chain_segments
        try:
            self._arrival_pump = admit_due if chained else None
            self._join_stamp = stamp_joined if chained else None
            while queue or self.has_work():
                now = admit_due()
                self._check_lifecycle()
                stamp(clock() - t0)
                if not self.has_work():
                    new_rm = self._maybe_migrate(idle=True)
                    if new_rm is not None:
                        return continue_on(new_rm)
                    if queue:   # idle until the next arrival
                        time.sleep(min(1e-3, max(0.0, queue[0][0] - now)))
                    continue
                if not chained:
                    self.scan_chunk = quantum if queue else saved_chunk
                starters = [rid for rid in open_rids
                            if "prefill_start_s" not in records[rid]
                            and self.requests[rid].prefill_offset == 0
                            and self.requests[rid].status
                            not in TERMINAL_STATUSES]
                self.profiler.tick_begin()
                self._tick()
                self.profiler.tick_end()
                self._sync_kv()
                self._maybe_check_health()
                self._maybe_brownout()
                for rid in starters:
                    # a joiner stamped (and reported) its own start
                    if (self.requests[rid].prefill_offset > 0
                            and "prefill_start_s" not in records[rid]):
                        records[rid]["prefill_start_s"] = now
                        if tel.enabled:
                            tel.request_prefill_started(
                                self.requests[rid].trace_id)
                stamp(clock() - t0)
                new_rm = self._maybe_migrate()
                if new_rm is not None:
                    return continue_on(new_rm)
            self._maybe_check_health(force=True)
        finally:
            self.scan_chunk = saved_chunk
            self._arrival_pump = self._join_stamp = None
            self._swap_clock(saved_clock)
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
            if self.profiler.enabled:
                rec["work"] = self.profiler.request_work(rid)
            start = rec.get("prefill_start_s",
                            rec.get("admitted_s", rec["arrival_s"]))
            stop = rec.get("first_token_s", rec.get("finish_s", end))
            rec["queue_wait_s"] = max(start - rec["arrival_s"], 0.0)
            rec["prefill_s"] = max(stop - start, 0.0)
        if record_trace is not None:
            # only the last manager of a migration chain gets here
            record_trace.finalize(records)
        return records

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None) -> List[List[int]]:
        rids = [self.register_new_request(p, max_new_tokens)
                for p in prompts]
        out = self.serve_incr_decoding()
        return [out[rid] for rid in rids]
