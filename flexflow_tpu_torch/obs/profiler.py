"""Step-level cost attribution: per-phase time budgets + deterministic

Port of the JAX package's ``flexflow_tpu/obs/profiler.py``.  Two
things differ.  The cost card's constants come from
:mod:`flexflow_tpu_torch.serve.cost`, which computes from the serve
model's modules what the reference reads off its compiled graph (the
same numbers, field by field).  And ``recompiles_total`` reads 0:
eager PyTorch has no jit cache, so ``install`` finds no callable with
a ``_cache_size`` to poll (the reference polls only where one exists);
building the CUDA kernels with nvcc is a one-time build, not a
recompile, and is not counted.  ``host_syncs`` counts the manager's
read-backs (``RequestManager.readbacks``) and the speculative
phases' reads, ``dispatches`` each ``step``, ``decode_scan_async``
segment, ``join_slot`` and ``prefill_scan`` call, as in the
reference.
work counters for the serving stack.

The calibration loop (obs/calibration.py) reconciles predicted vs
measured at WHOLE-PLAN granularity — one ``tpot_ms`` scalar per plan key —
so when prediction error appears it cannot say whether attention, the LM
head, the ICI hop, or host overhead is mispriced.  This module is the
decomposed half:

* :class:`StepProfiler` — one handle threaded through the managers
  exactly like :class:`~flexflow_tpu.obs.telemetry.Telemetry`
  (``RequestManager(..., profiler=StepProfiler())``; the manager syncs it
  onto the InferenceManager / every pipeline stage).  It

  - **times each serve tick's phases** on the injectable clock:
    admission/slot-fill/arrival parsing (``host_admit``), host batch
    preparation (``host_prepare``), jit dispatch (``dispatch``;
    per-stage ``stage{i}`` under pp), the inter-stage activation hop
    (``hop``), and the sample readback (``readback``) — the host-side
    time-budget decomposition of a tick;
  - **accumulates deterministic work counters** per tick and per request
    (:data:`WORK_COUNTERS`): flops executed, HBM bytes read/written, KV
    bytes touched, dispatch count, jit-recompile count, host-device
    syncs, pages mapped / copy-on-written.  "Deterministic" means the
    numbers are computed from host bookkeeping (token counts, batch
    shapes, the compiled plan) via the SAME arithmetic the serve search
    already prices with (``simulator._step_flops`` / ``Linear.flops`` /
    ``_step_param_bytes`` / the KVAllocator's ``bytes_per_token``), so
    two runs of the same workload produce identical counters with no
    device attached — the basis of the ``scripts/bench_compare.py``
    perf-regression guardrail.

* :class:`PlanCostCard` — the per-deployment constants that accounting
  uses, derived once per compiled plan (per stage under pp) from the
  plan's own sharded cost arithmetic.

**Deterministic accounting model** (the contract tests/test_profiler.py
cross-checks against ``Linear.flops`` / ``plan_memory_parts``):

* ``flops`` — fed tokens × (attention + mlp per-token flops at the
  compiled batch shape) + logit rows × per-row LM-head flops;
* ``hbm_bytes_read`` — model passes × streamed weight bytes (each scan
  step / micro-batch pass re-reads the weights) + KV read bytes;
* ``hbm_bytes_written`` — fed tokens × KV bytes/token (the committed
  cache write);
* ``kv_bytes_touched`` — KV read + written bytes, where a token at cache
  depth ``d`` reads the ``d``-deep causally-live prefix (a decode
  stretch of ``n`` steps starting at depth ``s`` reads
  ``n*s + n*(n-1)/2`` positions per row);
* ``dispatches`` — host program launches (per stage per micro-batch
  under pp); per-request ``dispatches`` counts the model passes whose
  batch carried the request's tokens;
* ``recompiles_total`` — jit cache misses: the registered jitted
  callables' ``_cache_size()`` growth since registration (a silent
  steady-state recompile is the most likely invisible perf bug);
* ``host_syncs`` — device→host result materializations (multi-step
  decode must perform exactly ONE, the final readback — the "never
  host-syncs" claim, now a pinned counter);
* ``pages_mapped`` / ``pages_cow`` — the paged allocator's cumulative
  page-table activity (serve/kv_paged.py).

**Host-side only, guaranteed.**  Nothing here is ever traced into a
jitted program and no hook reads a device value, so serve outputs are
bit-identical with the profiler on or off — pinned across
step/generate/arrivals/pp2/int8/paged/spec/migration by
tests/test_profiler.py, the same contract telemetry carries.

The per-component TIME vocabulary (:data:`COMPONENTS` →
``attention_ms``/``mlp_ms``/``lm_head_ms``/``kv_stream_ms``/``comms_ms``/
``hop_ms``/``host_overhead_ms``) is shared with the serve search's
decomposed pricing (``search.serve_search.pp_serve_cost`` returns the
same fields; ``search_serve_plan`` records them into the calibration
ledger and consults the store's component-level ``suggested_scale``
entries when re-pricing), so the CalibrationLedger reconciles
predicted-vs-executed PER COMPONENT and a mispriced hop corrects only
the hop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# the per-component time vocabulary: calibration-ledger field names are
# f"{component}_ms" (TIME_COMPONENT_FIELDS).  pp_serve_cost EMITS this
# decomposition, search_serve_plan records/consults it, the profiler's
# report and trace_report's time-budget section render it — one tuple, so
# a renamed component cannot drift between the pricing and the report.
COMPONENTS = ("attention", "mlp", "lm_head", "kv_stream", "comms", "hop",
              "host_overhead")
TIME_COMPONENT_FIELDS = tuple(f"{c}_ms" for c in COMPONENTS)

# the deterministic work-counter vocabulary (see the accounting model in
# the module docstring).  report.py folds these into the under-load /
# time-budget sections and scripts/bench_compare.py treats every field
# with one of these names as an exact-by-default regression guard.
WORK_COUNTERS = (
    "flops", "hbm_bytes_read", "hbm_bytes_written", "kv_bytes_touched",
    "dispatches", "recompiles_total", "host_syncs",
    "pages_mapped", "pages_cow",
)

# per-request attribution subset (stamped into serve_with_arrivals
# records — satellite: bench_compare gets deterministic per-run fields
# even with no device attached)
REQUEST_WORK_COUNTERS = ("flops", "kv_bytes_touched", "dispatches")

@dataclasses.dataclass
class PlanCostCard:
    """Per-deployment accounting constants, derived from the compiled
    plan(s) with the serve search's own arithmetic:

    * ``attn_flops_per_token`` / ``mlp_flops_per_token`` — per-device
      flops per fed token at the compiled batch shape
      (``simulator._step_flops`` over the plan steps, divided by the
      graph's flat token-batch rows);
    * ``lm_head_flops_per_row`` — per LOGIT ROW (the gated-prefill unit;
      ``Linear.flops``'s ``cost_logit_rows`` discount is the same
      arithmetic);
    * ``weight_bytes`` — per-device weight bytes one model pass streams
      (summed across pp stages: a pass traverses every stage);
    * ``kv_bytes_per_token`` — the allocator's committed-KV price (int8
      scales + lane padding included — the admission gate's number);
      falls back to the plan's registered-state arithmetic before the
      caches are allocated.
    """

    attn_flops_per_token: float = 0.0
    mlp_flops_per_token: float = 0.0
    lm_head_flops_per_row: float = 0.0
    weight_bytes: float = 0.0
    kv_bytes_per_token: float = 0.0

    def flops_for(self, n_tokens: int, logit_rows: int) -> float:
        return (n_tokens * (self.attn_flops_per_token
                            + self.mlp_flops_per_token)
                + logit_rows * self.lm_head_flops_per_row)


def plan_cost_card(im) -> PlanCostCard:
    """Build a :class:`PlanCostCard` for an InferenceManager: the ONE
    place the profiler's deterministic counters read their constants
    (reference :141), from :func:`~flexflow_tpu_torch.serve.cost.plan_cost`,
    the port's copy of the serve search's arithmetic."""
    from ..serve.cost import plan_cost

    return PlanCostCard(**plan_cost(im))


class _Phase:
    """Context manager accumulating one phase's wall time (entry/exit on
    the profiler's injectable clock — mirrors trace._Span)."""

    __slots__ = ("_prof", "_name", "_t0")

    def __init__(self, prof, name):
        self._prof = prof
        self._name = name

    def __enter__(self):
        self._t0 = self._prof._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._prof._phase_done(self._name, self._prof._clock() - self._t0)
        return False


class StepProfiler:
    """See the module docstring.  One instance per serving session;
    shared by the RequestManager and its InferenceManager(s) like the
    Telemetry handle (and carried across a live plan migration, so one
    rid space keeps one attribution table)."""

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock or time.perf_counter
        self.phase_s: Dict[str, float] = {}
        self.phase_counts: Dict[str, int] = {}
        self.work: Dict[str, float] = {k: 0 for k in WORK_COUNTERS}
        # rid -> {flops, kv_bytes_touched, dispatches}
        self.per_request: Dict[int, Dict[str, float]] = {}
        self.ticks = 0
        self.last_tick: Dict = {}
        self.telemetry = None   # bound via bind(); step_profile instants
        # jitted callables polled for cache growth, per deployment:
        # id(im) -> [(name, fn, base_size)] (keyed so uninstall() can
        # release a retired deployment's programs)
        self._jits: Dict[int, List[Tuple[str, object, int]]] = {}
        # compile counts already folded in from uninstalled deployments
        self._retired_compiles = 0
        self._installed: set = set()
        # paged allocators polled for cumulative page activity:
        # id(im) -> (kv, {counter: last_seen})
        self._paged: Dict[int, Tuple[object, Dict[str, int]]] = {}
        self._cards: Dict[int, PlanCostCard] = {}
        self._tick_mark: Optional[Dict] = None
        # scheduling annotations for the CURRENT tick (note()): merged
        # into the tick's step_profile instant and last_tick, then cleared
        self._tick_notes: Dict[str, float] = {}

    # ---- wiring -------------------------------------------------------
    def bind(self, telemetry) -> None:
        """Attach a Telemetry handle: the export grows a ``profile``
        JSONL line, each tick emits a ``step_profile`` instant, and the
        ``recompiles_total`` gauge lands in the metrics registry."""
        if telemetry is not None and getattr(telemetry, "enabled", False):
            self.telemetry = telemetry
            telemetry.profiler = self

    def install(self, im) -> None:
        """Register a deployment: its jitted step callables join the
        recompile poll and its paged allocator (if any) the page poll.
        Idempotent per ``im``; called by the RequestManager when the
        handle is synced (and again by a migration's successor)."""
        key = id(im)
        if key in self._installed:
            return
        self._installed.add(key)
        label = type(im).__name__
        jits = self._jits.setdefault(key, [])
        for name in ("_step", "_scan", "_pscan", "_advance", "_join"):
            fn = getattr(im, name, None)
            if fn is not None and hasattr(fn, "_cache_size"):
                jits.append((f"{label}{name}", fn, fn._cache_size()))
        for s, stage in enumerate(getattr(im, "stages", None) or []):
            fn = getattr(stage, "step", None)
            if fn is not None and hasattr(fn, "_cache_size"):
                jits.append((f"{label}.stage{s}", fn, fn._cache_size()))
        kv = getattr(im, "kv", None)
        if kv is not None and getattr(kv, "paged", False):
            # baseline NOW (registration), so page activity from the very
            # first tick counts — only pre-existing history is excluded
            self._paged[key] = (kv, {
                "pages_mapped": int(getattr(kv, "pages_mapped", 0)),
                "pages_cow": int(getattr(kv, "cow_copies", 0))})

    def uninstall(self, im) -> None:
        """Release a RETIRED deployment (live-migration incumbent
        teardown): its jitted callables leave the recompile poll — their
        compiles-so-far fold into a retained total, so the counter stays
        monotonic — and its cost card / page poll entries drop.  Without
        this, a long-migrating session would pin every retired manager's
        programs (and their buffers) alive through the poll list."""
        key = id(im)
        self._installed.discard(key)
        for _, fn, base in self._jits.pop(key, ()):  # noqa: B007
            self._retired_compiles += max(fn._cache_size() - base, 0)
        self._cards.pop(key, None)
        self._paged.pop(key, None)

    def card_for(self, im) -> PlanCostCard:
        """The deployment's accounting constants, built lazily once per
        ``im`` (the KV byte price needs allocated caches to include the
        real padding/scale planes)."""
        key = id(im)
        card = self._cards.get(key)
        if card is None:
            card = self._cards[key] = plan_cost_card(im)
        return card

    # ---- phase timing -------------------------------------------------
    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def _phase_done(self, name: str, dt: float) -> None:
        self.phase_s[name] = self.phase_s.get(name, 0.0) + dt
        self.phase_counts[name] = self.phase_counts.get(name, 0) + 1

    # ---- deterministic counters ---------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        self.work[name] = self.work.get(name, 0) + n

    def host_sync(self, n: int = 1) -> None:
        """One device→host result materialization (np.asarray of a
        dispatch's output)."""
        self.work["host_syncs"] += n

    def note(self, **kw) -> None:
        """Stamp scheduling decisions into the CURRENT tick's
        ``step_profile`` record (e.g. ``decode_quantum`` — the stretch
        length the scheduler chose — or ``stretch_segments`` /
        ``stretch_joins``).  Values must be JSON-scalar; keys are merged
        into the tick instant at ``tick_end`` and cleared per tick, so
        they never accumulate across ticks."""
        self._tick_notes.update(kw)

    def account(self, card: PlanCostCard,
                rows: Sequence[Tuple[int, int, int]],
                passes: int = 1,
                logit_rows: Optional[int] = None) -> None:
        """Fold one dispatch group's deterministic work in.

        ``rows``: ``[(rid, n_tokens_fed, kv_read_tokens)]`` — per-request
        host bookkeeping (see the module docstring's accounting model).
        ``passes``: model passes this group executes (a decode scan of n
        steps streams the weights n times and includes every row n
        times).  ``logit_rows``: logit rows materialized (gated prefill:
        the sample points; everything else: the fed tokens).
        """
        if not rows:
            return
        total = sum(n for _, n, _ in rows)
        if total <= 0:
            return
        lr = total if logit_rows is None else logit_rows
        flops = card.flops_for(total, lr)
        read_tokens = sum(r for _, _, r in rows)
        kv_w = total * card.kv_bytes_per_token
        kv_r = read_tokens * card.kv_bytes_per_token
        w = self.work
        w["flops"] += flops
        w["hbm_bytes_read"] += passes * card.weight_bytes + kv_r
        w["hbm_bytes_written"] += kv_w
        w["kv_bytes_touched"] += kv_r + kv_w
        per_tok = (card.attn_flops_per_token + card.mlp_flops_per_token
                   + (lr / total) * card.lm_head_flops_per_row)
        for rid, n, r in rows:
            rec = self.per_request.get(rid)
            if rec is None:
                rec = self.per_request[rid] = {
                    k: 0.0 for k in REQUEST_WORK_COUNTERS}
            rec["flops"] += n * per_tok
            rec["kv_bytes_touched"] += (n + r) * card.kv_bytes_per_token
            rec["dispatches"] += passes

    def request_work(self, rid: int) -> Dict[str, float]:
        """The per-request attribution (zeros for an unseen rid) —
        stamped into ``serve_with_arrivals`` records."""
        rec = self.per_request.get(rid)
        if rec is None:
            return {k: 0.0 for k in REQUEST_WORK_COUNTERS}
        return dict(rec)

    # ---- polled counters ----------------------------------------------
    def recompiles(self) -> int:
        """Jit cache misses since registration, summed over the
        registered callables (``_cache_size()`` growth — a compile per
        new (shapes, static args) signature), plus retired deployments'
        folded totals."""
        return self._retired_compiles + int(sum(
            max(fn._cache_size() - base, 0)
            for jits in self._jits.values() for _, fn, base in jits))

    def _poll(self) -> None:
        self.work["recompiles_total"] = self.recompiles()
        for kv, seen in self._paged.values():
            for name, attr in (("pages_mapped", "pages_mapped"),
                               ("pages_cow", "cow_copies")):
                cur = int(getattr(kv, attr, 0))
                if cur > seen[name]:
                    self.work[name] += cur - seen[name]
                seen[name] = cur

    # ---- tick boundaries ----------------------------------------------
    def tick_begin(self) -> None:
        self._tick_mark = {"work": dict(self.work),
                           "phase_s": dict(self.phase_s)}

    def tick_end(self) -> None:
        self._poll()
        self.ticks += 1
        mark = self._tick_mark or {"work": {}, "phase_s": {}}
        self._tick_mark = None
        dwork = {k: self.work[k] - mark["work"].get(k, 0)
                 for k in self.work if self.work[k] != mark["work"].get(k, 0)}
        dphase = {k: round((self.phase_s[k]
                            - mark["phase_s"].get(k, 0.0)) * 1e3, 6)
                  for k in self.phase_s
                  if self.phase_s[k] != mark["phase_s"].get(k, 0.0)}
        notes = self._tick_notes
        self._tick_notes = {}
        self.last_tick = {"tick": self.ticks, "work": dwork,
                          "phases_ms": dphase}
        if notes:
            self.last_tick["notes"] = notes
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.instant("step_profile", cat="profile", track="profile",
                        tick=self.ticks, **notes, **dwork)
            tel.metrics.gauge("recompiles_total").set(
                self.work["recompiles_total"])

    # ---- report -------------------------------------------------------
    def report(self) -> Dict:
        """JSON-ready accumulation: the phase time budget, the work
        counters, and the per-request attribution summary (counts only —
        the full table rides ``serve_with_arrivals`` records)."""
        self._poll()
        total_ms = sum(self.phase_s.values()) * 1e3
        phases = {
            name: {"ms": round(self.phase_s[name] * 1e3, 6),
                   "count": self.phase_counts.get(name, 0),
                   "frac": (round(self.phase_s[name] * 1e3 / total_ms, 4)
                            if total_ms else None)}
            for name in sorted(self.phase_s)
        }
        return {
            "ticks": self.ticks,
            "phases": phases,
            "work": {k: self.work[k] for k in WORK_COUNTERS},
            "requests_attributed": len(self.per_request),
        }


class NullStepProfiler:
    """No-op stand-in (the shared default): every hook returns a
    constant; ``enabled`` is False so instrumented code skips argument
    construction entirely."""

    enabled = False

    def bind(self, *a, **k):
        return None

    def install(self, *a, **k):
        return None

    def uninstall(self, *a, **k):
        return None

    def card_for(self, *a, **k):
        return None

    def phase(self, *a, **k):
        return _NULL_PHASE

    def count(self, *a, **k):
        return None

    def host_sync(self, *a, **k):
        return None

    def note(self, *a, **k):
        return None

    def account(self, *a, **k):
        return None

    def request_work(self, *a, **k):
        return {}

    def recompiles(self):
        return 0

    def tick_begin(self):
        return None

    def tick_end(self):
        return None

    def report(self):
        return {}


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_PHASE = _NullPhase()

NULL_PROFILER = NullStepProfiler()


def profiler_or_null(profiler) -> "StepProfiler":
    """Normalize an optional handle: None -> the shared no-op singleton."""
    return profiler if profiler is not None else NULL_PROFILER
