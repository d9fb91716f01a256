"""SLO-class serving lanes + brownout: graceful degradation under overload.

A copy of the JAX package's ``flexflow_tpu/serve/slo.py`` (host-side
Python only), its imports re-pointed at this package, which never
imports the JAX one.  Mentions of jitted programs below describe
the reference; here the same holds for the eager CUDA launches.

Production traffic is not one class: a latency-critical interactive lane
and a throughput-bound batch lane have different SLO targets, different
shed policies, and different claims on the KV cache — the same
DistServe-style separation of latency-bound and throughput-bound work the
ROADMAP cites for prefill/decode disaggregation, applied at the ADMISSION
layer first.  Before it every request shared one admission gate and one
shed policy, so a burst of batch traffic could crowd out interactive
requests and overload ended in undifferentiated ``REJECTED`` or priority
preemption.  This module is the policy plane that fixes both:

* :class:`SLOClass` — one traffic class: a priority band, per-class
  TTFT/TPOT p95 targets (fed to the plan-health checks), a shed policy,
  a KV reservation fraction, and a bounded per-class pending queue.
* :class:`SLOPolicy` — the class registry requests resolve against (the
  ``slo_class`` arrival option / ``register_new_request(slo_class=)``
  keyword; one vocabulary via ``parse_arrival_options``).
* :func:`reservation_reason` — the reserved-KV-headroom gate: each
  class's committed cache need charges its OWN reservation first and only
  the overflow competes for the shared pool, so batch traffic can NEVER
  dip into the latency-critical lane's reservation (whatever the arrival
  order).
* :class:`BrownoutController` — watches per-class SLO attainment, queue
  depth, and KV pressure on the injectable clock and walks a
  deterministic degradation ladder::

      NORMAL -> DEFER_BATCH -> DEGRADE_BATCH -> SHED_BATCH -> CRITICAL_ONLY

  one level per breached evaluation window, with hysteresis
  (``deescalate_after`` consecutive clean windows to step back down — an
  oscillating signal cannot flap the ladder).  The controller only
  DECIDES; the RequestManager / FleetRouter apply the level's actions at
  tick boundaries: DEFER holds degradable-class queue admissions,
  DEGRADE flips speculation off (the ``set_spec_mode`` path) and
  caps ``max_new_tokens`` for degradable classes, SHED turns their
  queued + new work into explicit ``REJECTED``, CRITICAL_ONLY also
  evicts their live requests.  Every outcome stays terminal and explicit
  (deferred requests eventually serve, time out, or shed as
  ``REJECTED`` — never ``FAILED``), and every ADMITTED request's tokens
  stay bit-identical to an unloaded run (degradation only truncates or
  re-schedules work; the (rid, token_index) sample fold is untouched).

Everything here is host-side policy — no decision is ever traced into a
jitted program, so attaching a policy or controller cannot change what
any compiled step computes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

from ..obs.telemetry import telemetry_or_null

# shed_policy vocabulary (the per-class knob):
#   "brownout" — the full ladder: deferred first, then degraded, then shed
#   "reject"   — impatient batch: skip deferral, reject new arrivals at
#                any brownout level >= DEFER_BATCH (callers that would
#                rather fail fast than wait out a brownout)
#   "never"    — latency-critical: the ladder never touches this class
SHED_POLICIES = ("brownout", "reject", "never")


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One traffic class (a serving lane).

    * ``priority_band``: added to the caller's per-request priority at
      registration — bands should be spaced wider than any per-request
      priority spread so classes strictly dominate (the default policy
      spaces them 1000 apart).
    * ``ttft_p95_s`` / ``tpot_p95_s``: per-class SLO targets.  The
      plan-health monitor checks the class's OWN p95s against them: a
      breach on a non-degradable class recommends replan, a breach on a
      degradable class escalates the brownout ladder first.
    * ``shed_policy``: see :data:`SHED_POLICIES`.
    * ``kv_reservation_frac``: fraction of the admission KV budget
      reserved for this class — other classes' committed need can never
      enter it (:func:`reservation_reason`).
    * ``max_pending``: bounded PER-CLASS pending queue (None =
      unbounded); registrations beyond it shed as explicit ``REJECTED``.
    * ``degraded_max_new_tokens``: the ``max_new_tokens`` cap applied to
      this class's requests while the ladder is at DEGRADE_BATCH or
      above (None = no cap).  Truncation only: committed tokens are a
      PREFIX of the unloaded run's stream, so bit-identity per position
      is preserved.
    """

    name: str
    priority_band: int = 0
    ttft_p95_s: Optional[float] = None
    tpot_p95_s: Optional[float] = None
    shed_policy: str = "brownout"
    kv_reservation_frac: float = 0.0
    max_pending: Optional[int] = None
    degraded_max_new_tokens: Optional[int] = None

    def __post_init__(self):
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy {self.shed_policy!r} "
                             f"(expected one of {SHED_POLICIES})")
        if not 0.0 <= self.kv_reservation_frac <= 1.0:
            raise ValueError("kv_reservation_frac must be in [0, 1]")
        if (self.degraded_max_new_tokens is not None
                and self.degraded_max_new_tokens < 1):
            raise ValueError("degraded_max_new_tokens must be >= 1")

    @property
    def degradable(self) -> bool:
        """Whether the brownout ladder may touch this class."""
        return self.shed_policy != "never"


class SLOPolicy:
    """The class registry one serving deployment (or fleet) resolves
    requests against.  ``default_class`` names the lane unclassified
    requests ride — in the default policy that is ``batch``, so only
    explicitly-marked traffic claims the latency-critical lane."""

    def __init__(self, classes: List[SLOClass], default_class: str):
        if not classes:
            raise ValueError("an SLOPolicy needs at least one class")
        self.classes: Dict[str, SLOClass] = {}
        for cls in classes:
            if cls.name in self.classes:
                raise ValueError(f"duplicate SLO class {cls.name!r}")
            self.classes[cls.name] = cls
        if default_class not in self.classes:
            raise ValueError(f"default_class {default_class!r} is not a "
                             f"registered class ({sorted(self.classes)})")
        self.default_class = default_class
        total = sum(c.kv_reservation_frac for c in classes)
        if total > 1.0 + 1e-9:
            raise ValueError(
                f"KV reservations sum to {total:.3f} > 1.0 — the shared "
                "pool would be negative")

    def resolve(self, name: Optional[str]) -> Optional[SLOClass]:
        """The class for a request's ``slo_class`` option (None / "" ->
        the default class); None for an UNKNOWN name — the caller turns
        that into a reject reason (one bad arrival must not kill a serve
        loop)."""
        if not name:
            return self.classes[self.default_class]
        return self.classes.get(name)

    def get(self, name: str) -> Optional[SLOClass]:
        return self.classes.get(name)

    def snapshot(self) -> Dict:
        """Serializable policy provenance for a traffic-trace header
        (obs/replay.py): every class's full knob set + the default lane.
        Replay does not rebuild a policy from this — the caller wires
        its own — but a what-if report keys per-class deltas on it and
        a fidelity check can assert the replayed policy matches."""
        return {
            "default_class": self.default_class,
            "classes": {name: dataclasses.asdict(cls)
                        for name, cls in sorted(self.classes.items())},
        }

    @staticmethod
    def default(lc_reservation_frac: float = 0.25,
                lc_ttft_p95_s: Optional[float] = None,
                lc_tpot_p95_s: Optional[float] = None,
                batch_max_pending: Optional[int] = None,
                degraded_max_new_tokens: Optional[int] = None
                ) -> "SLOPolicy":
        """The two-lane policy: ``latency_critical``
        (band 1000, reserved KV, never degraded) over ``batch`` (band 0,
        full brownout ladder, the default lane)."""
        return SLOPolicy([
            SLOClass("latency_critical", priority_band=1000,
                     ttft_p95_s=lc_ttft_p95_s, tpot_p95_s=lc_tpot_p95_s,
                     shed_policy="never",
                     kv_reservation_frac=lc_reservation_frac),
            SLOClass("batch", priority_band=0, shed_policy="brownout",
                     max_pending=batch_max_pending,
                     degraded_max_new_tokens=degraded_max_new_tokens),
        ], default_class="batch")


def reservation_reason(policy: SLOPolicy,
                       committed_by_class: Dict[str, float],
                       cls: SLOClass, need: float,
                       budget: float) -> Optional[str]:
    """The reserved-headroom gate: the rejection reason, or None to admit.

    Arithmetic (all in the same units — bytes or token-slots — as
    ``budget``): each class's reservation is ``r_k * budget``; a class's
    committed need charges its own reservation FIRST and only the
    overflow competes for the shared pool ``budget * (1 - sum(r_k))``.
    Admit the new request iff every class's overflow (with the new
    request added to ``cls``) still fits the shared pool.  Consequences:

    * a class with no reservation (batch) can use at most
      ``budget - sum(other reservations)`` — it can NEVER dip into the
      latency-critical reservation, whatever arrives first;
    * a reserved class can always use its own reservation even when the
      shared pool is saturated by others;
    * total committed never exceeds ``budget`` (each class's usage is
      ``min(committed, r*budget) + overflow`` and the overflows fit the
      shared pool) — the per-policy gate composes with, and is never
      looser than, the total-headroom gate.
    """
    reserved = {k: c.kv_reservation_frac * budget
                for k, c in policy.classes.items()}
    shared = budget - sum(reserved.values())
    overflow = 0.0
    for k, c in policy.classes.items():
        committed = committed_by_class.get(k, 0.0) \
            + (need if k == cls.name else 0.0)
        overflow += max(committed - reserved.get(k, 0.0), 0.0)
    if overflow > shared + 1e-9:
        return (f"KV lane reservation: class {cls.name!r} overflow would "
                f"need {overflow:.0f} of {shared:.0f} shared units "
                f"(reservations withhold "
                f"{sum(reserved.values()):.0f}/{budget:.0f})")
    return None


class BrownoutLevel(enum.IntEnum):
    """The degradation ladder — ordered so comparisons read naturally
    (``level >= BrownoutLevel.SHED_BATCH``)."""

    NORMAL = 0
    DEFER_BATCH = 1
    DEGRADE_BATCH = 2
    SHED_BATCH = 3
    CRITICAL_ONLY = 4


MAX_LEVEL = BrownoutLevel.CRITICAL_ONLY


@dataclasses.dataclass
class BrownoutConfig:
    """Ladder thresholds + hysteresis.

    * ``check_every``: serve/fleet ticks between evaluations (each
      evaluation is one hysteresis window).
    * ``queue_depth_high``: pending depth of the NON-degradable
      (latency-critical) lanes above which the window counts as
      pressured — interactive work queueing is exactly the signal the
      ladder exists to relieve.
    * ``kv_pressure_frac``: live-KV occupancy fraction above which the
      window is pressured.
    * ``escalate_after``: consecutive pressured windows before the
      ladder steps UP one level.
    * ``deescalate_after``: consecutive clean windows before it steps
      DOWN one level — the hysteresis knob; a level change resets both
      streaks, so the ladder moves at most one level per
      ``min(escalate_after, deescalate_after)`` windows and an
      oscillating signal cannot flap it.
    * ``slo_min_samples``: FRESH per-class latency observations (since
      the previous evaluation) required before the class-SLO signal can
      count as pressure — attainment is judged on recent evidence only
      (``Histogram.tail``), so one old breach can never pin a recovered
      ladder at its peak.
    """

    check_every: int = 4
    queue_depth_high: int = 4
    kv_pressure_frac: float = 0.9
    escalate_after: int = 2
    deescalate_after: int = 4
    slo_min_samples: int = 2


class BrownoutController:
    """Walks the degradation ladder from observed pressure signals.

    The controller DECIDES the level; the serving layer (RequestManager
    or FleetRouter) calls :meth:`evaluate` on its tick cadence with the
    live signals and applies the level's actions at its own tick
    boundary (see the module docstring for the action table).  Per-class
    SLO attainment arrives either through the bound telemetry handle's
    per-class histograms (read here) or through
    :meth:`note_slo_breach` (the plan-health monitor's escalation path
    for degradable-class breaches).

    Host-side only and deterministic: given the same signal sequence the
    level walk is identical, which is what lets the hermetic
    ``slo_overload`` bench pin "up the ladder and back down, zero
    flapping" on a virtual clock.
    """

    def __init__(self, policy: SLOPolicy,
                 config: Optional[BrownoutConfig] = None,
                 telemetry=None, clock=None):
        import time as _time

        self.policy = policy
        self.config = config or BrownoutConfig()
        self.telemetry = telemetry_or_null(telemetry)
        self.clock = clock or _time.perf_counter
        self.level = BrownoutLevel.NORMAL
        self._pressured_windows = 0
        self._clean_windows = 0
        self._breach_noted: Optional[str] = None
        self._slo_seen: Dict[str, int] = {}  # hist name -> count consumed
        self.evaluations = 0
        # (evaluation index, new level, reason) per transition — the
        # hermetic bench reads this to pin the monotone up-then-down walk
        self.history: List[Tuple[int, BrownoutLevel, str]] = []

    # ------------------------------------------------------------------
    # level queries the serving layers gate on
    # ------------------------------------------------------------------
    def _cls(self, name: str) -> Optional[SLOClass]:
        return self.policy.resolve(name)

    def holds(self, cls_name: str) -> bool:
        """DEFER semantics: should this class's queued requests be held
        out of engine slots this tick?  ("reject"-policy classes never
        wait — they shed via :meth:`admits` instead.)"""
        cls = self._cls(cls_name)
        return (cls is not None and cls.shed_policy == "brownout"
                and self.level >= BrownoutLevel.DEFER_BATCH)

    def spills(self, cls_name: str) -> bool:
        """SPILL semantics — the rung between DEFER and DEGRADE: may this
        class's decoding requests have their KV pages pushed to the host
        tier (preempt-with-spill) to relieve page pressure?  Carried by
        DEFER_BATCH and above as an ACTION, not a new ladder level: the
        level walk, its hysteresis pins, and fleet.py's hardcoded level
        comparisons stay untouched, and readmission restores the pages
        (bit-identical-prefix contract — preemption already carries it).
        Only degradable classes spill; latency-critical work keeps its
        pages hot."""
        cls = self._cls(cls_name)
        return (cls is not None and cls.degradable
                and self.level >= BrownoutLevel.DEFER_BATCH)

    def degrades(self, cls_name: str) -> bool:
        """DEGRADE semantics: spec off + output cap for this class?"""
        cls = self._cls(cls_name)
        return (cls is not None and cls.degradable
                and self.level >= BrownoutLevel.DEGRADE_BATCH)

    def sheds_queued(self, cls_name: str) -> bool:
        """SHED semantics: queued requests of this class go REJECTED."""
        cls = self._cls(cls_name)
        return (cls is not None and cls.degradable
                and self.level >= BrownoutLevel.SHED_BATCH)

    def sheds_live(self, cls_name: str) -> bool:
        """CRITICAL_ONLY semantics: even slotted requests evict."""
        cls = self._cls(cls_name)
        return (cls is not None and cls.degradable
                and self.level >= BrownoutLevel.CRITICAL_ONLY)

    def admits(self, cls_name: str) -> bool:
        """Admission gate for NEW arrivals of this class at the current
        level (False -> explicit REJECTED)."""
        cls = self._cls(cls_name)
        if cls is None or not cls.degradable:
            return True
        if cls.shed_policy == "reject":
            return self.level < BrownoutLevel.DEFER_BATCH
        return self.level < BrownoutLevel.SHED_BATCH

    def output_cap(self, cls_name: str) -> Optional[int]:
        """The ``max_new_tokens`` cap in force for this class (None = no
        cap at the current level)."""
        cls = self._cls(cls_name)
        if cls is None or not self.degrades(cls_name):
            return None
        return cls.degraded_max_new_tokens

    # ------------------------------------------------------------------
    # signal intake
    # ------------------------------------------------------------------
    def note_slo_breach(self, cls_name: str) -> None:
        """A degradable class breached its own SLO targets (the
        plan-health monitor's per-class check routes here FIRST; only a
        non-degradable breach recommends replan).  Counts as pressure in
        the next evaluation window."""
        self._breach_noted = cls_name

    def _class_slo_pressure(self) -> Optional[str]:
        """Latency-critical attainment from the per-class histograms the
        telemetry handle maintains: a NON-degradable class missing its
        own p95 targets is the clearest 'sacrifice batch work' signal.

        Judged on FRESH observations only (those since the previous
        evaluation, ``Histogram.tail``) — a brownout controller must see
        current attainment, and a single old breach pinning the ladder
        at its peak after the lane recovered would defeat the
        de-escalation contract."""
        from ..obs.metrics import percentile

        tel = self.telemetry
        if not tel.enabled:
            return None
        breach = None
        for name, cls in self.policy.classes.items():
            if cls.degradable:
                continue
            for metric, target in (("ttft_s", cls.ttft_p95_s),
                                   ("tpot_s", cls.tpot_p95_s)):
                if target is None:
                    continue
                key = f"{metric}_cls_{name}"
                hist = tel.metrics.histogram(key)
                fresh = hist.tail(self._slo_seen.get(key, 0))
                self._slo_seen[key] = hist.count
                if len(fresh) < self.config.slo_min_samples:
                    continue
                p95 = percentile(sorted(fresh), 0.95)
                if breach is None and p95 is not None and p95 > target:
                    breach = f"slo:{name}:{metric}"
        return breach

    def evaluate(self, lc_queue_depth: int = 0,
                 kv_occupancy_frac: float = 0.0) -> BrownoutLevel:
        """One hysteresis window: classify it pressured or clean, update
        the streaks, and walk the ladder at most ONE level.  Returns the
        (possibly new) level.  Callers supply the queue/KV signals they
        own; SLO attainment is read from telemetry + breach notes."""
        cfg = self.config
        self.evaluations += 1
        # the per-class tails are consumed EVERY window (whatever other
        # pressure fired), so "fresh" always means "since the previous
        # evaluation" and burst-era breaches cannot resurface later
        slo_pressure = self._class_slo_pressure()
        reason = None
        if lc_queue_depth > cfg.queue_depth_high:
            reason = f"lc_queue_depth:{lc_queue_depth}"
        elif kv_occupancy_frac > cfg.kv_pressure_frac:
            reason = f"kv_pressure:{kv_occupancy_frac:.2f}"
        elif self._breach_noted is not None:
            reason = f"slo_breach:{self._breach_noted}"
        elif slo_pressure is not None:
            reason = slo_pressure
        self._breach_noted = None
        if reason is not None:
            self._pressured_windows += 1
            self._clean_windows = 0
            if (self._pressured_windows >= cfg.escalate_after
                    and self.level < MAX_LEVEL):
                self._transition(BrownoutLevel(self.level + 1), reason)
        else:
            self._clean_windows += 1
            self._pressured_windows = 0
            if (self._clean_windows >= cfg.deescalate_after
                    and self.level > BrownoutLevel.NORMAL):
                self._transition(BrownoutLevel(self.level - 1),
                                 "clean_windows")
        tel = self.telemetry
        if tel.enabled:
            tel.metrics.gauge("brownout_level").set(int(self.level))
        return self.level

    def _transition(self, new: BrownoutLevel, reason: str) -> None:
        old = self.level
        self.level = new
        # a level change opens a fresh window in BOTH directions — K
        # clean windows are needed from HERE to step down (hysteresis),
        # K pressured ones to step further up
        self._pressured_windows = 0
        self._clean_windows = 0
        self.history.append((self.evaluations, new, reason))
        if self.telemetry.enabled:
            self.telemetry.brownout_level_changed(
                int(new), int(old), level_name=new.name, reason=reason)
