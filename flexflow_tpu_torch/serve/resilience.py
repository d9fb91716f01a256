"""Resilient serving: admission control, retry policy, fault injection.

A copy of ``flexflow_tpu/serve/resilience.py`` (numpy only), the policy
layer the :class:`~.request_manager.RequestManager` threads through its
admit/retire loop.  A request's KV is always recomputable from ``prompt +
generated``, which is what makes preemption-and-recompute exact:

* :class:`ResilienceConfig`: admission control (a bounded pending queue
  and a KV headroom gate), a default TTL, the preemption policy, the
  dispatch-failure strategy and the host page tier's capacity;
* :class:`RetryPolicy`: exponential backoff with a bounded budget for
  transient dispatch faults;
* :class:`FaultInjector`: a seeded, deterministic chaos hook consulted at
  the InferenceManager's ``step`` / ``decode_scan`` / ``prefill_scan``
  dispatch sites and the host tier's ``kv_swap_out:<rid>`` /
  ``kv_swap_in:<rid>`` sites.  Faults raise before any work reaches the
  device, so a retried dispatch replays identical compute;
* :func:`kv_bytes_per_token`: the per-position committed-KV cost the
  admission gate prices requests with.

Everything here is host-side Python: attaching any of it changes no
kernel's inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


class TransientServeError(RuntimeError):
    """A dispatch failure worth retrying (the serve loop's retry guard
    catches exactly this type; anything else propagates)."""


class InjectedFault(TransientServeError):
    """Raised by :class:`FaultInjector` at an instrumented dispatch site."""

    def __init__(self, message: str, site: str = ""):
        super().__init__(message)
        self.site = site


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with a bounded budget.

    ``max_retries`` counts re-dispatches after the first attempt
    (``max_retries=0`` fails a dispatch on its first fault).  The backoff
    of retry ``attempt`` (1-based) is ``backoff_s * backoff_mult **
    (attempt - 1)``, capped at ``max_backoff_s``.
    """

    max_retries: int = 3
    backoff_s: float = 0.01
    backoff_mult: float = 2.0
    max_backoff_s: float = 1.0

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_s * self.backoff_mult ** max(attempt - 1, 0),
                   self.max_backoff_s)


@dataclasses.dataclass
class ResilienceConfig:
    """Policy knobs of the resilient serving layer; the defaults keep
    every knob off (unbounded queue, no gate, no TTL, no preemption).

    * ``max_pending``: registrations beyond this many pending requests get
      a ``REJECTED`` outcome.
    * ``kv_gate`` / ``kv_headroom_frac`` / ``kv_budget_bytes``: admission
      prices each request's worst-case cache need (``_seq_len_needed``
      positions, rounded to whole pages under a paged cache, times
      :func:`kv_bytes_per_token`) summed over every live request against
      a byte budget: ``kv_budget_bytes`` when set, else
      ``kv_headroom_frac`` of the cache's own capacity.
    * ``default_ttl_s``: the deadline of requests registered without
      ``ttl_s``/``deadline_s`` (None: none).
    * ``preemption``: under slot or page pressure, evict the
      lowest-priority ``DECODING`` request (newest first among equals, at
      most ``max_preemptions`` times each) for a strictly higher-priority
      one; the victim requeues and recomputes ``prompt + generated``.
    * ``on_dispatch_failure``: once a dispatch exhausts its retries,
      ``"requeue"`` preempts the affected requests for recompute (at most
      ``max_requeues`` times each, then ``FAILED``); ``"fail"`` fails them.
      The engine keeps serving everyone else.
    * ``host_tier_bytes``: capacity of the host-memory page tier under a
      paged KV cache (0: off).  Preempted requests' written pages spill to
      it, and readmission restores them (checksum-verified) instead of
      recomputing them; a failed or corrupt restore recomputes.
    """

    max_pending: Optional[int] = None
    kv_gate: bool = False
    kv_headroom_frac: float = 1.0
    kv_budget_bytes: Optional[float] = None
    default_ttl_s: Optional[float] = None
    preemption: bool = False
    max_preemptions: int = 4
    on_dispatch_failure: str = "requeue"
    max_requeues: int = 2
    host_tier_bytes: int = 0
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)

    def __post_init__(self):
        if self.on_dispatch_failure not in ("requeue", "fail"):
            raise ValueError(
                f"on_dispatch_failure {self.on_dispatch_failure!r} "
                "(expected 'requeue' or 'fail')")


class FaultInjector:
    """Seeded, deterministic dispatch-fault injection (chaos testing).

    Consulted on the host at each instrumented site before the work is
    handed to the device, so an injected fault never leaves partial
    device state behind.  ``p`` is the default per-call fault
    probability; ``p_by_site`` maps a substring of the site name to an
    override (first match wins), e.g. ``{"decode_scan": 0.3}``.
    ``max_faults`` bounds the total injected count.  The draws come from
    ``np.random.RandomState(seed)``, so the same sequence of sites gives
    the reference's fault sequence.
    """

    def __init__(self, seed: int = 0, p: float = 0.0,
                 p_by_site: Optional[Dict[str, float]] = None,
                 max_faults: Optional[int] = None):
        self.seed = int(seed)
        self.p = float(p)
        self.p_by_site = dict(p_by_site or {})
        self.max_faults = max_faults
        self.injected = 0
        self.calls = 0
        self._rng = np.random.RandomState(seed)

    def prob(self, site: str) -> float:
        for pat, pr in self.p_by_site.items():
            if pat in site:
                return float(pr)
        return self.p

    def maybe_fail(self, site: str) -> None:
        """Raise :class:`InjectedFault` for ``site`` per the seeded draw.
        A site of probability 0 draws nothing, so an untargeted site never
        shifts the schedule of a targeted one."""
        self.calls += 1
        pr = self.prob(site)
        if pr <= 0.0:
            return
        if self.max_faults is not None and self.injected >= self.max_faults:
            return
        if self._rng.random_sample() < pr:
            self.injected += 1
            raise InjectedFault(
                f"injected fault #{self.injected} at {site}", site=site)


def kv_bytes_per_token(im) -> Optional[float]:
    """Committed-KV bytes one request position costs across the model's
    attention layers (K and V and, under int8 KV, their f32 scales), from
    the manager's allocator; None while the caches are unallocated."""
    kv = getattr(im, "kv", None)
    if kv is None or kv.state is None:
        return None
    return kv.bytes_per_token()
