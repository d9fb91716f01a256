"""Memory ledger: predicted vs allocated vs live HBM for executed plans.

A copy of the JAX package's ``flexflow_tpu/obs/memory.py`` (host-side
Python only), its imports re-pointed at this package, which never
imports the JAX one.  Mentions of jitted programs below describe
the reference; here the same holds for the eager CUDA launches.

The byte-side analog of :class:`~flexflow_tpu_torch.obs.calibration.
CalibrationLedger` (which reconciles the TIME side — TPOT/TTFT).  Three
views per plan, reconciled per component:

* **predicted** — what ``plan_memory_bytes`` priced at search time
  (``plan_memory_parts`` decomposes it into ``weights_gb`` / ``kv_gb`` /
  ``transient_gb`` / ``total_gb``);
* **allocated** — what the deployment actually holds: real parameter
  array bytes (int8 weights + scales included) and the
  :class:`~flexflow_tpu_torch.serve.kv_allocator.KVAllocator`'s buffer bytes
  (int8 KV scales and lane padding included);
* **live** — occupied KV positions × bytes/token, tracked as gauges +
  watermarks by the allocator's :meth:`~flexflow_tpu_torch.serve.kv_allocator.
  KVAllocator.observe` through :meth:`Telemetry.kv_usage`.

The predicted-vs-allocated per-component error feeds ``MachineModel``
memory-constant calibration exactly the way time constants already do —
the ledger IS a :class:`CalibrationLedger` whose "measured" side is the
allocation, so ``report()`` emits the same ``suggested_scale`` geometry
and a :class:`~flexflow_tpu_torch.obs.calibration.CalibrationStore` can absorb
``kv_gb``/``weights_gb`` components unchanged.

Host-side bookkeeping only — attaching the ledger can never change serve
outputs (tests/test_kv_allocator.py pins bit-identity with the memory
layer on vs off).
"""

from __future__ import annotations

from typing import Dict, Optional

from .calibration import CalibrationLedger

# the live-side gauge vocabulary: gauge name -> the KVAllocator snapshot
# key it publishes.  Telemetry.kv_usage EMITS by iterating this mapping
# and report.memory_section READS by iterating its keys — one table, so a
# renamed gauge can neither drift from its source field nor silently drop
# from the report
MEMORY_GAUGE_KEYS = {
    "kv_occupancy_frac": "occupancy_frac",
    "kv_headroom_bytes": "headroom_bytes",
    "kv_live_bytes": "live_bytes",
    "kv_live_bytes_hwm": "hwm_bytes",
    "kv_fragmentation_frac": "fragmentation_frac",
}
MEMORY_GAUGES = tuple(MEMORY_GAUGE_KEYS)

# the paged-allocator extension (serve/kv_paged.py): page-pool occupancy
# and sharing/refcount gauges, published by Telemetry.kv_usage only when
# the snapshot carries the page vocabulary (a slot-contiguous allocator
# never emits zeros for pools it doesn't have).  Same one-table contract
# as MEMORY_GAUGE_KEYS: kv_usage EMITS by iterating it, the report READS
# its keys.
PAGED_GAUGE_KEYS = {
    "kv_pages_live": "pages_live",
    "kv_pages_shared": "pages_shared",
    "kv_pages_free": "pages_free",
    "kv_pages_indexed": "pages_indexed",
    "kv_page_cow_copies": "cow_copies",
    "kv_pages_evicted": "pages_evicted",
}
PAGED_GAUGES = tuple(PAGED_GAUGE_KEYS)

# the host-tier extension (serve/kv_paged.py HostPageTier): host-DRAM
# occupancy gauges, published by Telemetry.kv_usage only when the
# snapshot carries the host vocabulary (an allocator with no tier
# attached never emits zeros for a pool it doesn't have).  Same
# one-table contract as MEMORY_GAUGE_KEYS.
HOST_TIER_GAUGE_KEYS = {
    "kv_host_pages": "host_pages",
    "kv_host_bytes": "host_bytes",
    "kv_host_capacity_bytes": "host_capacity_bytes",
    "kv_host_spilled_requests": "host_spilled_requests",
    "kv_host_evictions": "host_evictions",
}
HOST_TIER_GAUGES = tuple(HOST_TIER_GAUGE_KEYS)

# the occupancy distribution (p50/p95 in the report) rides a histogram
# under this registry name
KV_OCCUPANCY_HIST = "kv_occupancy"


def publish_predicted_parts(telemetry, key: str, parts: Dict) -> None:
    """Record a composed ``plan_memory_parts`` dict (BYTES — see
    :func:`~flexflow_tpu_torch.search.simulator.compose_stage_parts`) as the
    predicted side of the memory ledger.  One parts→GB-field mapping for
    EVERY emitter (``search_serve_plan`` and both managers'
    ``publish_memory``), so single-plan, pp, and search-side records can
    never drift in shape under the same plan key."""
    telemetry.memory_plan_predicted(
        key,
        weights_gb=parts["weights"] / 1e9,
        kv_gb=parts["kv_state"] / 1e9,
        transient_gb=parts["transient"] / 1e9,
        static_gb=parts["static"] / 1e9,
        total_gb=parts["total"] / 1e9,
    )


class MemoryLedger(CalibrationLedger):
    """Predicted-vs-allocated HBM accounting (+ live watermarks).

    Component convention: GB fields named ``weights_gb`` / ``kv_gb`` /
    ``transient_gb`` / ``total_gb`` (free-form like the time ledger's
    ``tpot_ms``...).  ``allocated`` is the byte-world name for the
    parent's ``measure`` — the ratio/``suggested_scale`` math is shared,
    so memory components calibrate through the same
    :class:`~flexflow_tpu_torch.obs.calibration.CalibrationStore` path.
    """

    def __init__(self):
        super().__init__()
        self.hwm_bytes = 0.0          # live high-watermark across the run
        self.hwm_tokens = 0
        self.capacity_bytes: Optional[float] = None

    def allocated(self, plan_key: str, **fields) -> None:
        """Record the deployment's REAL allocation for ``plan_key`` (same
        units/fields as the prediction)."""
        self.measure(plan_key, **fields)

    def observe_live(self, live_bytes: float, capacity_bytes: float,
                     live_tokens: int = 0) -> None:
        """Fold one live-occupancy observation into the watermarks (the
        allocator calls this through ``Telemetry.kv_usage``)."""
        if live_bytes > self.hwm_bytes:
            self.hwm_bytes = float(live_bytes)
        if live_tokens > self.hwm_tokens:
            self.hwm_tokens = int(live_tokens)
        if capacity_bytes:
            self.capacity_bytes = float(capacity_bytes)

    def report(self) -> Dict:
        """The calibration-shaped plans/components tables plus the live
        watermark view (``hwm_frac`` is the stamp-ready device field the
        ``hbm_frac`` close-out fills from a real run)."""
        rep = super().report()
        rep["live"] = {
            "hwm_bytes": self.hwm_bytes,
            "hwm_tokens": self.hwm_tokens,
            "capacity_bytes": self.capacity_bytes,
            "hwm_frac": (round(self.hwm_bytes / self.capacity_bytes, 4)
                         if self.capacity_bytes else None),
        }
        return rep
