"""Predicted-vs-measured cost accounting for executed serve plans.

A copy of the JAX package's ``flexflow_tpu/obs/calibration.py`` (host-side
Python only), its imports re-pointed at this package, which never
imports the JAX one.  Mentions of jitted programs below describe
the reference; here the same holds for the eager CUDA launches.

FlexFlow's simulator (MLSys'19) and Unity's search (OSDI'22) are only as
good as their calibrated per-op measurements — our ``serve_search`` /
``simulator`` price plans they historically never checked against reality.
This ledger closes the loop: every executed plan records the search's
predicted TPOT/TTFT/memory next to the measured values, and
:meth:`report` turns the pairs into a per-component calibration table
(ratio + signed error per field, aggregated across plans) that says which
``MachineModel`` constant to tune and by how much.

The :class:`CalibrationStore` closes it CONTINUOUSLY: a persisted JSON
artifact (default ``artifacts/torch_calibration_store.json``) the ledger commits
its per-component ``suggested_scale`` into after each measured run —
EWMA-smoothed across runs, clamped to a sane range, and gated behind a
minimum sample count — which ``MachineModel.with_store`` and
``search_serve_plan(calibration=...)`` consult automatically on the next
search.  An earlier flow printed ``suggested_scale`` and forgot it; this is
the artifact that remembers.

Host-side bookkeeping only; keys are free-form plan names (the serve
search's ``tp{t}_pp{p}_m{m}`` convention by default).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional

# the port's own artifact (gitignored): deliberate persistence only —
# nothing writes here unless a caller saves a store to it.  The JAX
# package's store (``artifacts/calibration_store.json`` and its
# ``FLEXFLOW_TPU_CALIBRATION_STORE`` override) holds numbers measured for
# its TPU plans, which never steer this port.
DEFAULT_STORE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "artifacts", "torch_calibration_store.json",
)
STORE_ENV = "FLEXFLOW_TPU_TORCH_CALIBRATION_STORE"


def default_store_path() -> Optional[str]:
    """The store path ``search_serve_plan(calibration="auto")`` consults
    (for a CUDA mesh only: the store holds H100 numbers).

    ``FLEXFLOW_TPU_TORCH_CALIBRATION_STORE`` overrides the port's
    artifact: a path redirects, the empty string disables the consult."""
    env = os.environ.get(STORE_ENV)
    if env is not None:
        return env or None
    return DEFAULT_STORE_PATH


class CalibrationLedger:
    def __init__(self):
        # plan_key -> {"predicted": {field: value}, "measured": {...}}
        self._plans: Dict[str, Dict[str, Dict[str, float]]] = {}

    def _entry(self, plan_key: str) -> Dict:
        return self._plans.setdefault(
            str(plan_key), {"predicted": {}, "measured": {}})

    def predict(self, plan_key: str, **fields) -> None:
        """Record the search/simulator's predictions for a plan (e.g.
        ``predict("tp2_pp1_m1", tpot_ms=7.1, memory_gb=12.3)``)."""
        self._entry(plan_key)["predicted"].update(
            {k: float(v) for k, v in fields.items() if v is not None})

    def measure(self, plan_key: str, **fields) -> None:
        """Record measured values for the same fields, same units."""
        self._entry(plan_key)["measured"].update(
            {k: float(v) for k, v in fields.items() if v is not None})

    # ------------------------------------------------------------------
    def report(self) -> Dict:
        """Per-plan, per-field predicted vs measured, plus the cross-plan
        component aggregation::

            {"plans": {plan: {field: {"predicted", "measured", "ratio",
                                      "error_frac"}}},
             "components": {field: {"mean_ratio", "suggested_scale", "n",
                                    "low_confidence"}}}

        ``ratio = measured/predicted`` — the factor to multiply the cost
        model's output by (``suggested_scale``) so it lands on reality;
        ``error_frac = (measured-predicted)/predicted`` is the signed
        relative error.  ``suggested_scale`` is the GEOMETRIC mean of the
        per-plan ratios: ratios are multiplicative corrections, and the
        arithmetic mean over-weights overshoots (ratios 0.5 and 2.0 must
        suggest 1.0, not 1.25).  Non-positive ratios (a sign error in a
        recorded field) stay visible per plan but are excluded from the
        aggregate — log of a non-positive ratio is undefined.  An
        aggregate built from a single pair carries ``low_confidence``
        so downstream consumers (the :class:`CalibrationStore` gate,
        reports) don't over-trust one measurement.  Fields recorded on
        only one side appear with the other side ``None`` and no ratio
        (coverage gaps stay visible instead of silently dropping).
        """
        plans: Dict[str, Dict] = {}
        comp: Dict[str, Dict] = {}
        for key, rec in self._plans.items():
            fields = {}
            for f in sorted(set(rec["predicted"]) | set(rec["measured"])):
                pred = rec["predicted"].get(f)
                meas = rec["measured"].get(f)
                entry = {"predicted": pred, "measured": meas,
                         "ratio": None, "error_frac": None}
                if pred is not None and meas is not None and pred != 0:
                    ratio = meas / pred
                    entry["ratio"] = round(ratio, 4)
                    entry["error_frac"] = round((meas - pred) / pred, 4)
                    if ratio > 0:
                        c = comp.setdefault(f, {"sum_log": 0.0, "n": 0})
                        c["sum_log"] += math.log(ratio)
                        c["n"] += 1
                fields[f] = entry
            plans[key] = fields
        components = {
            f: {"mean_ratio": round(math.exp(c["sum_log"] / c["n"]), 4),
                "suggested_scale": round(math.exp(c["sum_log"] / c["n"]), 4),
                "n": c["n"],
                "low_confidence": c["n"] == 1}
            for f, c in sorted(comp.items())
        }
        return {"plans": plans, "components": components}

    def commit(self, store: "CalibrationStore") -> Dict:
        """Fold this ledger's component aggregation into a persisted store
        (the continuous-calibration write path); returns what changed."""
        return store.update(self.report())

    def __bool__(self) -> bool:
        return bool(self._plans)


# ---------------------------------------------------------------------------
# continuous calibration: the persisted, smoothed scale artifact
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StoreConfig:
    """Smoothing/trust policy for the persisted calibration scales.

    * ``ewma_alpha`` — weight of the newest run's suggested scale; history
      keeps ``1 - alpha``.  A single wild run (thermal throttle, noisy
      neighbor on a shared chip) moves the applied scale only ``alpha`` of
      the way.
    * ``scale_min``/``scale_max`` — hard clamp on any suggestion before it
      is blended: a 10x outlier is a broken measurement, not a
      calibration, and must not poison the EWMA.
    * ``min_samples`` — cumulative predicted/measured pairs a component
      needs before :meth:`CalibrationStore.scale_for` applies it (below
      the gate the spec-sheet prediction stands).  With the ledger's
      ``low_confidence`` single-pair runs, the default of 2 means one run
      records but does not yet steer.
    """

    ewma_alpha: float = 0.3
    scale_min: float = 0.25
    scale_max: float = 4.0
    min_samples: int = 2


class CalibrationStore:
    """EWMA-smoothed per-component cost scales, persisted as JSON.

    The write path is ``CalibrationLedger.commit(store); store.save()``
    after a measured run; the read path is ``CalibrationStore.load(path)``
    inside ``search_serve_plan`` (field-level scales: ``tpot_ms``,
    ``transfer_ms``, ``memory_gb``, ...) and ``MachineModel.with_store``
    (constant-level scales: ``step_overhead``, ``mxu_efficiency``, ...).
    Missing or malformed files load as an EMPTY store — every scale is 1.0
    — so a corrupted artifact degrades to spec-sheet behavior, never an
    exception on the serving path.
    """

    def __init__(self, path: Optional[str] = None,
                 config: Optional[StoreConfig] = None):
        self.path = path
        self.config = config or StoreConfig()
        self.runs = 0
        # component -> {"scale": ewma, "n": cumulative pairs,
        #               "last_suggested": newest clamped suggestion}
        self.components: Dict[str, Dict] = {}

    # ---- persistence ---------------------------------------------------
    @classmethod
    def load(cls, path: Optional[str] = None,
             config: Optional[StoreConfig] = None) -> "CalibrationStore":
        """Read a store from disk; missing/malformed/partial files yield an
        empty (all-scales-1.0) store at the same path.  The persisted
        policy (``StoreConfig``) travels WITH the artifact — a store
        written with a relaxed min-sample gate keeps it on reload — unless
        the caller overrides with an explicit ``config``."""
        store = cls(path, config)
        if store.path is None:
            return store
        try:
            with open(store.path) as f:
                doc = json.load(f)
            if config is None and isinstance(doc.get("config"), dict):
                known = {f.name for f in dataclasses.fields(StoreConfig)}
                store.config = StoreConfig(**{
                    k: v for k, v in doc["config"].items() if k in known})
            store.runs = int(doc.get("runs", 0))
            comps = doc.get("components", {})
            if isinstance(comps, dict):
                for name, e in comps.items():
                    if not isinstance(e, dict) or "scale" not in e:
                        continue
                    store.components[str(name)] = {
                        "scale": float(e["scale"]),
                        "n": int(e.get("n", 0)),
                        "last_suggested": float(
                            e.get("last_suggested", e["scale"])),
                    }
        except (OSError, ValueError, TypeError):
            store.components = {}
            store.runs = 0
        return store

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("CalibrationStore.save needs a path (a store "
                             "writes the default artifact only when named: "
                             "DEFAULT_STORE_PATH)")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.as_dict(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    def as_dict(self) -> Dict:
        return {"version": 1, "runs": self.runs,
                "config": dataclasses.asdict(self.config),
                "components": {k: dict(v)
                               for k, v in sorted(self.components.items())}}

    # ---- update / read -------------------------------------------------
    def _clamp(self, s: float) -> float:
        return min(max(s, self.config.scale_min), self.config.scale_max)

    def update(self, report: Dict) -> Dict:
        """Blend one ledger ``report()``'s components in (EWMA over runs;
        first observation seeds the average).  Returns the per-component
        ``{"scale", "n", "applied"}`` view after the blend — ``applied``
        is whether the min-sample gate passes now."""
        alpha = self.config.ewma_alpha
        for name, comp in report.get("components", {}).items():
            suggested = comp.get("suggested_scale")
            if suggested is None or suggested <= 0:
                continue
            suggested = self._clamp(float(suggested))
            entry = self.components.get(name)
            if entry is None:
                entry = self.components[name] = {"scale": suggested, "n": 0}
            else:
                entry["scale"] = ((1.0 - alpha) * entry["scale"]
                                  + alpha * suggested)
            entry["scale"] = round(self._clamp(entry["scale"]), 6)
            entry["n"] = entry.get("n", 0) + int(comp.get("n", 1))
            entry["last_suggested"] = round(suggested, 6)
        self.runs += 1
        return {name: {"scale": e["scale"], "n": e["n"],
                       "applied": e["n"] >= self.config.min_samples}
                for name, e in sorted(self.components.items())}

    def scale_for(self, component: str, default: float = 1.0) -> float:
        """The applied scale for one component: the smoothed EWMA when the
        cumulative sample count clears ``min_samples``, else ``default``
        (the prediction stands un-corrected until there is evidence)."""
        e = self.components.get(component)
        if e is None or e.get("n", 0) < self.config.min_samples:
            return default
        return float(e["scale"])

    def scales(self) -> Dict[str, float]:
        """All components that clear the min-sample gate, name -> scale."""
        return {name: float(e["scale"])
                for name, e in sorted(self.components.items())
                if e.get("n", 0) >= self.config.min_samples}

    def __bool__(self) -> bool:
        return bool(self.components)
