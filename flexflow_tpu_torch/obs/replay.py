"""Traffic-trace capture and deterministic replay.

A copy of the JAX package's ``flexflow_tpu/obs/replay.py`` (host-side
Python only), its imports re-pointed at this package, which never imports
the JAX one.  Every token is a function of (seed, rid, token index) and
the committed prefix, so a faithfully recorded arrival stream replays
exactly: the same plan and seeds give the same streams and outcomes,
greedy and seeded, under a recorded fault schedule too.

* :class:`TrafficTraceRecorder` — the ``record_trace=`` handle that
  ``RequestManager.serve_with_arrivals``, the ``SpecInferManager`` and
  ``FleetRouter.serve_with_arrivals`` feed.  It writes a VERSIONED JSONL
  artifact: one ``trace_meta`` header (driver class, the whole
  :class:`~flexflow_tpu_torch.serve.request_manager.GenerationConfig` with
  its seed, plan key and engine shape, the fault injector's seed and
  sites, the fleet's topology and scheduled kills, the SLO policy), one
  ``arrival`` line per offered request (offset, prompt tokens and hash,
  max_new, the RAW options dict, so a malformed one replays its
  rejection), and one ``outcome`` line per request (terminal outcome,
  tokens and hash, the latency decomposition, replica and failovers).
* :class:`TrafficTrace` — the loaded artifact (``TrafficTrace.load``).
* :class:`ReplayHarness` — re-drives a deployment from a trace on a
  virtual clock.  *Fidelity replay* (:meth:`ReplayHarness.replay`, then
  :meth:`ReplayHarness.verify`) pins the recorded generation config,
  fault schedule and kill schedule onto a freshly built target and holds
  every request's stream, outcome and failover count to the recording.
  *What-if replay* (:meth:`ReplayHarness.what_if`) runs the recorded
  arrivals through a slot-level simulation priced by a candidate's
  ``tpot_s`` (a price dict: ``search.serve_search.price_plan``'s), and
  :meth:`ReplayHarness.diff` compares two summaries under
  ``tools/bench_compare.py``'s discipline.

All of it is host-side Python: recording never reads the serve loop's
clock and only appends, so a recorded run equals an unrecorded one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

TRACE_VERSION = 1

# JSONL line kinds a trace artifact carries, in file order
TRACE_LINE_KINDS = ("trace_meta", "arrival", "outcome")

# outcome-record fields replayed runs are verified against (bit-identity
# fields compare exactly; the latency decomposition is measured and rides
# the what-if deltas instead)
FIDELITY_FIELDS = ("tokens", "outcome", "failovers")


def token_hash(tokens: Sequence[int]) -> str:
    """Stable short digest of a token sequence (prompt or output) — the
    integrity stamp arrival/outcome lines carry so a hand-edited trace
    cannot silently masquerade as a faithful recording."""
    payload = ",".join(str(int(t)) for t in tokens).encode()
    return hashlib.sha256(payload).hexdigest()[:16]


def plan_key_of(im) -> str:
    """Best-effort plan key for an InferenceManager-like engine — the
    same ``tp{t}_pp{p}_m{m}`` vocabulary the search/calibration stack
    uses, suffixed with the KV layout knobs that change the engine's
    compiled programs (int8 KV, paged KV)."""
    stages = getattr(im, "stage_plans", None)
    pp = len(stages) if stages else 1
    mesh = getattr(im, "mesh", None)
    if mesh is None:
        meshes = getattr(im, "stage_meshes", None)
        mesh = meshes[0] if meshes else None
    tp = 1
    if mesh is not None:
        try:   # a jax Mesh's and the port's ``parallel.Mesh``'s shape
            tp = int(dict(mesh.shape).get("tp", 1))
        except Exception:
            tp = 1
    m = int(getattr(im, "n_micro", 1) or 1)
    key = f"tp{tp}_pp{pp}_m{m}"
    if getattr(im, "kv_dtype", None):
        key += f"_kv{im.kv_dtype}"
    page = getattr(im, "kv_page_size", None)
    if page:
        key += f"_paged{page}"
    return key


def engine_shape_of(im) -> Dict:
    """The engine capacity/layout fields the what-if simulator and the
    fidelity check need from a deployment (serializable)."""
    return {
        "plan_key": plan_key_of(im),
        "max_requests": int(getattr(im, "max_requests", 1)),
        "max_seq_len": int(getattr(im, "max_seq_len", 0)),
        "kv_dtype": getattr(im, "kv_dtype", None),
        "kv_page_size": getattr(im, "kv_page_size", None),
    }


def injector_meta(injector) -> Optional[Dict]:
    """Serialize a :class:`~flexflow_tpu_torch.serve.resilience.FaultInjector`'s
    full seeded schedule provenance (seed + site probabilities + bound) —
    what makes a recorded chaos run reproducible from the artifact
    alone."""
    if injector is None:
        return None
    return {
        "seed": getattr(injector, "seed", None),
        "p": getattr(injector, "p", 0.0),
        "p_by_site": dict(getattr(injector, "p_by_site", {}) or {}),
        "max_faults": getattr(injector, "max_faults", None),
    }


class VirtualClock:
    """Deterministic replay clock: advances ``step`` seconds per reading
    (``serve_with_arrivals`` takes any 0-argument seconds callable)."""

    def __init__(self, step: float = 1e-3, t: float = 0.0):
        self.step = step
        self.t = t

    def __call__(self) -> float:
        self.t += self.step
        return self.t


class TrafficTraceRecorder:
    """The ``record_trace=`` capture handle.

    Serve loops call :meth:`begin_run` on entry (idempotent — a
    live-migration successor manager re-enters the same recorder and its
    meta lands as a ``continuations`` entry), :meth:`record_arrival`
    for every offered arrival at admit time, and :meth:`finalize` with
    the finished records dict.  ``path`` set at construction auto-saves
    on finalize; a bound ``telemetry`` handle emits the
    ``trace_recorded`` instant (EVENT_SCHEMA "replay" category) when the
    artifact lands on disk.

    The recorder NEVER reads the serve loop's clock and never touches
    the request objects — capture is append-only host bookkeeping, so a
    recorded run is bit-identical to an unrecorded one.
    """

    def __init__(self, path: Optional[str] = None, telemetry=None):
        self.path = path
        self.telemetry = telemetry
        self.meta: Optional[Dict] = None
        self.arrivals: List[Dict] = []
        self.outcomes: List[Dict] = []
        self.saved_path: Optional[str] = None

    # ---- capture hooks (called by the serve loops) --------------------
    def begin_run(self, meta: Dict) -> None:
        if self.meta is None:
            self.meta = dict(meta)
        else:
            # a live-migration successor re-entered serve_with_arrivals
            # with the same recorder: the original header stands, the
            # successor's plan provenance is appended
            self.meta.setdefault("continuations", []).append(dict(meta))

    def record_arrival(self, offset_s: float, prompt: Sequence[int],
                       max_new, opts: Optional[Dict]) -> None:
        line = {
            "offset_s": float(offset_s),
            "prompt": [int(t) for t in prompt],
            "prompt_len": len(prompt),
            "prompt_hash": token_hash(prompt),
            "max_new": (None if max_new is None else int(max_new)),
        }
        if opts is not None:
            line["opts"] = opts
        self.arrivals.append(line)

    def finalize(self, records: Dict[int, Dict]) -> None:
        """Stamp every finished serving record (the ``serve_with_arrivals``
        return schema) as an ``outcome`` line, then auto-save if a path
        was configured."""
        self.outcomes = []
        for rid in sorted(records):
            rec = records[rid]
            out = {
                "rid": int(rid),
                "trace_id": rec.get("trace_id", f"r{rid:05d}"),
                "outcome": rec.get("outcome", "ok"),
                "tokens": [int(t) for t in rec.get("tokens", [])],
                "tokens_hash": token_hash(rec.get("tokens", [])),
                "prompt_len": rec.get("prompt_len"),
                "arrival_s": rec.get("arrival_s"),
                "queue_wait_s": rec.get("queue_wait_s"),
                "prefill_s": rec.get("prefill_s"),
                "kv_bytes": rec.get("kv_bytes"),
            }
            for opt in ("first_token_s", "finish_s", "slo_class",
                        "deferred_ticks", "replica", "failovers"):
                if opt in rec:
                    out[opt] = rec[opt]
            self.outcomes.append(out)
        if self.path is not None:
            self.save(self.path)

    # ---- artifact I/O -------------------------------------------------
    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("no trace path configured")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        meta = dict(self.meta or {})
        meta.update({"kind": "trace_meta", "version": TRACE_VERSION,
                     "arrivals": len(self.arrivals),
                     "requests": len(self.outcomes)})
        with open(path, "w") as f:
            f.write(json.dumps(meta) + "\n")
            for a in self.arrivals:
                f.write(json.dumps({"kind": "arrival", **a}) + "\n")
            for o in self.outcomes:
                f.write(json.dumps({"kind": "outcome", **o}) + "\n")
        self.saved_path = path
        tel = self.telemetry
        if tel is not None and getattr(tel, "enabled", False):
            tel.trace_recorded(arrivals=len(self.arrivals), path=path,
                               requests=len(self.outcomes))
        return path

    def trace(self) -> "TrafficTrace":
        """The in-memory view (no file round trip needed)."""
        return TrafficTrace(meta=dict(self.meta or {}),
                            arrivals=list(self.arrivals),
                            outcomes=list(self.outcomes))


@dataclasses.dataclass
class TrafficTrace:
    """A loaded (or in-memory) traffic-trace artifact."""

    meta: Dict
    arrivals: List[Dict]
    outcomes: List[Dict]

    @classmethod
    def load(cls, path: str) -> "TrafficTrace":
        meta: Dict = {}
        arrivals: List[Dict] = []
        outcomes: List[Dict] = []
        with open(path) as f:
            for i, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                doc = json.loads(line)
                kind = doc.get("kind")
                if kind == "trace_meta":
                    meta = doc
                elif kind == "arrival":
                    arrivals.append(doc)
                elif kind == "outcome":
                    outcomes.append(doc)
                else:
                    raise ValueError(
                        f"{path}:{i}: unknown trace line kind {kind!r}")
        if not meta:
            raise ValueError(f"{path}: no trace_meta line")
        version = meta.get("version")
        if version != TRACE_VERSION:
            raise ValueError(f"{path}: trace version {version!r}, "
                             f"this reader speaks {TRACE_VERSION}")
        return cls(meta=meta, arrivals=arrivals, outcomes=outcomes)

    def validate(self) -> List[str]:
        """Integrity check: declared counts and token hashes.  Returns
        violations (empty = valid) — ``tools/replay_report.py --check``
        is the CLI."""
        errors: List[str] = []
        if self.meta.get("arrivals") not in (None, len(self.arrivals)):
            errors.append(
                f"meta declares {self.meta.get('arrivals')} arrivals, "
                f"file carries {len(self.arrivals)}")
        if self.meta.get("requests") not in (None, len(self.outcomes)):
            errors.append(
                f"meta declares {self.meta.get('requests')} requests, "
                f"file carries {len(self.outcomes)}")
        if not self.meta.get("gen"):
            errors.append("trace_meta missing gen config (seed provenance)")
        for i, a in enumerate(self.arrivals):
            if token_hash(a.get("prompt", [])) != a.get("prompt_hash"):
                errors.append(f"arrival {i}: prompt hash mismatch")
        for o in self.outcomes:
            if token_hash(o.get("tokens", [])) != o.get("tokens_hash"):
                errors.append(
                    f"outcome {o.get('trace_id')}: tokens hash mismatch")
        return errors

    def arrival_tuples(self) -> List[tuple]:
        """The ``serve_with_arrivals`` arrival list this trace re-drives
        (offset, prompt, max_new[, opts]) — the RAW recorded options
        dict, so a malformed dict replays its rejection identically."""
        tuples = []
        for a in self.arrivals:
            t = (a["offset_s"], list(a["prompt"]), a["max_new"])
            if "opts" in a:
                t = t + (a["opts"],)
            tuples.append(t)
        return tuples

    def records(self) -> Dict[int, Dict]:
        """The recorded outcomes re-shaped as a ``serve_with_arrivals``
        records dict — the input ``obs.report.under_load_summary``
        reduces, so a trace summarizes with the SAME accounting as a
        live run."""
        recs: Dict[int, Dict] = {}
        for o in self.outcomes:
            rec = {k: v for k, v in o.items()
                   if k not in ("kind", "rid", "tokens_hash")}
            recs[o["rid"]] = rec
        return recs


class ReplayHarness:
    """Re-drive a recorded traffic trace against a deployment.

    ``telemetry`` (optional) emits the EVENT_SCHEMA "replay" vocabulary:
    ``replay_started`` / ``replay_completed`` instants plus one
    ``replay_mismatch`` per fidelity violation, and the
    ``replays_run`` / ``replay_mismatches`` exact counters
    ``tools/bench_compare.py`` guards.
    """

    def __init__(self, trace: TrafficTrace, telemetry=None):
        self.trace = trace
        from .telemetry import telemetry_or_null

        self.telemetry = telemetry_or_null(telemetry)

    # ---- recorded-run provenance --------------------------------------
    def gen_config(self):
        """The recorded run's full GenerationConfig (incl. sampling
        seed) — what fidelity replay pins onto the target."""
        from ..serve.request_manager import GenerationConfig

        return GenerationConfig(**self.trace.meta.get("gen", {}))

    def fault_injector(self):
        """A FRESH FaultInjector with the recorded seed/sites/bound
        (None when the recorded run had no injector).  Fresh per call:
        replaying twice must replay the same schedule twice."""
        fault = self.trace.meta.get("fault")
        if not fault or fault.get("seed") is None:
            return None
        from ..serve.resilience import FaultInjector

        return FaultInjector(seed=fault["seed"], p=fault.get("p", 0.0),
                             p_by_site=fault.get("p_by_site"),
                             max_faults=fault.get("max_faults"))

    def arrivals(self) -> List[tuple]:
        return self.trace.arrival_tuples()

    # ---- fidelity replay ----------------------------------------------
    def pin(self, target) -> None:
        """Pin the recorded provenance onto ``target`` (a RequestManager,
        SpecInferManager, or FleetRouter): gen config + sampling seed,
        fault-injector schedule, and — for a fleet — the recorded
        replica-kill schedule.  The target's weights/plan are the
        caller's choice (fidelity needs the recorded plan + identical
        weights; a different plan is a what-if the caller measures)."""
        gen = self.gen_config()
        inj = self.fault_injector()
        target.gen = gen
        target.injector = inj
        reps = getattr(target, "replicas", None)
        if reps is not None:  # FleetRouter
            for rep in reps:
                rep.rm.gen = gen
                rep.rm.injector = inj
                rep.rm.im.fault_injector = inj
            fleet = self.trace.meta.get("fleet") or {}
            for name, tick in (fleet.get("kills") or {}).items():
                target.schedule_kill(name, int(tick))
        else:
            target.im.fault_injector = inj

    def replay(self, target, clock: Optional[Callable[[], float]] = None,
               quantum: int = 8, pin: bool = True,
               record_trace=None) -> Dict[int, Dict]:
        """Fidelity replay: drive ``target`` with the recorded arrival
        stream on a virtual clock (``pin=True`` installs the recorded
        gen/fault/kill provenance first).  Returns the replayed records;
        :meth:`verify` diffs them against the recording."""
        if pin:
            self.pin(target)
        tel = self.telemetry
        if tel.enabled:
            tel.replay_started(mode="fidelity",
                               driver=self.trace.meta.get("driver", ""),
                               arrivals=len(self.trace.arrivals))
        return target.serve_with_arrivals(
            self.arrivals(), clock=clock or VirtualClock(),
            quantum=quantum, record_trace=record_trace)

    def verify(self, records: Dict[int, Dict]) -> Dict:
        """Bit-identity check of a replayed run against the recording:
        per-request token streams, terminal outcomes, and failover
        counts must match EXACTLY (``FIDELITY_FIELDS``).  Emits one
        ``replay_mismatch`` instant per violation and the
        ``replay_completed`` summary instant."""
        recorded = {o["rid"]: o for o in self.trace.outcomes}
        mismatches: List[Dict] = []
        tel = self.telemetry
        for rid in sorted(set(recorded) | set(records)):
            old, new = recorded.get(rid), records.get(rid)
            tid = (old or new or {}).get("trace_id", f"r{rid:05d}")
            if old is None or new is None:
                mismatches.append({"trace_id": tid, "field": "presence",
                                   "recorded": old is not None,
                                   "replayed": new is not None})
                continue
            for field in FIDELITY_FIELDS:
                if field == "failovers" and field not in old \
                        and field not in new:
                    continue
                ov = old.get(field)
                nv = list(new.get(field) or []) if field == "tokens" \
                    else new.get(field, 0 if field == "failovers" else None)
                if field == "failovers":
                    ov = old.get(field, 0)
                if ov != nv:
                    mismatches.append({"trace_id": tid, "field": field,
                                       "recorded": ov, "replayed": nv})
        if tel.enabled:
            for mm in mismatches:
                tel.replay_mismatch(mm["trace_id"], mm["field"])
            tel.replay_completed(mode="fidelity",
                                 bit_identical=not mismatches,
                                 mismatches=len(mismatches))
        return {
            "requests": len(recorded),
            "replayed": len(records),
            "bit_identical": not mismatches,
            "mismatches": mismatches,
        }

    # ---- what-if replay ------------------------------------------------
    def what_if(self, price: Dict, fleet_size: int = 1,
                max_requests: Optional[int] = None,
                prefill_s_per_token: Optional[float] = None) -> Dict:
        """Price a DIFFERENT deployment candidate against the recorded
        arrival stream with NO device attached.

        ``price`` is any dict with ``tpot_s`` (or ``tpot_ms``): the
        candidate's steady-state seconds a token, as the planner's
        ``price_plan`` gives them;
        ``plan_key`` labels the candidate, so tp×pp×m×kv_dtype×paged×
        spec variants all ride through one field).  ``fleet_size``
        scales the candidate to N identical replicas; ``max_requests``
        overrides the recorded engine's slot count.  Prefill is priced
        at ``prefill_s_per_token`` (default: the candidate's decode
        rate — conservative, one token-time per prompt position).

        The recorded arrivals run through a deterministic slot-level
        event simulation: earliest-free-slot placement over
        ``fleet_size × max_requests`` slots, per-request service =
        prompt prefill + (recorded output length) × tpot, TTL/deadline
        options re-applied to the simulated queue wait (so the outcome
        MIX responds to the candidate, not just the latencies).  Returns
        simulated records (the ``serve_with_arrivals`` schema),
        an ``under_load_summary`` reduction, and the candidate label —
        feed two of these to :meth:`diff` for the delta table.
        """
        tpot = float(price.get("tpot_s") or 0.0)
        if tpot <= 0.0 and price.get("tpot_ms"):
            tpot = float(price["tpot_ms"]) / 1e3
        if tpot <= 0.0:
            raise ValueError("candidate price carries no tpot_s/tpot_ms")
        pf = prefill_s_per_token if prefill_s_per_token is not None else tpot
        plan = self.trace.meta.get("plan") or {}
        slots_per = int(max_requests or plan.get("max_requests") or 1)
        n_slots = max(int(fleet_size), 1) * max(slots_per, 1)
        recorded = {o["rid"]: o for o in self.trace.outcomes}
        tel = self.telemetry
        if tel.enabled:
            tel.replay_started(mode="what_if",
                               driver=self.trace.meta.get("driver", ""),
                               arrivals=len(self.trace.arrivals))

        free_at = [0.0] * n_slots
        records: Dict[int, Dict] = {}
        sim_outcomes: Dict[str, int] = {}
        for rid, arrival in enumerate(sorted(
                self.trace.arrivals, key=lambda a: a["offset_s"])):
            off = float(arrival["offset_s"])
            opts = arrival.get("opts") or {}
            old = recorded.get(rid, {})
            # the output the candidate must serve: the recorded stream
            # (what-if changes WHEN tokens land, never WHICH tokens —
            # the fold makes streams plan-invariant); terminal-early
            # recorded requests fall back to their offered budget
            tokens = list(old.get("tokens", []))
            n_out = len(tokens)
            if n_out == 0 and old.get("outcome") not in ("ok", None):
                n_out = int(arrival.get("max_new") or 0)
            slot = min(range(n_slots), key=lambda s: free_at[s])
            start = max(off, free_at[slot])
            prefill_s = arrival["prompt_len"] * pf
            first = start + prefill_s + tpot
            finish = start + prefill_s + max(n_out, 1) * tpot
            rec: Dict = {
                "arrival_s": off,
                "admitted_s": off,
                "prompt_len": arrival["prompt_len"],
                "trace_id": old.get("trace_id", f"r{rid:05d}"),
                "queue_wait_s": max(start - off, 0.0),
                "prefill_s": prefill_s,
                "tokens": tokens,
                "outcome": "ok",
                "replica": f"sim{slot % max(int(fleet_size), 1)}",
            }
            if isinstance(opts, dict) and opts.get("slo_class") is not None:
                rec["slo_class"] = str(opts["slo_class"])
            # re-apply the request's own latency bound to the SIMULATED
            # schedule: a candidate that queues a request past its
            # ttl/deadline times it out — the outcome mix is priced, not
            # copied
            bound = None
            if isinstance(opts, dict):
                if opts.get("ttl_s") is not None:
                    bound = float(opts["ttl_s"])
                if opts.get("deadline_s") is not None:
                    d = float(opts["deadline_s"])
                    bound = d if bound is None else min(bound, d)
            if bound is not None and first - off > bound:
                rec["outcome"] = "timeout"
                rec["tokens"] = []
                rec["finish_s"] = off + bound
            else:
                if n_out > 0:
                    rec["first_token_s"] = first
                rec["finish_s"] = finish
                free_at[slot] = finish
            sim_outcomes[rec["outcome"]] = \
                sim_outcomes.get(rec["outcome"], 0) + 1
            records[rid] = rec
        from .report import under_load_summary

        summary = under_load_summary(records)
        if tel.enabled:
            tel.replay_completed(mode="what_if", bit_identical=None,
                                 mismatches=0)
        return {
            "candidate": {
                "plan_key": price.get("plan_key", "candidate"),
                "fleet_size": int(fleet_size),
                "slots": n_slots,
                "tpot_ms": round(tpot * 1e3, 4),
                "prefill_s_per_token": pf,
            },
            "records": records,
            "summary": summary,
            "outcomes": sim_outcomes,
        }

    def recorded_summary(self) -> Dict:
        """``under_load_summary`` of the RECORDED run (from the artifact
        alone) — the baseline side of every diff."""
        from .report import under_load_summary

        return under_load_summary(self.trace.records())

    def diff(self, old_summary: Dict, new_summary: Dict,
             default_threshold: float = 0.10) -> Dict:
        """Compare two run summaries (recorded vs replayed, or two
        what-if candidates) under ``tools/bench_compare.py``'s
        discipline: deterministic counters exact, latency fields
        thresholded (increase = regression), throughput fields
        directional (decrease = regression)."""
        bc = load_bench_compare()
        return bc.compare(old_summary, new_summary,
                          default_threshold=default_threshold)


def load_bench_compare():
    """The port's ``tools/bench_compare.py``: the replay diff and the
    command-line gate share one comparison discipline."""
    from ..tools import bench_compare

    return bench_compare
