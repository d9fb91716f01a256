"""Perf-regression comparator over two bench artifacts, for the port.

Usage::

    python -m flexflow_tpu_torch.tools.bench_compare OLD.json NEW.json
    python -m flexflow_tpu_torch.tools.bench_compare OLD.json NEW.json \
        --default-threshold 0.1 --threshold tpot_ms=0.05

The port's counterpart of the JAX package's ``scripts/bench_compare.py``
(the same command line, classes and exit codes), reading the work-counter
vocabulary from this package's profiler.  Two JSON artifacts are diffed
field by field; the exit code is 1 on any regression:

* the deterministic work counters (``obs.profiler.WORK_COUNTERS``:
  ``flops``, HBM bytes, ``kv_bytes_touched``, ``dispatches``,
  ``recompiles_total`` (0 in the port: eager PyTorch has no jit cache),
  ``host_syncs``, ``pages_mapped``, ``pages_cow``) and the SLO, tier and
  trace regression counters are compared exactly by default: two runs of
  the same workload must agree, and a counter missing from the new
  artifact is a regression;
* measured latency fields (``*tpot*``, ``*ttft*``, ``*_ms``, ...) regress
  past a relative threshold (default 10%), throughput fields
  (``*tok_s*``, ...) when they fall past it.

Output is one JSON document (``ok``, ``regressions``, ``improvements``,
``compared``).
"""

import argparse
import json
import re
import sys

# leaf-key name classes (lowercase substring/regex matching)
_COUNTER_KEYS = None  # loaded from obs.profiler.WORK_COUNTERS lazily
_LATENCY_RE = re.compile(
    r"(tpot|ttft|queue_wait|prefill(?!_tokens)|transfer|wall|downtime"
    r"|latency|overhead)", re.I)
_THROUGHPUT_RE = re.compile(r"(goodput|tokens_per_sec|tok_s|mfu)", re.I)
_TIME_SUFFIX_RE = re.compile(r"_(ms|s|us)$")


def _counter_keys():
    global _COUNTER_KEYS
    if _COUNTER_KEYS is None:
        from ..obs.profiler import WORK_COUNTERS
        from ..obs.telemetry import (
            FLEET_REGRESSION_COUNTERS,
            HOST_TICK_REGRESSION_COUNTERS,
            REPLAY_REGRESSION_COUNTERS,
            SLO_REGRESSION_COUNTERS,
            TIER_REGRESSION_COUNTERS,
            TRACE_REGRESSION_COUNTERS,
        )

        # fleet robustness counters join the deterministic-exact class:
        # a hermetic fleet run's failovers/quarantines/deaths are a pure
        # function of the seeded schedule, so any increase between two
        # runs of the same workload means the fleet got less robust
        # (more replicas failing per served token).  Same for the
        # SLO-lane counters (serve/slo.py): more shed/deferred requests
        # or more brownout escalations for the same seeded overload
        # means the lanes degrade less gracefully.  The host-tick ratios
        # (dispatches per token, host syncs per stretch) are derived
        # from exact counters over a deterministic schedule, so they
        # join the exact class too.
        # replay_mismatches (obs/replay.py) joins at exact-zero: any
        # fidelity mismatch means a recorded run stopped replaying
        # bit-identically.  telemetry_events_dropped hardens trace
        # drops: the ring buffer silently losing events was only a
        # stderr warning in trace_report — here it fails the diff.
        # kv_restore_failures (serve/kv_paged.py host tier) joins at
        # exact-zero too: a clean-path restore degrading to recompute is
        # correct-but-worse, so any increase on the same seeded workload
        # is a regression (the spill/restore volume counters stay out —
        # their direction depends on the pressure mix, not on health).
        _COUNTER_KEYS = frozenset(WORK_COUNTERS) \
            | frozenset(FLEET_REGRESSION_COUNTERS) \
            | frozenset(SLO_REGRESSION_COUNTERS) \
            | frozenset(HOST_TICK_REGRESSION_COUNTERS) \
            | frozenset(REPLAY_REGRESSION_COUNTERS) \
            | frozenset(TIER_REGRESSION_COUNTERS) \
            | frozenset(TRACE_REGRESSION_COUNTERS)
    return _COUNTER_KEYS


def classify(leaf_key: str):
    """'counter' | 'latency' | 'throughput' | None for one leaf key."""
    if leaf_key in _counter_keys():
        return "counter"
    if _THROUGHPUT_RE.search(leaf_key):
        return "throughput"
    if _LATENCY_RE.search(leaf_key) and (
            _TIME_SUFFIX_RE.search(leaf_key)
            or "ticks" in leaf_key or "frac" in leaf_key):
        return "latency"
    return None


def walk(doc, prefix=""):
    """Yield (dotted_path, leaf_key, numeric_value) for every numeric
    leaf (bools excluded; list indices join the path)."""
    if isinstance(doc, dict):
        for k, v in doc.items():
            yield from walk(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(doc, (list, tuple)):
        for i, v in enumerate(doc):
            yield from walk(v, f"{prefix}[{i}]")
    elif isinstance(doc, bool):
        return
    elif isinstance(doc, (int, float)):
        leaf = prefix.rsplit(".", 1)[-1]
        leaf = re.sub(r"\[\d+\]$", "", leaf)
        yield prefix, leaf, float(doc)


def compare(old: dict, new: dict, default_threshold: float = 0.10,
            counter_threshold: float = 0.0,
            overrides=None) -> dict:
    """Pure comparison (importable by tests and CI wrappers): returns
    ``{"ok", "regressions", "improvements", "compared", "missing"}``."""
    overrides = overrides or {}
    old_leaves = {path: (leaf, v) for path, leaf, v in walk(old)}
    new_leaves = {path: (leaf, v) for path, leaf, v in walk(new)}
    regressions, improvements, missing = [], [], []
    compared = 0
    for path, (leaf, v_old) in sorted(old_leaves.items()):
        kind = classify(leaf)
        if kind is None:
            continue
        if path not in new_leaves:
            if kind == "counter":
                # a deterministic guard field that vanished IS a
                # regression: the new run no longer proves its work
                missing.append({"field": path, "kind": kind,
                                "old": v_old})
            continue
        v_new = new_leaves[path][1]
        compared += 1
        thr = overrides.get(leaf,
                            counter_threshold if kind == "counter"
                            else default_threshold)
        if v_old == 0:
            delta = 0.0 if v_new == 0 else float("inf")
        else:
            delta = (v_new - v_old) / abs(v_old)
        worse = delta > thr if kind != "throughput" else (-delta) > thr
        better = delta < -thr if kind != "throughput" else delta > thr
        entry = {"field": path, "kind": kind, "old": v_old, "new": v_new,
                 "delta_frac": (round(delta, 4)
                                if delta != float("inf") else None),
                 "threshold": thr}
        if worse:
            regressions.append(entry)
        elif better:
            improvements.append(entry)
    regressions.extend(missing)
    return {
        "ok": not regressions,
        "compared": compared,
        "regressions": regressions,
        "improvements": improvements,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Diff two bench artifacts; exit nonzero on regression")
    ap.add_argument("old", help="reference artifact (JSON)")
    ap.add_argument("new", help="candidate artifact (JSON)")
    ap.add_argument("--default-threshold", type=float, default=0.10,
                    help="relative threshold for measured fields "
                         "(default 0.10)")
    ap.add_argument("--counter-threshold", type=float, default=0.0,
                    help="relative threshold for deterministic work "
                         "counters (default 0 = exact)")
    ap.add_argument("--threshold", action="append", default=[],
                    metavar="FIELD=FRAC",
                    help="per-field override (leaf key), repeatable")
    ap.add_argument("--indent", type=int, default=None)
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the result document to PATH "
                         "(machine-readable sink for CI and the replay "
                         "diff report; exit code unchanged)")
    args = ap.parse_args(argv)

    overrides = {}
    for spec in args.threshold:
        field, _, frac = spec.partition("=")
        if not frac:
            ap.error(f"--threshold needs FIELD=FRAC, got {spec!r}")
        overrides[field] = float(frac)

    with open(args.old) as f:
        old = json.load(f)
    with open(args.new) as f:
        new = json.load(f)
    result = compare(old, new, args.default_threshold,
                     args.counter_threshold, overrides)
    result["old"] = args.old
    result["new"] = args.new
    print(json.dumps(result, indent=args.indent))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
